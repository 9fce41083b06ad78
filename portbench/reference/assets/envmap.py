"""Environment-map importance-sampling tables: the luminance CDF and the
Vose alias table, mirroring ``hiprt_pt_tpu.assets.envmap`` (reference:
Image32Bit::compute_cdf / compute_alias_table, src/Image/Image.cpp:553-660).

Built on the host in numpy, with the JAX package's numbers, and moved to
the device in an ``EnvmapData`` (assets/scene.py); lights/envmap_sampling.py
reads them. ``load_envmap`` reads a Radiance .hdr file through
assets/image_io.py's own RGBE decoder.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .image_io import luminance, read_hdr
from .scene import EnvmapData, vose_alias


def sin_weighted_luminance(texels: np.ndarray) -> np.ndarray:
    """Per-texel importance: luminance × sin(theta), the solid-angle weight
    of an equirectangular row."""
    h = texels.shape[0]
    theta = (np.arange(h, dtype=np.float64) + 0.5) / h * np.pi
    return (luminance(texels) * np.sin(theta)[:, None]).astype(np.float64)


def compute_cdf(texels: np.ndarray) -> np.ndarray:
    """Flat inclusive CDF over all texels (reference: Image.cpp:553-574)."""
    imp = sin_weighted_luminance(texels).ravel()
    cdf = np.cumsum(imp)
    total = cdf[-1]
    if total <= 0.0:
        return np.linspace(1.0 / imp.size, 1.0, imp.size).astype(np.float32)
    return (cdf / total).astype(np.float32)


def compute_alias_table(texels: np.ndarray):
    """Vose O(N) alias table over the texel importance (reference:
    Image.cpp:576-660), in the JAX package's pop order (the emissive
    table's ``vose_alias``). Returns (probas f32 (N,), aliases i32 (N,)):
    draw a uniform texel index i and a uniform u, take i if u < probas[i]
    else aliases[i]."""
    return vose_alias(sin_weighted_luminance(texels))


def build_envmap(texels: np.ndarray, intensity: float = 1.0,
                 device=None) -> EnvmapData:
    """EnvmapData on ``device`` (default: the GPU) from an (H, W, 3) linear
    radiance map. ``intensity`` is ignored, as in the JAX package: the
    intensity is ``WorldSettings.envmap_intensity``."""
    del intensity
    device = resolve_device(device)
    texels = np.ascontiguousarray(np.asarray(texels, dtype=np.float32)[..., :3])
    probas, aliases = compute_alias_table(texels)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return EnvmapData(
        texels=t(texels), cdf=t(compute_cdf(texels)), alias_probas=t(probas),
        alias_indices=t(aliases),
        total_luminance=float(np.float32(sin_weighted_luminance(texels).sum())))


def load_envmap(path: str, intensity: float = 1.0, device=None) -> EnvmapData:
    """EnvmapData on ``device`` (default: the GPU) from a Radiance .hdr
    file (assets/image_io.py:read_hdr)."""
    return build_envmap(read_hdr(path), intensity, device=device)


def make_test_envmap(h: int = 64, w: int = 128, kind: str = "sky") -> np.ndarray:
    """Procedural envmaps (no HDR asset ships with the repo): "white",
    "sun" (one bright texel) or "sky" (a gradient and a sun disk)."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi
    t, p = np.meshgrid(theta, phi, indexing="ij")
    if kind == "white":
        return np.ones((h, w, 3), dtype=np.float32)
    if kind == "sun":
        img = np.full((h, w, 3), 0.05, dtype=np.float32)
        img[h // 4, w // 3] = [5000.0, 4500.0, 4000.0]
        return img
    sky = np.stack([0.2 + 0.3 * np.cos(t), 0.35 + 0.35 * np.cos(t),
                    0.65 + 0.3 * np.cos(t)], axis=-1).astype(np.float32)
    sun_dir = (np.pi / 3.0, np.pi / 4.0)
    ang = np.arccos(np.clip(
        np.sin(t) * np.sin(sun_dir[0]) * np.cos(p - sun_dir[1])
        + np.cos(t) * np.cos(sun_dir[0]), -1, 1))
    sky += (np.exp(-(ang ** 2) / 0.005)[..., None]
            * np.array([50.0, 45.0, 35.0])).astype(np.float32)
    return np.clip(sky, 0.0, None)
