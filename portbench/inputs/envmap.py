"""The test sky of the benchmark's envmap scene, frozen from the port's
maker: ``make_test_envmap(64, 128, "sky")``, a gradient and a sun disk.
Numpy only."""

from __future__ import annotations

import numpy as np


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
