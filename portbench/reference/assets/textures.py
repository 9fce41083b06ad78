"""Texture atlas construction, mirroring ``hiprt_pt_tpu.assets.textures``:
textures keep their own resolution (capped at ``layer_size``), are stored as
uint8 with sRGB decoded at fetch time (ops/texture.py), and carry a
box-filtered mip chain. Pure numpy on the host; the atlas is a
``TextureAtlas`` of CPU tensors that ``build_scene`` moves to its device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .scene import TextureAtlas

MAX_MIPS = 12
DEFAULT_MAX_SIZE = 2048
# footprint rows cost 4x storage; above this many texels (64M = 1 GB of
# 16-byte rows) the atlas keeps plain 4-byte texels and fetches 4 taps
FOOTPRINT_MAX_TEXELS = 64 * 1024 * 1024


def _to_u8(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == np.uint8:
        return arr
    return np.clip(np.asarray(arr, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _ensure_rgba(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        arr = arr[..., None]
    one = 255 if arr.dtype == np.uint8 else 1.0
    if arr.shape[-1] == 3:
        arr = np.concatenate([arr, np.full(arr.shape[:-1] + (1,), one, arr.dtype)], -1)
    elif arr.shape[-1] == 1:
        arr = np.concatenate(
            [arr] * 3 + [np.full(arr.shape[:-1] + (1,), one, arr.dtype)], -1)
    return arr


def _downsample2(img: np.ndarray) -> np.ndarray:
    """Box-filter halving of an (H, W, 4) uint8 image."""
    h, w = img.shape[:2]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    f = img[: h2 * 2, : w2 * 2].astype(np.float32)
    if h >= 2 and w >= 2:
        f = f.reshape(h2, 2, w2, 2, 4).mean((1, 3))
    elif h >= 2:
        f = f.reshape(h2, 2, w2, 4).mean(1)
    elif w >= 2:
        f = f.reshape(h2, w2, 2, 4).mean(2)
    return np.clip(f + 0.5, 0, 255).astype(np.uint8)


def build_texture_atlas(images: list, srgb_indices: set,
                        layer_size: int = DEFAULT_MAX_SIZE) -> Optional[TextureAtlas]:
    """images: list of HxWx{1,3,4} uint8/float arrays (or None).
    srgb_indices: image indices holding color data (decoded at fetch).
    layer_size: the largest level-0 dimension; larger sources are halved
    until they fit."""
    if not images or all(im is None for im in images):
        return None
    L = len(images)
    levels = []
    offsets = np.full((L, MAX_MIPS), -1, np.int64)
    widths = np.zeros((L,), np.int32)
    heights = np.zeros((L,), np.int32)
    num_levels = np.zeros((L,), np.int32)
    srgb_flags = np.zeros((L,), bool)
    total = 0
    any_alpha = False
    for i, im in enumerate(images):
        arr = (np.full((1, 1, 4), 255, np.uint8) if im is None
               else _to_u8(_ensure_rgba(np.asarray(im))))
        while max(arr.shape[0], arr.shape[1]) > layer_size:
            arr = _downsample2(arr)
        any_alpha = any_alpha or bool((arr[..., 3] < 255).any())
        srgb_flags[i] = i in srgb_indices
        widths[i] = arr.shape[1]
        heights[i] = arr.shape[0]
        mips = []
        cur = arr
        while len(mips) < MAX_MIPS:
            offsets[i, len(mips)] = total
            mips.append(cur)
            total += cur.shape[0] * cur.shape[1]
            if cur.shape[0] == 1 and cur.shape[1] == 1:
                break
            cur = _downsample2(cur)
        num_levels[i] = len(mips)
        levels.append(mips)

    footprint = total <= FOOTPRINT_MAX_TEXELS
    chunks = []
    for mips in levels:
        for cur in mips:
            if footprint:
                fp = np.concatenate(
                    [cur, np.roll(cur, -1, axis=1), np.roll(cur, -1, axis=0),
                     np.roll(np.roll(cur, -1, axis=0), -1, axis=1)], axis=-1)
                chunks.append(fp.reshape(-1, 16))
            else:
                chunks.append(cur.reshape(-1, 4))
    return TextureAtlas(
        texels=torch.from_numpy(np.concatenate(chunks, 0)),
        offsets=torch.from_numpy(offsets.astype(np.int32)),
        widths=torch.from_numpy(widths),
        heights=torch.from_numpy(heights),
        num_levels=torch.from_numpy(num_levels),
        is_srgb=torch.from_numpy(srgb_flags),
        has_alpha=any_alpha,
        footprint=footprint,
    )


def srgb_texture_indices(material_rows: list) -> set:
    """Texture indices carrying color data (sRGB-encoded in GLTF): base
    color and emission; normal, roughness and metallic maps stay linear."""
    out = set()
    for r in material_rows:
        for key in ("base_color_texture_index", "emission_texture_index"):
            if key in r and r[key] is not None and r[key] >= 0:
                out.add(int(r[key]))
    return out
