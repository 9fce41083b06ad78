"""Internal pixel ordering — tile-major layout, mirroring
``hiprt_pt_tpu.ops.pixel_order``.

The image is split into 16x8 = 128-pixel tiles whose pixels are consecutive
in every flat buffer. RNG seeds and all state buffers are indexed in this
order, and a 128-ray packet of the coherent traversal kernel is exactly one
screen tile. Images are unscrambled to row-major only at readout.
"""

from __future__ import annotations

import numpy as np
import torch

TILE_W = 16
TILE_H = 8


def is_tileable(width: int, height: int) -> bool:
    return width % TILE_W == 0 and height % TILE_H == 0


def pixel_coords(width: int, height: int, device="cpu"):
    """px, py (int32, length W*H) for the canonical flat order. Tile-major
    when the resolution allows it, row-major otherwise."""
    n = width * height
    idx = torch.arange(n, dtype=torch.int32, device=device)
    if not is_tileable(width, height):
        return idx % width, idx // width
    tiles_x = width // TILE_W
    tile_id = idx // (TILE_W * TILE_H)
    within = idx % (TILE_W * TILE_H)
    tx = tile_id % tiles_x
    ty = tile_id // tiles_x
    px = tx * TILE_W + (within % TILE_W)
    py = ty * TILE_H + (within // TILE_W)
    return px, py


def linear_index(width: int, height: int) -> np.ndarray:
    """(W*H,) canonical-order position i → row-major pixel index."""
    px, py = pixel_coords(width, height)
    return (py * width + px).numpy()


def unscramble(flat: np.ndarray, width: int, height: int) -> np.ndarray:
    """Canonical-order flat array (N, ...) → row-major (H, W, ...)."""
    flat = np.asarray(flat)
    if not is_tileable(width, height):
        return flat.reshape(height, width, *flat.shape[1:])
    out = np.empty_like(flat)
    out[linear_index(width, height)] = flat
    return out.reshape(height, width, *flat.shape[1:])
