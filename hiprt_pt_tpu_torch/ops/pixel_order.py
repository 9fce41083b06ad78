"""Internal pixel ordering — tile-major layout, mirroring
``hiprt_pt_tpu.ops.pixel_order``.

The image is split into 16x8 = 128-pixel tiles whose pixels are consecutive
in every flat buffer. RNG seeds and all state buffers are indexed in this
order, and a 128-ray packet of the coherent traversal kernel is exactly one
screen tile. Images are unscrambled to row-major only at readout.
"""

from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass(frozen=True)
class PixelRange:
    """The pixels [start, stop) of the canonical order of a width x height
    image that one render step holds: the whole image by default
    (``whole``). A render step decides a few things over every pixel of
    the image: whether any path is still alive, whether any shadow ray is
    still marching, the counters, the neighbour rows ReSTIR reads, the
    frame-constant bits it draws from pixel 0's stream. These methods are
    those decisions; on the whole image they are the identity.
    parallel/mesh.py's ``Shard`` is a range held by one rank of a process
    group, whose methods are the group's collectives."""

    width: int
    height: int
    start: int
    stop: int

    @classmethod
    def whole(cls, width: int, height: int) -> "PixelRange":
        return cls(width, height, 0, width * height)

    @classmethod
    def batch(cls, n: int) -> "PixelRange":
        """A whole wavefront of ``n`` rays, as an n x 1 image: the range of
        a step that reads only its size and its decisions."""
        return cls.whole(n, 1)

    @property
    def num_pixels(self) -> int:
        """Pixels of the whole image."""
        return self.width * self.height

    @property
    def size(self) -> int:
        """Pixels of this range."""
        return self.stop - self.start

    def index(self, device) -> torch.Tensor:
        """(size,) int64: the canonical index of each pixel of the range."""
        return torch.arange(self.start, self.stop, dtype=torch.int64,
                            device=device)

    def coords(self, device):
        """px, py (int32) of the range's pixels (pixel_coords' slice)."""
        px, py = pixel_coords(self.width, self.height, device)
        return px[self.start:self.stop], py[self.start:self.stop]

    def any(self, flag: torch.Tensor) -> bool:
        """Whether ``flag`` holds anywhere in the image (a host sync)."""
        return bool(flag.any())

    def count(self, flag: torch.Tensor) -> int:
        """The number of pixels of the image where ``flag`` holds (a host
        sync)."""
        return int(flag.sum())

    def sum(self, count: torch.Tensor) -> torch.Tensor:
        """A count over the image from the range's own count."""
        return count

    def gather_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """(num_pixels, ...) of every pixel's rows, from the range's."""
        return rows

    def from_first(self, x: torch.Tensor) -> torch.Tensor:
        """The value that the range holding pixel 0 has."""
        return x
