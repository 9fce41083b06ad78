"""What trace_coherent's warp packets lean on: in the canonical (tile-major)
pixel order, of the port and of the JAX package alike, every aligned run of
32 consecutive indices is a 16x2 strip of one 16x8 screen tile."""

import numpy as np
import pytest

from hiprt_pt_tpu.ops import pixel_order as jax_order
from hiprt_pt_tpu_torch.ops import pixel_order as port_order

WARP = 32


def _coords(package, width, height):
    px, py = package.pixel_coords(width, height)
    return np.asarray(px), np.asarray(py)


@pytest.mark.parametrize("package", [port_order, jax_order],
                         ids=["port", "jax"])
@pytest.mark.parametrize("width,height", [(16, 8), (64, 32), (48, 24),
                                          (256, 128), (1920, 1080)])
def test_a_warp_of_rays_is_a_16x2_strip_of_one_tile(package, width, height):
    assert package.is_tileable(width, height)
    px, py = _coords(package, width, height)
    assert len(px) == width * height and len(px) % WARP == 0
    px, py = px.reshape(-1, WARP), py.reshape(-1, WARP)
    x0, y0 = px[:, :1], py[:, :1]
    # 16 columns from a tile's left edge, two rows from an even row of it
    assert np.all(x0 % package.TILE_W == 0) and np.all(y0 % 2 == 0)
    lane = np.arange(WARP)
    assert np.array_equal(px, x0 + lane % package.TILE_W)
    assert np.array_equal(py, y0 + lane // package.TILE_W)
    # the four strips of a 128-ray run stack into one tile
    tile = (py // package.TILE_H) * (width // package.TILE_W) + px // package.TILE_W
    assert np.array_equal(tile, np.repeat(np.arange(len(tile) // 4), 4)[:, None]
                          + np.zeros((1, WARP), int))
    # every pixel once
    assert len(np.unique(py.ravel() * width + px.ravel())) == width * height


def test_the_two_packages_order_pixels_alike():
    for width, height in ((64, 32), (1920, 1080), (50, 30)):
        for a, b in zip(_coords(port_order, width, height),
                        _coords(jax_order, width, height)):
            assert np.array_equal(a, b)
