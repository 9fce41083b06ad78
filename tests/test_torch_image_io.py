"""Image IO in the port (hiprt_pt_tpu_torch/assets/image_io.py) against
imageio and the JAX package: the numpy + zlib PNG decoder on PNGs that
Pillow writes (8 and 16 bits; gray, gray + alpha, RGB, RGBA, palettes with
and without tRNS) and on every row filter, the PNG encoder, the Radiance
RGBE writer (byte for byte the JAX package's) and reader (flat and
run-length scanlines, within one RGBE step of the values written), and
load_envmap."""

import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image
import imageio.v3 as iio

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402

from hiprt_pt_tpu_torch.assets import image_io  # noqa: E402


def _pillow_png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _row_filters(data: bytes) -> set:
    """The row filters a PNG file uses."""
    ihdr = struct.unpack(">IIBB", data[16:26])
    w, h, depth, ctype = ihdr
    idat = b"".join(p for t, p in image_io._png_chunks(data, "test") if t == b"IDAT")
    stride = (w * image_io._PNG_CHANNELS[ctype] * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, stride + 1)[:, 0].tolist())


def _smooth(h, w, channels, seed, dtype=np.uint8):
    """Smooth gradients with noise: Pillow's adaptive filter picks several
    row filters on them."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    top = np.iinfo(dtype).max
    out = [(np.sin(xx / (5.0 + c) + c) + np.cos(yy / 7.0)) * 0.25 + 0.5
           + g.normal(0, 0.03, (h, w)) for c in range(channels)]
    return (np.clip(np.stack(out, -1), 0, 1) * top).astype(dtype)


PILLOW_KINDS = ("L", "LA", "RGB", "RGBA", "I;16", "P", "P+tRNS", "P4")


@pytest.mark.parametrize("kind", PILLOW_KINDS)
def test_png_decoder_equals_imageio(kind):
    """Every sample equals imageio's; for a palette with tRNS imageio keeps
    only the colours, so its alpha is held against Pillow's RGBA
    conversion."""
    g = np.random.default_rng(3)
    if kind in ("L", "LA", "RGB", "RGBA"):
        a = _smooth(48, 61, len(kind), 1)
        img = Image.fromarray(a[..., 0] if kind == "L" else a, kind)
    elif kind == "I;16":
        img = Image.fromarray(_smooth(48, 61, 1, 2, np.uint16)[..., 0])
    else:
        colors = 10 if kind == "P4" else 200
        img = Image.fromarray(g.integers(0, colors, (37, 45), dtype=np.uint8), "P")
        img.putpalette(g.integers(0, 256, 3 * colors).astype(np.uint8).tobytes())
    kw = {}
    if kind == "P+tRNS":
        kw["transparency"] = g.integers(0, 256, 120).astype(np.uint8).tobytes()
    data = _pillow_png(img, **kw)
    got = image_io.decode_png(data)
    ref = iio.imread(data)
    if kind == "P4":
        assert data[24] == 4  # Pillow packs a 10-colour palette in 4 bits
    if kind == "P+tRNS":
        assert got.shape == ref.shape[:2] + (4,)
        np.testing.assert_array_equal(got[..., :3], ref)
        rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        np.testing.assert_array_equal(got, rgba)
        assert (got[..., 3] < 255).any()
    else:
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    if kind in ("L", "LA", "RGB", "RGBA", "I;16"):
        assert len(_row_filters(data)) >= 2


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_png_decoder_reads_every_row_filter(filt):
    """Files the port's encoder writes with one row filter (or a seeded mix
    of all five): the decoder gives back the array, and so does imageio on
    8-bit and 16-bit gray images (it reads 16-bit colour as 8 bits)."""
    g = np.random.default_rng(5)
    for arr in (g.integers(0, 256, (23, 31, 3), dtype=np.uint8),
                g.integers(0, 256, (17, 29, 4), dtype=np.uint8),
                g.integers(0, 256, (9, 40), dtype=np.uint8),
                g.integers(0, 65536, (13, 21), dtype=np.uint16),
                g.integers(0, 65536, (11, 14, 3), dtype=np.uint16),
                g.integers(0, 65536, (7, 9, 2), dtype=np.uint16)):
        filters = g.integers(0, 5, arr.shape[0]) if filt == "mixed" else filt
        data = image_io.encode_png(arr, filters)
        want = {filt} if filt != "mixed" else set(filters.tolist())
        assert _row_filters(data) == want
        got = image_io.decode_png(data)
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)
        if arr.dtype == np.uint8 or arr.ndim == 2:
            np.testing.assert_array_equal(iio.imread(data), arr)


def test_png_decoder_refuses_bad_files(monkeypatch):
    data = image_io.encode_png(np.zeros((4, 4, 3), np.uint8))
    bad = bytearray(data)
    bad[40] ^= 0xFF  # inside the IDAT payload: its CRC fails
    with pytest.raises(ValueError, match="CRC"):
        image_io.decode_png(bytes(bad), "bad.png")
    # interlaced: the IHDR's last byte (and its CRC)
    ihdr = bytearray(data[16:29])
    ihdr[-1] = 1
    laced = (data[:16] + bytes(ihdr)
             + struct.pack(">I", zlib.crc32(bytes(data[12:16]) + bytes(ihdr)))
             + data[33:])
    with pytest.raises(ValueError, match="interlaced.png: Adam7"):
        image_io.decode_png(laced, "interlaced.png")
    # a format that needs imageio names the image when imageio is missing
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    with pytest.raises(RuntimeError, match="photo.jpg"):
        image_io.decode_image(b"\xff\xd8\xff\xe0 not a png", "photo.jpg")


def test_write_png_round_trip(tmp_path):
    """write_png encodes linear RGB to sRGB bytes without imageio; the JAX
    package's write_png (through imageio) writes the same pixels."""
    from hiprt_pt_tpu.assets.image_io import write_png as jwrite

    lin = np.random.default_rng(8).uniform(0, 1.2, (19, 27, 3)).astype(np.float32)
    image_io.write_png(str(tmp_path / "port.png"), lin)
    jwrite(str(tmp_path / "jax.png"), lin)
    got = image_io.read_image(str(tmp_path / "port.png"), linearize_srgb=False)
    want = (np.clip(image_io.linear_to_srgb(lin), 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(iio.imread(tmp_path / "port.png"), want)
    np.testing.assert_array_equal(image_io.decode_png((tmp_path / "jax.png").read_bytes()),
                                  want)
    np.testing.assert_array_equal(got, want.astype(np.float32) / 255.0)
    # read_image's sRGB decode is the JAX package's
    from hiprt_pt_tpu.assets.image_io import read_image as jread

    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "jax.png")),
                                  jread(str(tmp_path / "jax.png")))


def _hdr_map(seed=4, h=12, w=20):
    """Radiance over six decades, exact zeros and a dark channel beside a
    bright one."""
    g = np.random.default_rng(seed)
    img = (10.0 ** g.uniform(-3, 3, (h, w, 3))).astype(np.float32)
    img[0, :4] = 0.0
    img[1, :4, 1] = 0.0
    return img


def _rgbe_step(img):
    """One mantissa step of each pixel's shared exponent, 2^(e - 8) for
    max channel m·2^e (frexp), as write_hdr stores it."""
    _m, e = np.frexp(img.max(-1))
    return np.where(img.max(-1) >= 1e-32, np.ldexp(1.0, e - 8), 0.0)[..., None]


def _write_rle_hdr(path, img):
    """The same RGBE texels as write_hdr, in new-style run-length scanlines
    (a run of a repeated byte when 3 or more, else literals)."""
    with open(_flat_hdr(path, img), "rb") as f:
        flat = f.read()
    h, w = img.shape[:2]
    header, texels = flat[:-h * w * 4], np.frombuffer(flat[-h * w * 4:], np.uint8)
    out = bytearray(header)
    for row in texels.reshape(h, w, 4):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            ch, x = row[:, c], 0
            while x < w:
                n = 1
                while x + n < w and n < 127 and ch[x + n] == ch[x]:
                    n += 1
                if n >= 3:
                    out += bytes([128 + n, ch[x]])
                else:
                    n = min(w - x, 128)
                    out += bytes([n]) + ch[x:x + n].tobytes()
                x += n
    with open(path, "wb") as f:
        f.write(out)


def _flat_hdr(path, img):
    flat = str(path) + ".flat.hdr"
    image_io.write_hdr(flat, img)
    return flat


def test_write_hdr_is_the_jax_packages(tmp_path):
    from hiprt_pt_tpu.assets.image_io import write_hdr as jwrite

    for seed in (4, 5):
        img = _hdr_map(seed)
        image_io.write_hdr(str(tmp_path / "port.hdr"), img)
        jwrite(str(tmp_path / "jax.hdr"), img)
        assert (tmp_path / "port.hdr").read_bytes() == (tmp_path / "jax.hdr").read_bytes()


@pytest.mark.parametrize("layout", ["flat", "rle"])
def test_read_hdr_within_one_rgbe_step(tmp_path, layout):
    img = _hdr_map(h=9, w=40)
    img[3, :25] = img[3, 0]  # runs for the run-length layout
    path = str(tmp_path / "map.hdr")
    if layout == "flat":
        image_io.write_hdr(path, img)
    else:
        _write_rle_hdr(path, img)
        # the same texels as the flat file, in runs
        np.testing.assert_array_equal(image_io.read_hdr(path),
                                      image_io.read_hdr(path + ".flat.hdr"))
    got = image_io.read_hdr(path)
    assert got.shape == img.shape and got.dtype == np.float32
    err = np.abs(got.astype(np.float64) - img)
    assert (err <= _rgbe_step(img)).all(), float((err / np.maximum(_rgbe_step(img), 1e-30)).max())
    assert (got[0, :4] == 0.0).all() and got.max() > 100.0
    np.testing.assert_array_equal(image_io.read_image(path), got)


@pytest.mark.xfail(strict=True, reason=(
    "known fault in the reference (ROADMAP §3): the JAX package's read_hdr "
    "reads through imageio, which returns the RGBE file as clipped 8-bit "
    "values, so every radiance above 1 comes back as 1"))
def test_jax_read_hdr_within_one_rgbe_step(tmp_path):
    from hiprt_pt_tpu.assets.image_io import read_hdr as jread

    img = _hdr_map()
    path = str(tmp_path / "map.hdr")
    image_io.write_hdr(path, img)
    got = jread(path)
    assert (np.abs(got - img) <= _rgbe_step(img)).all()


def test_load_envmap_builds_the_tables_of_the_map(tmp_path):
    """load_envmap reads the file through read_hdr and builds the JAX
    package's tables of those texels."""
    from hiprt_pt_tpu.assets.envmap import build_envmap as jbuild
    from hiprt_pt_tpu_torch.assets.envmap import (build_envmap, load_envmap,
                                                  make_test_envmap)

    img = make_test_envmap(32, 64, "sky")
    path = str(tmp_path / "sky.hdr")
    image_io.write_hdr(path, img)
    env = load_envmap(path, device="cpu")
    texels = env.texels.numpy()
    assert (np.abs(texels - img) <= _rgbe_step(img)).all()
    assert texels.max() > 30.0  # the sun disk keeps its radiance
    ref = build_envmap(image_io.read_hdr(path), device="cpu")
    jref = tp.to_numpy_dict(jbuild(texels))
    for k in ("texels", "cdf", "alias_probas", "alias_indices"):
        assert torch.equal(getattr(env, k), getattr(ref, k)), k
        np.testing.assert_array_equal(getattr(env, k).numpy(), jref[k], err_msg=k)
    assert env.total_luminance == float(jref["total_luminance"])
