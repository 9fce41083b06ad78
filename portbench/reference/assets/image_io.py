"""Image IO — PNG and Radiance HDR read and write, and colour-space helpers,
mirroring ``hiprt_pt_tpu.assets.image_io`` (reference: Image8Bit /
Image32Bit, src/Image/Image.h:23-148: stbi readers, PNG/HDR writers, sRGB
conversions).

PNG and Radiance RGBE are decoded and encoded here, with numpy and the
standard library's zlib, so that scene textures and HDR environment maps
load where no imaging package is installed. The JAX package reads every
image through imageio, which is not always installed; where it is, it
returns the 8-bit mantissas of an RGBE file as clipped bytes, so HDR values
above 1 come back as 1. Every other format (JPEG, EXR, ...) goes through a
lazy imageio import, and without imageio it raises, naming the image.

- PNG decode: bit depths 1, 2, 4 (palette and gray), 8 and 16; colour types
  0 (gray), 2 (RGB), 3 (palette, with ``tRNS`` alpha: RGBA), 4 (gray +
  alpha) and 6 (RGBA); all five row filters; every chunk's CRC checked.
  Adam7-interlaced files raise. Returns the PNG's own samples: (H, W) for
  gray, else (H, W, C), uint8, or uint16 at 16 bits.
- RGBE decode: the flat layout ``write_hdr`` writes and the new-style
  run-length scanlines, ``-Y H +X W`` orientation only. A texel decodes to
  ``(m + 0.5) · 2^(e − 136)`` (Radiance's own ``colr_color``; 0 where
  e = 0): the midpoint of the truncating encoder's step, so every channel
  is within one step ``2^(e − 136)`` of the value written.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each PNG colour type
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_RGBE_MAGIC = (b"#?RADIANCE", b"#?RGBE")


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, dtype=np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.clip(np.asarray(c, dtype=np.float32), 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * (c ** (1.0 / 2.4)) - 0.055)


# ------------------------------------------------------------------- PNG


def _png_chunks(data: bytes, name: str):
    """(type, payload) of every chunk, each CRC checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    off = 8
    while off + 12 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, off)
        payload = data[off + 8:off + 8 + length]
        if len(payload) != length:
            raise ValueError(f"{name}: PNG chunk {ctype!r} is truncated")
        (crc,) = struct.unpack_from(">I", data, off + 8 + length)
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"{name}: PNG chunk {ctype!r} fails its CRC")
        yield ctype, payload
        off += 12 + length
        if ctype == b"IEND":
            return
    raise ValueError(f"{name}: PNG file ends before its IEND chunk")


def _paeth(a, b, c):
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(ftype: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters. ``rows`` (H, S) filtered bytes, ``ftype``
    (H,) the filter of each row, ``bpp`` bytes a pixel (at least 1).

    Without Average or Paeth rows a row is one vector operation: None a
    copy, Sub a cumulative sum over the row's pixels modulo 256, Up a row
    add. Average and Paeth read the pixel to the left once it is decoded,
    and the row above; so with them the image is decoded along its
    anti-diagonals of pixels, each diagonal one vector step that reads the
    two diagonals before it (H + W - 1 steps, every row in its own
    filter)."""
    h, s = rows.shape
    p = s // bpp
    if np.any(ftype > 4):
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    if not np.any(ftype >= 3):
        out = np.empty((h, s), np.uint8)
        prev = np.zeros((s,), np.uint8)
        for y in range(h):
            r = rows[y]
            if ftype[y] == 1:
                r = np.cumsum(r.reshape(p, bpp), axis=0, dtype=np.uint8).reshape(s)
            elif ftype[y] == 2:
                r = r + prev
            out[y] = r
            prev = out[y]
        return out
    # padded pixels: pixel (y, x) at (y + 1, x + 1), zeros above and left
    pad = np.zeros((h + 1, p + 1, bpp), np.int16)
    flat = pad.reshape(-1, bpp)
    raw = rows.reshape(h, p, bpp).astype(np.int16)
    for d in range(h + p - 1):
        ys = np.arange(max(0, d - p + 1), min(h, d + 1))
        xs = d - ys
        at = (ys + 1) * (p + 1) + xs + 1
        a, b, c = flat[at - 1], flat[at - p - 1], flat[at - p - 2]
        f = ftype[ys][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        flat[at] = (raw[ys, xs] + pred) & 255
    return pad[1:, 1:].reshape(h, s).astype(np.uint8)


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """A PNG file's bytes → its samples (see the module docstring)."""
    header, palette, trns, idat = None, None, None, []
    for ctype, payload in _png_chunks(data, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(payload, np.uint8)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise ValueError(f"{name}: PNG file without IHDR or IDAT")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if interlace:
        raise ValueError(f"{name}: Adam7-interlaced PNG files are not supported")
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16) or (
            depth < 8 and ctype not in (0, 3)) or (depth == 16 and ctype == 3):
        raise ValueError(f"{name}: unsupported PNG colour type {ctype} at "
                         f"bit depth {depth}")
    ch = _PNG_CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{name}: PNG image data is truncated")
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    img = _unfilter(raw[:, 0], raw[:, 1:], max(1, ch * depth // 8))
    if depth == 16:
        img = img.reshape(h, w * ch, 2).astype(np.uint16)
        img = (img[..., 0] << 8) | img[..., 1]
    elif depth < 8:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        img = ((img[..., None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
        if ctype == 0:  # scale to 8 bits by repeating the sample's bits
            img = img * (255 // ((1 << depth) - 1))
    img = img.reshape(h, w, ch).astype(np.uint16 if depth == 16 else np.uint8)
    if ctype == 3:
        if palette is None or int(img.max(initial=0)) >= len(palette):
            raise ValueError(f"{name}: PNG palette index outside its PLTE")
        if trns is not None:
            alpha = np.full((len(palette), 1), 255, np.uint8)
            alpha[:len(trns), 0] = trns[:len(palette)]
            palette = np.concatenate([palette, alpha], axis=1)
        return palette[img[..., 0]]
    return img[..., 0] if ch == 1 else img


def encode_png(img: np.ndarray, filters=2) -> bytes:
    """(H, W) or (H, W, 1-4) uint8 or uint16 samples → PNG bytes (colour
    type 0, 4, 2 or 6 by the channel count). ``filters``: the row filter
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), one for every row or a
    sequence of one per row."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if img.dtype not in (np.uint8, np.uint16) or not 1 <= ch <= 4:
        raise ValueError(f"encode_png takes (H, W, 1-4) uint8 or uint16, got "
                         f"{img.dtype} {img.shape}")
    depth = 8 * img.dtype.itemsize
    bpp = ch * img.dtype.itemsize
    x = img.astype(">u2").view(np.uint8) if depth == 16 else img
    x = x.reshape(h, w * bpp).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    f = np.broadcast_to(np.asarray(filters, np.uint8), (h,))[:, None]
    pred = np.select([f == 1, f == 2, f == 3, f == 4],
                     [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
    rows = np.concatenate([f, ((x - pred) & 255).astype(np.uint8)], axis=1)

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload)))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


# ------------------------------------------------------------------ RGBE


def decode_rgbe(data: bytes, name: str = "<hdr>") -> np.ndarray:
    """A Radiance .hdr file's bytes → (H, W, 3) float32 linear radiance."""
    if not data.startswith(_RGBE_MAGIC):
        raise ValueError(f"{name}: not a Radiance .hdr file")
    off = 0
    while True:  # header lines, up to the empty line
        end = data.find(b"\n", off)
        if end < 0:
            raise ValueError(f"{name}: .hdr header without its end")
        line, off = data[off:end].strip(), end + 1
        if line.startswith(b"FORMAT=") and line != b"FORMAT=32-bit_rle_rgbe":
            raise ValueError(f"{name}: .hdr format {line[7:]!r} is not RGBE")
        if not line:
            break
    end = data.find(b"\n", off)
    res = data[off:end].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{name}: .hdr orientation {data[off:end]!r}; only "
                         "'-Y H +X W' is supported")
    h, w = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8)
    pos = end + 1
    rgbe = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        head = buf[pos:pos + 4]
        if 8 <= w < 32768 and len(head) == 4 and head[0] == 2 and head[1] == 2 \
                and (int(head[2]) << 8 | int(head[3])) == w:
            pos += 4
            for c in range(4):  # one channel after the other, in runs
                x = 0
                while x < w:
                    if pos >= len(buf):
                        raise ValueError(f"{name}: .hdr scanline {y} is truncated")
                    n = int(buf[pos])
                    if n > 128:
                        n -= 128
                        if x + n > w:
                            raise ValueError(f"{name}: .hdr run overruns scanline {y}")
                        rgbe[y, x:x + n, c] = buf[pos + 1]
                        pos += 2
                    else:
                        if n == 0 or x + n > w:
                            raise ValueError(f"{name}: bad .hdr run in scanline {y}")
                        rgbe[y, x:x + n, c] = buf[pos + 1:pos + 1 + n]
                        pos += 1 + n
                    x += n
        else:
            flat = buf[pos:pos + 4 * w]
            if len(flat) != 4 * w:
                raise ValueError(f"{name}: .hdr scanline {y} is truncated")
            rgbe[y] = flat.reshape(w, 4)
            pos += 4 * w
    e = rgbe[..., 3:4].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), 0.0)
    return ((rgbe[..., :3].astype(np.float32) + 0.5) * scale).astype(np.float32)


# ----------------------------------------------------------- files


def _imageio_read(data, name: str) -> np.ndarray:
    """Decode an image that is neither PNG nor RGBE through imageio."""
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise RuntimeError(
            f"{name}: only PNG and Radiance .hdr images decode without "
            "imageio, which is not installed") from e
    return iio.imread(data)


def decode_image(data: bytes, name: str = "<image>") -> np.ndarray:
    """An image file's bytes → its samples: PNG and Radiance RGBE here,
    anything else through imageio."""
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data, name)
    if data.startswith(_RGBE_MAGIC):
        return decode_rgbe(data, name)
    return _imageio_read(data, name)


def read_image(path: str, linearize_srgb: bool = True) -> np.ndarray:
    """Read an image → (H, W, C) float32. LDR images are scaled to [0, 1]
    and optionally sRGB-decoded (colour channels only for RGBA); HDR
    formats pass through linear."""
    with open(path, "rb") as f:
        arr = decode_image(f.read(), path)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
        if linearize_srgb:
            if arr.ndim == 3 and arr.shape[-1] == 4:
                arr = np.concatenate(
                    [srgb_to_linear(arr[..., :3]), arr[..., 3:]], axis=-1
                )
            else:
                arr = srgb_to_linear(arr)
    elif arr.dtype == np.uint16:
        arr = arr.astype(np.float32) / 65535.0
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def read_hdr(path: str) -> np.ndarray:
    """Radiance .hdr (RGBE) → (H, W, 3) float32 linear."""
    with open(path, "rb") as f:
        return decode_rgbe(f.read(), path)


def write_png(path: str, linear_rgb: np.ndarray, gamma_encode: bool = True):
    """(H, W, 3) linear float → 8-bit PNG (reference: Image8Bit::write_image_png)."""
    img = np.asarray(linear_rgb, dtype=np.float32)
    if gamma_encode:
        img = linear_to_srgb(img)
    img8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img8))


def write_hdr(path: str, linear_rgb: np.ndarray):
    """(H, W, 3) float32 → Radiance .hdr RGBE (flat format, no RLE — every
    reader accepts it); the JAX package's encoder, byte for byte.
    reference: Image32Bit::write_image_hdr."""
    img = np.asarray(linear_rgb, dtype=np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    valid = maxc >= 1e-32
    m, exp = np.frexp(np.maximum(maxc, 1e-32))
    scale = np.where(valid, m * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    rgbe[..., 0] = np.clip(img[..., 0] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 1] = np.clip(img[..., 1] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 2] = np.clip(img[..., 2] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    header = f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n".encode()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rgbe.tobytes())


def write_exr(path: str, linear_rgb: np.ndarray):  # pragma: no cover
    """EXR write through imageio where it has an EXR plugin; otherwise a
    .hdr next to the requested path (tinyexr has no pip analog)."""
    try:
        import imageio.v3 as iio

        iio.imwrite(path, np.asarray(linear_rgb, dtype=np.float32))
    except (ImportError, OSError, ValueError, RuntimeError):
        write_hdr(os.path.splitext(path)[0] + ".hdr", linear_rgb)


def luminance(rgb: np.ndarray) -> np.ndarray:
    """Rec.709 luminance (reference: ColorRGB32F::luminance)."""
    rgb = np.asarray(rgb)
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
