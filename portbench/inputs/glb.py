"""The binary glTF writer of the benchmark's inputs, frozen from the
port's test-content writer, numpy only: a ``ParsedScene`` (inputs/stress.py)
written as a .glb, so that the program and the reference load one file:

- one mesh of one primitive per run of consecutive triangles with the same
  material, each with its own vertices (the run's, in their order), so the
  importer's flattening gives back the triangle order and, where no vertex
  is shared across runs, the vertex order; POSITION, NORMAL (where the
  scene has normals), TEXCOORD_0 (where it has uvs) and uint32 indices, in
  tightly packed bufferViews of one buffer;
- every material row as glTF PBR (base colour and alpha, metallic,
  roughness, the base-colour, metallic-roughness, normal and emissive
  textures, emission) plus the KHR extensions the importer maps
  (emissive_strength, ior, transmission, volume, specular, clearcoat,
  sheen, dispersion); fields glTF has no place for (separate roughness
  maps, anisotropy, thin film, ...) are not written;
- every image as a PNG (encode_png, Up filter), texture
  i naming image i;
- the camera as a perspective camera node with translation and rotation.

The materials named in ``alpha_materials`` get ``alphaMode: "MASK"`` and a
base-colour texture of their own (a copy of theirs, or white) whose alpha
is a cutout: square holes over half the texture. A row whose alpha_opacity
is below 1 gets ``"BLEND"``.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

# the material fields and their defaults, as the importer fills a row
_SCALAR_FIELDS = [
    ("emission_strength", 1.0),
    ("roughness", 0.3),
    ("oren_nayar_sigma", 0.34906585),
    ("metallic", 0.0),
    ("metallic_F90_falloff_exponent", 5.0),
    ("anisotropy", 0.0),
    ("anisotropy_rotation", 0.0),
    ("second_roughness_weight", 0.0),
    ("second_roughness", 0.5),
    ("specular", 1.0),
    ("specular_tint", 1.0),
    ("specular_darkening", 0.0),
    ("coat", 0.0),
    ("coat_medium_thickness", 5.0),
    ("coat_roughness", 0.0),
    ("coat_roughening", 1.0),
    ("coat_darkening", 1.0),
    ("coat_anisotropy", 0.0),
    ("coat_anisotropy_rotation", 0.0),
    ("coat_ior", 1.5),
    ("sheen", 0.0),
    ("sheen_roughness", 0.5),
    ("ior", 1.4),
    ("specular_transmission", 0.0),
    ("absorption_at_distance", 1.0),
    ("dispersion_scale", 0.0),
    ("dispersion_abbe_number", 20.0),
    ("thin_walled", 0.0),
    ("thin_film", 0.0),
    ("thin_film_ior", 1.3),
    ("thin_film_thickness", 500.0),
    ("thin_film_kappa_3", 0.0),
    ("thin_film_hue_shift_degrees", 0.0),
    ("thin_film_base_ior_override", 1.0),
    ("thin_film_do_ior_override", 0.0),
    ("alpha_opacity", 1.0),
    ("dielectric_priority", 0.0),
]

_COLOR_FIELDS = [
    ("base_color", (1.0, 1.0, 1.0)),
    ("emission", (0.0, 0.0, 0.0)),
    ("metallic_F82", (1.0, 1.0, 1.0)),
    ("metallic_F90", (1.0, 1.0, 1.0)),
    ("specular_color", (1.0, 1.0, 1.0)),
    ("coat_medium_absorption", (1.0, 1.0, 1.0)),
    ("sheen_color", (1.0, 1.0, 1.0)),
    ("absorption_color", (1.0, 1.0, 1.0)),
]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth(a, b, c):
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


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

# square holes of CUTOUT_CELL texels in a checker over the texture
CUTOUT_CELL = 8
# the base-colour texture of an alpha material that has none
_WHITE_SIZE = 64


def _quaternion(r: np.ndarray) -> list:
    """Rotation matrix (3, 3) → unit quaternion [x, y, z, w]."""
    r = np.asarray(r, np.float64)
    t = np.trace(r)
    if t > 0.0:
        s = 2.0 * np.sqrt(t + 1.0)
        q = [(r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s, 0.25 * s]
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + r[i, i] - r[j, j] - r[k, k])
        q = [0.0] * 4
        q[i] = 0.25 * s
        q[j] = (r[j, i] + r[i, j]) / s
        q[k] = (r[k, i] + r[i, k]) / s
        q[3] = (r[k, j] - r[j, k]) / s
    q = np.asarray(q) / np.linalg.norm(q)
    return [float(x) for x in q]


def cutout(img: np.ndarray) -> np.ndarray:
    """A copy of an (H, W, 4) uint8 image with alpha 0 in every other
    CUTOUT_CELL-square cell of a checker, 255 elsewhere."""
    out = np.array(img, np.uint8)
    yy, xx = np.mgrid[0:out.shape[0], 0:out.shape[1]]
    holes = ((yy // CUTOUT_CELL + xx // CUTOUT_CELL) % 2) == 1
    out[..., 3] = np.where(holes, 0, 255)
    return out


def _rgba_u8(img: np.ndarray) -> np.ndarray:
    """An (H, W, 3 or 4) uint8 or [0, 1] float image as RGBA uint8."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img.astype(np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
    return img


def _material(row: dict, alpha: bool) -> dict:
    """A material row as a glTF material (the MaterialBank default where the
    row has no value)."""
    dflt = dict(_SCALAR_FIELDS) | dict(_COLOR_FIELDS)

    def get(k):
        v = row.get(k, dflt.get(k))
        return [float(x) for x in v] if isinstance(v, (list, tuple, np.ndarray)) \
            else float(v)

    opacity = get("alpha_opacity")
    pbr = {"baseColorFactor": get("base_color") + [opacity],
           "metallicFactor": get("metallic"), "roughnessFactor": get("roughness")}
    mat = {"pbrMetallicRoughness": pbr, "emissiveFactor": get("emission")}
    for key, where, name in (
            ("base_color_texture_index", pbr, "baseColorTexture"),
            ("roughness_metallic_texture_index", pbr, "metallicRoughnessTexture"),
            ("normal_map_texture_index", mat, "normalTexture"),
            ("emission_texture_index", mat, "emissiveTexture")):
        if row.get(key, -1) is not None and row.get(key, -1) >= 0:
            where[name] = {"index": int(row[key])}
    ext = {"KHR_materials_emissive_strength":
           {"emissiveStrength": get("emission_strength")},
           "KHR_materials_ior": {"ior": get("ior")}}
    if get("specular_transmission") > 0.0:
        ext["KHR_materials_transmission"] = {
            "transmissionFactor": get("specular_transmission")}
        ext["KHR_materials_volume"] = {
            "attenuationDistance": get("absorption_at_distance"),
            "attenuationColor": get("absorption_color")}
    ext["KHR_materials_specular"] = {"specularFactor": get("specular"),
                                     "specularColorFactor": get("specular_color")}
    if get("coat") > 0.0:
        ext["KHR_materials_clearcoat"] = {
            "clearcoatFactor": get("coat"),
            "clearcoatRoughnessFactor": get("coat_roughness")}
    if get("sheen") > 0.0:
        ext["KHR_materials_sheen"] = {
            "sheenColorFactor": get("sheen_color"),
            "sheenRoughnessFactor": get("sheen_roughness")}
    if get("dispersion_scale") > 0.0:
        ext["KHR_materials_dispersion"] = {
            "dispersion": 20.0 / get("dispersion_abbe_number")}
    mat["extensions"] = ext
    if alpha:
        mat["alphaMode"] = "MASK"
    elif opacity < 1.0:
        mat["alphaMode"] = "BLEND"
    return mat


def gltf_document(parsed, camera=None, alpha_materials=()):
    """(glTF JSON document, its one buffer's bytes, the PNG bytes of every
    image) of ``parsed``; each image also lies in the buffer, in the
    bufferView the document's image names. ``camera``: an inputs/stress.py
    LookAtCamera (default: ``parsed.camera``; none: no camera node)."""
    rows = [dict(r) for r in parsed.material_rows] or [{}]
    images = [_rgba_u8(im) for im in parsed.images]
    for m in sorted(set(alpha_materials)):
        src = rows[m].get("base_color_texture_index", -1)
        base = (images[src] if src is not None and src >= 0
                else np.full((_WHITE_SIZE, _WHITE_SIZE, 4), 255, np.uint8))
        rows[m]["base_color_texture_index"] = len(images)
        images.append(cutout(base))

    chunks, views, accessors = [], [], []
    size = 0

    def view(data: bytes, target=None) -> int:
        nonlocal size
        v = {"buffer": 0, "byteOffset": size, "byteLength": len(data)}
        if target is not None:
            v["target"] = target
        pad = (-len(data)) % 4
        chunks.append(data + b"\x00" * pad)
        size += len(data) + pad
        views.append(v)
        return len(views) - 1

    def accessor(arr: np.ndarray, kind: str, ctype: int, target: int,
                 bounds: bool = False) -> int:
        acc = {"bufferView": view(np.ascontiguousarray(arr).tobytes(), target),
               "componentType": ctype, "count": int(arr.shape[0]), "type": kind}
        if bounds:
            acc["min"] = [float(x) for x in arr.min(0)]
            acc["max"] = [float(x) for x in arr.max(0)]
        accessors.append(acc)
        return len(accessors) - 1

    verts = np.asarray(parsed.vertices, np.float32)
    tris = np.asarray(parsed.triangles, np.int64)
    mids = np.asarray(parsed.material_ids, np.int64)
    starts = np.flatnonzero(np.r_[True, mids[1:] != mids[:-1]])
    ends = np.r_[starts[1:], len(mids)]
    prims = []
    for a, b in zip(starts, ends):
        used, local = np.unique(tris[a:b], return_inverse=True)
        attrs = {"POSITION": accessor(verts[used], "VEC3", 5126, 34962, True)}
        if parsed.normals is not None:
            attrs["NORMAL"] = accessor(
                np.asarray(parsed.normals, np.float32)[used], "VEC3", 5126, 34962)
        if parsed.uvs is not None:
            attrs["TEXCOORD_0"] = accessor(
                np.asarray(parsed.uvs, np.float32)[used], "VEC2", 5126, 34962)
        idx = local.reshape(-1).astype(np.uint32)[:, None]
        prims.append({"attributes": attrs, "material": int(mids[a]), "mode": 4,
                      "indices": accessor(idx, "SCALAR", 5125, 34963)})

    pngs = [encode_png(im) for im in images]
    materials = [_material(r, i in alpha_materials) for i, r in enumerate(rows)]
    doc = {
        "asset": {"version": "2.0", "generator": "hiprt_pt_tpu_torch test content"},
        "extensionsUsed": sorted({k for m in materials for k in m["extensions"]}),
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": prims}],
        "materials": materials,
        "images": [{"bufferView": view(p), "mimeType": "image/png"} for p in pngs],
        "textures": [{"source": i} for i in range(len(pngs))],
    }
    camera = parsed.camera if camera is None else camera
    if camera is not None:
        vi = camera.view_inv.astype(np.float64)
        proj = camera.proj
        doc["nodes"].append({"camera": 0,
                             "translation": [float(x) for x in vi[:3, 3]],
                             "rotation": _quaternion(vi[:3, :3])})
        doc["scenes"][0]["nodes"].append(1)
        doc["cameras"] = [{"type": "perspective", "perspective": {
            "yfov": float(camera.vfov),
            "aspectRatio": float(proj[1, 1] / proj[0, 0]),
            "znear": float(camera.near), "zfar": float(camera.far)}}]
    if not doc["images"]:
        for k in ("images", "textures"):
            del doc[k]
    doc["bufferViews"] = views
    doc["accessors"] = accessors
    blob = b"".join(chunks)
    doc["buffers"] = [{"byteLength": len(blob)}]
    return doc, blob, pngs


def write_glb(path: str, parsed, camera=None, alpha_materials=()) -> None:
    """Write ``parsed`` as a binary glTF (.glb): the JSON chunk, then the
    buffer as the BIN chunk (gltf_document)."""
    doc, blob, _pngs = gltf_document(parsed, camera, alpha_materials)
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sII", b"glTF", 2, total))
        f.write(struct.pack("<I4s", len(js), b"JSON") + js)
        f.write(struct.pack("<I4s", len(blob), b"BIN\x00") + blob)
