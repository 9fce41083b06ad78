"""GLTF 2.0 scene importer — pure python/numpy, mirroring
``hiprt_pt_tpu.assets.gltf``.

Role parity with the reference's ASSIMP-based ``SceneParser``
(src/Scene/SceneParser.cpp:22-220): loads geometry pre-transformed to world
space (ASSIMP ``aiProcess_PreTransformVertices`` ≡ the node-graph
flattening here), triangulated indices, per-mesh material assignment,
material property mapping with the KHR material extensions
(SceneParser.cpp:362-407) and camera extraction with a bounding-box default
fallback (SceneParser.cpp:222-276). ``.gltf`` (with data-URI or external
buffers and images) and ``.glb`` containers.

Two differences from the JAX package, both its faults:

- A material's texture index is resolved through ``textures[i].source`` to
  its image, as the glTF spec and Assimp do; the JAX package uses the
  texture index as the image index, which is right only where
  ``source == i``.
- Images decode through ``image_io.decode_image``: PNG without any imaging
  package, other formats through imageio, and a missing decoder raises
  rather than dropping the texture. 16-bit images are scaled to [0, 1]
  floats (the JAX package hands their uint16 samples to the atlas, which
  saturates them), and gray + alpha images become RGBA.
"""

from __future__ import annotations

import base64
import json
import os
import struct
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.camera import Camera, camera_from_lookat, quat_to_matrix
from .image_io import decode_image

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT4": 16,
}


@dataclass
class ParsedScene:
    """Host-side parse result, consumed by assets.scene.build_scene; the
    camera lies on the CPU, like the arrays beside it."""

    vertices: np.ndarray
    triangles: np.ndarray
    normals: Optional[np.ndarray]
    uvs: Optional[np.ndarray]
    material_ids: np.ndarray
    material_rows: list
    camera: Optional[Camera]
    images: list = field(default_factory=list)  # (H, W, 4) uint8 or float32


def _uri_bytes(uri: str, base_dir: str) -> bytes:
    """A buffer's or image's bytes: a data URI, or a file beside the scene."""
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    with open(os.path.join(base_dir, uri), "rb") as f:
        return f.read()


def _read_buffers(doc: dict, base_dir: str, bin_chunk: Optional[bytes] = None
                  ) -> list[bytes]:
    """Every buffer's bytes; a buffer without a URI is the GLB binary chunk."""
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise ValueError("GLB binary chunk not supported in .gltf path")
            out.append(bin_chunk)
        else:
            out.append(_uri_bytes(uri, base_dir))
    return out


def _read_accessor(doc: dict, buffers: list[bytes], idx: int) -> np.ndarray:
    """(count, components) array of an accessor. An interleaved bufferView
    (byteStride past the element) is read as one strided view, not element
    by element. Normalized integers become floats in [0, 1] (or [-1, 1])."""
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    itemsize = dtype.itemsize * ncomp
    stride = view.get("byteStride") or itemsize
    raw = buffers[view.get("buffer", 0)]
    if count and offset + (count - 1) * stride + itemsize > len(raw):
        raise ValueError(f"accessor {idx} reads past the end of its buffer")
    arr = np.array(np.ndarray((count, ncomp), dtype=dtype, buffer=raw,
                              offset=offset, strides=(stride, dtype.itemsize)))
    if acc.get("normalized", False) and dtype != np.float32:
        info = np.iinfo(dtype)
        arr = arr.astype(np.float32) / float(info.max)
    return arr


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], dtype=np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m[:3, :3] *= np.asarray(node["scale"], dtype=np.float32)
    if "rotation" in node:
        m[:3, :3] = quat_to_matrix(node["rotation"]) @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = np.asarray(node["translation"], dtype=np.float32)
    return m


def _gltf_material_row(mat: dict, tex_offset_of) -> dict:
    """Map a GLTF material (+KHR extensions) onto MaterialBank fields —
    semantics follow the reference's aiMaterial mapping
    (SceneParser.cpp:362-407). ``tex_offset_of`` maps a glTF texture index
    to an image index."""
    row: dict = {}
    pbr = mat.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
    row["base_color"] = base[:3]
    row["alpha_opacity"] = base[3] if len(base) > 3 else 1.0
    row["roughness"] = pbr.get("roughnessFactor", 1.0)
    row["metallic"] = pbr.get("metallicFactor", 1.0)
    if "baseColorTexture" in pbr:
        row["base_color_texture_index"] = tex_offset_of(
            pbr["baseColorTexture"]["index"]
        )
    if "metallicRoughnessTexture" in pbr:
        row["roughness_metallic_texture_index"] = tex_offset_of(
            pbr["metallicRoughnessTexture"]["index"]
        )
    if "normalTexture" in mat:
        row["normal_map_texture_index"] = tex_offset_of(mat["normalTexture"]["index"])
    if "emissiveTexture" in mat:
        row["emission_texture_index"] = tex_offset_of(mat["emissiveTexture"]["index"])
    em = mat.get("emissiveFactor", [0.0, 0.0, 0.0])
    row["emission"] = em
    ext = mat.get("extensions", {})
    if "KHR_materials_emissive_strength" in ext:
        row["emission_strength"] = ext["KHR_materials_emissive_strength"].get(
            "emissiveStrength", 1.0
        )
    if "KHR_materials_ior" in ext:
        row["ior"] = ext["KHR_materials_ior"].get("ior", 1.5)
    if "KHR_materials_transmission" in ext:
        row["specular_transmission"] = ext["KHR_materials_transmission"].get(
            "transmissionFactor", 0.0
        )
    if "KHR_materials_volume" in ext:
        vol = ext["KHR_materials_volume"]
        row["absorption_at_distance"] = vol.get("attenuationDistance", 1.0)
        row["absorption_color"] = vol.get("attenuationColor", [1.0, 1.0, 1.0])
    if "KHR_materials_specular" in ext:
        sp = ext["KHR_materials_specular"]
        row["specular"] = sp.get("specularFactor", 1.0)
        row["specular_color"] = sp.get("specularColorFactor", [1.0, 1.0, 1.0])
    if "KHR_materials_clearcoat" in ext:
        cc = ext["KHR_materials_clearcoat"]
        row["coat"] = cc.get("clearcoatFactor", 0.0)
        row["coat_roughness"] = cc.get("clearcoatRoughnessFactor", 0.0)
    if "KHR_materials_sheen" in ext:
        sh = ext["KHR_materials_sheen"]
        row["sheen"] = 1.0
        row["sheen_color"] = sh.get("sheenColorFactor", [0.0, 0.0, 0.0])
        row["sheen_roughness"] = sh.get("sheenRoughnessFactor", 0.5)
    if "KHR_materials_dispersion" in ext:
        disp = ext["KHR_materials_dispersion"].get("dispersion", 0.0)
        if disp > 0.0:
            row["dispersion_scale"] = 1.0
            row["dispersion_abbe_number"] = 20.0 / max(disp, 1e-6)
    # GLTF alphaMode MASK/BLEND → alpha testing via opacity
    if mat.get("alphaMode", "OPAQUE") == "OPAQUE":
        row["alpha_opacity"] = 1.0
    return row


def _texture_source(doc: dict, i: int) -> int:
    """The image index of glTF texture ``i`` (``textures[i].source``)."""
    source = doc["textures"][i].get("source")
    if source is None:
        raise ValueError(f"glTF texture {i} names no image (source)")
    return int(source)


def _load_images(doc: dict, buffers: list[bytes], base_dir: str) -> list:
    """Decode every glTF image (image_io.decode_image) → (H, W, 4) arrays,
    uint8 for 8-bit images, float32 in [0, 1] for 16-bit ones. Colour-space
    decode happens at texture fetch (ops/texture.py)."""
    images = []
    for i, img in enumerate(doc.get("images", [])):
        if "uri" in img:
            name = img["uri"] if not img["uri"].startswith("data:") else f"image {i}"
            data = _uri_bytes(img["uri"], base_dir)
        elif "bufferView" in img:
            name = f"image {i} (bufferView {img['bufferView']})"
            view = doc["bufferViews"][img["bufferView"]]
            off = view.get("byteOffset", 0)
            data = buffers[view.get("buffer", 0)][off: off + view["byteLength"]]
        else:
            raise ValueError(f"glTF image {i} has neither a uri nor a bufferView")
        arr = decode_image(data, name)
        if arr.dtype == np.uint16:
            arr = arr.astype(np.float32) / 65535.0
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.shape[-1] in (1, 2):  # gray (+ alpha) → RGB(A)
            arr = np.concatenate([arr[..., :1]] * 3 + [arr[..., 1:]], axis=-1)
        if arr.shape[-1] == 3:
            one = 255 if arr.dtype == np.uint8 else 1.0
            arr = np.concatenate(
                [arr, np.full(arr.shape[:2] + (1,), one, dtype=arr.dtype)], axis=-1
            )
        images.append(arr)
    return images


def _read_glb(path: str):
    """Parse a binary .glb container → (json doc, [bin chunk]) (GLTF 2.0
    spec §4: 12-byte header + JSON/BIN chunks)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _version, length = struct.unpack_from("<4sII", data, 0)
    if magic != b"glTF":
        raise ValueError(f"{path}: not a GLB container")
    off = 12
    doc = None
    bin_chunks = []
    while off < length:
        chunk_len, chunk_type = struct.unpack_from("<I4s", data, off)
        off += 8
        payload = data[off: off + chunk_len]
        off += chunk_len
        if chunk_type == b"JSON":
            doc = json.loads(payload.decode("utf-8"))
        elif chunk_type == b"BIN\x00":
            bin_chunks.append(payload)
    if doc is None:
        raise ValueError(f"{path}: GLB missing JSON chunk")
    return doc, bin_chunks


def load_gltf(path: str, aspect_override: Optional[float] = None,
              timings: Optional[dict] = None) -> ParsedScene:
    """Parse a .gltf (JSON) or .glb (binary container) file into flattened
    world-space SoA arrays. Given ``timings``, sets its "images" to the
    seconds spent decoding the images."""
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"glTF":
        doc, bin_chunks = _read_glb(path)
        buffers = _read_buffers(doc, base_dir, bin_chunks[0] if bin_chunks else b"")
    else:
        with open(path) as f:
            doc = json.load(f)
        buffers = _read_buffers(doc, base_dir)

    material_rows = [
        _gltf_material_row(m, lambda i: _texture_source(doc, i))
        for m in doc.get("materials", [])
    ]
    if not material_rows:
        material_rows = [{}]

    all_pos, all_nrm, all_uv, all_tri, all_mid = [], [], [], [], []
    vert_base = 0
    camera = None
    cam_aspect = aspect_override or 16.0 / 9.0

    scene = doc["scenes"][doc.get("scene", 0)]

    def visit(node_idx: int, parent_m: np.ndarray):
        nonlocal vert_base, camera
        node = doc["nodes"][node_idx]
        m = parent_m @ _node_matrix(node)
        if "camera" in node:
            cam = doc["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                persp = cam["perspective"]
                aspect = aspect_override or persp.get("aspectRatio", 16.0 / 9.0)
                # decompose the world transform: rotation part + translation,
                # re-orthonormalized (scale-free cameras assumed)
                R = m[:3, :3]
                R = R / np.linalg.norm(R, axis=0, keepdims=True)
                view_inv = np.eye(4, dtype=np.float32)
                view_inv[:3, :3] = R
                view_inv[:3, 3] = m[:3, 3]
                camera = Camera.create(
                    np.linalg.inv(view_inv),
                    persp["yfov"],
                    aspect,
                    persp.get("znear", 0.1),
                    persp.get("zfar", 100.0),
                    device="cpu",
                )
        if "mesh" in node:
            mesh = doc["meshes"][node["mesh"]]
            nrm_m = np.linalg.inv(m[:3, :3]).T
            for prim in mesh["primitives"]:
                if prim.get("mode", 4) != 4:  # triangles only
                    continue
                attrs = prim["attributes"]
                pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(
                    np.float32
                )
                pos_w = pos @ m[:3, :3].T + m[:3, 3]
                nv = pos.shape[0]
                if "NORMAL" in attrs:
                    nrm = _read_accessor(doc, buffers, attrs["NORMAL"]).astype(
                        np.float32
                    )
                    nrm_w = nrm @ nrm_m.T
                    lens = np.linalg.norm(nrm_w, axis=-1, keepdims=True)
                    nrm_w = nrm_w / np.maximum(lens, 1e-12)
                else:
                    nrm_w = np.zeros_like(pos_w)
                if "TEXCOORD_0" in attrs:
                    uv = _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(
                        np.float32
                    )[:, :2]
                else:
                    uv = np.zeros((nv, 2), dtype=np.float32)
                if "indices" in prim:
                    idx = _read_accessor(doc, buffers, prim["indices"]).astype(
                        np.int64
                    )[:, 0]
                else:
                    idx = np.arange(nv, dtype=np.int64)
                tris = idx.reshape(-1, 3).astype(np.int64) + vert_base
                mid = prim.get("material", 0)
                all_pos.append(pos_w)
                all_nrm.append(nrm_w)
                all_uv.append(uv)
                all_tri.append(tris)
                all_mid.append(np.full((tris.shape[0],), mid, dtype=np.int32))
                vert_base += nv
        for child in node.get("children", []):
            visit(child, m)

    for root in scene["nodes"]:
        visit(root, np.eye(4, dtype=np.float32))

    vertices = np.concatenate(all_pos, axis=0)
    triangles = np.concatenate(all_tri, axis=0).astype(np.int32)
    normals = np.concatenate(all_nrm, axis=0)
    uvs = np.concatenate(all_uv, axis=0)
    material_ids = np.concatenate(all_mid, axis=0)

    # flip winding/normal consistency: keep as authored; zero normals → facet
    if np.all(np.abs(normals) < 1e-9):
        normals = None

    if camera is None:
        # default camera from the scene's bounding box (reference:
        # SceneParser.cpp:222-276 default camera path)
        lo, hi = vertices.min(0), vertices.max(0)
        center = 0.5 * (lo + hi)
        extent = float(np.linalg.norm(hi - lo))
        eye = center + np.array([0.0, 0.25 * extent, 1.1 * extent])
        camera = camera_from_lookat(eye, center, vfov_deg=45.0,
                                    aspect=cam_aspect, device="cpu")

    t0 = time.perf_counter()
    images = _load_images(doc, buffers, base_dir)
    if timings is not None:
        timings["images"] = time.perf_counter() - t0

    return ParsedScene(
        vertices=vertices,
        triangles=triangles,
        normals=normals,
        uvs=uvs,
        material_ids=material_ids,
        material_rows=material_rows,
        camera=camera,
        images=images,
    )
