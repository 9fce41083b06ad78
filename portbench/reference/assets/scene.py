"""Scene data model — flat world-space arrays, mirroring
``hiprt_pt_tpu.assets.scene`` (reference: HIPRTScene.h:94-122).

``build_scene`` packs the per-triangle hit attributes (``tri_data``) and the
emissive-triangle sampling tables in numpy with the JAX package's numbers,
then moves them to ``device``. Textures come as a ``TextureAtlas``
(assets/textures.py), an environment map as an ``EnvmapData``
(assets/envmap.py:build_envmap).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device


TEXTURE_KIND_FIELDS = {
    "base": "base_color_texture_index",
    "mr": "roughness_metallic_texture_index",
    "em": "emission_texture_index",
    "normal": "normal_map_texture_index",
    "rough": "roughness_texture_index",
    "metal": "metallic_texture_index",
    "spec": "specular_texture_index",
    "coat": "coat_texture_index",
    "sheen": "sheen_texture_index",
    "trans": "specular_transmission_texture_index",
}


def _tensors_to(obj, device) -> dict:
    """Each tensor field of the dataclass ``obj``, moved to ``device``."""
    return {f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)}


@dataclasses.dataclass
class TextureAtlas:
    """Material textures at their own resolutions in one flat uint8 buffer,
    with per-texture offset and size tables and a box-filtered mip chain
    (the JAX package's ``TextureAtlas``, same layout and numbers)."""

    # (TOTAL, 16) u8: per texel its wrap-addressed 2x2 bilinear footprint
    # [(y,x),(y,x+1),(y+1,x),(y+1,x+1)] RGBA — or (TOTAL, 4) plain texels
    # when ``footprint`` is False (atlases above FOOTPRINT_MAX_TEXELS)
    texels: torch.Tensor
    offsets: torch.Tensor     # (L, MAX_MIPS) i32 — first texel per level, -1 pad
    widths: torch.Tensor      # (L,) i32 — level-0 width
    heights: torch.Tensor     # (L,) i32
    num_levels: torch.Tensor  # (L,) i32
    is_srgb: torch.Tensor     # (L,) bool — decoded at fetch
    has_alpha: bool = True    # does any texel have alpha < 1
    # the texture kinds (TEXTURE_KIND_FIELDS) some material references, and
    # those whose referenced layers are sRGB somewhere / everywhere (set by
    # build_scene); a kind no material references is never fetched
    kinds_used: tuple = tuple(TEXTURE_KIND_FIELDS)
    kinds_srgb_any: tuple = tuple(TEXTURE_KIND_FIELDS)
    kinds_srgb_all: tuple = ()
    footprint: bool = True

    @property
    def num_layers(self) -> int:
        return self.widths.shape[0]

    def to(self, device) -> "TextureAtlas":
        return dataclasses.replace(self, **_tensors_to(self, device))


@dataclasses.dataclass
class EnvmapData:
    """Equirectangular environment map and its sampling tables (reference:
    OrochiEnvmap.cpp:30-66), built by assets/envmap.py:build_envmap."""

    texels: torch.Tensor         # (H,W,3) f32 linear radiance
    cdf: torch.Tensor            # (H*W,) f32 luminance CDF (CDF_BINARY)
    alias_probas: torch.Tensor   # (H*W,) f32 Vose alias table (ALIAS_TABLE)
    alias_indices: torch.Tensor  # (H*W,) i32
    total_luminance: float

    def to(self, device) -> "EnvmapData":
        return dataclasses.replace(self, **_tensors_to(self, device))


@dataclasses.dataclass
class SceneData:
    """Flat world-space scene. T triangles, V vertices, E emissive triangles."""

    vertices: torch.Tensor        # (V,3) f32
    triangles: torch.Tensor       # (T,3) i32
    normals: torch.Tensor         # (V,3) f32
    uvs: torch.Tensor             # (V,2) f32
    material_ids: torch.Tensor    # (T,) i32
    # (T, 32) f32: [0:9] n0,n1,n2 [9:15] uv0,uv1,uv2 [15:24] v0,e1,e2
    # [24] mat_id (int32 bits) [25:28] unit geometric normal [28:31] tangent
    tri_data: torch.Tensor
    materials: object             # MaterialBank
    emissive_tri_indices: torch.Tensor  # (E,) i32, [-1] when E == 0
    num_emissives: int
    emissive_power_cdf: torch.Tensor    # (E,) f32
    emissive_alias_prob: torch.Tensor   # (E,) f32 — Vose alias table
    emissive_alias: torch.Tensor        # (E,) i32
    emissive_pmf: torch.Tensor          # (E,) f32
    # (E, 32) f32: [0:3] v0 [3:6] e1 [6:9] e2 [9:12] unit normal [12] area
    # [13] pmf [14:17] radiance [17] tri index [18] alias prob [19] alias slot
    emissive_rows: torch.Tensor
    emissive_slot_of_tri: torch.Tensor  # (T,) i32, -1 = not emissive
    emissive_total_area: float
    envmap: Optional[EnvmapData] = None
    textures: Optional[object] = None

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]

    def to(self, device) -> "SceneData":
        kw = _tensors_to(self, device)
        textures = None if self.textures is None else self.textures.to(device)
        envmap = None if self.envmap is None else self.envmap.to(device)
        return dataclasses.replace(self, materials=self.materials.to(device),
                                   textures=textures, envmap=envmap, **kw)


def vose_alias(weights: np.ndarray):
    """Vose O(N) alias table from nonnegative weights
    (reference: Image.cpp:576-660). Returns (prob f32 (N,), alias i32 (N,))."""
    w = np.asarray(weights, np.float64).ravel()
    n = w.size
    total = w.sum()
    if total <= 0.0 or n == 0:
        return np.ones(max(n, 1), np.float32), np.arange(max(n, 1), dtype=np.int32)
    p = w * (n / total)
    probas = np.zeros(n, np.float32)
    aliases = np.arange(n, dtype=np.int32)
    small = list(np.nonzero(p < 1.0)[0])
    large = list(np.nonzero(p >= 1.0)[0])
    p = p.copy()
    while small and large:
        s = small.pop()
        l = large.pop()
        probas[s] = p[s]
        aliases[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    for rest in small + large:
        probas[rest] = 1.0
    return probas, aliases


def compute_triangle_areas(vertices: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    v0 = vertices[triangles[:, 0]]
    v1 = vertices[triangles[:, 1]]
    v2 = vertices[triangles[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)


def texture_kinds(textures: TextureAtlas, materials) -> TextureAtlas:
    """The atlas with the kinds the material bank references, and their
    sRGB flags, filled in (as the JAX package's build_scene does)."""
    srgb = textures.is_srgb.cpu().numpy()
    kinds, srgb_any, srgb_all = [], [], []
    for kind, field in TEXTURE_KIND_FIELDS.items():
        idx = getattr(materials, field).cpu().numpy()
        ref = idx[idx >= 0]
        if not len(ref):
            continue
        kinds.append(kind)
        if bool(srgb[ref].any()):
            srgb_any.append(kind)
        if bool(srgb[ref].all()):
            srgb_all.append(kind)
    return dataclasses.replace(textures, kinds_used=tuple(kinds),
                               kinds_srgb_any=tuple(srgb_any),
                               kinds_srgb_all=tuple(srgb_all))


def build_scene(vertices: np.ndarray, triangles: np.ndarray,
                material_ids: np.ndarray, materials,
                normals: Optional[np.ndarray] = None,
                uvs: Optional[np.ndarray] = None,
                textures: Optional[TextureAtlas] = None,
                envmap: Optional[EnvmapData] = None,
                device=None) -> SceneData:
    """Assemble a SceneData on ``device`` (default: the GPU, see
    core/device.py:resolve_device) from host numpy arrays; derives the
    emissive list."""
    device = resolve_device(device)
    vertices = np.asarray(vertices, dtype=np.float32)
    triangles = np.asarray(triangles, dtype=np.int32)
    material_ids = np.asarray(material_ids, dtype=np.int32)
    if normals is None:
        # geometric normals averaged per vertex
        normals = np.zeros_like(vertices)
        v0, v1, v2 = (vertices[triangles[:, k]] for k in range(3))
        fn = np.cross(v1 - v0, v2 - v0)
        for k in range(3):
            np.add.at(normals, triangles[:, k], fn)
        lens = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = normals / np.maximum(lens, 1e-12)
    if uvs is None:
        uvs = np.zeros((vertices.shape[0], 2), dtype=np.float32)

    em_colors = materials.emission.cpu().numpy() * materials.emission_strength.cpu().numpy()[..., None]
    em_mask_mat = np.any(em_colors > 0.0, axis=-1)
    em_indices = np.nonzero(em_mask_mat[material_ids])[0].astype(np.int32)
    num_em = len(em_indices)
    areas = compute_triangle_areas(vertices, triangles)
    if num_em > 0:
        em_areas = areas[em_indices]
        em_power = em_areas * np.maximum(
            em_colors[material_ids[em_indices]].sum(-1), 1e-12
        )
        cdf = np.cumsum(em_power)
        cdf = cdf / cdf[-1]
        total_area = float(em_areas.sum())
        pmf = (em_power / em_power.sum()).astype(np.float32)
        alias_p, alias_i = vose_alias(em_power)
    else:
        em_indices = np.zeros((1,), dtype=np.int32) - 1
        cdf = np.ones((1,), dtype=np.float32)
        total_area = 0.0
        pmf = np.ones((1,), np.float32)
        alias_p = np.ones((1,), np.float32)
        alias_i = np.zeros((1,), np.int32)

    T = triangles.shape[0]
    if T >= (1 << 24):
        raise ValueError(
            f"scene has {T} triangles; f32-value-encoded indices are exact "
            "only below 2^24")
    normals32 = normals.astype(np.float32)
    uvs32 = uvs.astype(np.float32)
    td = np.zeros((T, 32), dtype=np.float32)
    td[:, 0:3] = normals32[triangles[:, 0]]
    td[:, 3:6] = normals32[triangles[:, 1]]
    td[:, 6:9] = normals32[triangles[:, 2]]
    td[:, 9:11] = uvs32[triangles[:, 0]]
    td[:, 11:13] = uvs32[triangles[:, 1]]
    td[:, 13:15] = uvs32[triangles[:, 2]]
    tv0 = vertices[triangles[:, 0]]
    te1 = vertices[triangles[:, 1]] - tv0
    te2 = vertices[triangles[:, 2]] - tv0
    td[:, 15:18] = tv0
    td[:, 18:21] = te1
    td[:, 21:24] = te2
    td[:, 24] = material_ids.view(np.float32)
    gn = np.cross(te1, te2)
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-12)
    td[:, 25:28] = gn
    # per-triangle tangent from UV derivatives (normal mapping)
    duv1 = uvs32[triangles[:, 1]] - uvs32[triangles[:, 0]]
    duv2 = uvs32[triangles[:, 2]] - uvs32[triangles[:, 0]]
    det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    safe_det = np.where(np.abs(det_uv) > 1e-12, det_uv, 1.0)
    inv_det = np.where(np.abs(det_uv) > 1e-12, 1.0 / safe_det, 0.0)
    tangent = (te1 * duv2[:, 1:2] - te2 * duv1[:, 1:2]) * inv_det[:, None]
    tlen = np.linalg.norm(tangent, axis=-1, keepdims=True)
    tangent = np.where(tlen > 1e-9, tangent / np.maximum(tlen, 1e-12), 0.0)
    td[:, 28:31] = tangent

    E = len(em_indices)
    em_rows = np.zeros((E, 32), np.float32)
    slot_of_tri = np.full((T,), -1, np.int32)
    if num_em > 0:
        ei = em_indices
        ev0 = vertices[triangles[ei, 0]]
        ee1 = vertices[triangles[ei, 1]] - ev0
        ee2 = vertices[triangles[ei, 2]] - ev0
        en = np.cross(ee1, ee2)
        e_area = 0.5 * np.linalg.norm(en, axis=-1)
        en_unit = en / np.maximum(
            np.linalg.norm(en, axis=-1, keepdims=True), 1e-30
        )
        em_rows[:, 0:3] = ev0
        em_rows[:, 3:6] = ee1
        em_rows[:, 6:9] = ee2
        em_rows[:, 9:12] = en_unit
        em_rows[:, 12] = e_area
        em_rows[:, 13] = pmf
        em_rows[:, 14:17] = em_colors[material_ids[ei]]
        em_rows[:, 17] = ei.astype(np.float32)
        em_rows[:, 18] = alias_p
        em_rows[:, 19] = alias_i.astype(np.float32)
        slot_of_tri[ei] = np.arange(E, dtype=np.int32)
    else:
        em_rows[:, 17] = -1.0

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return SceneData(
        vertices=t(vertices),
        triangles=t(triangles),
        normals=t(normals32),
        uvs=t(uvs32),
        material_ids=t(material_ids),
        tri_data=t(td),
        materials=materials.to(device),
        emissive_tri_indices=t(em_indices),
        num_emissives=int(num_em),
        emissive_power_cdf=t(cdf.astype(np.float32)),
        emissive_alias_prob=t(alias_p),
        emissive_alias=t(alias_i),
        emissive_pmf=t(pmf),
        emissive_rows=t(em_rows),
        emissive_slot_of_tri=t(slot_of_tri),
        emissive_total_area=float(total_area),
        envmap=None if envmap is None else envmap.to(device),
        textures=None if textures is None
        else texture_kinds(textures, materials).to(device),
    )
