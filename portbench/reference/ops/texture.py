"""Texture fetch and material texture application, mirroring
``hiprt_pt_tpu.ops.texture`` (reference: Texture.h; Material.h
get_intersection_material).

One bilinear fetch reads one 16-byte footprint row of the uint8 atlas (the
texel's 2x2 neighbourhood); the uv wrap and the weights are elementwise
math. A NO_TEXTURE (-1) index fetches layer 0 and is masked out.
"""

from __future__ import annotations

import dataclasses

import torch


def _srgb_decode(c):
    """Exact piecewise sRGB → linear."""
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def fetch_bilinear(atlas, tex_idx: torch.Tensor, uv: torch.Tensor,
                   lod: torch.Tensor | None = None,
                   decode_srgb: bool | None = None) -> torch.Tensor:
    """Bilinear texel fetch: tex_idx (N,) i32 (NO_TEXTURE = -1 → 1s),
    uv (N,2) wrap-addressed, lod optional (N,) mip level (rounded; 0 = full
    resolution). sRGB is decoded per tap before filtering; decode_srgb
    True/False skips the per-lane select where every referenced layer
    agrees, None selects per lane. Returns (N,4) f32."""
    has = tex_idx >= 0
    layer = tex_idx.clamp_min(0).long()
    w0 = atlas.widths[layer]
    h0 = atlas.heights[layer]
    if lod is None:
        level = torch.zeros_like(layer)
    else:
        level = torch.minimum(torch.round(lod).to(torch.int64).clamp_min(0),
                              atlas.num_levels[layer].long() - 1)
    off = atlas.offsets[layer, level].long()
    w = (w0 >> level).clamp_min(1).long()
    h = (h0 >> level).clamp_min(1).long()

    u = uv[:, 0] % 1.0
    v = uv[:, 1] % 1.0
    x = u * w.to(torch.float32) - 0.5
    y = v * h.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    y0i = torch.remainder(y0.to(torch.int64), h)

    if decode_srgb is False:
        def tap(t):
            return t
    elif decode_srgb is True:
        def tap(t):
            return torch.cat([_srgb_decode(t[:, :3]), t[:, 3:4]], dim=-1)
    else:
        srgb = atlas.is_srgb[layer][:, None]

        def tap(t):
            rgb = torch.where(srgb, _srgb_decode(t[:, :3]), t[:, :3])
            return torch.cat([rgb, t[:, 3:4]], dim=-1)

    if atlas.footprint:
        row = atlas.texels[off + y0i * w + x0i].to(torch.float32) / 255.0
        t00, t01 = row[:, 0:4], row[:, 4:8]
        t10, t11 = row[:, 8:12], row[:, 12:16]
    else:
        x1i = torch.remainder(x0i + 1, w)
        y1i = torch.remainder(y0i + 1, h)

        def texel(yy, xx):
            return atlas.texels[off + yy * w + xx].to(torch.float32) / 255.0

        t00, t01 = texel(y0i, x0i), texel(y0i, x1i)
        t10, t11 = texel(y1i, x0i), texel(y1i, x1i)

    tex = (tap(t00) * ((1 - fx) * (1 - fy)) + tap(t01) * (fx * (1 - fy))
           + tap(t10) * ((1 - fx) * fy) + tap(t11) * (fx * fy))
    return torch.where(has[:, None], tex, 1.0)


def _srgb_mode(atlas, kind):
    if kind in atlas.kinds_srgb_all:
        return True
    if kind not in atlas.kinds_srgb_any:
        return False
    return None


def apply_textures(atlas, mats, uv: torch.Tensor):
    """Modulate gathered material parameters by their textures: base color
    and alpha, roughness/metallic (the GLTF map's G/B channels or separate
    maps), emission, and the scalar maps (specular, coat, sheen,
    transmission read from R, replacing the value). Kinds that no material
    references (atlas.kinds_used) are not fetched."""
    if atlas is None:
        return mats
    kinds = atlas.kinds_used

    def fetch(kind, idx):
        return fetch_bilinear(atlas, idx, uv, decode_srgb=_srgb_mode(atlas, kind))

    kw = {}
    if "base" in kinds:
        base = fetch("base", mats.base_color_texture_index)
        has_base = mats.base_color_texture_index >= 0
        kw["base_color"] = torch.where(has_base[:, None],
                                       mats.base_color * base[:, :3], mats.base_color)
        kw["alpha_opacity"] = torch.where(has_base, mats.alpha_opacity * base[:, 3],
                                          mats.alpha_opacity)
    roughness = mats.roughness
    metallic = mats.metallic
    if "mr" in kinds:
        mr = fetch("mr", mats.roughness_metallic_texture_index)
        has_mr = mats.roughness_metallic_texture_index >= 0
        roughness = torch.where(has_mr, mats.roughness * mr[:, 1], roughness)
        metallic = torch.where(has_mr, mats.metallic * mr[:, 2], metallic)
    if "rough" in kinds:
        r1 = fetch("rough", mats.roughness_texture_index)
        roughness = torch.where(mats.roughness_texture_index >= 0, r1[:, 0], roughness)
    if "metal" in kinds:
        m1 = fetch("metal", mats.metallic_texture_index)
        metallic = torch.where(mats.metallic_texture_index >= 0, m1[:, 0], metallic)
    if "rough" in kinds or "mr" in kinds:
        kw["roughness"] = roughness
    if "metal" in kinds or "mr" in kinds:
        kw["metallic"] = metallic
    if "em" in kinds:
        em = fetch("em", mats.emission_texture_index)
        kw["emission"] = torch.where((mats.emission_texture_index >= 0)[:, None],
                                     mats.emission * em[:, :3], mats.emission)
    for kind, name in (("spec", "specular"), ("coat", "coat"), ("sheen", "sheen"),
                       ("trans", "specular_transmission")):
        if kind in kinds:
            idx = getattr(mats, name + "_texture_index")
            t1 = fetch(kind, idx)
            kw[name] = torch.where(idx >= 0, t1[:, 0], getattr(mats, name))
    return dataclasses.replace(mats, **kw) if kw else mats


def apply_normal_map(atlas, nm_index: torch.Tensor, uv: torch.Tensor,
                     ns: torch.Tensor, tangent: torch.Tensor) -> torch.Tensor:
    """Perturb the shading normal by the tangent-space normal map
    (reference: Intersect.h:30-62). nm_index: (N,) normal_map_texture_index
    per hit."""
    if atlas is None or "normal" not in atlas.kinds_used:
        return ns
    has = nm_index >= 0
    tex = fetch_bilinear(atlas, nm_index, uv, decode_srgb=_srgb_mode(atlas, "normal"))
    nt = tex[:, :3] * 2.0 - 1.0
    # orthonormalize the tangent against the (interpolated) normal
    t = tangent - ns * (tangent * ns).sum(dim=-1, keepdim=True)
    t_len = torch.linalg.norm(t, dim=-1, keepdim=True)
    t = torch.where(t_len > 1e-6, t / t_len.clamp_min(1e-12), 0.0)
    b = torch.linalg.cross(ns, t, dim=-1)
    n2 = nt[:, 0:1] * t + nt[:, 1:2] * b + nt[:, 2:3] * ns
    n2_len = torch.linalg.norm(n2, dim=-1, keepdim=True)
    n2 = torch.where(n2_len > 1e-6, n2 / n2_len.clamp_min(1e-12), ns)
    ok = has & (torch.linalg.norm(tangent, dim=-1) > 1e-6)
    return torch.where(ok[:, None], n2, ns)
