"""Emissive-triangle light sampling (NEE), mirroring
``hiprt_pt_tpu.lights.light_sampling`` (reference: Lights.h:277-321,
LightUtils.h:13-101).

Lights are picked in proportion to power through the Vose alias table, and
the pdf is reported exactly. Rows of ``emissive_rows`` are fetched with a
plain index gather (the JAX package's one-hot matmul is for the TPU's
matrix unit).
"""

from __future__ import annotations

import torch

from ..core import rng as rng_mod
from ..ops.sampling import sample_triangle


def sample_emissive_triangle(scene, p: torch.Tensor, rng_state):
    """Sample one emissive-triangle point per shading point p (N,3).

    Returns (rng_state, dict) with wi (N,3) unit direction to the light,
    dist (N,), radiance (N,3), pdf (N,) solid-angle pdf, valid (N,) bool,
    light_normal (N,3), light_point (N,3), tri_index (N,).
    Draw order: u_sel, (u1, u2), u_acc — as in the JAX package."""
    rng_state, u_sel = rng_mod.next_float(rng_state)
    rng_state, u1, u2 = rng_mod.next_float2(rng_state)
    rng_state, u_acc = rng_mod.next_float(rng_state)

    rows = scene.emissive_rows
    e = rows.shape[0]
    j = (u_sel * e).to(torch.int64).clamp_max(e - 1)
    rowj = rows[j]
    alias_slot = torch.round(rowj[:, 19]).to(torch.int64)
    slot = torch.where(u_acc < rowj[:, 18], j, alias_slot)
    row = torch.where((slot == j)[:, None], rowj, rows[slot])

    v0 = row[:, 0:3]
    e1 = row[:, 3:6]
    e2 = row[:, 6:9]
    light_n = row[:, 9:12]
    area = row[:, 12]
    pdf_tri = row[:, 13]
    radiance = row[:, 14:17]
    tri_idx = torch.round(row[:, 17]).to(torch.int32)

    light_p, _ng = sample_triangle(v0, e1, e2, u1, u2)
    to_light = light_p - p
    dist2 = (to_light * to_light).sum(dim=-1)
    dist = torch.sqrt(dist2.clamp_min(1e-12))
    wi = to_light / dist[..., None]

    # area pdf → solid angle (reference: LightUtils.h)
    cos_light = (light_n * (-wi)).sum(dim=-1).abs()
    pdf = pdf_tri / area.clamp_min(1e-12) * dist2 / cos_light.clamp_min(1e-8)

    valid = (tri_idx >= 0) & (cos_light > 1e-8) & (scene.num_emissives > 0)
    return rng_state, {
        "wi": wi,
        "dist": dist,
        "radiance": radiance,
        "pdf": torch.where(valid, pdf, 0.0),
        "valid": valid,
        "light_normal": light_n,
        "light_point": light_p,
        "tri_index": tri_idx,
    }


def emissive_pdf_of_direction(scene, p, hit_prim, hit_t, wi):
    """Solid-angle pdf with which NEE would have produced the direction wi
    that hit emissive primitive hit_prim at distance hit_t (for MIS weights
    of BSDF samples that land on lights). Returns (pdf (N,), is_emissive)."""
    safe_prim = hit_prim.clamp_min(0).long()
    slot = scene.emissive_slot_of_tri[safe_prim]
    matched = (hit_prim >= 0) & (slot >= 0)
    row = scene.emissive_rows[slot.clamp_min(0).long()]
    light_n = row[:, 9:12]
    area = row[:, 12]
    pdf_tri = row[:, 13]
    is_em = matched & (row[:, 14:17].sum(dim=-1) > 0.0)

    cos_light = (light_n * (-wi)).sum(dim=-1).abs()
    dist2 = hit_t * hit_t
    pdf = pdf_tri / area.clamp_min(1e-12) * dist2 / cos_light.clamp_min(1e-8)
    ok = is_em & matched & torch.isfinite(pdf)
    return torch.where(ok, pdf, 0.0), is_em
