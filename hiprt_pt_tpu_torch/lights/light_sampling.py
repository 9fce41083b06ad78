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
from ..ops import cuda_sweep
from ..ops.sampling import sample_triangle
from ..utils import spans


# the dense emissive sweep works on (rays, emitters) blocks of at most this
# many elements (64 MB for each f32 temporary)
SWEEP_BLOCK_ELEMS = 1 << 24


def _alias_draw(rows, u_sel, u_acc):
    """Rows of the emissive slots drawn by the Vose alias table."""
    e = rows.shape[0]
    j = (u_sel * e).to(torch.int64).clamp_max(e - 1)
    rowj = rows[j]
    alias_slot = torch.round(rowj[:, 19]).to(torch.int64)
    slot = torch.where(u_acc < rowj[:, 18], j, alias_slot)
    return torch.where((slot == j)[:, None], rowj, rows[slot])


def sample_emissive_triangle(scene, p: torch.Tensor, rng_state,
                             tile_size: int | None = None,
                             wavefront_size: int | None = None):
    """Sample one emissive-triangle point per shading point p (N,3).

    Returns (rng_state, dict) with wi (N,3) unit direction to the light,
    dist (N,), radiance (N,3), pdf (N,) solid-angle pdf, valid (N,) bool,
    light_normal (N,3), light_point (N,3), tri_index (N,).
    Draw order: u_sel, (u1, u2), u_acc — as in the JAX package.

    With ``tile_size`` set, all rays of one wavefront tile share the
    triangle drawn with the tile's first ray's uniforms (the point on it
    stays per ray): each ray's marginal density, and so every pdf, is
    unchanged (reference: LightsPresampling.h, tile-coherent subsets).
    Tiles are shared when the wavefront has more rays than a tile:
    ``wavefront_size`` is the wavefront's size when p holds only a part
    of it (a pixel shard: whole tiles of it), else p's own."""
    rng_state, u_sel = rng_mod.next_float(rng_state)
    rng_state, u1, u2 = rng_mod.next_float2(rng_state)
    rng_state, u_acc = rng_mod.next_float(rng_state)

    rows = scene.emissive_rows
    n = p.shape[0]
    if tile_size is not None and (wavefront_size or n) > tile_size:
        base = (torch.arange(0, n, tile_size, device=p.device)).clamp_max(n - 1)
        row = _alias_draw(rows, u_sel[base], u_acc[base])
        row = row.repeat_interleave(tile_size, dim=0)[:n]
    else:
        row = _alias_draw(rows, u_sel, u_acc)

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


def closest_emissive_hit(scene, o: torch.Tensor, d: torch.Tensor,
                         active=None, t_min: float = 1e-5):
    """Nearest emissive-triangle hit along (o, d), ignoring occluders: the
    JAX package's dense Moller-Trumbore sweep over the emissive set (RIS
    uses it to find which emitter a BSDF candidate reaches; the winner's
    visibility ray settles occlusion). The first emitter wins an equal t,
    as in the JAX package's sequential loop. On the CPU it runs the plain
    version (_closest_emissive_hit_plain); on CUDA tensors one launch of
    the kernel (ops/cuda_sweep.py), which gives the same bits, or it
    raises. Recorded as the span ``emissive_sweep``.

    Returns (t (N,), slot (N,) i64 into emissive_rows — -1 on a miss)."""
    rows = scene.emissive_rows
    e = rows.shape[0]
    n = o.shape[0]
    if e == 0 or scene.num_emissives == 0:
        return (torch.full((n,), float("inf"), dtype=torch.float32, device=o.device),
                torch.full((n,), -1, dtype=torch.int64, device=o.device))
    with spans.span("emissive_sweep"):
        if o.device.type == "cpu":
            return _closest_emissive_hit_plain(rows, o, d, active, t_min)
        return cuda_sweep.emissive_sweep(rows, o, d, active, t_min)


def _closest_emissive_hit_plain(rows, o, d, active=None, t_min: float = 1e-5):
    """closest_emissive_hit in plain PyTorch over the emissive table
    ``rows`` (E, W), E > 0: the sweep runs over blocks of emitters of at
    most SWEEP_BLOCK_ELEMS (ray, emitter) pairs."""
    e = rows.shape[0]
    n = o.shape[0]
    best_t = torch.full((n,), float("inf"), dtype=torch.float32, device=o.device)
    best_slot = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    block = max(1, min(e, SWEEP_BLOCK_ELEMS // max(n, 1)))
    for s0 in range(0, e, block):
        r = rows[s0:s0 + block]
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (r[None, :, k] for k in range(9))
        # pvec = d x e2, det = pvec . e1
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = px * e1x + py * e1y + pz * e1z
        ok = det.abs() > 1e-12
        inv_det = torch.where(ok, 1.0 / det, 0.0)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        del px, py, pz
        # qvec = tvec x e1
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        del tx, ty, tz
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (qx * e2x + qy * e2y + qz * e2z) * inv_det
        del qx, qy, qz
        hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
        tw = torch.where(hit, t, float("inf"))
        tb, kb = tw.min(dim=1)
        better = tb < best_t
        best_t = torch.where(better, tb, best_t)
        best_slot = torch.where(better, kb + s0, best_slot)
    if active is not None:
        best_slot = torch.where(active, best_slot, -1)
    return best_t, best_slot
