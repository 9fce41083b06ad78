"""BVH traversal of the reference: the ``HitRecord`` contract, its own
walk over its own BVH (accel.py), and the alpha-aware shadow march.

Rays ``o, d`` (N, 3), ``t_min``/``t_max`` scalar or (N,), ``active`` (N,)
bool; the result is ``HitRecord(t, prim, u, v)`` where a miss (and every
inactive ray) is ``prim = -1, t = inf``, and any-hit reports occlusion in
``prim >= 0`` with ``u = v = 0``.

``walk`` is a vectorized per-ray stack walk over the four-wide tree of
accel.py with exact f32 triangles: every iteration pops one entry per live
ray, slab-tests the four children of the rays that popped a node and pushes
the hits far-to-near, and intersects the triangles of the rays that popped
a leaf. An equal-t tie between two triangles goes to the smaller prim id,
so neither the tree nor the visit order picks the winner of a closest-hit
ray. Given a ``stats`` dict, the walk adds its box tests and triangle tests
(the filled slots it tested) to it: the operation count of a traversal's
least time (portbench/yardstick.py).

``occluded_alpha`` is the alpha-aware shadow test of scenes with alpha
textures: an any-hit prune, then a march of closest hits through the
surfaces the stochastic alpha test lets pass.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import rng as rng_mod
from .intersect import triangle_test
from .pixel_order import PixelRange
from .texture import apply_textures



@dataclasses.dataclass
class HitRecord:
    t: torch.Tensor     # (N,) f32, inf = miss
    prim: torch.Tensor  # (N,) i32, -1 = miss
    u: torch.Tensor     # (N,) f32 barycentric
    v: torch.Tensor     # (N,) f32


def empty_hit_record(n: int, device) -> HitRecord:
    """All-miss record."""
    return HitRecord(
        t=torch.full((n,), float("inf"), dtype=torch.float32, device=device),
        prim=torch.full((n,), -1, dtype=torch.int32, device=device),
        u=torch.zeros((n,), dtype=torch.float32, device=device),
        v=torch.zeros((n,), dtype=torch.float32, device=device),
    )


def per_ray(x, n: int, device) -> torch.Tensor:
    """Scalar or (N,) → contiguous (N,) f32 on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(n).contiguous()


def inverse_direction(d: torch.Tensor) -> torch.Tensor:
    """1/d, with ±1e12 for a component within 1e-12 of zero: -1e12 for a
    negative one, +1e12 for +0 and -0. (The JAX package's guard,
    ``sign(c)·1e12 + 1e12``, gives 0 for a tiny negative component, which
    collapses that axis's slab and misses every box not around the origin.)"""
    big = torch.where(d < 0.0, -1e12, 1e12)
    return torch.where(d.abs() > 1e-12, 1.0 / d, big)


def slab_test(boxes, o, inv, best_t):
    """boxes (k, C, 6) [min xyz, max xyz], rays (k, 3), best_t (k,).
    Returns (hit (k, C), t_entry (k, C)); an empty (NaN) slot never hits."""
    t0 = (boxes[..., 0:3] - o[:, None, :]) * inv[:, None, :]
    t1 = (boxes[..., 3:6] - o[:, None, :]) * inv[:, None, :]
    tsm = torch.minimum(t0, t1)
    tbg = torch.maximum(t0, t1)
    t_entry = torch.maximum(torch.maximum(tsm[..., 0], tsm[..., 1]),
                            tsm[..., 2].clamp_min(0.0))
    t_exit = torch.minimum(torch.minimum(tbg[..., 0], tbg[..., 1]),
                           torch.minimum(tbg[..., 2], best_t[:, None]))
    hit = (t_entry <= t_exit) & ~torch.isnan(boxes[..., 0])
    return hit, t_entry


def _count(stats, key, n):
    """Add the count ``n`` (a device tensor, read only by the caller) to
    stats[key]."""
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def walk(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None,
         any_hit: bool = False, stats: dict | None = None) -> HitRecord:
    """Closest-hit (or any-hit) walk of N rays over ``bvh`` (accel.py's
    RefBVH) on the rays' device."""
    n = o.shape[0]
    dev = o.device
    rec = empty_hit_record(n, dev)
    if n == 0:
        return rec
    inv = inverse_direction(d)
    t_min = per_ray(t_min, n, dev)
    best_t = per_ray(t_max, n, dev).clone()
    act = (torch.ones((n,), dtype=torch.bool, device=dev) if active is None
           else active.to(torch.bool))
    width = bvh.child_boxes.shape[1]
    leaf_tris = bvh.leaf_tris.shape[1]
    slot = torch.arange(leaf_tris, device=dev)[None, :]

    stack = torch.zeros((n, bvh.stack_size), dtype=torch.int32, device=dev)
    sp = act.to(torch.int64)  # every live stack starts as [root]
    alive = torch.nonzero(sp > 0).squeeze(1)
    while alive.numel():
        sp[alive] -= 1
        ref = stack[alive, sp[alive]]
        is_node = ref >= 0

        ni = alive[is_node]
        if ni.numel():
            r = ref[is_node].long()
            boxes, refs = bvh.child_boxes[r], bvh.child_refs[r]
            hit, t_entry = slab_test(boxes, o[ni], inv[ni], best_t[ni])
            if stats is not None:
                _count(stats, "box_tests", bvh.child_count[r].sum())
            # push hit children far-to-near so the nearest is popped first
            key = torch.where(hit, t_entry, torch.full_like(t_entry, -1.0))
            key, order = torch.sort(key, dim=1, descending=True)
            child = refs.gather(1, order)
            for j in range(width):
                m = key[:, j] >= 0.0
                rows = ni[m]
                stack[rows, sp[rows]] = child[m, j]
                sp[rows] += 1

        li = alive[~is_node]
        if li.numel():
            leaf = -(ref[~is_node].long() + 1)
            cnt = bvh.leaf_count[leaf]
            if stats is not None:
                _count(stats, "tri_tests", cnt.sum())
            tri = bvh.leaf_tris[leaf]
            ol, dl = o[li], d[li]
            ok, t, u, v = triangle_test(
                ol[:, 0:1], ol[:, 1:2], ol[:, 2:3],
                dl[:, 0:1], dl[:, 1:2], dl[:, 2:3],
                *(tri[..., c] for c in range(9)))
            bt = best_t[li][:, None]
            bp = rec.prim[li][:, None]
            prims = bvh.leaf_prims[leaf]
            # a hit beats the best so far; an equal-t tie goes to the smaller
            # prim id, so the result does not depend on the visit order
            hit = (ok & (slot < cnt[:, None]) & (t > t_min[li, None])
                   & ((t < bt) | ((t == bt) & (bp >= 0) & (prims < bp))))
            tk = torch.where(hit, t, torch.full_like(t, float("inf")))
            first = hit & (tk == tk.amin(dim=1, keepdim=True))
            k = torch.where(first, prims, torch.iinfo(torch.int32).max
                            ).argmin(dim=1, keepdim=True)
            found = hit.any(dim=1)
            hl = li[found]
            kf = k[found]
            best_t[hl] = tk[found].gather(1, kf)[:, 0]
            rec.prim[hl] = prims[found].gather(1, kf)[:, 0]
            rec.u[hl] = u[found].gather(1, kf)[:, 0]
            rec.v[hl] = v[found].gather(1, kf)[:, 0]
            if any_hit:
                sp[hl] = 0
        alive = torch.nonzero(sp > 0).squeeze(1)

    miss = rec.prim < 0
    rec.t = torch.where(miss, torch.full_like(best_t, float("inf")), best_t)
    if any_hit:
        rec.u.zero_()
        rec.v.zero_()
    return rec


# the alpha march's counts since reset_march_counts(): its calls and the
# segments run, by the name of the traversal that ran them; with a tally,
# also the shadow rays it was given ("rays"), those the prune found a
# blocker for ("entered") and those that passed through at least one
# surface ("passed") and the segments run with none of the batch's own rays
# searching ("idle": only a shard's march runs such a segment, for the
# other shards): device tensors, read on the host only by the caller
march_counts: dict = {}


def reset_march_counts(tally: bool = False) -> None:
    march_counts.clear()
    march_counts.update(calls=0, segments={})
    if tally:
        march_counts.update(rays=0, entered=0, passed=0, idle=0)


reset_march_counts()


def _tally(key: str, mask: torch.Tensor) -> None:
    """Adds mask's count to march_counts[key] when a tally was asked for."""
    if key in march_counts:
        march_counts[key] = march_counts[key] + mask.sum()


def alpha_shadows(scene) -> bool:
    """Whether a scene's shadow rays take ``occluded_alpha``: its textures
    carry alpha (TextureAtlas.has_alpha), as the JAX package gates it."""
    return scene.textures is not None and scene.textures.has_alpha


def occluded_alpha(bvh, scene, o, d, rng_state, t_min=1e-4,
                   t_max=float("inf"), active=None, max_segments: int = 4,
                   trace=None, prune: bool = True, shard=None):
    """Alpha-aware shadow test (reference: stochastic alpha in the
    traversal filter function, FilterFunction.h:19-49), the JAX package's
    ``occluded_alpha``: march up to ``max_segments`` closest hits, passing
    through each surface with probability 1 - alpha (the hit's material,
    its base-colour texture's alpha applied). A ray still passing after the
    last segment is unoccluded.

    ``trace``: the traversal that serves these rays (default ``walk``). With ``prune``, an
    alpha-blind any-hit pass first drops the rays that nothing blocks. A
    segment draws one ``next_float`` for every ray of the batch; a segment
    with no searching ray is skipped, draws included, as the JAX package's
    ``lax.cond`` skips it: the check is one host sync a segment. Under a
    ``shard`` (ops/pixel_order.py:PixelRange; the rays are its pixels') the
    check is the image's: a segment that one device would run draws for
    every ray, so a shard runs it, draws included, while any shard's rays
    still search.
    Returns (rng_state, occluded (N,) bool)."""
    trace = walk if trace is None else trace
    n = o.shape[0]
    dev = o.device
    shard = shard or PixelRange.batch(n)
    searching = (torch.ones((n,), dtype=torch.bool, device=dev)
                 if active is None else active.to(torch.bool))
    march_counts["calls"] += 1
    _tally("rays", searching)
    if prune:
        searching = searching & (trace(bvh, o, d, t_min=t_min, t_max=t_max,
                                       active=searching, any_hit=True).prim >= 0)
    _tally("entered", searching)
    occluded = torch.zeros((n,), dtype=torch.bool, device=dev)
    crossed = torch.zeros_like(occluded)
    remaining = per_ray(t_max, n, dev)
    cur_o = o
    name = getattr(trace, "__name__", "trace")
    for _ in range(max_segments):
        if not shard.any(searching):
            break
        march_counts["segments"][name] = march_counts["segments"].get(name, 0) + 1
        _tally("idle", ~searching.any())
        rec = trace(bvh, cur_o, d, t_min=t_min, t_max=remaining,
                    active=searching, any_hit=False)
        hit = (rec.prim >= 0) & searching
        # the hit's material and uv, its base-colour alpha applied
        row = scene.tri_data[rec.prim.clamp_min(0).long()]
        mat_id = row[:, 24].contiguous().view(torch.int32)
        w = 1.0 - rec.u - rec.v
        uv = torch.stack(
            [row[:, 9] * w + row[:, 11] * rec.u + row[:, 13] * rec.v,
             row[:, 10] * w + row[:, 12] * rec.u + row[:, 14] * rec.v], dim=-1)
        mats = scene.materials.at_indices(mat_id)
        if scene.textures is not None:
            mats = apply_textures(scene.textures, mats, uv)
        rng_state, u_a = rng_mod.next_float(rng_state)
        opaque = hit & (u_a < mats.alpha_opacity)
        occluded = occluded | opaque
        # pass-through rays go on from just past the hit
        passthrough = hit & ~opaque
        crossed = crossed | passthrough
        seg = torch.where(torch.isfinite(rec.t), rec.t, 0.0)
        cur_o = torch.where(passthrough[:, None], cur_o + d * (seg + 1e-4)[:, None],
                            cur_o)
        remaining = torch.where(passthrough, remaining - seg - 1e-4, remaining)
        searching = passthrough
    _tally("passed", crossed)
    return rng_state, occluded


def shadow_blocked(bvh, scene, o, d, rng_state, t_max, active, trace,
                   shard=None):
    """(rng_state, blocked (N,) bool) of the shadow rays (o, d) from t_min =
    1e-4 to t_max: through ``occluded_alpha`` on ``trace`` when the scene's
    textures carry alpha (alpha_shadows) and a PCG stream is given, which it
    then advances; else one alpha-blind any-hit trace on ``trace``, which
    draws nothing (the JAX package's gates at its three call sites).
    ``shard``: the pixel range the rays belong to (occluded_alpha)."""
    if alpha_shadows(scene) and rng_state is not None:
        return occluded_alpha(bvh, scene, o, d, rng_state, t_min=1e-4,
                              t_max=t_max, active=active, trace=trace,
                              shard=shard)
    return rng_state, trace(bvh, o, d, t_min=1e-4, t_max=t_max, active=active,
                            any_hit=True).prim >= 0
