"""BVH traversal — the ``HitRecord`` contract and the plain PyTorch versions
of the port's traversal kernels (ops/cuda_traverse.py).

The contract is the JAX package's (``hiprt_pt_tpu.ops.traverse``): rays
``o, d`` (N, 3), ``t_min``/``t_max`` scalar or (N,), ``active`` (N,) bool;
the result is ``HitRecord(t, prim, u, v)`` where a miss (and every inactive
ray) is ``prim = -1, t = inf``, and any-hit reports occlusion in
``prim >= 0`` with ``u = v = 0``.

The plain version is a vectorized per-ray stack walk over ``nodes4`` +
``leaf_rows`` with exact f32 triangles: every iteration pops one entry per
live ray, slab-tests the four children of the rays that popped a node and
pushes the hits far-to-near, and intersects the up-to-12 triangles of the
rays that popped a leaf. An equal-t tie between two triangles that a walk
tests goes to the smaller prim id, in the kernels too, so the visit order
does not pick the winner; a walk that culls the second triangle's box at
exactly that t still keeps the first (rare: one ray in two million 1080p
camera rays on the stress interior). It runs on any device; the render
path sends only CPU tensors to it. Given a ``stats`` dict, each plain walk
adds its node visits, box tests, leaf visits and triangle tests to it (the
operation count of a kernel's bound in chip_smoke.py).

``traverse8`` is the same walk over the BVH8 tables ``nodes8l`` +
``leaf_rows8`` (the plain version of ``trace_stream8`` and
``trace_lane8log``): eight children per node, pushed far-to-near.

``traverse_meganode`` is the same per-ray walk over the meganode table
``nodes`` (the plain version of ``trace_meganode``): two children per row,
leaves of up to 4 triangles embedded in the row, the near child popped
first, the same tie rule.

``occluded_alpha`` is the alpha-aware shadow test of scenes with alpha
textures: an any-hit prune, then a march of closest hits through the
surfaces the stochastic alpha test lets pass, on whichever traversal the
caller routes its shadow rays through.
"""

from __future__ import annotations

import dataclasses

import torch

from ..accel.build import MEGANODE_LEAF_TRIS
from ..core import rng as rng_mod
from ..utils import spans
from .intersect import triangle_test
from .pixel_order import PixelRange
from .texture import apply_textures

STACK_SIZE = 64
STACK8 = 96                # BVH8 walks: 7·depth8 + 1 entries, depth8 <= 13
LEAF_TRIS = 12
MEGANODE_STACK = 64        # far-sibling entries of a meganode walk


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


def check_stack_depth(bvh) -> None:
    """A walk holds at most 3 siblings per level plus the 4 children of the
    deepest node: 3·depth4 + 1 entries must fit the stack."""
    if bvh.leaf_rows is None:
        raise ValueError("this BVH has no BVH4 leaf table (leaf_rows is None)")
    need = 3 * int(bvh.depth4) + 1
    if need > STACK_SIZE:
        raise ValueError(
            f"BVH4 depth {bvh.depth4} needs a {need}-entry traversal stack; "
            f"the traversal holds {STACK_SIZE}")


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
    """Add n (an int, or a tensor read only here) to stats[key]."""
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(n)


def _walk(children, leaf_rows, stack_size, o, d, t_min, t_max, active,
          any_hit, stats):
    """The per-ray stack walk shared by the BVH4 and BVH8 plain versions.
    ``children(r)`` gives the child boxes (k, C, 6) and refs (k, C) of node
    rows r; a ref >= 0 is a node row, a ref < 0 leaf row -(ref+1)."""
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
    leaf_prims = leaf_rows[:, 108:120].contiguous().view(torch.int32)

    stack = torch.zeros((n, stack_size), dtype=torch.int32, device=dev)
    sp = act.to(torch.int64)  # every live stack starts as [root]
    alive = torch.nonzero(sp > 0).squeeze(1)
    while alive.numel():
        sp[alive] -= 1
        ref = stack[alive, sp[alive]]
        is_node = ref >= 0

        ni = alive[is_node]
        if ni.numel():
            boxes, refs = children(ref[is_node].long())
            _count(stats, "node_visits", ni.numel())
            _count(stats, "box_tests", boxes.shape[0] * boxes.shape[1])
            hit, t_entry = slab_test(boxes, o[ni], inv[ni], best_t[ni])
            # push hit children far-to-near so the nearest is popped first
            key = torch.where(hit, t_entry, torch.full_like(t_entry, -1.0))
            key, order = torch.sort(key, dim=1, descending=True)
            child = refs.gather(1, order)
            for j in range(refs.shape[1]):
                m = key[:, j] >= 0.0
                rows = ni[m]
                stack[rows, sp[rows]] = child[m, j]
                sp[rows] += 1

        li = alive[~is_node]
        if li.numel():
            leaf = -(ref[~is_node].long() + 1)
            rows = leaf_rows[leaf]
            _count(stats, "leaf_visits", li.numel())
            _count(stats, "tri_tests", rows[:, 121].sum())
            tri = rows[:, :108].reshape(-1, LEAF_TRIS, 9)
            ol, dl = o[li], d[li]
            ok, t, u, v = triangle_test(
                ol[:, 0:1], ol[:, 1:2], ol[:, 2:3],
                dl[:, 0:1], dl[:, 1:2], dl[:, 2:3],
                *(tri[..., c] for c in range(9)))
            slot = torch.arange(LEAF_TRIS, device=dev)[None, :]
            bt = best_t[li][:, None]
            bp = rec.prim[li][:, None]
            prims = leaf_prims[leaf]
            # a hit beats the best so far; an equal-t tie goes to the smaller
            # prim id, so the result does not depend on the visit order
            hit = (ok & (slot < rows[:, 121:122]) & (t > t_min[li, None])
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


def traverse(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None,
             any_hit: bool = False, stats: dict | None = None) -> HitRecord:
    """Closest-hit (or any-hit) traversal for N rays over ``nodes4`` +
    ``leaf_rows``, plain PyTorch. With ``stats`` given, adds the walk's
    node visits, box tests, leaf visits and triangle tests to it."""
    check_stack_depth(bvh)
    boxes4 = bvh.nodes4[:, :24].reshape(-1, 4, 6)
    refs4 = bvh.nodes4[:, 24:28].contiguous().view(torch.int32)
    return _walk(lambda r: (boxes4[r], refs4[r]), bvh.leaf_rows, STACK_SIZE,
                 o, d, t_min, t_max, active, any_hit, stats)


def check_stack8_depth(bvh) -> None:
    """A BVH8 walk holds at most 7 siblings per level plus the 8 children
    of the deepest node: 7·depth8 + 1 entries must fit the stack."""
    if bvh.nodes8l is None or bvh.leaf_rows8 is None:
        raise ValueError("this BVH has no BVH8 tables (nodes8l is None)")
    need = 7 * int(bvh.depth8) + 1
    if need > STACK8:
        raise ValueError(
            f"BVH8 depth {bvh.depth8} needs a {need}-entry traversal stack; "
            f"the BVH8 walks hold {STACK8}")


def bvh8_children(nodes8l: torch.Tensor):
    """(boxes (M8, 8, 6), refs (M8, 8) i32) of every nodes8l row: child c
    is node row base_int + c below n_int, else leaf row
    base_leaf + (c - n_int), as ref -(row + 1). An empty slot's box is NaN."""
    words = nodes8l[:, 48:50].contiguous().view(torch.int32)
    base_int = words[:, 0:1] & ((1 << 26) - 1)
    n_int = words[:, 0:1] >> 26
    c = torch.arange(8, dtype=torch.int32, device=nodes8l.device)[None, :]
    refs = torch.where(c < n_int, base_int + c, -(words[:, 1:2] + c - n_int) - 1)
    return nodes8l[:, :48].reshape(-1, 8, 6), refs


def traverse8(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None,
              any_hit: bool = False, stats: dict | None = None) -> HitRecord:
    """Closest-hit (or any-hit) walk over the BVH8 ``nodes8l`` +
    ``leaf_rows8``, plain PyTorch: the plain version of ``trace_stream8``
    and ``trace_lane8log``. Hit children are pushed far-to-near, leaves are
    intersected exactly, with the tie rule of ``traverse``."""
    check_stack8_depth(bvh)
    boxes8, refs8 = bvh8_children(bvh.nodes8l)
    return _walk(lambda r: (boxes8[r], refs8[r]), bvh.leaf_rows8, STACK8,
                 o, d, t_min, t_max, active, any_hit, stats)


def check_meganode_depth(bvh) -> None:
    """A meganode walk holds at most one far sibling per row on its path
    plus the near child just pushed: depth2 entries must fit the stack."""
    if bvh.nodes is None:
        raise ValueError("this BVH has no meganode table (nodes is None)")
    if int(bvh.depth2) > MEGANODE_STACK:
        raise ValueError(
            f"meganode tree depth {bvh.depth2} needs a {bvh.depth2}-entry "
            f"stack; the meganode walk holds {MEGANODE_STACK}")


def traverse_meganode(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None,
                      any_hit: bool = False, stats: dict | None = None) -> HitRecord:
    """Closest-hit (or any-hit) walk over the meganode table ``bvh.nodes``,
    plain PyTorch: the plain version of ``trace_meganode``. Every iteration
    pops one row per live ray, slab-tests its two child boxes, intersects
    the embedded leaf triangles of the children it hits and pushes the
    internal children it hits, far first. An empty slot (count < 0) is
    neither descended nor intersected."""
    check_meganode_depth(bvh)
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

    nodes = bvh.nodes
    boxes = nodes[:, :12].reshape(-1, 2, 6)
    meta = nodes[:, 12:16].contiguous().view(torch.int32)
    tris = nodes[:, 16:88].reshape(-1, 2 * MEGANODE_LEAF_TRIS, 9)
    tri_prims = nodes[:, 88:96].contiguous().view(torch.int32)
    slot = torch.arange(MEGANODE_LEAF_TRIS, device=dev)

    stack = torch.zeros((n, MEGANODE_STACK), dtype=torch.int32, device=dev)
    sp = act.to(torch.int64)  # every live stack starts as [root]
    alive = torch.nonzero(sp > 0).squeeze(1)
    while alive.numel():
        sp[alive] -= 1
        row = stack[alive, sp[alive]].long()
        m = meta[row]
        ref, cnt = m[:, 0::2], m[:, 1::2]  # (k, 2) per child slot
        hit, t_entry = slab_test(boxes[row], o[alive], inv[alive], best_t[alive])
        hit = hit & (cnt >= 0)
        _count(stats, "node_visits", row.numel())
        _count(stats, "box_tests", 2 * row.numel())

        # leaf children: the embedded triangles of each child the ray hits
        tri_ok = (hit & (cnt > 0))[:, :, None] & (slot < cnt[:, :, None])
        tri_ok = tri_ok.reshape(-1, 2 * MEGANODE_LEAF_TRIS)
        leafy = tri_ok.any(dim=1)
        found = torch.zeros_like(leafy)
        _count(stats, "tri_tests", tri_ok.sum())
        if leafy.any():
            li = alive[leafy]
            r = row[leafy]
            tri = tris[r]
            ol, dl = o[li], d[li]
            ok, t, u, v = triangle_test(
                ol[:, 0:1], ol[:, 1:2], ol[:, 2:3],
                dl[:, 0:1], dl[:, 1:2], dl[:, 2:3],
                *(tri[..., c] for c in range(9)))
            prims = tri_prims[r]
            bt = best_t[li][:, None]
            bp = rec.prim[li][:, None]
            # the tie rule of traverse(): an equal t goes to the smaller prim
            hit_t = (ok & tri_ok[leafy] & (t > t_min[li, None])
                     & ((t < bt) | ((t == bt) & (bp >= 0) & (prims < bp))))
            tk = torch.where(hit_t, t, torch.full_like(t, float("inf")))
            first = hit_t & (tk == tk.amin(dim=1, keepdim=True))
            k = torch.where(first, prims, torch.iinfo(torch.int32).max
                            ).argmin(dim=1, keepdim=True)
            f = hit_t.any(dim=1)
            found[leafy] = f
            hl = li[f]
            kf = k[f]
            best_t[hl] = tk[f].gather(1, kf)[:, 0]
            rec.prim[hl] = prims[f].gather(1, kf)[:, 0]
            rec.u[hl] = u[f].gather(1, kf)[:, 0]
            rec.v[hl] = v[f].gather(1, kf)[:, 0]
            if any_hit:
                sp[hl] = 0

        # internal children: push the far one first so the near one pops next
        take = hit & (cnt == 0)
        if any_hit:
            take = take & ~found[:, None]
        far = (t_entry[:, 0] <= t_entry[:, 1]).long()  # near child 0 on a tie
        for child in (far, 1 - far):
            mt = take.gather(1, child[:, None])[:, 0]
            rows = alive[mt]
            stack[rows, sp[rows]] = ref[mt].gather(1, child[mt][:, None])[:, 0]
            sp[rows] += 1
        alive = torch.nonzero(sp > 0).squeeze(1)

    miss = rec.prim < 0
    rec.t = torch.where(miss, torch.full_like(best_t, float("inf")), best_t)
    if any_hit:
        rec.u.zero_()
        rec.v.zero_()
    return rec


def closest_hit(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None) -> HitRecord:
    return traverse(bvh, o, d, t_min, t_max, active, any_hit=False)


def occluded(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None) -> torch.Tensor:
    """Shadow-ray any-hit test. Returns (N,) bool."""
    return traverse(bvh, o, d, t_min, t_max, active, any_hit=True).prim >= 0


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

    ``trace``: the traversal (a wrapper of ops/cuda_traverse.py or a plain
    walk; default ``traverse``) that serves these rays; callers pass the
    routed tracer of their alpha-blind shadow rays. With ``prune``, an
    alpha-blind any-hit pass first drops the rays that nothing blocks. A
    segment draws one ``next_float`` for every ray of the batch; a segment
    with no searching ray is skipped, draws included, as the JAX package's
    ``lax.cond`` skips it: the check is one host sync a segment. Under a
    ``shard`` (ops/pixel_order.py:PixelRange; the rays are its pixels') the
    check is the image's: a segment that one device would run draws for
    every ray, so a shard runs it, draws included, while any shard's rays
    still search. The march is recorded as the span ``march``
    (utils/spans.py).
    Returns (rng_state, occluded (N,) bool)."""
    with spans.span("march"):
        trace = traverse if trace is None else trace
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
