"""The reference's own BVH, built with numpy alone: a binary tree by the
surface area heuristic over 16 centroid bins on the widest axis, split
level by level down to leaves of at most LEAF_TRIS triangles, then
collapsed to a four-wide tree (each node takes its binary children, or
their children where they are internal). It serves the reference's walk
(ops/traverse.py:walk) and counts the least work of a traversal
(portbench/yardstick.py); it shares nothing with the program's builder.
Leaves hold each triangle as (v0, v1 - v0, v2 - v0) in f32, the layout the
triangle test reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

WIDTH = 4
LEAF_TRIS = 4


@dataclasses.dataclass
class RefBVH:
    child_boxes: torch.Tensor  # (M, WIDTH, 6) f32 [min xyz, max xyz], NaN = empty
    child_refs: torch.Tensor   # (M, WIDTH) i32: >= 0 node row, < 0 leaf -(row+1)
    child_count: torch.Tensor  # (M,) i64 filled slots
    leaf_tris: torch.Tensor    # (L, LEAF_TRIS, 9) f32, NaN = empty
    leaf_prims: torch.Tensor   # (L, LEAF_TRIS) i32, -1 = empty
    leaf_count: torch.Tensor   # (L,) i64
    stack_size: int
    depth: int

    def table_bytes(self) -> int:
        """Bytes of the tree's nodes and leaves."""
        return sum(t.numel() * t.element_size() for t in (
            self.child_boxes, self.child_refs, self.leaf_tris, self.leaf_prims))


BINS = 16


def _area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    e = np.maximum(hi - lo, 0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def _segment_reduce(ufunc, x: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """ufunc over x[start:end] of each (non-empty) segment."""
    pad = np.concatenate([x, x[-1:]])
    idx = np.stack([starts, ends], axis=1).reshape(-1)
    return ufunc.reduceat(pad, idx, axis=0)[0::2]


def sah_binary(tri_lo: np.ndarray, tri_hi: np.ndarray):
    """A binary SAH tree over the triangles' boxes. Returns (order: the
    triangles in leaf order, and per node: start, count, left child, right
    child (-1 for a leaf), box lo, box hi); node 0 is the root."""
    t = tri_lo.shape[0]
    cen = 0.5 * (tri_lo + tri_hi)
    order = np.arange(t)
    start, count, left, right = [0], [t], [-1], [-1]
    frontier = np.array([0]) if t > LEAF_TRIS else np.zeros(0, np.int64)
    while frontier.size:
        s0 = np.asarray(start)[frontier]
        n0 = np.asarray(count)[frontier]
        e0 = s0 + n0
        c = cen[order]
        cmin = _segment_reduce(np.minimum, c, s0, e0)
        cmax = _segment_reduce(np.maximum, c, s0, e0)
        axis = np.argmax(cmax - cmin, axis=1)
        nseg = frontier.size
        seg = np.repeat(np.arange(nseg), n0)
        # each triangle's position in ``order``
        pos = np.arange(seg.size) - np.repeat(np.cumsum(n0) - n0, n0) + np.repeat(s0, n0)
        tri = order[pos]
        ax = axis[seg]
        lo_a = cmin[seg, ax]
        ext = (cmax - cmin)[seg, ax]
        cc = cen[tri, ax]
        b = np.where(ext > 0, ((cc - lo_a) / np.where(ext > 0, ext, 1.0) * BINS)
                     .astype(np.int64), 0).clip(0, BINS - 1)
        key = seg * BINS + b
        cnt = np.bincount(key, minlength=nseg * BINS).reshape(nseg, BINS)
        blo = np.full((nseg * BINS, 3), np.inf, np.float32)
        bhi = np.full((nseg * BINS, 3), -np.inf, np.float32)
        np.minimum.at(blo, key, tri_lo[tri])
        np.maximum.at(bhi, key, tri_hi[tri])
        blo, bhi = blo.reshape(nseg, BINS, 3), bhi.reshape(nseg, BINS, 3)
        l_lo = np.minimum.accumulate(blo, axis=1)[:, :-1]
        l_hi = np.maximum.accumulate(bhi, axis=1)[:, :-1]
        r_lo = np.minimum.accumulate(blo[:, ::-1], axis=1)[:, ::-1][:, 1:]
        r_hi = np.maximum.accumulate(bhi[:, ::-1], axis=1)[:, ::-1][:, 1:]
        n_l = np.cumsum(cnt, axis=1)[:, :-1]
        n_r = n0[:, None] - n_l
        cost = np.where((n_l > 0) & (n_r > 0),
                        _area(l_lo, l_hi) * n_l + _area(r_lo, r_hi) * n_r, np.inf)
        best = np.argmin(cost, axis=1)
        ok = np.isfinite(cost[np.arange(nseg), best])
        # where no bin boundary splits the node (all centroids in one bin),
        # split it at its middle in the current order
        side = np.where(ok[seg], b > best[seg],
                        (pos - s0[seg]) >= (n0 // 2)[seg]).astype(np.int64)
        perm = np.lexsort((pos, side, seg))
        order[np.sort(pos)] = tri[perm]
        n_left = np.bincount(seg, weights=1 - side, minlength=nseg).astype(np.int64)
        nxt = []
        for i, node in enumerate(frontier):
            for a, n in ((s0[i], n_left[i]), (s0[i] + n_left[i], n0[i] - n_left[i])):
                start.append(int(a))
                count.append(int(n))
                left.append(-1)
                right.append(-1)
                if n > LEAF_TRIS:
                    nxt.append(len(start) - 1)
            left[node], right[node] = len(start) - 2, len(start) - 1
        frontier = np.asarray(nxt, np.int64)
    start, count = np.asarray(start), np.asarray(count)
    left, right = np.asarray(left), np.asarray(right)
    b_lo = _segment_reduce(np.minimum, tri_lo[order], start, start + count)
    b_hi = _segment_reduce(np.maximum, tri_hi[order], start, start + count)
    return order, start, count, left, right, b_lo, b_hi


def build(vertices: np.ndarray, triangles: np.ndarray, device) -> RefBVH:
    """The tree over ``triangles`` (T, 3) of ``vertices`` (V, 3), its
    tables on ``device``."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(triangles, np.int64)
    v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    tri_lo = np.minimum(np.minimum(v0, v1), v2)
    tri_hi = np.maximum(np.maximum(v0, v1), v2)
    order, start, count, left, right, b_lo, b_hi = sah_binary(tri_lo, tri_hi)

    # leaves: the binary leaves, numbered in node order
    is_leaf = left < 0
    leaf_nodes = np.nonzero(is_leaf)[0]
    leaf_of = np.full(is_leaf.shape, -1)
    leaf_of[leaf_nodes] = np.arange(leaf_nodes.size)
    slots = start[leaf_nodes][:, None] + np.arange(LEAF_TRIS)[None, :]
    filled = np.arange(LEAF_TRIS)[None, :] < count[leaf_nodes][:, None]
    prims = np.where(filled, order[np.minimum(slots, order.size - 1)], -1)
    safe = np.maximum(prims, 0)
    tri9 = np.concatenate([v0[safe], v1[safe] - v0[safe], v2[safe] - v0[safe]],
                          axis=-1)
    tri9 = np.where(filled[..., None], tri9, np.nan).astype(np.float32)

    # four-wide nodes, top down: a node's slots are its binary children, or
    # their children where they are internal
    wide = []            # per four-wide row: its binary slots, their refs
    level = [0]          # per four-wide row: its depth below the root
    queue = [0]
    while queue:
        nb = queue.pop(0)
        kids = [nb] if is_leaf[nb] else [int(left[nb]), int(right[nb])]
        slots_b = []
        for k in kids:
            slots_b.extend([k] if is_leaf[k] else [int(left[k]), int(right[k])])
        row_refs = []
        for k in slots_b:
            if is_leaf[k]:
                row_refs.append(-(int(leaf_of[k]) + 1))
            else:
                row_refs.append(len(level))
                level.append(level[len(wide)] + 1)
                queue.append(k)
        wide.append((slots_b, row_refs))
    m = len(wide)
    boxes = np.full((m, WIDTH, 6), np.nan, np.float32)
    refs = np.zeros((m, WIDTH), np.int32)
    for r, (slots_b, row_refs) in enumerate(wide):
        k = np.asarray(slots_b)
        boxes[r, :k.size, :3] = b_lo[k]
        boxes[r, :k.size, 3:] = b_hi[k]
        refs[r, :k.size] = row_refs
    depth = max(level) + 1

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return RefBVH(
        child_boxes=dev(boxes), child_refs=dev(refs),
        child_count=dev((~np.isnan(boxes[..., 0])).sum(axis=1).astype(np.int64)),
        leaf_tris=dev(tri9), leaf_prims=dev(prims.astype(np.int32)),
        leaf_count=dev(filled.sum(axis=1).astype(np.int64)),
        stack_size=(WIDTH - 1) * depth + 2, depth=depth)
