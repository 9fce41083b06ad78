"""Host-side BVH build, mirroring ``hiprt_pt_tpu.accel.build``.

The native SBVH builder makes a BVH2 with fat leaves of up to 12 triangles;
it is packed into exactly the tables the port's traversal reads, with the
JAX package's layouts and numbers:

  nodes4 (M4, 32) f32 — BVH4 rows: [0:24] four child boxes (min xyz, max
      xyz; NaN for an empty slot, whose ref is 0), [24:28] child refs
      (int32 bits): ref >= 0 is a nodes4 row, ref < 0 is leaf row -(ref+1);
      [28:32] zero. Row 0 is the root.
  leaf_rows (L, 128) f32 — [0:108] up to 12 triangles [v0, e1, e2] (NaN
      padded), [108:120] prim ids (int32 bits, -1 padded), [120] leaf flag
      1.0, [121] triangle count. Row 0 is an all-zero dummy.
  tri_rows (T, 12) f32 — per triangle [v0, e1, e2, 0, 0, 0].
  nodes8l (M8, 64) f32 — the BVH8 collapse of the same BVH2 with a
      consecutive-children layout: [0:48] up to 8 child boxes, internal
      children first (NaN = empty), [48] word A (int32 bits) = first
      internal child row | n_internal << 26, [49] word B (int32 bits) =
      first leaf row of leaf_rows8; child c < n_internal is node row
      A.base + c, child c >= n_internal is leaf row B.base + (c - n_int).
      Row 0 is the root.
  leaf_rows8 (L8, 128) f32 — leaf_rows re-emitted in nodes8l's leaf order
      (row 0 the dummy), same layout.
  nodes (M, 128) f32 — the meganode BVH2 of the native binned-SAH builder
      (leaves of up to 4 triangles embedded in their parent's row):
      [0:12] two child boxes, [12:16] c0_ref, c0_count, c1_ref, c1_count
      (int32 bits; count 0 = internal child, ref its row; count > 0 = a leaf
      of that many triangles in this row; count < 0 = empty slot, with a
      zero box), [16:52] and [52:88] up to 4 triangles [v0, e1, e2] per
      child (NaN padded), [88:96] their prim ids (-1 padded). Row 0 is the
      root. Kept only up to MAX_MEGANODE_ROWS rows (small scenes, whose
      every ray goes through trace_meganode); None above.

``build_bvh`` keeps ``leaf_rows``, ``nodes8l`` + ``leaf_rows8`` and ``nodes``
only where a kernel that the router (ops/routing.py) picks for the scene
reads them; the others are None. Its stages (STAGES) are host spans
``bvh/<stage>`` of one set-up step (utils/spans.py), which a reader finds
after any number of frames.

The JAX package's lane8 tables (bf16 boxes, int8 lattice leaves over a BVH8
of 128-triangle cluster leaves) exist for the TPU's matrix unit and are not
built; only their sizes are (``Lane8Sizes``), so that the router takes the
JAX package's routing decisions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops import routing
from ..utils import spans

LEAF_TRIS_COMPACT = 12  # fat-leaf capacity of a leaf row
MEGANODE_LEAF_TRIS = 4  # triangles of a leaf embedded in a meganode row
# the largest meganode table that is kept (8 MB of 512-byte rows); the JAX
# package's K3 holds it in VMEM up to the same count (MAX_VMEM_NODES)
MAX_MEGANODE_ROWS = 16384
LANE8_LEAF_TRIS = 128   # cluster-leaf capacity of the JAX package's lane8 tables
# the lane8 leaves store 12-bit instead of 16-bit coordinates above this many
# triangles (the JAX package's LEAF_BITS_AUTO_TRIS)
LEAF_BITS_AUTO_TRIS = 600_000
# build_bvh's stages, in their order: the native SBVH's BVH2, its leaf and
# node rows, the BVH4 collapse, the native meganode build, the lane8 sizes,
# the BVH8 collapse, the kept tables' copy to the device
STAGES = ("raw_sbvh", "compact_rows", "collapse4", "meganode_rows",
          "lane8_sizes", "collapse8", "upload")


@dataclasses.dataclass(frozen=True)
class Lane8Sizes:
    """The sizes of the JAX package's lane8 tables for this scene, which its
    routing gates read: cluster-BVH8 node rows (``nodes_lane8.shape[0]``),
    leaf rows and leaf row bytes (``leaves_lane8.shape``) and the cluster
    tree's depth (``lane8_depth``)."""
    nodes: int
    leaves: int
    row_bytes: int
    depth: int

    @property
    def leaf_bytes(self) -> int:
        return self.leaves * self.row_bytes


@dataclasses.dataclass
class BVHData:
    nodes4: torch.Tensor     # (M4, 32) f32
    leaf_rows: Optional[torch.Tensor]  # (L, 128) f32
    tri_rows: torch.Tensor   # (T, 12) f32
    # max internal-node depth of nodes4 (root = 1); bounds traversal stacks
    depth4: int
    nodes: Optional[torch.Tensor] = None  # (M, 128) f32, M <= MAX_MEGANODE_ROWS
    # max row depth of the meganode tree (root = 1); bounds its stacks
    depth2: int = 0
    nodes8l: Optional[torch.Tensor] = None     # (M8, 64) f32
    leaf_rows8: Optional[torch.Tensor] = None  # (L8, 128) f32
    # max node depth of nodes8l (root = 1); bounds the BVH8 walks' stacks
    depth8: int = 0
    lane8: Optional[Lane8Sizes] = None

    def to(self, device) -> "BVHData":
        def mv(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, nodes4=mv(self.nodes4), leaf_rows=mv(self.leaf_rows),
            tri_rows=mv(self.tri_rows), nodes=mv(self.nodes),
            nodes8l=mv(self.nodes8l), leaf_rows8=mv(self.leaf_rows8))

    @property
    def nbytes(self) -> int:
        tables = (self.nodes4, self.leaf_rows, self.tri_rows, self.nodes,
                  self.nodes8l, self.leaf_rows8)
        return sum(t.numel() * t.element_size() for t in tables if t is not None)


def meganode_depth(rows: np.ndarray) -> int:
    """Max row depth (root = 1) of a meganode table: a child slot with
    count 0 is an internal child whose ref is its row."""
    meta = np.ascontiguousarray(rows[:, 12:16]).view(np.int32)
    frontier = np.zeros((1,), np.int64)
    depth = 0
    while frontier.size:
        depth += 1
        m = meta[frontier]
        frontier = np.concatenate([m[m[:, 1] == 0, 0], m[m[:, 3] == 0, 2]]
                                  ).astype(np.int64)
    return depth


def _compact_from_raw(bounds, meta, order, vertices, triangles):
    """Raw BVH2 (fat leaves, max_leaf=12) → (nodes16, leaf_rows)."""
    M = bounds.shape[0]
    left = meta[:, 0]
    count = meta[:, 1]
    is_leaf = count > 0
    internal = np.nonzero(~is_leaf)[0]
    id_map = np.full((M,), -1, np.int64)
    id_map[internal] = np.arange(len(internal))
    leaf_nodes = np.nonzero(is_leaf)[0]
    leaf_id = np.full((M,), 0, np.int64)
    leaf_id[leaf_nodes] = 1 + np.arange(len(leaf_nodes))
    L = len(leaf_nodes) + 1

    # --- leaf rows ---
    lrows = np.zeros((L, 128), np.float32)
    neg1 = np.asarray([-1], np.int32).view(np.float32)[0]
    lrows[:, 108:120] = neg1
    lrows[0] = 0.0
    if len(leaf_nodes):
        cnt = count[leaf_nodes]
        offs = left[leaf_nodes][:, None] + np.arange(LEAF_TRIS_COMPACT)[None, :]
        valid = np.arange(LEAF_TRIS_COMPACT)[None, :] < cnt[:, None]
        tri_idx = order[np.clip(offs, 0, len(order) - 1)]
        v0 = vertices[triangles[tri_idx, 0]]
        e1 = vertices[triangles[tri_idx, 1]] - v0
        e2 = vertices[triangles[tri_idx, 2]] - v0
        tri9 = np.concatenate([v0, e1, e2], axis=-1)  # (Lf, 12, 9)
        tri9 = np.where(valid[..., None], tri9, np.nan)
        lrows[1:, 0:108] = tri9.reshape(len(leaf_nodes), 108)
        ids = np.where(valid, tri_idx, -1).astype(np.int32)
        lrows[1:, 108:120] = ids.view(np.float32)
        lrows[1:, 120] = 1.0
        lrows[1:, 121] = cnt.astype(np.float32)

    # --- internal 16-float rows ---
    Mi = max(len(internal), 1)
    n16 = np.zeros((Mi, 16), np.float32)
    refs = np.zeros((Mi, 2), np.int32)
    cnts = np.zeros((Mi, 2), np.int32)
    if len(internal):
        c0 = left[internal]
        c1 = c0 + 1
        n16[:, 0:6] = bounds[c0]
        n16[:, 6:12] = bounds[c1]
        for j, ch in enumerate((c0, c1)):
            ch_leaf = is_leaf[ch]
            refs[:, j] = np.where(
                ch_leaf, -(leaf_id[ch] + 1), id_map[ch]
            ).astype(np.int32)
            cnts[:, j] = np.where(ch_leaf, count[ch], 0).astype(np.int32)
    meta16 = np.stack(
        [refs[:, 0], cnts[:, 0], refs[:, 1], cnts[:, 1]], axis=1
    ).astype(np.int32)
    n16[:, 12:16] = meta16.view(np.float32)
    return n16, lrows


def _collapse4(n16: np.ndarray):
    """BVH2 16-float rows → (BVH4 32-float rows, depth) by pulling
    grandchildren up; depth is the max internal-node depth (root = 1)."""
    meta = n16[:, 12:16].view(np.int32)
    boxes = n16[:, :12].reshape(n16.shape[0], 2, 6)
    refs2 = np.stack([meta[:, 0], meta[:, 2]], 1)
    cnts2 = np.stack([meta[:, 1], meta[:, 3]], 1)

    kept = [0]
    new_id = {0: 0}
    depth = {0: 1}
    rows_children = []
    qi = 0
    while qi < len(kept):
        n = kept[qi]
        qi += 1
        ch = []
        for c in range(2):
            if cnts2[n, c] > 0 or refs2[n, c] < 0:
                ch.append((boxes[n, c], ("leaf", refs2[n, c])))
            else:
                g = refs2[n, c]
                for gc in range(2):
                    if cnts2[g, gc] > 0 or refs2[g, gc] < 0:
                        ch.append((boxes[g, gc], ("leaf", refs2[g, gc])))
                    else:
                        t = refs2[g, gc]
                        if t not in new_id:
                            new_id[t] = len(new_id)
                            depth[t] = depth[n] + 1
                            kept.append(t)
                        ch.append((boxes[g, gc], ("node", t)))
        rows_children.append((n, ch))

    out = np.zeros((len(rows_children), 32), np.float32)
    out[:, 0:24] = np.nan
    refs4 = np.zeros((len(rows_children), 4), np.int32)
    for (n, ch) in rows_children:
        r = new_id[n]
        for ci, (box, (kind, ref)) in enumerate(ch[:4]):
            out[r, ci * 6:(ci + 1) * 6] = box
            refs4[r, ci] = new_id[ref] if kind == "node" else ref
    out[:, 24:28] = refs4.view(np.float32)
    return out, max(depth.values())


def _cluster_from_raw(bounds, meta, order, leaf_tris: int):
    """Raw BVH2 (max_leaf=leaf_tris) → (n16, prims (L, Tc) i64, counts (L,)):
    the node rows of _compact_from_raw over padded prim-id leaves, dummy
    leaf row 0 kept. A root-is-leaf scene gets an internal root (the leaf as
    child 0, child 1 empty)."""
    M = bounds.shape[0]
    left = meta[:, 0]
    count = meta[:, 1]
    is_leaf = count > 0
    internal = np.nonzero(~is_leaf)[0]
    leaf_nodes = np.nonzero(is_leaf)[0]
    Tc = leaf_tris
    L = len(leaf_nodes) + 1
    prims = np.full((L, Tc), -1, np.int64)
    counts = np.zeros((L,), np.int64)
    if len(leaf_nodes):
        cnt = count[leaf_nodes]
        offs = left[leaf_nodes][:, None] + np.arange(Tc)[None, :]
        valid = np.arange(Tc)[None, :] < cnt[:, None]
        tri_idx = order[np.clip(offs, 0, len(order) - 1)]
        prims[1:] = np.where(valid, tri_idx, -1)
        counts[1:] = cnt
    if not len(internal):
        n16 = np.zeros((1, 16), np.float32)
        if M:
            n16[0, 0:6] = bounds[0]
        m16 = np.asarray([[-2, int(count[0]) if M else 0, 0, -1]], np.int32)
        n16[:, 12:16] = m16.view(np.float32)
        return n16, prims, counts
    id_map = np.full((M,), -1, np.int64)
    id_map[internal] = np.arange(len(internal))
    leaf_id = np.zeros((M,), np.int64)
    leaf_id[leaf_nodes] = 1 + np.arange(len(leaf_nodes))
    n16 = np.zeros((len(internal), 16), np.float32)
    c0 = left[internal]
    c1 = c0 + 1
    n16[:, 0:6] = bounds[c0]
    n16[:, 6:12] = bounds[c1]
    refs = np.zeros((len(internal), 2), np.int32)
    cnts = np.zeros((len(internal), 2), np.int32)
    for j, ch in enumerate((c0, c1)):
        ch_leaf = is_leaf[ch]
        refs[:, j] = np.where(ch_leaf, -(leaf_id[ch] + 1), id_map[ch]).astype(np.int32)
        cnts[:, j] = np.where(ch_leaf, count[ch], 0).astype(np.int32)
    meta16 = np.stack([refs[:, 0], cnts[:, 0], refs[:, 1], cnts[:, 1]],
                      axis=1).astype(np.int32)
    n16[:, 12:16] = meta16.view(np.float32)
    return n16, prims, counts


def depth8_of(n8l: np.ndarray) -> int:
    """Max node depth (root = 1) of a linear BVH8 node table."""
    M = n8l.shape[0]
    wa = np.ascontiguousarray(n8l[:, 48]).view(np.int32)
    base = wa & ((1 << 26) - 1)
    n_int = wa >> 26
    depth = np.zeros((M,), np.int32)
    depth[0] = 1
    for r in np.nonzero(n_int)[0]:
        depth[base[r]:base[r] + n_int[r]] = depth[r] + 1
    return int(depth.max(initial=1))


def collapse8_linear(n16: np.ndarray, leaf_rows: np.ndarray):
    """BVH2 16-float rows → (nodes8l (M8, 64), leaf_rows8 (L8, 128), src):
    the JAX package's ``_collapse8_linear``, with its numbers. Each node
    starts from its two BVH2 children and expands, while it has fewer than
    8 entries, the internal entry with the smallest subtree leaf count that
    still fits whole, else the one with the largest box area; entries are
    sorted internal-first and numbered breadth-first, so a node's internal
    children are consecutive node rows and its leaf children consecutive
    leaf rows. ``src`` holds each new leaf row's old leaf row (-1 for the
    dummy row 0)."""
    M = n16.shape[0]
    meta = n16[:, 12:16].view(np.int32)
    boxes = n16[:, :12].reshape(M, 2, 6)
    refs2 = np.stack([meta[:, 0], meta[:, 2]], 1)
    cnts2 = np.stack([meta[:, 1], meta[:, 3]], 1)

    def is_leaf_child(n, c):
        return cnts2[n, c] > 0 or refs2[n, c] < 0

    def empty_slot(n, c):
        # count < 0, or the all-zero meta of a single-leaf scene's root
        return cnts2[n, c] < 0 or (cnts2[n, c] == 0 and refs2[n, c] == 0)

    nleaf = np.full(M, -1, np.int64)  # subtree leaf-ref counts, post-order

    def subtree_leaves(root):
        stack = [root]
        while stack:
            n = stack[-1]
            if nleaf[n] >= 0:
                stack.pop()
                continue
            total = 0
            ready = True
            for c in range(2):
                if empty_slot(n, c):
                    continue
                if is_leaf_child(n, c):
                    total += 1
                elif nleaf[refs2[n, c]] < 0:
                    stack.append(refs2[n, c])
                    ready = False
                else:
                    total += nleaf[refs2[n, c]]
            if ready:
                nleaf[n] = total
                stack.pop()
        return nleaf[root]

    def entry(n, c):
        return (boxes[n, c], "leaf" if is_leaf_child(n, c) else "node",
                refs2[n, c])

    def children8(n):
        ch = [entry(n, c) for c in range(2) if not empty_slot(n, c)]
        while len(ch) < 8:
            best, best_n = -1, 1 << 60
            for i, (_box, kind, r) in enumerate(ch):
                if kind == "node":
                    s = subtree_leaves(r)
                    if s < best_n and len(ch) - 1 + s <= 8:
                        best, best_n = i, s
            if best < 0:
                best_a = -1.0
                for i, (box, kind, _r) in enumerate(ch):
                    if kind == "node":
                        dx = max(float(box[3] - box[0]), 0.0)
                        dy = max(float(box[4] - box[1]), 0.0)
                        dz = max(float(box[5] - box[2]), 0.0)
                        a = dx * dy + dy * dz + dz * dx
                        if a > best_a:
                            best, best_a = i, a
            if best < 0:
                break
            _box, _kind, r = ch.pop(best)
            ch.extend(entry(r, c) for c in range(2))
        ch.sort(key=lambda e: 0 if e[1] == "node" else 1)
        return ch

    def degenerate_children():
        # single-leaf scene: one leaf child (row 1), boxed from its triangles
        if leaf_rows.shape[0] < 2:
            return []
        tris = leaf_rows[1, 0:108].reshape(12, 9)
        v0, e1, e2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
        pts = np.concatenate([v0, v0 + e1, v0 + e2])
        box = np.concatenate([np.nanmin(pts, axis=0),
                              np.nanmax(pts, axis=0)]).astype(np.float32)
        return [(box, "leaf", np.int32(-2))]

    rows_out = []  # per new node: (entries, n_int, base_int, base_leaf)
    queue = [0]    # BVH2 rows in new-id order
    next_node = 1
    leaf_src = [0]  # old leaf row + 1 per new leaf row (0 = dummy)
    qi = 0
    while qi < len(queue):
        n = queue[qi]
        qi += 1
        ch = children8(n)
        if not ch and n == 0:
            ch = degenerate_children()
        n_int = sum(1 for e in ch if e[1] == "node")
        base_int = next_node
        queue.extend(e[2] for e in ch if e[1] == "node")
        next_node += n_int
        base_leaf = len(leaf_src)
        leaf_src.extend(-e[2] for e in ch if e[1] == "leaf")
        rows_out.append((ch, n_int, base_int, base_leaf))

    M8 = len(rows_out)
    out = np.zeros((M8, 64), np.float32)
    out[:, 0:48] = np.nan
    wa = np.zeros((M8,), np.int32)
    wb = np.zeros((M8,), np.int32)
    for r, (ch, n_int, base_int, base_leaf) in enumerate(rows_out):
        for ci, (box, _kind, _ref) in enumerate(ch):
            out[r, ci * 6:(ci + 1) * 6] = box
        wa[r] = base_int | (n_int << 26)
        wb[r] = base_leaf
    out[:, 48] = wa.view(np.float32)
    out[:, 49] = wb.view(np.float32)
    src = np.asarray(leaf_src, np.int64) - 1
    lr = leaf_rows[np.maximum(src, 0)]
    lr[0] = 0.0
    return out, np.ascontiguousarray(lr), src


def lane8_sizes(vertices: np.ndarray, triangles: np.ndarray,
                leaf_tris: int = LANE8_LEAF_TRIS) -> Lane8Sizes:
    """The sizes of the JAX package's lane8 tables (``_lane8_cluster_tables``
    without its ``_pack_lane8``): a BVH2 of up to ``leaf_tris``-triangle
    cluster leaves, collapsed to a linear BVH8. A leaf row holds 18 bytes a
    triangle slot at 16-bit coordinates, 14 at 12-bit (above
    LEAF_BITS_AUTO_TRIS triangles), plus 14 bytes, rounded up to 8."""
    from .native import build_bvh_raw_native

    raw = build_bvh_raw_native(vertices, triangles, leaf_tris)
    n16c, primsc, _counts = _cluster_from_raw(*raw, leaf_tris)
    n8lc, _lr, src = collapse8_linear(
        n16c, np.zeros((primsc.shape[0], 1), np.float32))
    per_slot = 14 if triangles.shape[0] > LEAF_BITS_AUTO_TRIS else 18
    row_bytes = -(-(per_slot * leaf_tris + 14) // 8) * 8
    return Lane8Sizes(nodes=n8lc.shape[0], leaves=src.shape[0],
                      row_bytes=row_bytes, depth=depth8_of(n8lc))


def build_bvh(vertices: np.ndarray, triangles: np.ndarray, device=None,
              all_tables: bool = False, timings: Optional[dict] = None) -> BVHData:
    """SBVH build on the host, tables moved to ``device`` (default: the GPU,
    see core/device.py:resolve_device). The router's gates (ops/routing.py)
    pick the kernels that serve the scene's coherent and incoherent rays,
    and only the tables those kernels read are kept: the meganode table when
    it has at most MAX_MEGANODE_ROWS rows; else ``leaf_rows`` when a BVH4
    kernel serves a route and the BVH8 (built only then) when a BVH8 kernel
    does. ``nodes4`` and ``tri_rows`` are always kept, and the lane8 sizes
    are computed for every scene without a meganode table. ``all_tables``
    builds and keeps every table. Given ``timings``, adds the seconds of
    each stage that ran to it as "bvh/<stage>" (STAGES)."""
    with spans.step("cpu", keep=True):
        return _build(vertices, triangles, resolve_device(device), all_tables,
                      timings)


@contextlib.contextmanager
def _stage(name: str, timings: Optional[dict]):
    """One stage of build_bvh: a host span "bvh/<name>", and its seconds in
    ``timings`` where given."""
    t0 = time.perf_counter()
    with spans.span("bvh/" + name):
        yield
    if timings is not None:
        timings["bvh/" + name] = time.perf_counter() - t0


def _build(vertices, triangles, device, all_tables: bool,
           timings: Optional[dict]) -> BVHData:
    from .native import build_bvh_native, build_bvh_raw_native

    vertices = np.asarray(vertices, dtype=np.float32)
    triangles = np.asarray(triangles, dtype=np.int64)
    T = triangles.shape[0]
    tv0 = vertices[triangles[:, 0]]
    tri_rows = np.zeros((max(T, 1), 12), np.float32)
    if T:
        tri_rows[:, 0:3] = tv0
        tri_rows[:, 3:6] = vertices[triangles[:, 1]] - tv0
        tri_rows[:, 6:9] = vertices[triangles[:, 2]] - tv0

    with _stage("raw_sbvh", timings):
        bounds, meta, order = build_bvh_raw_native(
            vertices, triangles, LEAF_TRIS_COMPACT)
    with _stage("compact_rows", timings):
        n16, lrows = _compact_from_raw(bounds, meta, order, vertices, triangles)
    with _stage("collapse4", timings):
        if bounds.shape[0] == 1:
            # the whole scene is one leaf: a root row with that leaf as child 0
            nodes4 = np.zeros((1, 32), np.float32)
            nodes4[0, 0:24] = np.nan
            nodes4[0, 0:6] = bounds[0]
            nodes4[0, 24:28] = np.asarray([-2, 0, 0, 0], np.int32).view(np.float32)
            depth4 = 1
        else:
            nodes4, depth4 = _collapse4(n16)
    with _stage("meganode_rows", timings):
        rows = build_bvh_native(vertices, triangles, MEGANODE_LEAF_TRIS)
        depth2 = meganode_depth(rows)
    small = rows.shape[0] <= MAX_MEGANODE_ROWS

    def t(x):  # host tensors until the kept ones are moved
        return torch.from_numpy(np.ascontiguousarray(x))

    bvh = BVHData(nodes4=t(nodes4), leaf_rows=t(lrows), tri_rows=t(tri_rows),
                  depth4=int(depth4), nodes=t(rows) if small else None,
                  depth2=depth2)
    if all_tables or not small:
        with _stage("lane8_sizes", timings):
            bvh.lane8 = lane8_sizes(vertices, triangles)
    if all_tables or routing.needs_bvh8(bvh):
        with _stage("collapse8", timings):
            n8l, lr8, _src = collapse8_linear(n16, lrows)
            bvh.nodes8l, bvh.leaf_rows8 = t(n8l), t(lr8)
            bvh.depth8 = depth8_of(n8l)
    if not all_tables:
        keep = routing.routed_tables(bvh)
        bvh = dataclasses.replace(bvh, **{
            k: None for k in ("nodes", "leaf_rows", "nodes8l", "leaf_rows8")
            if k not in keep})
    with _stage("upload", timings):
        return bvh.to(device)
