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
  nodes (M, 128) f32 — the meganode BVH2 of the native binned-SAH builder
      (leaves of up to 4 triangles embedded in their parent's row):
      [0:12] two child boxes, [12:16] c0_ref, c0_count, c1_ref, c1_count
      (int32 bits; count 0 = internal child, ref its row; count > 0 = a leaf
      of that many triangles in this row; count < 0 = empty slot, with a
      zero box), [16:52] and [52:88] up to 4 triangles [v0, e1, e2] per
      child (NaN padded), [88:96] their prim ids (-1 padded). Row 0 is the
      root. Kept only up to MAX_MEGANODE_ROWS rows (small scenes, whose
      every ray goes through trace_meganode); None above.

The BVH8 and lane8 tables of the JAX package exist for its TPU kernels and
are not built here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

LEAF_TRIS_COMPACT = 12  # fat-leaf capacity of a leaf row
MEGANODE_LEAF_TRIS = 4  # triangles of a leaf embedded in a meganode row
# the largest meganode table that is kept (8 MB of 512-byte rows); the JAX
# package's K3 holds it in VMEM up to the same count (MAX_VMEM_NODES)
MAX_MEGANODE_ROWS = 16384


@dataclasses.dataclass
class BVHData:
    nodes4: torch.Tensor     # (M4, 32) f32
    leaf_rows: torch.Tensor  # (L, 128) f32
    tri_rows: torch.Tensor   # (T, 12) f32
    # max internal-node depth of nodes4 (root = 1); bounds traversal stacks
    depth4: int
    nodes: Optional[torch.Tensor] = None  # (M, 128) f32, M <= MAX_MEGANODE_ROWS
    # max row depth of the meganode tree (root = 1); bounds its stacks
    depth2: int = 0

    def to(self, device) -> "BVHData":
        return dataclasses.replace(
            self, nodes4=self.nodes4.to(device),
            leaf_rows=self.leaf_rows.to(device),
            tri_rows=self.tri_rows.to(device),
            nodes=None if self.nodes is None else self.nodes.to(device))

    @property
    def nbytes(self) -> int:
        tables = (self.nodes4, self.leaf_rows, self.tri_rows, self.nodes)
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


def build_bvh(vertices: np.ndarray, triangles: np.ndarray,
              device="cpu") -> BVHData:
    """SBVH build on the host, tables moved to ``device``; the meganode
    table is built too and moved only when it has at most
    MAX_MEGANODE_ROWS rows."""
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

    bounds, meta, order = build_bvh_raw_native(
        vertices, triangles, LEAF_TRIS_COMPACT)
    n16, lrows = _compact_from_raw(bounds, meta, order, vertices, triangles)
    if bounds.shape[0] == 1:
        # the whole scene is one leaf: a root row with that leaf as child 0
        nodes4 = np.zeros((1, 32), np.float32)
        nodes4[0, 0:24] = np.nan
        nodes4[0, 0:6] = bounds[0]
        nodes4[0, 24:28] = np.asarray([-2, 0, 0, 0], np.int32).view(np.float32)
        depth4 = 1
    else:
        nodes4, depth4 = _collapse4(n16)

    rows = build_bvh_native(vertices, triangles, MEGANODE_LEAF_TRIS)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    small = rows.shape[0] <= MAX_MEGANODE_ROWS
    return BVHData(nodes4=t(nodes4), leaf_rows=t(lrows), tri_rows=t(tri_rows),
                   depth4=int(depth4), nodes=t(rows) if small else None,
                   depth2=meganode_depth(rows))
