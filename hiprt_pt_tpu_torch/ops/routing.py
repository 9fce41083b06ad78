"""Which traversal kernel serves a batch of rays — the JAX package's routing
(``hiprt_pt_tpu/render/integrator.py:_make_tracers``, lines 100-140) on the
port's own tables.

The gates are the JAX package's structural gates, with their constants,
applied in its order; only its test for a TPU backend is left out. Its
ray-count conditions (a wavefront that is a multiple of 128 or 1024 rays)
are layout rules of the TPU kernels, which the port's kernels do not have,
so they are left out too. Where no gate holds the JAX package walks the
BVH in plain XLA. Its last two caps (MAX_STREAM8L_NODES, MAX_STREAM8L_LEAVES)
bound a table that its kernel holds in on-chip memory; the port's BVH8
kernels read their tables from device memory, so a scene past every gate
goes to them: coherent rays to trace_stream8, incoherent rays to
trace_lane8log, limited only by their stack (ops/traverse.py,
check_stack8_depth).

``tracer`` hands the integrator the wrapper of the routed kernel or, with
``RenderOptions.use_pallas_traversal`` off, that kernel's plain walk
(PLAIN_WALKS), which launches nothing on any device: the JAX package's
switch to its exact XLA walks (``render/integrator.py:74, 199``).
"""

from __future__ import annotations

# hiprt_pt_tpu/ops/pallas_traverse.py gate constants, with their lines
MAX_VMEM_NODES = 16384           # :52, pallas_supported (K3) — the port's
#                                  MAX_MEGANODE_ROWS keeps exactly such tables
MAX_COMPACT_NODES = 180224       # :377, pallas_wide_supported (K2): nodes4
#                                  rows <= MAX_COMPACT_NODES // 2 (:694)
L8S_MAX_PACK = 16384             # :1862, lane8s_tables_ok (K1) node rows
L8S_VMEM_BYTES = 100 * 1024 * 1024   # :2467, lane8s_tables_ok VMEM estimate
L8S_MAX_DEPTH = 16               # :2468, lane8s_tables_ok cluster depth
MAX_LANE8_NODES = 65536          # :1242, pallas_lane8_supported (K5)
MAX_LANE8_LEAF_BYTES = 48 * 1024 * 1024  # :1243
MAX_STREAM8L_NODES = 196608      # :1180, pallas_stream8l_supported (K4)
MAX_STREAM8L_LEAVES = 1 << 20    # :1181

# the BVHData tables each kernel reads (ops/cuda_traverse.py), with their
# row widths in floats
KERNEL_TABLES = {
    "trace_meganode": ("nodes",),
    "trace_coherent": ("nodes4", "leaf_rows"),
    "trace_incoherent": ("nodes4", "leaf_rows"),
    "trace_stream8": ("nodes8l", "leaf_rows8"),
    "trace_lane8log": ("nodes8l", "leaf_rows8"),
}
# the plain PyTorch version of each kernel (ops/traverse.py)
PLAIN_WALKS = {
    "trace_meganode": "traverse_meganode",
    "trace_coherent": "traverse",
    "trace_incoherent": "traverse",
    "trace_stream8": "traverse8",
    "trace_lane8log": "traverse8",
}
TABLE_WIDTHS = {"nodes": 128, "nodes4": 32, "leaf_rows": 128, "nodes8l": 64,
                "leaf_rows8": 128}


def lane8s_tables_ok(bvh) -> bool:
    """pallas_traverse.py:2449-2468 on the lane8 sizes."""
    s = bvh.lane8
    if s is None:
        return False
    vmem_est = s.leaf_bytes + s.leaves * 512 * 5 + s.nodes * 512 * 5
    return (s.nodes <= L8S_MAX_PACK and s.leaves < (1 << 24)
            and vmem_est <= L8S_VMEM_BYTES and s.depth <= L8S_MAX_DEPTH)


def lane8_ok(bvh) -> bool:
    """pallas_traverse.py:1246-1254 on the lane8 sizes."""
    s = bvh.lane8
    return (s is not None and s.nodes <= MAX_LANE8_NODES
            and s.leaf_bytes <= MAX_LANE8_LEAF_BYTES)


def stream8_ok(bvh) -> bool:
    """pallas_traverse.py:1184-1192 on nodes8l / leaf_rows8."""
    return (bvh.nodes8l is not None and bvh.leaf_rows8 is not None
            and bvh.nodes8l.shape[0] <= MAX_STREAM8L_NODES
            and bvh.leaf_rows8.shape[0] <= MAX_STREAM8L_LEAVES)


def meganode_ok(bvh) -> bool:
    """pallas_traverse.py:52, pallas_supported, on the kept meganode table."""
    return bvh.nodes is not None and bvh.nodes.shape[0] <= MAX_VMEM_NODES


def wide_ok(bvh) -> bool:
    """pallas_traverse.py:689-696, pallas_wide_supported, on nodes4."""
    return bvh.nodes4.shape[0] <= MAX_COMPACT_NODES // 2


def needs_bvh8(bvh) -> bool:
    """Whether a route of this scene reaches a BVH8 kernel, read from the
    tables built before the BVH8: no meganode table, and coherent rays past
    the BVH4 gate or incoherent rays past the lane8s gate (a scene past
    every gate is among them)."""
    return not meganode_ok(bvh) and not (wide_ok(bvh) and lane8s_tables_ok(bvh))


def route(bvh, coherent: bool) -> str:
    """The name of the kernel (ops/cuda_traverse.py) that serves a batch of
    rays: ``coherent`` rays are screen-tile packets (camera rays and the
    first bounce's shadow rays), the others scatter."""
    if meganode_ok(bvh):
        return "trace_meganode"
    if coherent and wide_ok(bvh):
        return "trace_coherent"
    if not coherent and lane8s_tables_ok(bvh):
        return "trace_incoherent"
    if not coherent and lane8_ok(bvh):
        return "trace_lane8log"
    if stream8_ok(bvh):
        return "trace_stream8"
    # past every gate of the JAX package: the BVH8 kernels, whose tables
    # have no size cap here
    if bvh.nodes8l is None or bvh.leaf_rows8 is None:
        raise ValueError(
            "this scene is past every BVH4 gate and its BVH has no BVH8 "
            f"tables: nodes4 {tuple(bvh.nodes4.shape)}, lane8 {bvh.lane8}; "
            "build it with accel/build.py:build_bvh")
    from .traverse import check_stack8_depth

    check_stack8_depth(bvh)
    return "trace_stream8" if coherent else "trace_lane8log"


def routed_tables(bvh) -> set:
    """The tables that the kernels of the scene's two routes read."""
    return {t for c in (True, False) for t in KERNEL_TABLES[route(bvh, c)]}


def tracer(bvh, coherent: bool, use_kernels: bool = True):
    """The wrapper (ops/cuda_traverse.py) of the kernel that ``route``
    picks; on CPU tensors it runs the kernel's plain version. With
    ``use_kernels`` off (RenderOptions.use_pallas_traversal): that kernel's
    plain walk (ops/traverse.py) itself, on whatever device the tensors
    lie; it launches no kernel of the port."""
    from . import cuda_traverse, traverse

    kernel = route(bvh, coherent)
    if not use_kernels:
        return getattr(traverse, PLAIN_WALKS[kernel])
    return getattr(cuda_traverse, kernel)


def _route_table(tri_scales) -> None:
    """Print, for the stress interior at each tri_scale, the table sizes the
    gates read and the two routes."""
    from ..accel.build import build_bvh
    from ..assets.stress import generate_stress_scene

    for ts in tri_scales:
        p = generate_stress_scene(tri_scale=float(ts), texture_size=32)
        bvh = build_bvh(p.vertices, p.triangles, "cpu", all_tables=True)
        s = bvh.lane8
        vmem = s.leaf_bytes + s.leaves * 512 * 5 + s.nodes * 512 * 5
        print(f"tri_scale {ts}: {p.triangles.shape[0]} triangles, nodes4 "
              f"{bvh.nodes4.shape[0]}, lane8 {s.nodes} / {s.leaves} x "
              f"{s.row_bytes} / {s.depth}, lane8s VMEM estimate "
              f"{vmem / 2**20:.1f} MiB, nodes8l {bvh.nodes8l.shape[0]}, "
              f"leaf_rows8 {bvh.leaf_rows8.shape[0]}, depth8 {bvh.depth8}; "
              f"routes {route(bvh, True)} / {route(bvh, False)}", flush=True)


if __name__ == "__main__":
    import sys

    _route_table(sys.argv[1:] or ["1", "11", "14", "17"])
