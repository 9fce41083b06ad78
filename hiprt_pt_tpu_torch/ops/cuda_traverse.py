"""Hopper traversal kernels (csrc/traverse.cu, csrc/traverse8.cu) and their
wrappers — the counterpart of ``hiprt_pt_tpu/ops/pallas_traverse.py``.

- ``trace_incoherent``: one persistent thread per ray over the BVH4
  (``nodes4`` + ``leaf_rows``), refilled from a global ray counter, as a
  while-while walk (the warp descends together, then tests leaves together;
  the nearest child stays in a register, a pop skips entries the ray has
  passed, leaves are read with 16-byte loads); replaces the TPU kernel
  ``_kernel_lane8s`` (K1).
- ``trace_coherent``: a 32-ray packet per warp (a 16x2 strip of a screen
  tile in the tile-major order) in persistent warps that draw packets from
  a global counter; one stack a warp in shared memory, every decision a
  warp vote, children near to far by the packet's least entry distance,
  entries dropped at the pop once their lanes have passed them, leaves by
  16-byte loads at one address for the warp; a packet whose rays diverge
  leaves packet mode and its lanes finish with ``trace_incoherent``'s
  per-ray walk (``coherent_packets`` reads how many did); replaces
  ``_kernel_compact4`` (K2).
- ``trace_meganode``: the same per-ray while-while walk over the meganode
  table ``bvh.nodes`` (a visit reads the row's 64 bytes of boxes and refs;
  a leaf child's triangles only when the ray hits its box); replaces
  ``_kernel`` / ``traverse_pallas`` (K3).
- ``trace_stream8``: one persistent thread per ray over the BVH8
  (``nodes8l`` + ``leaf_rows8``), the while-while walk of
  ``trace_lane8log`` (one template in csrc/traverse8.cu) with
  ``trace_incoherent``'s refill of half a warp, so that a warp's rays stay
  neighbours in a screen tile; replaces ``_kernel_stream8l`` (K4).
- ``trace_lane8log``: one persistent thread per ray over the BVH8, refilled
  from a global ray counter as soon as a ray ends, the same while-while
  walk; replaces ``_kernel_lane8log`` (K5).

Which kernel serves which rays is the router's decision (ops/routing.py).
A wrapper given CPU tensors runs the plain version (ops/traverse.py). Given
CUDA tensors it launches its kernel, or raises: there is no fallback. The
sources are compiled with nvcc at first use and bound with ctypes
(ops/cuda_build.py), which launches them and counts their launches in
``cuda_build.launch_counts``. Each wrapper's call, on either device, is the
span "trace/<kernel>" with the counters "launches/<kernel>" and
"rays/<kernel>" (utils/spans.py).
"""

from __future__ import annotations

import torch

from ..utils import spans
from . import cuda_build
from . import traverse as plain
from .cuda_build import check_tensor
from .routing import KERNEL_TABLES, TABLE_WIDTHS
from .traverse import (HitRecord, check_meganode_depth, check_stack8_depth,
                       check_stack_depth, per_ray)

# kernel -> its zeroed int64 scratch words: the counter a persistent kernel
# draws its rays or packets from; for trace_coherent also the count of
# packets that left packet mode
_SCRATCH_WORDS = {"trace_coherent": 2, "trace_incoherent": 1,
                  "trace_meganode": 1, "trace_stream8": 1, "trace_lane8log": 1}
# trace_coherent's last launch: its scratch words and its ray count (read by
# coherent_packets)
_coherent_last: list = []


def routed_kernel_info(bvh) -> dict:
    """{kernel: {"closest" | "any_hit": {registers, local_bytes,
    shared_bytes, blocks_per_sm}}} of the kernels that ``bvh``'s rays route
    to (ops/routing.py), from their libraries' *_info functions; builds and
    loads the libraries where needed. Raises where a build or a query
    fails."""
    from .routing import route

    return {k: {mode: cuda_build.kernel_info(k, flag)
                for mode, flag in (("closest", 0), ("any_hit", 1))}
            for k in sorted({route(bvh, True), route(bvh, False)})}


def _tables(kernel: str, bvh, dev) -> tuple:
    """The table pointers of ``kernel``, after checking the tables and that
    the deepest walk fits the kernel's stack."""
    if kernel == "trace_meganode":
        check_meganode_depth(bvh)
    elif kernel in ("trace_stream8", "trace_lane8log"):
        check_stack8_depth(bvh)
    else:
        check_stack_depth(bvh)
    ptrs = []
    for name in KERNEL_TABLES[kernel]:
        t = getattr(bvh, name)
        check_tensor(name, t, torch.float32, (t.shape[0], TABLE_WIDTHS[name]),
                     dev)
        ptrs.append(t.data_ptr())
    return tuple(ptrs)


def _launch(kernel: str, bvh, o, d, t_min, t_max, active, any_hit) -> HitRecord:
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {dev}")
    n = o.shape[0]
    check_tensor("o", o, torch.float32, (n, 3), dev)
    check_tensor("d", d, torch.float32, (n, 3), dev)
    tables = _tables(kernel, bvh, dev)
    tmin = per_ray(t_min, n, dev)
    tmax = per_ray(t_max, n, dev)
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    check_tensor("active", active, torch.bool, (n,), dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    scratch = torch.zeros((_SCRATCH_WORDS[kernel],), dtype=torch.int64,
                          device=dev)
    cuda_build.launch(kernel, dev, *tables,
                      o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
                      tmax.data_ptr(), active.data_ptr(), n, int(any_hit),
                      scratch.data_ptr(), t.data_ptr(), prim.data_ptr(),
                      u.data_ptr(), v.data_ptr())
    if kernel == "trace_coherent":
        _coherent_last[:] = [scratch, n]
    return HitRecord(t=t, prim=prim, u=u, v=v)


def coherent_packets() -> tuple:
    """(packets that left packet mode, packets) of trace_coherent's last
    launch on the card; waits for that launch."""
    if not _coherent_last:
        raise RuntimeError("trace_coherent has not been launched")
    scratch, n = _coherent_last
    return int(scratch[1]), -(-n // 32)


def _trace(kernel: str, walk, bvh, o, d, t_min, t_max, active,
           any_hit: bool) -> HitRecord:
    """One traversal call of ``kernel``: its plain ``walk`` on CPU tensors,
    its launch on CUDA tensors; inside the span "trace/<kernel>", counted
    in the step's counters "launches/<kernel>" and "rays/<kernel>" (the
    rays handed over, active or not)."""
    with spans.step(o.device), spans.span("trace/" + kernel):
        if o.device.type == "cpu":
            hit = walk(bvh, o, d, t_min, t_max, active, any_hit=any_hit)
        else:
            hit = _launch(kernel, bvh, o, d, t_min, t_max, active, any_hit)
        spans.count("launches/" + kernel)
        spans.count("rays/" + kernel, int(o.shape[0]))
    return hit


def trace_incoherent(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None,
                     any_hit: bool = False) -> HitRecord:
    """Per-ray BVH4 while-while walk in persistent threads with a ray-pool
    refill (K1 port)."""
    return _trace("trace_incoherent", plain.traverse, bvh, o, d, t_min, t_max,
                  active, any_hit)


def trace_coherent(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None,
                   any_hit: bool = False) -> HitRecord:
    """32-ray warp-packet BVH4 walk in persistent warps, with a way out into
    the per-ray walk for packets that diverge (K2 port); rays in tile-major
    order."""
    return _trace("trace_coherent", plain.traverse, bvh, o, d, t_min, t_max,
                  active, any_hit)


def trace_meganode(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None,
                   any_hit: bool = False) -> HitRecord:
    """Per-ray while-while walk over the meganode table in persistent
    threads with a ray-pool refill (K3 port). Needs ``bvh.nodes``."""
    return _trace("trace_meganode", plain.traverse_meganode, bvh, o, d, t_min,
                  t_max, active, any_hit)


def trace_stream8(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None,
                  any_hit: bool = False) -> HitRecord:
    """Per-ray BVH8 while-while walk for coherent rays in persistent
    threads, refilled half a warp at a time (K4 port); rays in tile-major
    order. Needs ``bvh.nodes8l``."""
    return _trace("trace_stream8", plain.traverse8, bvh, o, d, t_min, t_max,
                  active, any_hit)


def trace_lane8log(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None,
                   any_hit: bool = False) -> HitRecord:
    """Per-ray BVH8 while-while walk in persistent threads with a ray-pool
    refill (K5 port). Needs ``bvh.nodes8l``."""
    return _trace("trace_lane8log", plain.traverse8, bvh, o, d, t_min, t_max,
                  active, any_hit)
