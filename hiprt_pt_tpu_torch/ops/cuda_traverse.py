"""Hopper traversal kernels (csrc/traverse.cu) and their wrappers — the
counterpart of ``hiprt_pt_tpu/ops/pallas_traverse.py``.

- ``trace_incoherent``: one thread per ray over the BVH4; replaces the TPU
  kernel ``_kernel_lane8s`` (K1). Serves bounce rays and shadow rays after
  the first bounce.
- ``trace_coherent``: a 128-ray packet per block with one shared stack;
  replaces ``_kernel_compact4`` (K2). Serves camera rays and the first
  bounce's shadow rays.
- ``trace_meganode``: a 128-ray packet per block over the meganode table
  ``bvh.nodes``; replaces ``_kernel`` / ``traverse_pallas`` (K3). Serves
  every ray of a scene whose meganode table is kept (at most
  MAX_MEGANODE_ROWS rows, accel/build.py).

A wrapper given CPU tensors runs the plain version (ops/traverse.py). Given
CUDA tensors it launches its kernel, or raises: there is no fallback. The
kernels are compiled with nvcc at first use into ``_build/`` and bound with
ctypes. ``launch_counts`` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from . import traverse as plain
from .traverse import (HitRecord, check_meganode_depth, check_stack_depth,
                       per_ray)
from ..utils.native_build import build_shared

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                      "traverse.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

launch_counts = {"trace_coherent": 0, "trace_incoherent": 0,
                 "trace_meganode": 0}

_lock = threading.Lock()
_lib = None
build_log = ""


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def load_library():
    """Build (if needed) and load the kernel library. Raises on failure."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            path, build_log = build_shared([_nvcc()] + NVCC_FLAGS, [SOURCE],
                                           "libtraverse_sm90a.so")
            lib = ctypes.CDLL(path)
            argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int]
                        + [ctypes.c_void_p] * 5)
            for name in ("hpt_trace_incoherent", "hpt_trace_coherent"):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.hpt_trace_meganode.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int]
                + [ctypes.c_void_p] * 5)
            lib.hpt_trace_meganode.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(kernel: str, bvh, o, d, t_min, t_max, active, any_hit) -> HitRecord:
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {dev}")
    n = o.shape[0]
    _check("o", o, torch.float32, (n, 3), dev)
    _check("d", d, torch.float32, (n, 3), dev)
    if kernel == "trace_meganode":
        check_meganode_depth(bvh)
        _check("nodes", bvh.nodes, torch.float32, (bvh.nodes.shape[0], 128), dev)
        tables = (bvh.nodes.data_ptr(),)
    else:
        check_stack_depth(bvh)
        _check("nodes4", bvh.nodes4, torch.float32, (bvh.nodes4.shape[0], 32), dev)
        _check("leaf_rows", bvh.leaf_rows, torch.float32,
               (bvh.leaf_rows.shape[0], 128), dev)
        tables = (bvh.nodes4.data_ptr(), bvh.leaf_rows.data_ptr())
    tmin = per_ray(t_min, n, dev)
    tmax = per_ray(t_max, n, dev)
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    _check("active", active, torch.bool, (n,), dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    fn = getattr(load_library(), "hpt_" + kernel)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*tables,
                 o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
                 active.data_ptr(), n, int(any_hit), t.data_ptr(),
                 prim.data_ptr(), u.data_ptr(), v.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    launch_counts[kernel] += 1
    return HitRecord(t=t, prim=prim, u=u, v=v)


def trace_incoherent(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None,
                     any_hit: bool = False) -> HitRecord:
    """Per-ray BVH4 walk (K1 port)."""
    if o.device.type == "cpu":
        return plain.traverse(bvh, o, d, t_min, t_max, active, any_hit)
    return _launch("trace_incoherent", bvh, o, d, t_min, t_max, active, any_hit)


def trace_coherent(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None,
                   any_hit: bool = False) -> HitRecord:
    """128-ray packet BVH4 walk (K2 port); rays in tile-major order."""
    if o.device.type == "cpu":
        return plain.traverse(bvh, o, d, t_min, t_max, active, any_hit)
    return _launch("trace_coherent", bvh, o, d, t_min, t_max, active, any_hit)


def trace_meganode(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None,
                   any_hit: bool = False) -> HitRecord:
    """128-ray packet walk over the meganode table (K3 port); rays in
    tile-major order. Needs ``bvh.nodes``."""
    if o.device.type == "cpu":
        return plain.traverse_meganode(bvh, o, d, t_min, t_max, active,
                                       any_hit=any_hit)
    return _launch("trace_meganode", bvh, o, d, t_min, t_max, active, any_hit)
