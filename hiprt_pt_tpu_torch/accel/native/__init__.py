"""Native (C++) BVH builder — a verbatim copy of the JAX package's
``accel/native/bvh_builder.cpp``, built with g++ at first use into the
port's build directory and bound with ctypes: the SBVH of the BVH4 tables
and the binned-SAH BVH2 of the meganode table."""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ...utils.native_build import build_shared

_SRC = os.path.join(os.path.dirname(__file__), "bvh_builder.cpp")
_lock = threading.Lock()
_lib = None


def get_lib():
    """Load the builder, compiling it first if needed. Raises if g++ fails."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build_shared(
                ["g++", "-O2", "-march=native", "-shared", "-fPIC",
                 "-std=c++17"], [_SRC], "libbvh_builder.so", timeout=300)
            lib = ctypes.CDLL(path)
            fp = ctypes.POINTER(ctypes.c_float)
            ip = ctypes.POINTER(ctypes.c_int32)
            lp = ctypes.POINTER(ctypes.c_int64)
            lib.hpt_build_bvh_raw_sbvh.restype = ctypes.c_int64
            lib.hpt_build_bvh_raw_sbvh.argtypes = [
                fp, ctypes.c_int64, ip, ctypes.c_int64, ctypes.c_int,
                fp, ip, ctypes.c_int64, lp, ctypes.c_int64, lp,
            ]
            lib.hpt_build_bvh.restype = ctypes.c_int64
            lib.hpt_build_bvh.argtypes = [
                fp, ctypes.c_int64, ip, ctypes.c_int64, ctypes.c_int,
                fp, ctypes.c_int64,
            ]
            _lib = lib
        return _lib


def build_bvh_native(vertices: np.ndarray, triangles: np.ndarray,
                     max_leaf: int = 4) -> np.ndarray:
    """Binned-SAH BVH2 packed into (M, 128) f32 meganode rows, leaves of up
    to ``max_leaf`` (≤ 4) triangles embedded in their parent's row (layout:
    accel/build.py)."""
    lib = get_lib()
    verts = np.ascontiguousarray(vertices, dtype=np.float32)
    tris = np.ascontiguousarray(triangles, dtype=np.int32)
    n_tris = tris.shape[0]
    cap = max(n_tris, 1)
    rows = np.zeros((cap, 128), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    n = lib.hpt_build_bvh(
        verts.ctypes.data_as(fp), verts.shape[0],
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_tris, max_leaf,
        rows.ctypes.data_as(fp), cap,
    )
    if n <= 0:
        raise RuntimeError(f"native meganode build failed (returned {n})")
    return rows[:n]


def build_bvh_raw_native(vertices: np.ndarray, triangles: np.ndarray,
                         max_leaf: int):
    """Raw SBVH (binned SAH with spatial splits): (bounds (M,6) f32,
    meta (M,2) i32 [left, count], order (R,) i64 — up to 2T references)."""
    lib = get_lib()
    verts = np.ascontiguousarray(vertices, dtype=np.float32)
    tris = np.ascontiguousarray(triangles, dtype=np.int32)
    n_tris = tris.shape[0]
    cap = max(4 * n_tris, 16)
    bounds = np.zeros((cap, 6), np.float32)
    meta = np.zeros((cap, 2), np.int32)
    cap_order = max(2 * n_tris, 1)
    order = np.zeros((cap_order,), np.int64)
    n_order = ctypes.c_int64(0)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lp = ctypes.POINTER(ctypes.c_int64)
    n = lib.hpt_build_bvh_raw_sbvh(
        verts.ctypes.data_as(fp), verts.shape[0],
        tris.ctypes.data_as(ip), n_tris, max_leaf,
        bounds.ctypes.data_as(fp), meta.ctypes.data_as(ip), cap,
        order.ctypes.data_as(lp), cap_order, ctypes.byref(n_order),
    )
    if n <= 0:
        raise RuntimeError(f"native BVH build failed (returned {n})")
    return bounds[:n], meta[:n], order[: max(int(n_order.value), 1)]
