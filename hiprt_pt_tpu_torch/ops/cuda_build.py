"""Build, load and check the port's CUDA sources (``csrc/*.cu``).

Every source is compiled by nvcc for sm_90a into its own shared library with
a plain C interface, in ``_build/`` (utils/native_build.py), at first use.
All sources are compiled at once, one nvcc each, in a thread pool, so one
round of compiles builds every kernel of the port:

- ``traverse.cu``: the BVH4 and meganode kernels (ops/cuda_traverse.py);
- ``traverse8.cu``: the BVH8 kernels (ops/cuda_traverse.py);
- ``probes.cu``: the gather probes (probes/r5probe2.py); its P1 runs on
  ``wgmma`` fed by TMA (``hopper_async.cuh``), whose tensor map libcuda
  encodes: the source looks ``cuTensorMapEncodeTiled`` up with ``dlsym`` in
  the libcuda the process has loaded, so only ``-ldl`` is linked.

The traversal sources are built with ``-fmad=false`` so that their t is
bit-identical to the plain walk's; the probes' arithmetic is integer or
exact, so they are built without it. Each library's C functions get the
signatures of ``SIGNATURES`` when it is loaded; every one returns the
``cudaError_t`` of its launch as an int. ``-Xptxas -v`` puts every kernel's
registers, spills and shared memory into ``build_log``.

``load_source`` builds and loads one more source the same way; a script
uses it for a kernel that is not part of the package (an earlier version
kept for a side-by-side timing).

The package's libraries are loaded once for each build directory
(``native_build.BUILD_DIR``, which ``utils/precompile.py:
enable_persistent_cache`` may point elsewhere), under one lock that covers
the build and the load: threads that ask at once (the render loop, the
warm-up jobs of utils/precompile.py) wait for one build.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

from ..utils import native_build
from ..utils.native_build import build_shared

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_TRAVERSE_HEADER = os.path.join(CSRC, "traverse_common.cuh")
_ASYNC_HEADER = os.path.join(CSRC, "hopper_async.cuh")
# source name -> (extra nvcc flags, included headers)
SOURCES = {
    "traverse": (["-fmad=false"], (_TRAVERSE_HEADER,)),
    "traverse8": (["-fmad=false"], (_TRAVERSE_HEADER,)),
    "probes": (["-ldl"], (_ASYNC_HEADER,)),
}

_P, _I = ctypes.c_void_p, ctypes.c_int


def trace_args(n_tables: int, counter: bool) -> list:
    """A traversal kernel's arguments: its tables, o, d, t_min, t_max,
    active, n (int64), any_hit, [its scratch words], t, prim, u, v, stream."""
    return ([_P] * (n_tables + 5) + [ctypes.c_int64, _I]
            + [_P] * (5 + int(counter)))


MM_PROBE_ARGS = [_P, _P] + [_I] * 8 + [_P] * 3
# *_info: any_hit or is_int8, then four int pointers (registers per thread,
# local memory bytes per thread, shared memory bytes per block, resident
# blocks per SM)
INFO_ARGS = [_I, _P, _P, _P, _P]
# source name -> {C function: argument types}
SIGNATURES = {
    "traverse": {"hpt_trace_coherent": trace_args(2, True),
                 "hpt_trace_coherent_info": INFO_ARGS,
                 "hpt_trace_incoherent": trace_args(2, True),
                 "hpt_trace_incoherent_info": INFO_ARGS,
                 "hpt_trace_meganode": trace_args(1, True),
                 "hpt_trace_meganode_info": INFO_ARGS},
    "traverse8": {"hpt_trace_stream8": trace_args(2, True),
                  "hpt_trace_stream8_info": INFO_ARGS,
                  "hpt_trace_lane8log": trace_args(2, True),
                  "hpt_trace_lane8log_info": INFO_ARGS},
    # mm: tab_t, idx, L, W, w_pad, l_pad, nl, rounds, groups, is_int8,
    # partial, out, stream; mm_rows: the gathered rows of a block; dg: tab,
    # idx, S, tiles, rounds, g, threads, partial, out, stream; dg_info: g,
    # threads, S, then the four int pointers of INFO_ARGS
    "probes": {"hpt_mm_probe": MM_PROBE_ARGS,
               "hpt_mm_probe_rows": [],
               "hpt_mm_probe_info": INFO_ARGS,
               "hpt_dg_probe": [_P, _P] + [_I] * 5 + [_P] * 3,
               "hpt_dg_probe_info": [_I] * 3 + [_P] * 4},
}

_lock = threading.Lock()
# build directory -> {source name: CDLL}
_libs: dict = {}
build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _build(nvcc: str, name: str) -> tuple[str, str]:
    extra, deps = SOURCES[name]
    return build_shared([nvcc] + BASE_FLAGS + extra,
                        [os.path.join(CSRC, name + ".cu")],
                        f"lib{name}_sm90a.so", deps=deps)


def _load(path: str, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def load_source(path: str, extra_flags: list,
                signatures: dict) -> tuple[ctypes.CDLL, str]:
    """Build the CUDA source at ``path`` (any directory; headers of csrc/
    are on its include path) with the package's flags plus ``extra_flags``
    and load it with ``signatures`` ({C function: argument types}, each
    returning an int). Returns (the library, the compiler's output)."""
    name = os.path.splitext(os.path.basename(path))[0]
    lib_path, log = build_shared(
        [_nvcc()] + BASE_FLAGS + ["-I", CSRC] + list(extra_flags), [path],
        f"lib{name}_sm90a.so")
    return _load(lib_path, signatures), log


def load_libraries() -> dict:
    """Build (where needed) and load every source's library in the build
    directory, compiling all of them at once, with the C signatures
    declared. Returns {source name: CDLL}. Raises on failure, and a later
    call tries again."""
    global build_log
    with _lock:
        build_dir = native_build.BUILD_DIR
        if build_dir not in _libs:
            nvcc = _nvcc()
            with ThreadPoolExecutor(len(SOURCES)) as pool:
                built = dict(zip(SOURCES, pool.map(
                    lambda name: _build(nvcc, name), SOURCES)))
            build_log = "\n".join(log for _path, log in built.values())
            _libs[build_dir] = {name: _load(path, SIGNATURES[name])
                                for name, (path, _log) in built.items()}
        return _libs[build_dir]


def kernel_info(fn, *flags) -> tuple:
    """(registers per thread, local memory bytes per thread, shared memory
    bytes per block, resident blocks per SM) from a source's *_info
    function ``fn`` called with ``flags``; raises if the call fails."""
    out = [ctypes.c_int() for _ in range(4)]
    err = fn(*flags, *(ctypes.byref(x) for x in out))
    if err != 0:
        raise RuntimeError(f"kernel info failed: cudaError {err}")
    return tuple(x.value for x in out)


def check_tensor(name, t, dtype, shape, device):
    """Raise unless ``t`` lies on ``device`` with the dtype ``dtype`` (or
    one of a tuple of them) and the shape ``shape``, contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
