"""The port's CUDA kernels: their registry, build, load, launch and count.

``KERNELS`` declares every kernel the port launches: the source that holds
it, the argument types of its C launch function ``hpt_<kernel>``, and its
``*_info`` function with the flags that function takes. ``SIGNATURES``,
what each library is loaded with, is derived from it and from
``HELPERS``, the few C functions that are not launches. ``launch`` is the
one launch path: each wrapper (ops/cuda_traverse.py, ops/cuda_sweep.py,
ops/cuda_bsdf.py, probes/r5probe2.py) checks its arguments, allocates its
outputs and hands the pointers over; ``launch`` calls the C function on
the device's current stream, raises if the launch failed and counts it in
``launch_counts`` if not. ``kernel_info`` reads a kernel's registers,
memory and residency. A new kernel is its ``.cu`` file (with an entry in
``SOURCES`` if the file is new), one entry in ``KERNELS``, its wrapper and
its tests.

Every source is compiled by nvcc for sm_90a into its own shared library with
a plain C interface, in ``_build/`` (utils/native_build.py), at first use.
All sources are compiled at once, one nvcc each, in a thread pool, so one
round of compiles builds every kernel of the port:

- ``traverse.cu``: the BVH4 and meganode kernels (ops/cuda_traverse.py);
- ``traverse8.cu``: the BVH8 kernels (ops/cuda_traverse.py);
- ``probes.cu``: the gather probes (probes/r5probe2.py); its P1 runs on
  ``wgmma`` fed by TMA (``hopper_async.cuh``), whose tensor map libcuda
  encodes: the source looks ``cuTensorMapEncodeTiled`` up with ``dlsym`` in
  the libcuda the process has loaded, so only ``-ldl`` is linked;
- ``emissive_sweep.cu``: the dense emissive sweep of RIS's and ReSTIR's
  BSDF candidates (ops/cuda_sweep.py);
- ``principled.cu``: the principled BSDF's eval and sample
  (ops/cuda_bsdf.py).

The traversal sources and the sweep are built with ``-fmad=false`` so that
their t is bit-identical to the plain version's, and the BSDF so that its
operations round as the plain version's separate kernels do; the probes'
arithmetic is integer or exact, so they are built without it. Every C
function returns an int: a launch function the ``cudaError_t`` of its
launch (P1 also negative refusals of its own), an ``*_info`` function that
of its queries. ``-Xptxas -v`` puts every kernel's registers, spills and
shared memory into ``build_log``.

The package's libraries are loaded once for each build directory
(``native_build.BUILD_DIR``, which ``utils/precompile.py:
enable_persistent_cache`` may point elsewhere), under one lock that covers
the build and the load: threads that ask at once (the render loop, the
warm-up jobs of utils/precompile.py) wait for one build.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import torch

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
    "emissive_sweep": (["-fmad=false"], ()),
    "principled": (["-fmad=false"], ()),
}

_P, _I = ctypes.c_void_p, ctypes.c_int


def trace_args(n_tables: int) -> list:
    """A traversal kernel's arguments: its tables, o, d, t_min, t_max,
    active, n (int64), any_hit, its scratch words, t, prim, u, v, stream."""
    return [_P] * (n_tables + 5) + [ctypes.c_int64, _I] + [_P] * 6


def info_args(n_flags: int) -> list:
    """An *_info function's arguments: its ``n_flags`` int flags, then four
    int pointers (registers per thread, local memory bytes per thread,
    shared memory bytes per block, resident blocks per SM)."""
    return [_I] * n_flags + [_P] * 4


def _tensor_map_refusal(err: int) -> str:
    """P1's negative returns: -1, libcuda has no tensor-map encoder; -100 -
    r, the encoder returned the CUresult r."""
    return "libcuda's tensor-map encoder " + (
        "is missing" if err == -1 else f"refused the table: CUresult {-err - 100}")


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A kernel the port launches. ``args``: the argument types of its C
    function ``hpt_<name>``, the stream last. ``info_flags``: the names of
    the int flags a caller passes its *_info function (``info``, by
    default ``hpt_<name>_info``), which first takes ``info_fixed`` where
    two kernels share it. ``refusal``: the meaning of a negative return of
    the launch function (None: every nonzero return is a cudaError)."""
    name: str
    source: str
    args: list
    info_flags: tuple = ("any_hit",)
    info: str = ""
    info_fixed: tuple = ()
    refusal: Callable[[int], str] | None = None

    @property
    def info_fn(self) -> str:
        return self.info or f"hpt_{self.name}_info"


KERNELS = {k.name: k for k in (
    Kernel("trace_coherent", "traverse", trace_args(2)),
    Kernel("trace_incoherent", "traverse", trace_args(2)),
    Kernel("trace_meganode", "traverse", trace_args(1)),
    Kernel("trace_stream8", "traverse8", trace_args(2)),
    Kernel("trace_lane8log", "traverse8", trace_args(2)),
    # rows, e, row stride, o, d, active (or null), n (int64), t_min (f32),
    # t, slot, stream
    Kernel("emissive_sweep", "emissive_sweep",
           [_P, _I, _I, _P, _P, _P, ctypes.c_int64, ctypes.c_float, _P, _P, _P],
           info_flags=()),
    # eval: fields (a host array of device pointers), n, wo, wi, eta (or
    # null), tables, flags, n (int64), f, pdf, stream; sample: fields, n,
    # wo, rng, eta, tables, flags, n (int64), rng_out, wi, f, pdf,
    # refracted, lobe (or null), stream; their info function's flag is
    # "sample"
    Kernel("principled_eval", "principled",
           [_P] * 6 + [_I, ctypes.c_int64] + [_P] * 3,
           info_flags=(), info="hpt_principled_info", info_fixed=(0,)),
    Kernel("principled_sample", "principled",
           [_P] * 6 + [_I, ctypes.c_int64] + [_P] * 7,
           info_flags=(), info="hpt_principled_info", info_fixed=(1,)),
    # tab_t, idx, L, W, w_pad, l_pad, nl, rounds, groups, is_int8, partial,
    # out, stream
    Kernel("mm_probe", "probes", [_P, _P] + [_I] * 8 + [_P] * 3,
           info_flags=("is_int8",), refusal=_tensor_map_refusal),
    # tab, idx, S, tiles, rounds, g, threads, partial, out, stream
    Kernel("dg_probe", "probes", [_P, _P] + [_I] * 5 + [_P] * 3,
           info_flags=("g", "threads", "S")),
)}
# the C functions that are not launches, source -> {C function: argument
# types}: the rows a block of P1 gathers, the length of the BSDF's
# coefficient table
HELPERS = {"probes": {"hpt_mm_probe_rows": []},
           "principled": {"hpt_principled_table_floats": []}}


def _signatures() -> dict:
    """source name -> {C function: argument types}: the registry's launch
    and *_info functions and the helpers, each once."""
    out = {name: dict(HELPERS.get(name, {})) for name in SOURCES}
    for k in KERNELS.values():
        out[k.source]["hpt_" + k.name] = k.args
        out[k.source][k.info_fn] = info_args(len(k.info_fixed)
                                             + len(k.info_flags))
    return out


SIGNATURES = _signatures()
# launches of each kernel since reset_launch_counts: one reset and one read
# cover a frame's
launch_counts = {k: 0 for k in KERNELS}

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


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@contextlib.contextmanager
def _current_stream(device):
    """Make ``device`` the current device for the block, which gets the
    handle of its current stream."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def launch(kernel: str, device, *args) -> None:
    """Launch ``kernel`` (a key of KERNELS): its C function called with
    ``args`` and the current stream of ``device``, with ``device`` current.
    Counts the launch in launch_counts; raises RuntimeError, and counts
    nothing, where the C function returns nonzero."""
    k = KERNELS[kernel]
    fn = getattr(load_libraries()[k.source], "hpt_" + kernel)
    with _current_stream(device) as stream:
        err = fn(*args, stream)
    if err < 0 and k.refusal is not None:
        raise RuntimeError(f"{kernel}: {k.refusal(err)}")
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    launch_counts[kernel] += 1


def kernel_info(kernel: str, *flags) -> dict:
    """{registers (per thread), local_bytes (per thread), shared_bytes (per
    block), blocks_per_sm (resident)} of ``kernel`` from its *_info
    function called with ``flags`` (Kernel.info_flags); builds and loads
    the libraries where needed. Raises if the call fails."""
    k = KERNELS[kernel]
    if len(flags) != len(k.info_flags):
        raise TypeError(f"{kernel}'s info takes the flags {k.info_flags}, "
                        f"got {flags}")
    fn = getattr(load_libraries()[k.source], k.info_fn)
    out = [ctypes.c_int() for _ in range(4)]
    err = fn(*k.info_fixed, *flags, *(ctypes.byref(x) for x in out))
    if err != 0:
        raise RuntimeError(f"{kernel} info failed: cudaError {err}")
    keys = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm")
    return dict(zip(keys, (x.value for x in out)))


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
