"""The registry and build table of the port's CUDA kernels
(ops/cuda_build.py) against the sources themselves, and its one launch
path with the C function and the stream lookup substituted, on the host: no
compiler runs here."""

import contextlib
import ctypes
import os
import re
import types

import pytest

from hiprt_pt_tpu_torch.ops import cuda_build


def _source(name: str) -> str:
    with open(os.path.join(cuda_build.CSRC, name + ".cu")) as f:
        return f.read()


def _c_functions(text: str) -> dict:
    """{name: number of parameters} of the C functions a source defines
    (``int hpt_...(...) {``)."""
    out = {}
    for m in re.finditer(r"\bint (hpt_\w+)\(([^)]*)\)\s*\{", text):
        params = m.group(2).strip()
        out[m.group(1)] = 0 if not params else params.count(",") + 1
    return out


@pytest.mark.parametrize("name", sorted(cuda_build.SOURCES))
def test_signatures_match_the_source(name):
    """Every C function of a source has a signature with as many arguments
    as the source's definition has parameters, and no signature names a
    function the source lacks."""
    defined = _c_functions(_source(name))
    assert set(cuda_build.SIGNATURES[name]) == set(defined)
    for fn, argtypes in cuda_build.SIGNATURES[name].items():
        assert len(argtypes) == defined[fn], fn


@pytest.mark.parametrize("name", sorted(cuda_build.SOURCES))
def test_headers_are_named_as_dependencies(name):
    """A source's quoted includes are exactly the headers whose change
    rebuilds it."""
    included = set(re.findall(r'#include "([^"]+)"', _source(name)))
    _flags, deps = cuda_build.SOURCES[name]
    assert included == {os.path.basename(d) for d in deps}
    assert all(os.path.exists(d) for d in deps)


@pytest.mark.parametrize("name,flag", [("traverse", True), ("traverse8", True),
                                       ("probes", False),
                                       ("emissive_sweep", True),
                                       ("principled", True)])
def test_the_bit_exact_sources_forbid_fused_multiply_add(name, flag):
    assert ("-fmad=false" in cuda_build.SOURCES[name][0]) is flag


def test_the_emissive_sweep_is_built_and_declared():
    """The sweep's source is built with the package's sources, its C
    functions are declared (rows, e, row stride, o, d, active, n, t_min, t,
    slot, stream; the four info pointers), and its kernel's name is not a
    traversal kernel's, so the benchmark counts its time as the
    integrator's."""
    assert cuda_build.SOURCES["emissive_sweep"] == (["-fmad=false"], ())
    sig = cuda_build.SIGNATURES["emissive_sweep"]
    assert sig["hpt_emissive_sweep"][6:8] == [ctypes.c_int64, ctypes.c_float]
    assert len(sig["hpt_emissive_sweep"]) == 11
    assert sig["hpt_emissive_sweep_info"] == cuda_build.info_args(0)
    text = _source("emissive_sweep")
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(", text)
    assert kernels == ["emissive_sweep_kernel"]


def test_the_principled_bsdf_is_built_and_declared():
    """The BSDF's source is built with the package's sources; its C
    functions are declared (eval: fields, n, wo, wi, eta, tables, flags, n,
    f, pdf, stream; sample: fields, n, wo, rng, eta, tables, flags, n,
    rng_out, wi, f, pdf, refracted, lobe, stream; info with its selector);
    its two kernels' names are not traversal kernels', so the benchmark
    counts their time as the integrator's."""
    assert cuda_build.SOURCES["principled"] == (["-fmad=false"], ())
    sig = cuda_build.SIGNATURES["principled"]
    for fn, n_args in (("hpt_principled_eval", 11), ("hpt_principled_sample", 15)):
        assert len(sig[fn]) == n_args
        assert sig[fn][6:8] == [ctypes.c_int, ctypes.c_int64]
    assert sig["hpt_principled_info"] == cuda_build.info_args(1)
    assert sig["hpt_principled_table_floats"] == []
    text = _source("principled")
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(", text)
    assert kernels == ["principled_eval_kernel", "principled_sample_kernel"]


def test_trace_coherent_takes_its_scratch_words():
    """trace_coherent is persistent now: like the per-ray kernels it takes a
    scratch pointer between any_hit and the outputs, and reports its
    registers, memory and residency."""
    sig = cuda_build.SIGNATURES["traverse"]
    assert sig["hpt_trace_coherent"] == sig["hpt_trace_incoherent"]
    assert sig["hpt_trace_coherent_info"] == cuda_build.info_args(1)
    assert len(cuda_build.info_args(1)) == 5
    probes = cuda_build.SIGNATURES["probes"]
    assert len(probes["hpt_dg_probe"]) == 10
    assert len(probes["hpt_dg_probe_info"]) == 7


def test_trace_stream8_is_a_persistent_per_ray_walk():
    """trace_stream8 takes the arguments of trace_lane8log, the per-ray walk
    it shares its template with (a uint64 ray counter between any_hit and
    the outputs), and reports its registers, memory and residency."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse

    sig = cuda_build.SIGNATURES["traverse8"]
    assert sig["hpt_trace_stream8"] == sig["hpt_trace_lane8log"] == \
        cuda_build.trace_args(2)
    assert sig["hpt_trace_stream8_info"] == cuda_build.info_args(1)
    assert cuda_traverse._SCRATCH_WORDS["trace_stream8"] == \
        cuda_traverse._SCRATCH_WORDS["trace_lane8log"] == 1
    text = _source("traverse8")
    assert text.count("walk8<kAnyHit, ") == 2


@pytest.mark.parametrize("kernel", sorted(cuda_build.KERNELS))
def test_launch_counts_and_raises(kernel, monkeypatch):
    """launch calls the kernel's C function with the wrapper's arguments and
    the device's current stream last. A return of 0 counts one launch of
    that kernel and none of any other; a nonzero return raises, names the
    kernel and counts nothing."""
    returns, calls = [0], []

    def c_function(*args):
        calls.append(args)
        return returns[0]

    @contextlib.contextmanager
    def current_stream(device):
        assert device == "card"
        yield "stream"

    spec = cuda_build.KERNELS[kernel]
    lib = types.SimpleNamespace(**{"hpt_" + kernel: c_function})
    monkeypatch.setattr(cuda_build, "load_libraries", lambda: {spec.source: lib})
    monkeypatch.setattr(cuda_build, "_current_stream", current_stream)
    monkeypatch.setattr(cuda_build, "launch_counts",
                        dict.fromkeys(cuda_build.KERNELS, 0))
    args = tuple(range(len(spec.args) - 1))
    cuda_build.launch(kernel, "card", *args)
    assert calls == [args + ("stream",)]
    one = {k: int(k == kernel) for k in cuda_build.KERNELS}
    assert cuda_build.launch_counts == one
    for err in (2, -1):
        returns[0] = err
        with pytest.raises(RuntimeError, match=f"^{kernel}\\b"):
            cuda_build.launch(kernel, "card", *args)
        assert cuda_build.launch_counts == one
    returns[0] = 700
    with pytest.raises(RuntimeError,
                       match=f"^{kernel} launch failed: cudaError 700$"):
        cuda_build.launch(kernel, "card", *args)
    assert cuda_build.launch_counts == one and len(calls) == 4


@pytest.mark.parametrize("kernel", sorted(cuda_build.KERNELS))
def test_kernel_info_reads_the_info_function(kernel, monkeypatch):
    """kernel_info calls the kernel's *_info function with the flags that
    pick the kernel, then the caller's, then the four int pointers, and
    names the four values; it refuses a wrong number of flags and raises
    where the call fails."""
    spec = cuda_build.KERNELS[kernel]
    returns, calls = [0], []

    def info(*args):
        calls.append(args[:-4])
        for i, p in enumerate(args[-4:]):
            p._obj.value = 10 + i
        return returns[0]

    lib = types.SimpleNamespace(**{spec.info_fn: info})
    monkeypatch.setattr(cuda_build, "load_libraries", lambda: {spec.source: lib})
    flags = tuple(range(3, 3 + len(spec.info_flags)))
    got = cuda_build.kernel_info(kernel, *flags)
    assert got == {"registers": 10, "local_bytes": 11, "shared_bytes": 12,
                   "blocks_per_sm": 13}
    assert calls == [spec.info_fixed + flags]
    assert len(cuda_build.SIGNATURES[spec.source][spec.info_fn]) == \
        len(spec.info_fixed) + len(flags) + 4
    with pytest.raises(TypeError, match=kernel):
        cuda_build.kernel_info(kernel, *flags, 0)
    returns[0] = 1
    with pytest.raises(RuntimeError, match=f"^{kernel} info failed"):
        cuda_build.kernel_info(kernel, *flags)
