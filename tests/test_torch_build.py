"""The build table of the port's CUDA sources (ops/cuda_build.py) against
the sources themselves, on the host: no compiler runs here."""

import ctypes
import os
import re

import pytest

from hiprt_pt_tpu_torch.ops import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
                                       ("probes", False)])
def test_only_the_traversal_sources_forbid_fused_multiply_add(name, flag):
    assert ("-fmad=false" in cuda_build.SOURCES[name][0]) is flag


def test_previous_kernels_stay_out_of_the_package():
    """The earlier versions kept for side-by-side timings are no source of
    the package, and define other C names than the package's kernels."""
    prev = os.path.join(REPO, "previous_kernels")
    names = {f for f in os.listdir(prev) if f.endswith(".cu")}
    assert names == {"mm_probe_mma_sync.cu", "trace_lane8log_step.cu",
                     "trace_incoherent_step.cu", "trace_meganode_packet.cu",
                     "trace_coherent_block.cu", "dg_probe_l2.cu",
                     "trace_stream8_packet.cu", "trace_stream8_toptree.cu"}
    package = {fn for sig in cuda_build.SIGNATURES.values() for fn in sig}
    for f in names:
        with open(os.path.join(prev, f)) as fh:
            defined = _c_functions(fh.read())
        assert defined and not set(defined) & package
        assert all(fn.startswith("hpt_prev_") for fn in defined)


# the earlier versions' C functions as chip_smoke.py declares them: the
# package's argument lists, with or without the scratch words; the top-rows
# variant of trace_stream8 as previous_kernels/sweep_k4.py declares it
_DG_ARGS = cuda_build.SIGNATURES["probes"]["hpt_dg_probe"]
_STREAM8 = cuda_build.trace_args(2, True)
PREVIOUS_ARGS = {
    "mm_probe_mma_sync": {"hpt_prev_mm_probe": cuda_build.MM_PROBE_ARGS},
    "dg_probe_l2": {"hpt_prev_dg_probe": _DG_ARGS[:5] + _DG_ARGS[7:]},
    "trace_lane8log_step": {"hpt_prev_trace_lane8log": cuda_build.trace_args(2, True)},
    "trace_incoherent_step": {"hpt_prev_trace_incoherent": cuda_build.trace_args(2, False)},
    "trace_meganode_packet": {"hpt_prev_trace_meganode": cuda_build.trace_args(1, False)},
    "trace_coherent_block": {"hpt_prev_trace_coherent": cuda_build.trace_args(2, False)},
    "trace_stream8_packet": {"hpt_prev_trace_stream8": _STREAM8},
    "trace_stream8_toptree": {"hpt_prev_trace_stream8_toptree":
                              _STREAM8[:9] + [ctypes.c_int] + _STREAM8[9:]},
}


@pytest.mark.parametrize("name", sorted(PREVIOUS_ARGS))
def test_previous_kernels_take_the_declared_arguments(name):
    """An earlier version defines its launch function with as many
    parameters as the argument list it is loaded with, and one *_info
    function with the parameters of INFO_ARGS."""
    with open(os.path.join(REPO, "previous_kernels", name + ".cu")) as f:
        defined = _c_functions(f.read())
    (fn, argtypes), = PREVIOUS_ARGS[name].items()
    assert set(defined) == {fn, fn + "_info"}
    assert defined[fn] == len(argtypes)
    assert defined[fn + "_info"] == len(cuda_build.INFO_ARGS)


def test_trace_coherent_takes_its_scratch_words():
    """trace_coherent is persistent now: like the per-ray kernels it takes a
    scratch pointer between any_hit and the outputs, and reports its
    registers, memory and residency."""
    sig = cuda_build.SIGNATURES["traverse"]
    assert sig["hpt_trace_coherent"] == sig["hpt_trace_incoherent"]
    assert sig["hpt_trace_coherent_info"] == cuda_build.INFO_ARGS
    assert len(cuda_build.INFO_ARGS) == 5
    probes = cuda_build.SIGNATURES["probes"]
    assert len(probes["hpt_dg_probe"]) == 10
    assert len(probes["hpt_dg_probe_info"]) == 7


def test_trace_stream8_is_a_persistent_per_ray_walk():
    """trace_stream8 takes the arguments of trace_lane8log, the per-ray walk
    it shares its template with (a uint64 ray counter between any_hit and
    the outputs), and reports its registers, memory and residency; its
    earlier block-packet version is what chip_smoke.py loads beside it, and
    the top-rows variant is the sweep's (previous_kernels/sweep_k4.py)."""
    import chip_smoke
    from hiprt_pt_tpu_torch.ops import cuda_traverse

    sig = cuda_build.SIGNATURES["traverse8"]
    assert sig["hpt_trace_stream8"] == sig["hpt_trace_lane8log"] == _STREAM8
    assert sig["hpt_trace_stream8_info"] == cuda_build.INFO_ARGS
    assert cuda_traverse._KERNELS["trace_stream8"] == \
        cuda_traverse._KERNELS["trace_lane8log"]
    text = _source("traverse8")
    assert text.count("walk8<kAnyHit, ") == 2
    assert chip_smoke.EARLIER["trace_stream8"] == ("trace_stream8_packet",
                                                   "traverse8", True)
    assert chip_smoke.PREVIOUS["trace_stream8_packet"] == ["-fmad=false"]
