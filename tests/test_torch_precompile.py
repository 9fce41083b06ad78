"""The port's warm-up of render-option permutations
(hiprt_pt_tpu_torch/utils/precompile.py) against the JAX package's
permutation set, on the CPU; and the lock that keeps concurrent warm-ups
and the render loop from building one library twice at once
(ops/cuda_build.py, utils/native_build.py)."""

import dataclasses
import os
import sys
import threading
import types

import pytest
import torch

from hiprt_pt_tpu.core import settings as js
from hiprt_pt_tpu.utils.precompile import common_permutations as jperms
from hiprt_pt_tpu_torch.core import settings as ts
from hiprt_pt_tpu_torch.ops import cuda_build
from hiprt_pt_tpu_torch.utils import native_build, precompile
from hiprt_pt_tpu_torch.utils.precompile import (Precompiler,
                                                 common_permutations)

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402


def _fields(opts) -> dict:
    return {f.name: (v.name if hasattr(v, "name") else v)
            for f in dataclasses.fields(opts)
            for v in (getattr(opts, f.name),)}


def test_permutation_set_matches_jax():
    """The six option sets, field by field the JAX package's (which also
    carries pallas_force_interpret, not ported), hashable and distinct."""
    base = ts.RenderOptions(max_bounces_static=3)
    perms = common_permutations(base)
    want = jperms(js.RenderOptions(max_bounces_static=3))
    assert len(perms) == len(want) == 6 and len(set(perms)) == 6
    for p, w in zip(perms, want):
        wf = _fields(w)
        assert wf.pop("pallas_force_interpret") is False
        assert _fields(p) == wf


@pytest.fixture(scope="module")
def renderer(tmp_path_factory):
    from hiprt_pt_tpu_torch.assets.loader import load_scene_file
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    glb = tp.write_cornell_glb(str(tmp_path_factory.mktemp("pc") / "c.glb"), 1.0)
    scene, cam, bvh = load_scene_file(glb, aspect=1.0, with_bvh=True,
                                      device="cpu")
    return Renderer(scene, cam, 16, 16, bvh=bvh, options=ts.RenderOptions(
        bsdf_override=ts.BSDFOverride.LAMBERTIAN, max_bounces_static=1),
        settings=ts.RenderSettings(nb_bounces=1))


def test_warm_compiles_on_the_cpu(renderer):
    """tests/test_precompile.py's warm-up on the port: on the CPU there is
    no library to build, so every job makes its state and counts compiled;
    with no permutations given, the six of common_permutations."""
    opts = renderer.options
    pc = Precompiler(max_workers=2)
    pc.warm(renderer, [
        opts.replace(direct_light_sampling=ts.LightSamplingStrategy.UNIFORM_ONE),
        opts.replace(direct_light_sampling=ts.LightSamplingStrategy.BSDF_ONLY)])
    pc.wait(timeout=60)
    assert (pc.compiled, pc.failed) == (2, 0)
    log = types.SimpleNamespace(lines=[], update_line=lambda k, v: log.lines.append(v))
    futures = pc.warm(renderer, log=log)
    pc.wait(timeout=60)
    assert all(f.done() for f in futures) and len(futures) == 8
    assert (pc.compiled, pc.failed) == (8, 0) and len(log.lines) == 6
    pc.shutdown()
    assert renderer.state.sample_count == 0  # the live state is untouched


def test_a_build_that_raises_counts_failed(renderer, monkeypatch):
    """On a CUDA device with the kernels on, a job builds the routed
    kernels' libraries first; a build that raises counts failed and nothing
    else (no state is made, nothing falls back)."""
    calls = []

    def broken():
        calls.append(threading.current_thread().name)
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    from hiprt_pt_tpu_torch.core import state

    states = []
    monkeypatch.setattr(cuda_build, "load_libraries", broken)
    monkeypatch.setattr(state, "init_render_state",
                        lambda *a, **kw: states.append(a))
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0),
                                    bvh=renderer.bvh, width=16, height=16,
                                    seed=42, options=renderer.options)
    pc = Precompiler(max_workers=2)
    pc.warm(on_card)
    pc.wait(timeout=60)
    pc.shutdown()
    assert (pc.compiled, pc.failed) == (0, 6) and len(calls) == 6
    assert states == []
    with pytest.raises(RuntimeError, match="nvcc not found"):
        precompile.warm_permutation(on_card, renderer.options)


def test_enable_persistent_cache_moves_the_build_directory(tmp_path,
                                                           monkeypatch):
    """The package's libraries are built and loaded once for each build
    directory, by one thread while others wait: eight threads asking at
    once build each source once; a new directory builds anew; the default
    comes back to the libraries already loaded."""
    built = []

    def fake_build(nvcc, name):
        built.append((native_build.BUILD_DIR, name))
        return os.path.join(native_build.BUILD_DIR, name), f"log {name}"

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "_build", fake_build)
    monkeypatch.setattr(cuda_build, "_load", lambda path, sigs: path)
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(native_build, "BUILD_DIR", native_build.BUILD_DIR)
    default = precompile.enable_persistent_cache()
    assert default == native_build.DEFAULT_BUILD_DIR == native_build.BUILD_DIR

    def load_in(d):
        precompile.enable_persistent_cache(str(d))
        threads = [threading.Thread(target=cuda_build.load_libraries)
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        return cuda_build.load_libraries()

    first = load_in(tmp_path / "a")
    assert sorted(built) == sorted((str(tmp_path / "a"), n)
                                   for n in cuda_build.SOURCES)
    second = load_in(tmp_path / "b")
    assert len(built) == 2 * len(cuda_build.SOURCES)
    assert first != second and os.path.isdir(tmp_path / "b")
    assert load_in(tmp_path / "a") is first
    assert len(built) == 2 * len(cuda_build.SOURCES)


def test_build_shared_builds_a_library_once_for_concurrent_callers(tmp_path,
                                                                    monkeypatch):
    """Threads that ask for the same library at once wait for one compiler
    run (a stand-in compiler that counts its runs and sleeps)."""
    src = tmp_path / "x.c"
    src.write_text("int x;")
    runs = tmp_path / "runs"
    compiler = tmp_path / "cc.py"
    compiler.write_text(
        "import sys, time\n"
        f"open({str(runs)!r}, 'a').write('run\\n')\n"
        "time.sleep(0.3)\n"
        "print('compiled')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    out = []
    threads = [threading.Thread(target=lambda: out.append(
        native_build.build_shared([sys.executable, str(compiler)], [str(src)],
                                  "libx.so"))) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(out) == 6 and runs.read_text().count("run") == 1
    assert {p for p, _log in out} == {str(tmp_path / "build" / "libx.so")}
    assert sorted(log == "" for _p, log in out) == [False] + [True] * 5
