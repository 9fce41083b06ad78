"""The port's frame loop (render/renderer.py:Renderer) and the integrator
options it renders since the Renderer was completed (the AUTOMATIC interior
stack, white-furnace mode, per-bounce alive counts) against the JAX
package, on the procedural Cornell scene (tests/torch_parity.py) built by
the JAX package and carried into the port through interop: the box with
its seven spheres (two of glass), and the box alone (its first 12
triangles). Image gates as in test_torch_render.py: >= 98% of pixels within
1e-3 + 1e-3·|ref|, image mean within 1%."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402

from hiprt_pt_tpu_torch import interop  # noqa: E402
from hiprt_pt_tpu_torch.core import settings as ts  # noqa: E402

W, H = 32, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one intra-op thread: the test runner's workers share
    the machine's cores, and the plain walks' many small parallel ops then
    oversubscribe them (one test here took 391 s instead of 5)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _both(box_only: bool, white: bool = False):
    """The Cornell scene in both packages: (JAX scene, camera, BVH; the
    port's). ``box_only``: the first 12 triangles; ``white``: every base
    color 1."""
    from hiprt_pt_tpu.accel.build import build_bvh as jbvh
    from hiprt_pt_tpu.assets.scene import build_scene as jscene
    from hiprt_pt_tpu.core.camera import camera_from_lookat as jcam
    from hiprt_pt_tpu.core.material import MaterialBank as JBank
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat

    v, f, m, rows, cam = tp.cornell_spheres_arrays(W / H)
    if box_only:
        f, m = f[:12], m[:12]
    bank = JBank.from_rows(rows)
    if white:
        bank = bank.replace(base_color=jnp.ones_like(bank.base_color))
    jsc = jscene(v, f, m, bank)
    return dict(jscene=jsc, jcam=jcam(**cam), jbvh=jbvh(v, f),
                tscene=interop.scene_from_numpy(tp.to_numpy_dict(jsc), "cpu"),
                tcam=camera_from_lookat(**cam, device="cpu"),
                tbvh=build_bvh(v, f, "cpu"))


@pytest.fixture(scope="module")
def box():
    return _both(box_only=True)


@pytest.fixture(scope="module")
def spheres():
    return _both(box_only=False)


def _lambert(jax_package: bool, **kw):
    """Lambertian override, MIS, no dispersion, 2 bounces: the options of
    the frame-loop tests (short JAX compiles)."""
    from hiprt_pt_tpu.core import settings as js

    s = js if jax_package else ts
    return s.RenderOptions(direct_light_sampling=s.LightSamplingStrategy.MIS,
                           bsdf_override=s.BSDFOverride.LAMBERTIAN,
                           do_dispersion=False, max_bounces_static=2, **kw)


def _renderers(c, jset_kw: dict, set_kw: dict):
    """A JAX Renderer and the port's on the scene ``c`` with _lambert's
    options, ambient UNIFORM, and the given settings."""
    from hiprt_pt_tpu.render.renderer import Renderer as JRenderer
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    jr = JRenderer(c["jscene"], c["jcam"], W, H, options=_lambert(True),
                   bvh=c["jbvh"], seed=42)
    jr.settings = jr.settings.replace(nb_bounces=jnp.int32(2), **jset_kw)
    r = Renderer(c["tscene"], c["tcam"], W, H, options=_lambert(False),
                 settings=ts.RenderSettings(nb_bounces=2, **set_kw),
                 world=interop.world_from_numpy(tp.to_numpy_dict(jr.world)),
                 bvh=c["tbvh"], seed=42)
    return jr, r


def _agree(got, ref):
    assert np.isfinite(got).all() and got.shape == ref.shape
    close = np.all(np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= 0.98, close.mean()
    assert abs(got.mean() - ref.mean()) <= 0.01 * abs(ref.mean())


def _state_tensors(state):
    return {k: v for k, v in interop.to_numpy(state).items()
            if isinstance(v, np.ndarray)}


def test_renderer_has_the_jax_api(box):
    """Every public method, property and attribute of the JAX package's
    Renderer exists on the port's."""
    jr, r = _renderers(box, {}, {})
    names = {k for k in dir(jr) if not k.startswith("_")}
    assert {"recompile", "step", "render", "is_rendering_done", "profile",
            "frame_render_done", "kernel_stats", "ldr_image", "aov_images",
            "reset", "set_camera", "fuse_frame", "metrics"} <= names
    missing = sorted(k for k in names if not hasattr(r, k))
    assert not missing, missing


def test_fuse_frame_equals_the_sample_loop(spheres):
    """A fused frame of 3 samples (Renderer.step with fuse_frame: one
    render_step of n_samples=3) is the per-sample loop (three render_step
    calls of one sample) exactly, on the principled Cornell path's
    options."""
    from hiprt_pt_tpu_torch.render.renderer import Renderer, render_step

    opts = ts.RenderOptions(max_bounces_static=2)
    settings = ts.RenderSettings(nb_bounces=2, samples_per_frame=3)
    r = Renderer(spheres["tscene"], spheres["tcam"], W, H, options=opts,
                 settings=settings, bvh=spheres["tbvh"], seed=42)
    loop = r.state
    for _ in range(3):
        loop = render_step(opts, W, H, spheres["tscene"], spheres["tbvh"],
                           loop, spheres["tcam"], settings, r.world)
    r.fuse_frame = True
    fused = r.step()
    assert loop.sample_count == fused.sample_count == 3
    a, b = _state_tensors(loop), _state_tensors(fused)
    assert a.keys() == b.keys() and "accum" in a
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k
    assert float(loop.accum.abs().sum()) > 0.0


def test_step_block_adds_frame_metrics(box):
    _jr, r = _renderers(box, {}, dict(samples_per_frame=2))
    r.step()
    assert r.metrics.names() == []
    r.step(block=True)
    r.step(block=True)
    assert r.metrics.names() == ["frame_ms", "samples_per_s"]
    ms, sps = r.metrics.values("frame_ms"), r.metrics.values("samples_per_s")
    assert len(ms) == len(sps) == 2 and min(ms) > 0.0
    np.testing.assert_allclose(sps, [2000.0 / x for x in ms], rtol=1e-3)
    assert r.state.sample_count == 6
    assert r.frame_render_done()  # the CPU: a step returns when it is done


@pytest.fixture(scope="module")
def converging(box):
    """Both packages rendered to 12 samples, one a frame, stopping once half
    the pixels have converged (adaptive-sampling test, min 2 samples,
    threshold 0.5)."""
    kw = dict(stop_noise_threshold=0.01, stop_pixel_percentage_converged=0.5,
              adaptive_sampling_min_samples=2,
              adaptive_sampling_noise_threshold=0.5)
    jr, r = _renderers(box, {k: jnp.asarray(v) for k, v in kw.items()}, kw)
    jr.render(12)
    r.render(12)
    return jr, r


def test_render_stops_at_the_converged_share_where_jax_stops(converging):
    jr, r = converging
    sc = int(jr.state.sample_count)
    assert 2 < sc < 12
    assert r.state.sample_count == sc
    frac = int(r.state.nb_pixels_converged) / (W * H)
    assert frac >= 0.5
    assert abs(frac - float(jr.state.nb_pixels_converged) / (W * H)) <= 0.02
    assert r.is_rendering_done()


def test_ldr_and_aov_images_match_jax(converging):
    jr, r = converging
    _agree(r.hdr_image(), jr.hdr_image())
    ldr = r.ldr_image(exposure=1.5, gamma=2.2)
    _agree(ldr, jr.ldr_image(exposure=1.5, gamma=2.2))
    assert ldr.min() >= 0.0 and ldr.max() <= 1.0
    for got, ref in zip(r.aov_images(), jr.aov_images()):
        _agree(got, np.asarray(ref))


def test_render_stops_at_max_sample_count_where_jax_stops(box):
    jr, r = _renderers(box, {}, {})
    jr.max_sample_count = r.max_sample_count = 3
    jr.render(10)
    r.render(10)
    assert r.state.sample_count == int(jr.state.sample_count) == 3
    _agree(r.hdr_image(), jr.hdr_image())
    r.max_sample_count = None
    r.max_render_time = 0.0
    r.render(10)  # the time is up after one frame
    assert r.state.sample_count == 4


def test_reset_and_set_camera_match_jax(box):
    from hiprt_pt_tpu.core.camera import camera_translate as jtranslate
    from hiprt_pt_tpu_torch.core.camera import camera_translate

    jr, r = _renderers(box, {}, {})
    jr.step(block=True)
    r.step(block=True)
    r.reset()
    assert r.state.sample_count == 0 and float(r.state.accum.abs().sum()) == 0.0
    assert r._render_start_time is None
    jr.set_camera(jtranslate(jr.camera, 0.1, -0.05, 0.3))
    r.set_camera(camera_translate(r.camera, 0.1, -0.05, 0.3))
    assert r.state.sample_count == 0
    jr.step(block=True)
    r.step(block=True)
    assert r.state.sample_count == 1
    _agree(r.hdr_image(), jr.hdr_image())


def test_profile_and_kernel_stats_on_the_cpu(box):
    """profile() gives the JAX package's keys and leaves the live state as
    it was; kernel_stats() names the plain walks on the CPU."""
    jr, r = _renderers(box, {}, {})
    r.step()
    before = _state_tensors(r.state)
    prof = r.profile(frames=1)
    assert prof.keys() == jr.profile(frames=1).keys()
    assert prof["nb_bounces"] == 2 and prof["full_frame_ms"] > 0.0
    assert all(v >= 0.0 for v in prof.values())
    after = _state_tensors(r.state)
    assert r.state.sample_count == 1
    for k in before:
        assert np.array_equal(before[k], after[k], equal_nan=True), k
    assert r.metrics.get_average("full_frame_ms") == prof["full_frame_ms"]
    assert r.kernel_stats() == {"kernel": "plain walks",
                                "options": str(r.options)}


def test_recompile_restarts_the_sample_count(box):
    """After recompile() the stop conditions count only the new samples."""
    _jr, r = _renderers(box, {}, {})
    r.render(2)
    r.recompile(_lambert(False, do_energy_compensation=False))
    assert r.options.do_energy_compensation is False
    assert r.state.sample_count == 0
    r.max_sample_count = 2
    r.render(5)
    assert r.state.sample_count == 2
    assert float(r.state.accum.abs().sum()) > 0.0


@pytest.mark.xfail(strict=True, reason=(
    "the JAX package's recompile() does not reset its host sample count "
    "_sc_host (ADVICE.md, hiprt_pt_tpu/render/renderer.py:293), so render() "
    "stops after one new sample"))
def test_jax_recompile_restarts_the_sample_count(box):
    jr, _r = _renderers(box, {}, {})
    jr.render(2)
    jr.recompile(jr.options)
    jr.max_sample_count = 2
    jr.render(5)
    assert int(jr.state.sample_count) == 2


def _jax_sample_with_stats(c, opts, settings, world):
    """One JAX sample (camera pass + render_sample with the per-bounce alive
    counts) on the scene ``c``: (radiance, alive counts)."""
    from hiprt_pt_tpu.core import rng as jrng
    from hiprt_pt_tpu.core.state import init_render_state
    from hiprt_pt_tpu.render.integrator import camera_rays_pass, render_sample

    @jax.jit
    def run(state):
        rng = jrng.seed(jnp.arange(W * H, dtype=jnp.uint32), 0, 42)
        rng, g, active = camera_rays_pass(c["jscene"], c["jbvh"], c["jcam"],
                                          settings, state, W, H, 0, rng, opts)
        out = render_sample(opts, c["jscene"], c["jbvh"], world, settings, g,
                            active, rng, collect_bounce_stats=True)
        return out[1], out[5]

    rad, alive = run(init_render_state(W, H, 42))
    return np.asarray(rad), np.asarray(alive)


def _port_sample_with_stats(c, opts, settings, world):
    from hiprt_pt_tpu_torch.core import rng
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.integrator import (camera_rays_pass,
                                                      render_sample)

    s = rng.seed(torch.arange(W * H), 0, 42)
    s, g, active = camera_rays_pass(c["tscene"], c["tbvh"], c["tcam"],
                                    settings, init_render_state(W, H, 42, "cpu"),
                                    W, H, 0, s, opts)
    out = render_sample(opts, c["tscene"], c["tbvh"], world, settings, g,
                        active, s, collect_bounce_stats=True)
    assert len(out) == 6
    return out[1].numpy(), out[5].numpy()


@pytest.fixture(scope="module")
def automatic(spheres):
    """One sample of the principled Cornell scene (two glass spheres)
    under the AUTOMATIC interior stack, 4 bounces, in both packages."""
    from hiprt_pt_tpu.core import settings as js

    jopts = js.RenderOptions(
        direct_light_sampling=js.LightSamplingStrategy.MIS, max_bounces_static=4,
        interior_stack_strategy=js.InteriorStackStrategy.AUTOMATIC)
    jset = js.RenderSettings().replace(nb_bounces=jnp.int32(4))
    jworld = js.WorldSettings()
    opts = ts.RenderOptions(
        direct_light_sampling=ts.LightSamplingStrategy.MIS, max_bounces_static=4,
        interior_stack_strategy=ts.InteriorStackStrategy.AUTOMATIC)
    ref = _jax_sample_with_stats(spheres, jopts, jset, jworld)
    got = _port_sample_with_stats(spheres, opts, ts.RenderSettings(nb_bounces=4),
                                  interop.world_from_numpy(tp.to_numpy_dict(jworld)))
    return got, ref


def test_automatic_interior_stack_matches_jax(automatic):
    (rad, _), (ref, _) = automatic
    _agree(rad, ref)


def test_collect_bounce_stats_matches_jax(automatic):
    (_, alive), (_, ref) = automatic
    assert alive.dtype == np.int64 and alive.shape == ref.shape == (4,)
    np.testing.assert_array_equal(alive, ref.astype(np.int64))
    assert alive[0] > alive[-1] > 0


@pytest.fixture(scope="module")
def white_box():
    return _both(box_only=True, white=True)


def _furnace(jax_package: bool):
    from hiprt_pt_tpu.core import settings as js

    s = js if jax_package else ts
    return s.RenderOptions(bsdf_override=s.BSDFOverride.LAMBERTIAN,
                           direct_light_sampling=s.LightSamplingStrategy.BSDF_ONLY,
                           white_furnace_mode=True, max_bounces_static=4)


def test_white_furnace_mode_matches_jax(white_box):
    """The world given is ignored: furnace mode renders a uniform white
    environment with emission and NEE off."""
    from hiprt_pt_tpu.core import settings as js
    from hiprt_pt_tpu.core.state import init_render_state as jinit
    from hiprt_pt_tpu.render.renderer import render_step as jstep
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    c = white_box
    jworld = js.WorldSettings().replace(
        ambient_light_type=jnp.int32(int(js.AmbientLightType.NONE)))
    ref = jstep(_furnace(True), W, H, (c["jscene"], c["jbvh"]), jinit(W, H, 42),
                c["jcam"], js.RenderSettings().replace(nb_bounces=jnp.int32(4)),
                jworld)
    state = render_step(_furnace(False), W, H, c["tscene"], c["tbvh"],
                        init_render_state(W, H, 42, "cpu"), c["tcam"],
                        ts.RenderSettings(nb_bounces=4),
                        interop.world_from_numpy(tp.to_numpy_dict(jworld)))
    got = state.accum.numpy()
    _agree(got, np.asarray(ref.accum))
    assert int(state.rays_traced) == int(float(ref.rays_traced))
    assert got.max() <= 1.0 + 1e-3 and got.mean() > 0.5


def test_white_furnace_invariant(white_box):
    """As tests/test_integrator.py holds the JAX package (64 samples at
    16x16 there; here 4 at 64x64, as many paths in a sixteenth of the
    frames): white Lambertian surfaces in furnace mode, 16 bounces, no
    russian roulette: no pixel gains energy, and little is lost."""
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    c = white_box
    opts = _furnace(False).replace(max_bounces_static=16)
    r = Renderer(c["tscene"], c["tcam"], 64, 64, options=opts,
                 settings=ts.RenderSettings(nb_bounces=16, samples_per_frame=4,
                                            do_russian_roulette=False),
                 world=ts.WorldSettings(
                     ambient_light_type=int(ts.AmbientLightType.NONE)),
                 bvh=c["tbvh"])
    r.fuse_frame = True
    r.step(block=True)
    img = r.hdr_image()
    assert np.all(img <= 1.0 + 1e-3)
    assert img.mean() > 0.85


@pytest.mark.parametrize("window", [3, 64])
def test_performance_metrics_match_jax(window):
    from hiprt_pt_tpu.utils.perf import PerformanceMetrics as JMetrics
    from hiprt_pt_tpu_torch.utils.perf import PerformanceMetrics

    vals = np.random.default_rng(window).uniform(0.0, 50.0, 10)
    jm, m = JMetrics(window), PerformanceMetrics(window)
    for i, x in enumerate(vals):
        for k in ("a", "b") if i % 2 else ("a",):
            jm.add(k, x)
            m.add(k, x)
    assert m.names() == jm.names() == ["a", "b"]
    for k in ("a", "b", "absent"):
        assert m.values(k) == jm.values(k)
        for f in ("get_average", "get_variance", "get_stddev", "get_min",
                  "get_max"):
            assert getattr(m, f)(k) == getattr(jm, f)(k), (k, f)
    assert len(m.values("a")) == min(window, 10)
