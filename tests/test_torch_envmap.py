"""Environment maps in the port against the JAX package: the sampling tables
(assets/envmap.py), the textured eval, both samplers and the pdf of a
direction (lights/envmap_sampling.py), and one render sample with an envmap
on the procedural Cornell box (tests/torch_parity.py:cornell_spheres_arrays,
whose open front lets the envmap in) under MIS, RIS and ReSTIR DI, the scene
carried from the JAX package through hiprt_pt_tpu_torch.interop.

Image gates, as for the other render paths: >= 98% of pixels within
1e-3 + 1e-3·|ref| per channel, image mean within 1%, rays within 0.5%."""

import dataclasses
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
KINDS = ("sky", "sun", "white")
STRATEGIES = ("ALIAS_TABLE", "CDF_BINARY")


def _rotation(seed: int) -> np.ndarray:
    """A seeded random rotation (QR of a Gaussian matrix, det +1)."""
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


def _worlds(mode: str, seed: int = 3):
    """(JAX WorldSettings, the port's) with a random rotation, intensity
    1.7 and the ambient ``mode``."""
    from hiprt_pt_tpu.core import settings as js

    rot = _rotation(seed)
    jw = js.WorldSettings().replace(
        ambient_light_type=jnp.int32(int(getattr(js.AmbientLightType, mode))),
        uniform_light_color=jnp.asarray([0.3, 0.6, 0.9], jnp.float32),
        envmap_intensity=jnp.float32(1.7),
        envmap_to_world=jnp.asarray(rot), world_to_envmap=jnp.asarray(rot.T))
    return jw, interop.world_from_numpy(tp.to_numpy_dict(jw))


def _random_map(h=16, w=32, seed=5) -> np.ndarray:
    """A map whose every texel has its own value, so that equal radiance
    means the same texel."""
    return np.random.default_rng(seed).uniform(0.0, 4.0, (h, w, 3)).astype(np.float32)


def _envmaps(texels):
    """(the JAX package's EnvmapData, the port's from the same texels)."""
    from hiprt_pt_tpu.assets.envmap import build_envmap as jbuild
    from hiprt_pt_tpu_torch.assets.envmap import build_envmap

    return jbuild(texels), build_envmap(texels, device="cpu")


def _directions(n: int, seed: int) -> np.ndarray:
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("kind", KINDS)
def test_envmap_tables_equal_jax(kind):
    from hiprt_pt_tpu.assets.envmap import make_test_envmap as jmake
    from hiprt_pt_tpu_torch.assets.envmap import make_test_envmap

    texels = make_test_envmap(64, 128, kind)
    np.testing.assert_array_equal(texels, jmake(64, 128, kind))
    jenv, env = _envmaps(texels)
    for k in ("texels", "cdf", "alias_probas", "alias_indices"):
        np.testing.assert_array_equal(getattr(env, k).numpy(),
                                      np.asarray(getattr(jenv, k)), err_msg=k)
    assert env.alias_indices.dtype == torch.int32
    assert env.total_luminance == float(jenv.total_luminance)
    # interop carries the same tables
    got = interop.envmap_from_numpy(tp.to_numpy_dict(jenv), "cpu")
    for k in ("cdf", "alias_probas", "alias_indices"):
        assert torch.equal(getattr(got, k), getattr(env, k)), k


@pytest.mark.parametrize("mode", ["NONE", "UNIFORM", "ENVMAP"])
def test_eval_envmap_matches_jax(mode):
    from hiprt_pt_tpu.assets.envmap import make_test_envmap
    from hiprt_pt_tpu.lights.envmap_sampling import eval_envmap as jeval
    from hiprt_pt_tpu_torch.lights.envmap_sampling import eval_envmap

    jw, tw = _worlds(mode)
    jenv, env = _envmaps(make_test_envmap(64, 128, "sky"))
    d = _directions(8192, 11)
    ref = np.asarray(jax.jit(lambda x: jeval(jw, jenv, x))(jnp.asarray(d)))
    got = eval_envmap(tw, env, torch.from_numpy(d)).numpy()
    assert got.shape == ref.shape == (8192, 3)
    # XLA's dot, arccos and atan2 round differently from torch's in the last
    # bit of u and v, which moves a bilinear fetch across the sun disk
    # (radiance up to 85 here, where one float32 ulp is 7.6e-6) by a few
    # ulps: atol 1e-6 plus rtol 1e-5
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    if mode == "ENVMAP":
        assert ref.max() > 1.0  # the sun disk is in view


@pytest.mark.parametrize("texels", ["random", "sky"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sample_envmap_matches_jax(strategy, texels):
    """From the same PCG state both packages draw the same texel on every
    ray (every texel of the random map has its own radiance), the same
    direction and pdf, and leave the same RNG state."""
    from hiprt_pt_tpu.assets.envmap import make_test_envmap
    from hiprt_pt_tpu.core import rng as jrng
    from hiprt_pt_tpu.core import settings as js
    from hiprt_pt_tpu.lights.envmap_sampling import sample_envmap as jsample
    from hiprt_pt_tpu_torch.core import rng
    from hiprt_pt_tpu_torch.lights.envmap_sampling import sample_envmap

    tex = _random_map() if texels == "random" else make_test_envmap(64, 128, "sky")
    jenv, env = _envmaps(tex)
    jw, tw = _worlds("ENVMAP")
    n = 8192
    jopts = js.RenderOptions(envmap_sampling=getattr(js.EnvmapSamplingStrategy, strategy))
    opts = ts.RenderOptions(envmap_sampling=getattr(ts.EnvmapSamplingStrategy, strategy))
    js0 = jrng.seed(jnp.arange(n, dtype=jnp.uint32), 3, 42)
    s0 = rng.seed(torch.arange(n), 3, 42)
    js1, jwi, jrad, jpdf = jax.jit(
        lambda s: jsample(jopts, jw, jenv, s, n))(js0)
    s1, wi, rad, pdf = sample_envmap(opts, tw, env, s0)
    np.testing.assert_array_equal(s1.numpy().astype(np.uint32), np.asarray(js1))
    np.testing.assert_array_equal(rad.numpy(), np.asarray(jrad))
    np.testing.assert_allclose(wi.numpy(), np.asarray(jwi), rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-5)
    assert (pdf.numpy() > 0.0).all()


@pytest.mark.parametrize("texels", ["random", "sky"])
def test_envmap_pdf_of_direction_matches_jax(texels):
    from hiprt_pt_tpu.assets.envmap import make_test_envmap
    from hiprt_pt_tpu.core import settings as js
    from hiprt_pt_tpu.lights.envmap_sampling import envmap_pdf_of_direction as jpdf
    from hiprt_pt_tpu_torch.lights.envmap_sampling import envmap_pdf_of_direction

    tex = _random_map() if texels == "random" else make_test_envmap(64, 128, "sky")
    jenv, env = _envmaps(tex)
    jw, tw = _worlds("ENVMAP")
    d = _directions(8192, 17)
    ref = np.asarray(jax.jit(lambda x: jpdf(js.RenderOptions(), jw, jenv, x))(
        jnp.asarray(d)))
    got = envmap_pdf_of_direction(tw, env, torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)


# --- one render sample with an envmap, both packages ---


@pytest.fixture(scope="module")
def cornell_env():
    """The Cornell scene with the "sky" test envmap, built by the JAX
    package and carried into the port through interop; the port's BVH
    (bit-identical tables) and camera."""
    from hiprt_pt_tpu.accel.build import build_bvh as jbvh
    from hiprt_pt_tpu.assets.envmap import build_envmap, make_test_envmap
    from hiprt_pt_tpu.assets.scene import build_scene as jscene
    from hiprt_pt_tpu.core.camera import camera_from_lookat as jcam
    from hiprt_pt_tpu.core.material import MaterialBank as JBank
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat

    v, f, m, rows, cam = tp.cornell_spheres_arrays(W / H)
    jsc = jscene(v, f, m, JBank.from_rows(rows),
                 envmap=build_envmap(make_test_envmap(64, 128, "sky")))
    return dict(jscene=jsc, jcam=jcam(**cam), jbvh=jbvh(v, f),
                tscene=interop.scene_from_numpy(tp.to_numpy_dict(jsc), "cpu"),
                tcam=camera_from_lookat(**cam, device="cpu"),
                tbvh=build_bvh(v, f, "cpu"))


def _configs(strategy: str):
    """(JAX options, settings, world; the port's) of run_configs.py's config
    3 at 3 bounces under the light strategy ``strategy``: the full
    principled BSDF under MIS (the config itself); under RIS and ReSTIR DI
    the Lambertian override without dispersion, which keeps the JAX
    package's compile short (the principled BSDF under RIS and ReSTIR is
    held in tests/test_torch_ris.py and test_torch_restir.py)."""
    from hiprt_pt_tpu.core import settings as js

    lambert = {} if strategy == "MIS" else dict(do_dispersion=False)
    jopts = js.RenderOptions(
        direct_light_sampling=getattr(js.LightSamplingStrategy, strategy),
        envmap_sampling=js.EnvmapSamplingStrategy.ALIAS_TABLE,
        max_bounces_static=3, **lambert,
        **({} if strategy == "MIS"
           else dict(bsdf_override=js.BSDFOverride.LAMBERTIAN)))
    jset = js.RenderSettings().replace(nb_bounces=jnp.int32(3))
    jworld = js.WorldSettings().replace(
        ambient_light_type=jnp.int32(int(js.AmbientLightType.ENVMAP)))
    opts = ts.RenderOptions(
        direct_light_sampling=getattr(ts.LightSamplingStrategy, strategy),
        envmap_sampling=ts.EnvmapSamplingStrategy.ALIAS_TABLE,
        max_bounces_static=3, **lambert,
        **({} if strategy == "MIS"
           else dict(bsdf_override=ts.BSDFOverride.LAMBERTIAN)))
    return (jopts, jset, jworld, opts, ts.RenderSettings(nb_bounces=3),
            interop.world_from_numpy(tp.to_numpy_dict(jworld)))


def assert_images_agree(got, ref, rays_got, rays_ref):
    assert np.isfinite(got).all()
    close = np.all(np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= 0.98, close.mean()
    assert abs(got.mean() - ref.mean()) <= 0.01 * abs(ref.mean())
    assert abs(rays_got - rays_ref) <= 0.005 * rays_ref


@pytest.mark.parametrize("strategy", ["MIS", "RIS_BSDF_LIGHT", "RESTIR_DI"])
def test_render_with_envmap_matches_jax(cornell_env, strategy, monkeypatch):
    """One sample at 32x16; every envmap shadow ray is an any-hit trace
    with an infinite t_max on the meganode walk."""
    from hiprt_pt_tpu.core.state import init_render_state as jinit
    from hiprt_pt_tpu.render.renderer import render_step as jstep
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.ops import traverse as plain
    from hiprt_pt_tpu_torch.render.renderer import render_step

    jopts, jset, jworld, opts, settings, world = _configs(strategy)
    restir = strategy == "RESTIR_DI"
    c = cornell_env
    ref = jstep(jopts, W, H, (c["jscene"], c["jbvh"]),
                jinit(W, H, 42, with_restir=restir), c["jcam"], jset, jworld)
    unbounded = []
    walk = plain.traverse_meganode

    def counted(bvh, o, d, t_min=1e-4, t_max=float("inf"), active=None,
                any_hit=False):
        if any_hit and isinstance(t_max, float) and t_max == float("inf"):
            unbounded.append(int(active.sum()))
        return walk(bvh, o, d, t_min, t_max, active, any_hit=any_hit)

    monkeypatch.setattr(plain, "traverse_meganode", counted)
    state = render_step(opts, W, H, c["tscene"], c["tbvh"],
                        init_render_state(W, H, 42, "cpu", with_restir=restir),
                        c["tcam"], settings, world)
    # one envmap shadow wavefront a bounce (ReSTIR's camera vertex masks
    # its own: the reservoirs hold the envmap candidates there)
    assert len(unbounded) == 3 and max(unbounded) > 0
    assert (unbounded[0] == 0) == restir
    assert_images_agree(state.accum.numpy(), np.asarray(ref.accum),
                        int(state.rays_traced), float(ref.rays_traced))


def test_envmap_strategies_agree():
    """The port's envmap samplers agree with each other and with BSDF
    sampling alone, as tests/test_envmap_strategies.py holds the JAX
    package's (32x32 at 48, 48 and 160 samples there; here 128x128 at 3,
    3 and 10, as many paths a crop in a sixteenth of the frames): the
    Cornell box without its spheres (its first 12 triangles, like the JAX
    package's fallback box) and without emission, lit only by the sky
    through its open front, Lambertian, MIS, 2 bounces."""
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.assets.envmap import build_envmap, make_test_envmap
    from hiprt_pt_tpu_torch.assets.scene import build_scene
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat
    from hiprt_pt_tpu_torch.core.material import MaterialBank
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    v, f, m, rows, cam = tp.cornell_spheres_arrays(1.0)
    f, m = f[:12], m[:12]
    bank = MaterialBank.from_rows(rows)
    bank = dataclasses.replace(
        bank, emission_strength=torch.zeros_like(bank.emission_strength))
    scene = build_scene(v, f, m, bank, device="cpu",
                        envmap=build_envmap(make_test_envmap(32, 64, "sky"),
                                            device="cpu"))
    assert scene.num_emissives == 0
    camera, bvh = camera_from_lookat(**cam, device="cpu"), build_bvh(v, f, "cpu")

    def render(strategy, spp, seed):
        opts = ts.RenderOptions(
            bsdf_override=ts.BSDFOverride.LAMBERTIAN,
            direct_light_sampling=ts.LightSamplingStrategy.MIS,
            envmap_sampling=strategy, max_bounces_static=2)
        r = Renderer(scene, camera, 128, 128, options=opts,
                     settings=ts.RenderSettings(nb_bounces=2,
                                                samples_per_frame=spp),
                     world=ts.WorldSettings(
                         ambient_light_type=int(ts.AmbientLightType.ENVMAP)),
                     bvh=bvh, seed=seed)
        r.fuse_frame = True
        r.step(block=True)
        return r.hdr_image()

    img_alias = render(ts.EnvmapSamplingStrategy.ALIAS_TABLE, 3, 42)
    img_cdf = render(ts.EnvmapSamplingStrategy.CDF_BINARY, 3, 7)
    img_none = render(ts.EnvmapSamplingStrategy.NO_SAMPLING, 10, 13)
    a, c, n = (img[16:-16, 16:-16].mean() for img in (img_alias, img_cdf, img_none))
    assert abs(a - c) / max(a, 1e-6) < 0.08, (a, c)
    assert abs(a - n) / max(a, 1e-6) < 0.3, (a, n)
    for img in (img_alias, img_cdf, img_none):
        assert np.all(np.isfinite(img))


def test_envmap_path_is_run_configs_config_3():
    """paths.py's envmap path: run_configs.py's config 3 options (every
    field the JAX package's RenderOptions shares), 6 bounces, ambient
    ENVMAP, the Cornell path's scene and routes with the "sky" test envmap,
    19 trace_meganode launches a frame as chip_smoke.py reckons them."""
    import chip_smoke
    from hiprt_pt_tpu.assets.envmap import build_envmap, make_test_envmap
    from hiprt_pt_tpu.core import settings as js
    from hiprt_pt_tpu_torch import paths

    opts, settings, world = paths.slice_options("envmap")
    jopts = js.RenderOptions(
        direct_light_sampling=js.LightSamplingStrategy.MIS,
        envmap_sampling=js.EnvmapSamplingStrategy.ALIAS_TABLE,
        max_bounces_static=6)
    for f in dataclasses.fields(opts):
        if hasattr(jopts, f.name):
            assert getattr(opts, f.name) == getattr(jopts, f.name), f.name
    assert (settings.nb_bounces, settings.samples_per_frame) == (6, 1)
    assert world == ts.WorldSettings(
        ambient_light_type=int(ts.AmbientLightType.ENVMAP))
    assert paths.ROUTES["envmap"] == paths.ROUTES["cornell"]
    scene, _cam, bvh, _secs = paths.load("envmap", "cpu")
    cornell = paths.load("cornell", "cpu")[0]
    assert torch.equal(scene.vertices, cornell.vertices)
    assert scene.num_emissives == cornell.num_emissives == 2
    ref = build_envmap(make_test_envmap(64, 128, "sky"))
    for k in ("texels", "cdf", "alias_probas", "alias_indices"):
        np.testing.assert_array_equal(getattr(scene.envmap, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    per_kind = chip_smoke.launches_per_frame("envmap", scene)
    assert per_kind == {("envmap", "trace_meganode", k): n for k, n in
                        (("camera", 1), ("shadow", 6), ("bounce", 6),
                         ("envmap", 6))}
    assert chip_smoke.launches_per_frame("cornell", cornell) == {
        ("cornell", "trace_meganode", k): n
        for k, n in (("camera", 1), ("shadow", 4), ("bounce", 4))}
