"""The port's ReSTIR DI (hiprt_pt_tpu_torch/restir/di.py, bias.py, the
ReSTIR branch of render/renderer.py and the path ``restir`` of paths.py)
against the JAX package on the textured stress interior at a small size
(tri_scale 0.01: ~122k triangles, 240 emissive triangles, 18 textures;
64x32 pixels).

The inputs of frame 2's ReSTIR pipeline come from the JAX package's render
steps: frame 1's G-buffer, reservoirs and view-projection, frame 2's
G-buffer and the materials there, carried into the port as numpy. Each pass then runs in both packages on the same inputs; a pass's
input reservoir is the JAX package's output of the pass before. The JAX
scene is handed over with ``emissive_woop=None``, so both find BSDF
candidates' emitters with the dense sweep (tests/test_torch_ris.py).

Tolerances: the RNG state after a pass is exact. A pixel's winner agrees
when its light point is within atol 1e-5 and its envmap flag equal; winners
agree on >= 99% of the pixels; where they agree, W, the target and the
weight sum are within atol 1e-5 / rtol 1e-4 (XLA's CPU code may contract
products into FMAs) and M is within 1e-4. Measured: the winners of every
pass here agree on every pixel, so no tap moved, with the port's
back-projection summed term by term (restir/di.py:_back_project). The whole
step (2 samples, so temporal reuse has a frame before it) holds radiance
within atol 1e-3 + rtol 1e-3 on >= 97% of the pixels and the rays traced
within 0.5%, as tests/test_torch_ris.py holds RIS."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch_parity as tp  # noqa: E402

from hiprt_pt_tpu_torch import interop, paths  # noqa: E402
from hiprt_pt_tpu_torch.core import settings as ts  # noqa: E402

W, H = 64, 32
N = W * H
# the render steps' bounces (the camera vertex's ReSTIR and one RIS vertex
# after it; the path runs 4), as tests/test_torch_headline.py cuts them
BOUNCES = 2
ATOL, RTOL = 1e-5, 1e-4
WINNER_MIN = 0.99
SCHEMES = tuple(ts.ReSTIRBiasCorrection)


def _t(x):
    return torch.from_numpy(np.array(x))


def _configs(**opt_kw):
    """(JAX options, settings, world), (the port's): bench.py's ReSTIR row
    (RESTIR_DI, ambient NONE, the rest defaults) cut to BOUNCES bounces."""
    from hiprt_pt_tpu.core import settings as js

    jo = js.RenderOptions(direct_light_sampling=js.LightSamplingStrategy.RESTIR_DI,
                          max_bounces_static=BOUNCES, **opt_kw)
    jset = js.RenderSettings().replace(nb_bounces=jnp.int32(BOUNCES))
    jworld = js.WorldSettings().replace(
        ambient_light_type=jnp.int32(int(js.AmbientLightType.NONE)))
    to = ts.RenderOptions(direct_light_sampling=ts.LightSamplingStrategy.RESTIR_DI,
                          max_bounces_static=BOUNCES, **opt_kw)
    return (jo, jset, jworld), (to, ts.RenderSettings(nb_bounces=BOUNCES),
                                ts.WorldSettings(ambient_light_type=int(
                                    ts.AmbientLightType.NONE)))


@pytest.fixture(scope="module")
def both():
    """The scenes, and two render steps of each package from the same
    scene arrays."""
    from hiprt_pt_tpu.core.state import init_render_state as jinit
    from hiprt_pt_tpu.render.renderer import render_step as jstep
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    jscene, jcam, jbvh = tp.jax_stress(aspect=W / H, with_textures=True)
    jscene = jscene.replace(emissive_woop=None)
    tscene, tcam, tbvh = tp.port_of(jscene, jcam, jbvh)
    (jo, jset, jworld), (to, tset, tworld) = _configs()
    j1 = jstep(jo, W, H, (jscene, jbvh), jinit(W, H, 42, with_restir=True),
               jcam, jset, jworld)
    j1_np = tp.to_numpy_dict(j1)
    j2 = jstep(jo, W, H, (jscene, jbvh), j1, jcam, jset, jworld)
    t1 = render_step(to, W, H, tscene, tbvh,
                     init_render_state(W, H, 42, "cpu", with_restir=True),
                     tcam, tset, tworld)
    t2 = render_step(to, W, H, tscene, tbvh, t1, tcam, tset, tworld)
    return dict(jscene=jscene, jcam=jcam, jbvh=jbvh, tscene=tscene, tcam=tcam,
                tbvh=tbvh, j1=j1_np, j2=tp.to_numpy_dict(j2), t2=t2)


@pytest.fixture(scope="module")
def stage(both):
    """Frame 2's pipeline inputs from the JAX package's render steps, in
    both packages: frame 2's G-buffer, the textured materials there, the
    relative IOR, the active mask, the RNG after frame 2's camera pass (its
    two jitter draws) and frame 1's G-buffer, reservoirs and
    view-projection."""
    from hiprt_pt_tpu.core import rng as jrng
    from hiprt_pt_tpu.core.state import GBuffer as JGBuffer
    from hiprt_pt_tpu.ops.texture import apply_textures
    from hiprt_pt_tpu.restir.reservoir import Reservoir as JReservoir
    from hiprt_pt_tpu_torch.core.material import FIELD_NAMES, MaterialBank

    jscene, j1, j2 = both["jscene"], both["j1"], both["j2"]
    state1 = interop.state_from_numpy(j1, "cpu")  # the port's copies
    state2 = interop.state_from_numpy(j2, "cpu")
    prev_gbuf = JGBuffer(**{k: jnp.asarray(v) for k, v in j1["gbuffer"].items()})
    prev_res = JReservoir(**{k: jnp.asarray(v) for k, v in j1["restir"].items()})
    g = JGBuffer(**{k: jnp.asarray(v) for k, v in j2["gbuffer"].items()})
    rng = jrng.seed(jnp.arange(N, dtype=jnp.uint32), 1, 42)
    rng, _jx = jrng.next_float(rng)
    rng, _jy = jrng.next_float(rng)
    active0 = g.prim_index >= 0
    m = jscene.materials.at_indices(jnp.maximum(g.material_id, 0)).make_safe()
    m = apply_textures(jscene.textures, m, g.uv)
    ior = jnp.maximum(m.ior, 1.0 + 1e-3)
    eta = jnp.where(~g.backface, ior, 1.0 / ior)
    return dict(
        j=dict(gbuf=g, prev_gbuf=prev_gbuf, prev_res=prev_res, mats=m,
               eta=eta, active=active0, rng=rng,
               prev_vp=jnp.asarray(j1["prev_view_proj"])),
        t=dict(gbuf=state2.gbuffer, prev_gbuf=state1.gbuffer,
               prev_res=state1.restir,
               mats=MaterialBank(**{k: _t(getattr(m, k)) for k in FIELD_NAMES}),
               eta=_t(eta), active=_t(active0),
               prev_vp=_t(j1["prev_view_proj"])))


def _rng_t(jr):
    return torch.from_numpy(np.asarray(jr).astype(np.int64))


def _res_t(jres):
    return interop.reservoir_from_numpy(tp.to_numpy_dict(jres), "cpu")


def _hold(got, ref, jr, tr, what):
    """Hold the port's reservoir and RNG against the JAX package's."""
    assert np.array_equal(np.asarray(jr).astype(np.int64), tr.numpy()), what
    lp_ok = np.all(np.abs(got.light_point.numpy() - np.asarray(ref.light_point))
                   <= ATOL, axis=-1)
    agree = lp_ok & (got.is_envmap.numpy() == np.asarray(ref.is_envmap))
    assert agree.mean() >= WINNER_MIN, (what, agree.mean())
    for k in ("W", "target", "weight_sum"):
        np.testing.assert_allclose(getattr(got, k).numpy()[agree],
                                   np.asarray(getattr(ref, k))[agree],
                                   atol=ATOL, rtol=RTOL, err_msg=f"{what} {k}")
    np.testing.assert_allclose(got.M.numpy()[agree], np.asarray(ref.M)[agree],
                               atol=1e-4, err_msg=f"{what} M")


@pytest.fixture(scope="module")
def initial(both, stage):
    """Frame 2's presampled pool and initial candidates, JAX package."""
    from hiprt_pt_tpu.restir import di as jdi

    (jo, jset, jworld), _ = _configs()
    j = stage["j"]
    pool = jdi.presample_lights(both["jscene"], 1, jo)
    g = j["gbuf"]
    res, rng = jdi.initial_candidates(
        jo, both["jscene"], both["jbvh"], jworld, jset, j["mats"], g.position,
        g.shading_normal, g.geometric_normal, g.view_direction, j["eta"],
        j["active"], j["rng"], pool=pool,
        tile_id=jnp.arange(N, dtype=jnp.int32) // 128)
    return pool, res, rng


@pytest.fixture(scope="module")
def temporal(both, stage, initial):
    """Frame 2's temporal reuse, JAX package."""
    from hiprt_pt_tpu.restir import di as jdi

    (jo, jset, _), _ = _configs()
    j = stage["j"]
    _pool, res0, rng0 = initial
    return jdi.temporal_reuse(jo, jset, both["jscene"], j["mats"], j["gbuf"],
                              j["prev_gbuf"], j["prev_res"], res0, j["eta"],
                              j["active"], W, H, j["prev_vp"], rng0)


def test_presample_lights_matches_jax(both, initial):
    from hiprt_pt_tpu_torch.restir import di as tdi

    _, (to, _, _) = _configs()
    jpool = initial[0]
    tpool = tdi.presample_lights(both["tscene"], 1, to)
    assert (tpool["S"], tpool["K"]) == (jpool["S"], jpool["K"]) == (128, 1024)
    assert np.array_equal(tpool["valid"].numpy(), np.asarray(jpool["valid"]))
    assert np.array_equal(tpool["is_envmap"].numpy(), np.asarray(jpool["is_envmap"]))
    for k in ("light_point", "light_normal", "radiance", "pdf"):
        np.testing.assert_allclose(tpool[k].numpy(), np.asarray(jpool[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    assert float(tpool["pdf"].min()) > 0.0


def test_initial_candidates_matches_jax(both, stage, initial):
    from hiprt_pt_tpu_torch.restir import di as tdi

    _, (to, tset, tworld) = _configs()
    t, g = stage["t"], stage["t"]["gbuf"]
    tpool = tdi.presample_lights(both["tscene"], 1, to)
    res, rng = tdi.initial_candidates(
        to, both["tscene"], both["tbvh"], tworld, tset, t["mats"], g.position,
        g.shading_normal, g.geometric_normal, g.view_direction, t["eta"],
        t["active"], _rng_t(stage["j"]["rng"]), pool=tpool,
        tile_id=torch.arange(N, dtype=torch.int32) // 128)
    # the JAX package's initial_candidates ends with visibility reuse, a
    # pass of its own in the port
    res = tdi.visibility_reuse(to, both["tbvh"], g.position,
                               g.geometric_normal, res, t["active"])
    _hold(res, initial[1], initial[2], rng, "initial candidates")
    # visibility reuse zeroed the W of occluded winners
    has, lit = (float((x > 0).float().mean()) for x in (res.weight_sum, res.W))
    assert 0.05 < lit < has


def test_initial_candidates_without_pool_matches_jax(both, stage):
    """Light candidates drawn per pixel from the alias table (no pool), no
    visibility reuse."""
    from hiprt_pt_tpu.restir import di as jdi
    from hiprt_pt_tpu_torch.restir import di as tdi

    kw = dict(restir_do_light_presampling=False,
              restir_di_initial_visibility=False)
    (jo, jset, jworld), (to, tset, tworld) = _configs(**kw)
    j, t = stage["j"], stage["t"]
    g, tg = j["gbuf"], t["gbuf"]
    jres, jr = jdi.initial_candidates(
        jo, both["jscene"], both["jbvh"], jworld, jset, j["mats"], g.position,
        g.shading_normal, g.geometric_normal, g.view_direction, j["eta"],
        j["active"], j["rng"])
    tres, tr = tdi.initial_candidates(
        to, both["tscene"], both["tbvh"], tworld, tset, t["mats"], tg.position,
        tg.shading_normal, tg.geometric_normal, tg.view_direction, t["eta"],
        t["active"], _rng_t(j["rng"]))
    _hold(tres, jres, jr, tr, "initial candidates without pool")


def test_initial_candidates_traced_bsdf_candidates_match_jax(both, stage,
                                                            monkeypatch):
    """A scene with more emitters than the dense sweep takes: the BSDF
    candidates find their emitter by a closest-hit trace (both packages'
    DENSE_EMISSIVE_MAX set to 0 for the 240 emitters here)."""
    import hiprt_pt_tpu.lights.ris as jris
    from hiprt_pt_tpu.restir import di as jdi
    from hiprt_pt_tpu_torch.restir import di as tdi

    monkeypatch.setattr(jris, "DENSE_EMISSIVE_MAX", 0)
    monkeypatch.setattr(tdi, "DENSE_EMISSIVE_MAX", 0)
    (jo, jset, jworld), (to, tset, tworld) = _configs()
    j, t = stage["j"], stage["t"]
    g, tg = j["gbuf"], t["gbuf"]
    jres, jr = jdi.initial_candidates(
        jo, both["jscene"], both["jbvh"], jworld, jset, j["mats"], g.position,
        g.shading_normal, g.geometric_normal, g.view_direction, j["eta"],
        j["active"], j["rng"])
    tres, tr = tdi.initial_candidates(
        to, both["tscene"], both["tbvh"], tworld, tset, t["mats"], tg.position,
        tg.shading_normal, tg.geometric_normal, tg.view_direction, t["eta"],
        t["active"], _rng_t(j["rng"]))
    tres = tdi.visibility_reuse(to, both["tbvh"], tg.position,
                                tg.geometric_normal, tres, t["active"])
    _hold(tres, jres, jr, tr, "initial candidates, traced BSDF candidates")
    # the trace stops at occluders, which the dense sweep looks through
    monkeypatch.setattr(tdi, "DENSE_EMISSIVE_MAX", 1024)
    dense, _ = tdi.initial_candidates(
        to, both["tscene"], both["tbvh"], tworld, tset, t["mats"], tg.position,
        tg.shading_normal, tg.geometric_normal, tg.view_direction, t["eta"],
        t["active"], _rng_t(j["rng"]))
    assert not torch.equal(dense.weight_sum, tres.weight_sum)


@pytest.mark.parametrize("permutation", [False, True],
                         ids=["exact tap", "permutation sampling"])
def test_temporal_reuse_matches_jax(both, stage, initial, temporal,
                                    permutation):
    """Temporal reuse on the JAX package's frame-1 state; with permutation
    sampling the exact reprojected tap moves by the frame's permutation
    bits (read from the first pixel's RNG state)."""
    from hiprt_pt_tpu.restir import di as jdi
    from hiprt_pt_tpu_torch.restir import di as tdi

    (jo, jset, _), (to, tset, _) = _configs()
    t = stage["t"]
    _pool, res0, rng0 = initial
    ref = temporal
    if permutation:
        j = stage["j"]
        jset = jset.replace(restir_di=jset.restir_di.replace(
            temporal_use_permutation_sampling=jnp.bool_(True)))
        tset = tset.replace(restir_di=tset.restir_di.replace(
            temporal_use_permutation_sampling=True))
        ref = jdi.temporal_reuse(jo, jset, both["jscene"], j["mats"], j["gbuf"],
                                 j["prev_gbuf"], j["prev_res"], res0, j["eta"],
                                 j["active"], W, H, j["prev_vp"], rng0)
        # the permutation moves the winners of some pixels
        assert not np.array_equal(np.asarray(ref[0].light_point),
                                  np.asarray(temporal[0].light_point))
    res, rng = tdi.temporal_reuse(
        to, tset, both["tscene"], t["mats"], t["gbuf"], t["prev_gbuf"],
        t["prev_res"], _res_t(res0), t["eta"], t["active"], W, H, t["prev_vp"],
        _rng_t(rng0))
    _hold(res, ref[0], ref[1], rng, "temporal reuse")
    # the previous frame's reservoirs were found and combined
    assert float((res.M > 1.0).float().mean()) > 0.3


@pytest.mark.parametrize("scheme", SCHEMES, ids=[s.name for s in SCHEMES])
def test_spatial_reuse_pass_matches_jax(both, stage, temporal, scheme):
    """The last spatial pass (with its visibility ray) under each of the six
    bias corrections, on the JAX package's temporal output."""
    from hiprt_pt_tpu.restir import di as jdi
    from hiprt_pt_tpu.core.settings import ReSTIRBiasCorrection as JScheme
    from hiprt_pt_tpu_torch.restir import di as tdi

    (jo, jset, _), (to, tset, _) = _configs()
    jo = jo.replace(restir_di_bias_correction=JScheme(int(scheme)))
    to = to.replace(restir_di_bias_correction=scheme)
    j, t = stage["j"], stage["t"]
    res0, rng0 = temporal
    jres, jr = jdi.spatial_reuse_pass(
        jo, jset, both["jscene"], j["mats"], j["gbuf"], res0, j["eta"],
        j["active"], W, H, rng0, bvh=both["jbvh"], is_last_pass=True)
    tres, tr = tdi.spatial_reuse_pass(
        to, tset, both["tscene"], t["mats"], t["gbuf"], _res_t(res0), t["eta"],
        t["active"], W, H, _rng_t(rng0), bvh=both["tbvh"], is_last_pass=True)
    _hold(tres, jres, jr, tr, f"spatial pass {scheme.name}")


def test_fused_spatiotemporal_reuse_matches_jax(both, stage, initial):
    from hiprt_pt_tpu.restir import di as jdi
    from hiprt_pt_tpu_torch.restir import di as tdi

    (jo, jset, _), (to, tset, _) = _configs(restir_di_fused_spatiotemporal=True)
    j, t = stage["j"], stage["t"]
    _pool, res0, rng0 = initial
    jres, jr = jdi.fused_spatiotemporal_reuse(
        jo, jset, both["jscene"], j["mats"], j["gbuf"], j["prev_gbuf"],
        j["prev_res"], res0, j["eta"], j["active"], W, H, j["prev_vp"], rng0)
    tres, tr = tdi.fused_spatiotemporal_reuse(
        to, tset, both["tscene"], t["mats"], t["gbuf"], t["prev_gbuf"],
        t["prev_res"], _res_t(res0), t["eta"], t["active"], W, H,
        t["prev_vp"], _rng_t(rng0))
    _hold(tres, jres, jr, tr, "fused spatiotemporal reuse")


def test_final_shading_matches_jax(both, stage, temporal):
    """Final shading of the temporal output: radiance per pixel and the
    count of visibility rays that found their light, which is what the JAX
    package adds to rays_traced."""
    from hiprt_pt_tpu.restir import di as jdi
    from hiprt_pt_tpu_torch.restir import di as tdi

    (jo, jset, jworld), (to, tset, tworld) = _configs()
    j, t = stage["j"], stage["t"]
    res0, rng0 = temporal
    jc, jn, _ = jdi.final_shading(jo, both["jscene"], both["jbvh"], jworld,
                                  j["mats"], j["gbuf"], res0, j["eta"],
                                  j["active"], rng_state=rng0, settings=jset)
    tc, tn, _ = tdi.final_shading(to, both["tscene"], both["tbvh"], tworld,
                                  t["mats"], t["gbuf"], _res_t(res0), t["eta"],
                                  t["active"], rng_state=_rng_t(rng0),
                                  settings=tset)
    ref, got = np.asarray(jc), tc.numpy()
    assert (ref.sum(-1) > 0).mean() > 0.3
    close = np.all(np.abs(got - ref) <= ATOL + RTOL * np.abs(ref), axis=-1)
    assert close.mean() >= WINNER_MIN, close.mean()
    assert tn.dtype == torch.int64 and int(tn) == int(jn)


@pytest.mark.parametrize("case", ["defaults", "1/M", "no final visibility",
                                  "adaptive", "RIS"])
def test_bias_status_matches_jax(case):
    from hiprt_pt_tpu.restir.bias import bias_status as jbias
    from hiprt_pt_tpu.core import settings as js
    from hiprt_pt_tpu_torch.restir.bias import bias_status

    kw = {"1/M": dict(restir_di_bias_correction=0,
                      restir_di_initial_visibility=False,
                      ris_use_visibility_target=True),
          "no final visibility": dict(restir_di_final_visibility=False)}.get(case, {})
    (jo, jset, _), (to, tset, _) = _configs()
    jo = jo.replace(**{k: (js.ReSTIRBiasCorrection(v)
                           if k == "restir_di_bias_correction" else v)
                       for k, v in kw.items()})
    to = to.replace(**{k: (ts.ReSTIRBiasCorrection(v)
                           if k == "restir_di_bias_correction" else v)
                       for k, v in kw.items()})
    if case == "adaptive":
        jset = jset.replace(enable_adaptive_sampling=jnp.bool_(True))
        tset = tset.replace(enable_adaptive_sampling=True)
    if case == "RIS":
        jo = jo.replace(direct_light_sampling=js.LightSamplingStrategy.RIS_BSDF_LIGHT)
        to = to.replace(direct_light_sampling=ts.LightSamplingStrategy.RIS_BSDF_LIGHT)
    got, ref = bias_status(to, tset), jbias(jo, jset)
    assert got == ref
    assert got["active"] == (case != "RIS")
    assert len(got["reasons"]) == {"defaults": 1, "1/M": 2,
                                   "no final visibility": 2, "adaptive": 2,
                                   "RIS": 0}[case]


def test_render_step_matches_jax(both):
    """bench.py's ReSTIR configuration (RESTIR_DI, the principled BSDF with
    dispersion and thin film, textures, ambient NONE; 2 bounces) over two
    samples, so the second has a frame to reuse: the accumulated radiance
    per pixel, the rays traced and the reservoirs after the second step."""
    ref, st = both["j2"], both["t2"]
    got = st.accum.numpy()
    assert np.isfinite(got).all()
    assert (got.sum(-1) > 0).mean() > 0.3
    close = np.all(np.abs(got - ref["accum"]) <= 1e-3 + 1e-3 * np.abs(ref["accum"]),
                   axis=-1)
    assert close.mean() >= 0.97, close.mean()
    rays_ref = float(ref["rays_traced"])
    assert abs(int(st.rays_traced) - rays_ref) <= 0.005 * rays_ref
    assert st.sample_count == 2 and st.restir is not None
    lp_ok = np.all(np.abs(st.restir.light_point.numpy()
                          - ref["restir"]["light_point"]) <= ATOL, axis=-1)
    assert lp_ok.mean() >= 0.97, lp_ok.mean()


def test_restir_path_is_bench_pys_row(both):
    """slice_options("restir") is the headline's options with RESTIR_DI, and
    every field the JAX package's RenderOptions shares equals what bench.py's
    make_renderer sets for its ReSTIR row; the defaults that the path runs
    (temporal reuse, then 2 spatial passes of 3 neighbours, pairwise MIS
    defensive, confidence weights, proxy target, a 128 x 1,024 pool,
    initial, last-pass and final visibility); the routes are the
    headline's."""
    import chip_smoke

    assert paths.PATHS[-5:] == ("restir", "envmap", "gltf", "cli", "viewer")
    assert paths.ROUTES["restir"] == ("trace_coherent", "trace_incoherent")
    opts, settings, world = paths.slice_options("restir")
    hopts, hset, hworld = paths.slice_options("headline")
    assert opts == hopts.replace(
        direct_light_sampling=ts.LightSamplingStrategy.RESTIR_DI)
    assert (settings, world) == (hset, hworld)
    assert (opts.max_bounces_static, settings.nb_bounces) == (4, 4)
    jo = _configs()[0][0].replace(max_bounces_static=4)
    for name in ("direct_light_sampling", "restir_di_bias_correction",
                 "restir_di_confidence_weights", "restir_di_fused_spatiotemporal",
                 "restir_presample_subset_count", "restir_presample_subset_size",
                 "restir_di_initial_visibility", "restir_di_final_visibility",
                 "restir_di_spatial_visibility_last_pass", "ris_proxy_target",
                 "max_bounces_static"):
        assert int(getattr(opts, name)) == int(getattr(jo, name)), name
    rs = settings.restir_di
    assert (rs.temporal_enabled, rs.spatial_enabled, rs.num_spatial_passes,
            rs.num_spatial_neighbors) == (True, True, 2, 3)
    assert opts.restir_di_bias_correction == ts.ReSTIRBiasCorrection.PAIRWISE_MIS_DEFENSIVE
    # chip_smoke's count a frame: K2 for the camera rays and the first
    # bounce's RIS shadow rays, every one masked; K1 for 4 bounces, 3 RIS
    # shadow wavefronts and ReSTIR's visibility rays: of visibility reuse
    # ("initial"), of the last spatial pass and of final shading ("restir")
    assert chip_smoke.launches_per_frame("restir", both["tscene"]) == {
        ("restir", "trace_coherent", "camera"): 1,
        ("restir", "trace_coherent", "masked"): 1,
        ("restir", "trace_incoherent", "shadow"): 3,
        ("restir", "trace_incoherent", "bounce"): 4,
        ("restir", "trace_incoherent", "initial"): 1,
        ("restir", "trace_incoherent", "restir"): 2}
    assert dict(chip_smoke.PATH_CASES)["restir"] == (
        ("trace_coherent", "masked"), ("trace_incoherent", "initial"),
        ("trace_incoherent", "restir"))


@pytest.mark.parametrize("override", ["NONE", "LAMBERTIAN"])
def test_proxy_eval_without_context_matches_jax(override):
    """The dispatcher's context-free proxy eval (ReSTIR's m-terms at
    neighbour surfaces), on seeded vertices and materials of the Cornell
    spheres, against the JAX package's: f and pdf at
    tests/test_torch_ris.py's tolerances."""
    from hiprt_pt_tpu.core import settings as js
    from hiprt_pt_tpu.core.material import MaterialBank as JBank
    from hiprt_pt_tpu.models import dispatcher as jd
    from hiprt_pt_tpu_torch.core.material import MaterialBank as TBank
    from hiprt_pt_tpu_torch.models import dispatcher as td

    n = 4096
    rng = np.random.default_rng(11)
    ns, wo, wi = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3))
    for v in (ns, wo, wi):
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
    wo = np.where((wo * ns).sum(-1, keepdims=True) < 0, -wo, wo).astype(np.float32)
    rows = tp.CORNELL_SPHERE_ROWS
    ids = rng.integers(0, len(rows), n).astype(np.int32)
    jm = JBank.from_rows(rows).to_device().at_indices(jnp.asarray(ids)).make_safe()
    tm = TBank.from_rows(rows).at_indices(_t(ids)).make_safe()
    jo = js.RenderOptions(bsdf_override=js.BSDFOverride[override])
    to = ts.RenderOptions(bsdf_override=ts.BSDFOverride[override])
    J, T = [jnp.asarray(a) for a in (ns, wo, wi)], [_t(a) for a in (ns, wo, wi)]
    fj, pj = jd.bsdf_proxy_eval(jo, jm, *J)
    ft, pt = td.bsdf_proxy_eval(to, tm, *T)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=ATOL, rtol=RTOL)
    assert float(pt.max()) > 0.0
