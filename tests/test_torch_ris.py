"""The port's RIS path against the JAX package: the tile-shared light draw,
the dense emissive sweep, the proxy BSDF and its dispatcher, RIS direct
lighting at one vertex wavefront, and the render step of the textured
stress interior (~122k triangles, 18 textures, 120 emitters) under
RIS_BSDF_LIGHT with the full principled BSDF, compared per pixel.

The JAX scene is handed over with ``emissive_woop=None``: the JAX package
then finds BSDF candidates' emitters with the dense Moller-Trumbore sweep
that the port carries, not with its matrix-unit Woop form (whose different
rounding would move hits on triangle edges). Tolerances: f32 atol 1e-5 /
rtol 1e-4 for the elementwise modules (XLA's CPU code may contract products
into FMAs), as in tests/test_torch_principled.py."""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402

from hiprt_pt_tpu_torch.core import settings as ts  # noqa: E402

W, H = 64, 32
N = 4096
ATOL, RTOL = 1e-5, 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def both():
    jscene, jcam, jbvh = tp.jax_stress(aspect=W / H, with_textures=True)
    jscene = jscene.replace(emissive_woop=None)
    tscene, tcam, tbvh = tp.port_of(jscene, jcam, jbvh)
    return dict(jscene=jscene, jcam=jcam, jbvh=jbvh, tscene=tscene, tcam=tcam,
                tbvh=tbvh)


def _vertices(seed, n=N):
    """Shading points in the hall, normals, outgoing directions above them,
    relative IORs, and a material id per ray from the scene's bank."""
    rng = np.random.default_rng(seed)
    p, d = tp.incoherent_rays_np(n, seed)
    ns = rng.normal(size=(n, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    wo = np.where((d * ns).sum(-1, keepdims=True) < 0, -d, d).astype(np.float32)
    eta = rng.uniform(0.7, 1.6, n).astype(np.float32)
    return p, ns, wo, eta, rng


def _jax_rng(n, sample=3):
    from hiprt_pt_tpu.core import rng as jrng
    from hiprt_pt_tpu_torch.core import rng as trng

    return (jrng.seed(jnp.arange(n, dtype=jnp.uint32), sample, 42),
            trng.seed(torch.arange(n), sample, 42))


@pytest.mark.parametrize("tile", [None, 128])
def test_sample_emissive_triangle_matches_jax(both, tile):
    from hiprt_pt_tpu.lights.light_sampling import sample_emissive_triangle as jf
    from hiprt_pt_tpu_torch.lights.light_sampling import sample_emissive_triangle as tf

    p, *_ = _vertices(1, n=1000)
    jr, tr = _jax_rng(1000)
    jr, jl = jf(both["jscene"], jnp.asarray(p), jr, tile_size=tile)
    tr, tl = tf(both["tscene"], _t(p), tr, tile_size=tile)
    assert np.array_equal(np.asarray(jr).astype(np.int64), tr.numpy())
    assert np.array_equal(np.asarray(jl["tri_index"]), tl["tri_index"].numpy())
    if tile:
        tri = tl["tri_index"].numpy()
        assert all(len(set(tri[s:s + tile])) == 1 for s in range(0, 1000, tile))
    for k in ("wi", "dist", "radiance", "pdf", "light_point"):
        _close(tl[k], jl[k])


def test_closest_emissive_hit_matches_jax(both, monkeypatch):
    """The dense sweep, also over blocks of emitters (the block size is
    shrunk so that 240 emitters take 30 blocks)."""
    from hiprt_pt_tpu.lights.light_sampling import closest_emissive_hit as jf
    from hiprt_pt_tpu_torch.lights import light_sampling as tls

    jscene, tscene = both["jscene"], both["tscene"]
    # rays from the hall towards sampled light points, so most hit
    p, *_ = _vertices(2)
    rng = np.random.default_rng(3)
    rows = tscene.emissive_rows.numpy()[rng.integers(0, 240, N)]
    target = rows[:, 0:3] + (rows[:, 3:6] + rows[:, 6:9]) / 3.0
    target = target + rng.normal(scale=0.05, size=target.shape).astype(np.float32)
    d = (target - p).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    active = rng.random(N) > 0.1
    jt, js = jf(jscene, jnp.asarray(p), jnp.asarray(d), active=jnp.asarray(active))
    for block in (tls.SWEEP_BLOCK_ELEMS, 8 * N):
        monkeypatch.setattr(tls, "SWEEP_BLOCK_ELEMS", block)
        tt, tsl = tls.closest_emissive_hit(tscene, _t(p), _t(d), active=_t(active))
        assert np.array_equal(tsl.numpy(), np.asarray(js))
        m = np.asarray(js) >= 0
        assert m.mean() > 0.2
        _close(tt.numpy()[m], np.asarray(jt)[m])


@pytest.mark.parametrize("case", ["stress", "glass", "metal"])
def test_proxy_eval_and_sample_match_jax(case):
    from hiprt_pt_tpu.core.material import MaterialBank as JBank
    from hiprt_pt_tpu.models import dispatcher as jd
    from hiprt_pt_tpu_torch.core.material import MaterialBank as TBank
    from hiprt_pt_tpu_torch.models import dispatcher as td
    from hiprt_pt_tpu.core import settings as js

    rows = {"glass": [tp.CORNELL_SPHERE_ROWS[2]],
            "metal": [tp.CORNELL_SPHERE_ROWS[0]],
            "stress": tp.CORNELL_SPHERE_ROWS + [dict(base_color=[0.7, 0.6, 0.5],
                                                     roughness=0.8)]}[case]
    p, ns, wo, eta, rng = _vertices(4)
    ids = rng.integers(0, len(rows), N).astype(np.int32)
    jm = JBank.from_rows(rows).to_device().at_indices(jnp.asarray(ids)).make_safe()
    tm = TBank.from_rows(rows).at_indices(_t(ids)).make_safe()
    wi = rng.normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    jo, to = js.RenderOptions(), ts.RenderOptions()
    J = [jnp.asarray(a) for a in (ns, wo, wi)]
    T = [_t(a) for a in (ns, wo, wi)]
    jctx = jd.bsdf_proxy_ctx(jo, jm, J[0], J[1])
    tctx = td.bsdf_proxy_ctx(to, tm, T[0], T[1])
    fj, pj = jd.bsdf_proxy_eval_ctx(jo, jctx, jm, *J)
    ft, pt = td.bsdf_proxy_eval_ctx(to, tctx, tm, *T)
    assert float(np.asarray(pj).max()) > 0.0
    _close(ft, fj)
    _close(pt, pj)
    jr, tr = _jax_rng(N)
    jr, wij, fj, pj = jd.bsdf_proxy_sample_ctx(jo, jctx, jm, J[0], J[1], jr)
    tr, wit, ft, pt = td.bsdf_proxy_sample_ctx(to, tctx, tm, T[0], T[1], tr)
    assert np.array_equal(np.asarray(jr).astype(np.int64), tr.numpy())
    _close(wit, wij, atol=1e-4)
    # sampled f and pdf at the conditioning of the principled sample test
    _close(ft, fj, rtol=1e-3)
    _close(pt, pj, rtol=1e-3)


def test_cheap_override_routes_to_the_real_bsdf():
    from hiprt_pt_tpu_torch.core.material import MaterialBank
    from hiprt_pt_tpu_torch.models import dispatcher as td
    from hiprt_pt_tpu_torch.models import lambert

    opts = ts.RenderOptions(bsdf_override=ts.BSDFOverride.LAMBERTIAN)
    _p, ns, wo, _eta, rng = _vertices(5, n=64)
    mats = MaterialBank.from_rows([dict(base_color=[0.5, 0.4, 0.3])]).at_indices(
        torch.zeros(64, dtype=torch.int64))
    assert td.bsdf_proxy_ctx(opts, mats, _t(ns), _t(wo)) is None
    f, pdf = td.bsdf_proxy_eval_ctx(opts, None, mats, _t(ns), _t(wo), _t(ns))
    fr, pr = lambert.eval_pdf(mats.base_color, _t(ns), _t(wo), _t(ns))
    assert torch.equal(f, fr) and torch.equal(pdf, pr)


@pytest.mark.parametrize("coherent,variant", [
    (False, "default"), (True, "default"), (False, "exact_target"),
    (False, "visibility_target"), (True, "traced_bsdf_candidates")])
def test_ris_direct_lighting_matches_jax(both, coherent, variant, monkeypatch):
    """One RIS vertex wavefront (4 light + 1 BSDF candidates, 128-ray light
    tiles) on camera-pass vertices of the JAX package: with the proxy
    target (the default), the exact BSDF as target, shadowed light
    candidates, and BSDF candidates that find their emitter by a trace of
    the scene (past DENSE_EMISSIVE_MAX emissive triangles) instead of the
    dense sweep."""
    from hiprt_pt_tpu.core import settings as js
    from hiprt_pt_tpu.core.state import init_render_state as jinit
    from hiprt_pt_tpu.lights import ris as jris_mod
    from hiprt_pt_tpu.render.integrator import camera_rays_pass as jpass
    from hiprt_pt_tpu_torch.lights import ris as tris_mod

    jris, tris = jris_mod.ris_direct_lighting, tris_mod.ris_direct_lighting
    jscene, tscene = both["jscene"], both["tscene"]
    kw = {"exact_target": dict(ris_proxy_target=False),
          "visibility_target": dict(ris_use_visibility_target=True)}.get(variant, {})
    if variant == "traced_bsdf_candidates":
        monkeypatch.setattr(jris_mod, "DENSE_EMISSIVE_MAX", 0)
        monkeypatch.setattr(tris_mod, "DENSE_EMISSIVE_MAX", 0)
    jo = js.RenderOptions(direct_light_sampling=js.LightSamplingStrategy.RIS_BSDF_LIGHT,
                          **kw)
    to = ts.RenderOptions(direct_light_sampling=ts.LightSamplingStrategy.RIS_BSDF_LIGHT,
                          **kw)
    jset, tset = js.RenderSettings(), ts.RenderSettings()
    n = W * H
    jr, tr = _jax_rng(n)
    jr, g, act = jpass(jscene, both["jbvh"], both["jcam"], jset, jinit(W, H, 42),
                       W, H, 3, jr, jo)
    tr = torch.from_numpy(np.asarray(jr).astype(np.int64))
    hit = np.asarray(g.prim_index) >= 0
    mid = np.maximum(np.asarray(g.material_id), 0)
    jm = jscene.materials.at_indices(jnp.asarray(mid)).make_safe()
    tm = tscene.materials.at_indices(_t(mid)).make_safe()
    p, ns, ng, wo = (np.asarray(getattr(g, k)) for k in
                     ("position", "shading_normal", "geometric_normal",
                      "view_direction"))
    eta = np.full((n,), 1.5, np.float32)
    jr, jc, jn = jris(jo, jscene, both["jbvh"], jset, jm,
                      *(jnp.asarray(a) for a in (p, ns, ng, wo)), jr,
                      jnp.asarray(hit), jnp.asarray(eta), shadow_coherent=coherent)
    tr, tc, tn = tris(to, tscene, both["tbvh"], tset, tm,
                      *(_t(a) for a in (p, ns, ng, wo)), tr, _t(hit), _t(eta),
                      shadow_coherent=coherent)
    assert np.array_equal(np.asarray(jr).astype(np.int64), tr.numpy())
    ref, got = np.asarray(jc), tc.numpy()
    assert (ref.sum(-1) > 0).mean() > 0.05
    close = np.all(np.abs(got - ref) <= 1e-4 + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(int(tn) - float(jn)) <= 0.005 * float(jn)


def _slice_configs():
    from hiprt_pt_tpu.core import settings as js

    jopts = js.RenderOptions(direct_light_sampling=js.LightSamplingStrategy.RIS_BSDF_LIGHT,
                             max_bounces_static=4)
    jset = js.RenderSettings().replace(nb_bounces=jnp.int32(4))
    jworld = js.WorldSettings().replace(
        ambient_light_type=jnp.int32(int(js.AmbientLightType.NONE)))
    topts = ts.RenderOptions(direct_light_sampling=ts.LightSamplingStrategy.RIS_BSDF_LIGHT,
                             max_bounces_static=4)
    return (jopts, jset, jworld), (topts, ts.RenderSettings(nb_bounces=4),
                                   ts.WorldSettings(ambient_light_type=int(
                                       ts.AmbientLightType.NONE)))


def test_render_step_matches_jax(both):
    """The slice configuration (bench.py's headline: full principled BSDF
    with dispersion and thin film, RIS with 4 light and 1 BSDF candidate,
    textures, 4 bounces, ambient NONE) at 64x32, one sample, per pixel:
    radiance within atol 1e-3 + rtol 1e-3 on >= 97% of the pixels (a path
    whose sampled direction lands within rounding of a lobe or refraction
    boundary takes the other branch, and one such path changes its pixel),
    the image mean within 2% and the rays traced within 0.5%."""
    from hiprt_pt_tpu.core.state import init_render_state as jinit
    from hiprt_pt_tpu.render.renderer import render_step as jstep
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    (jopts, jset, jworld), (topts, tset, tworld) = _slice_configs()
    ref_state = jstep(jopts, W, H, (both["jscene"], both["jbvh"]),
                      jinit(W, H, 42), both["jcam"], jset, jworld)
    state = render_step(topts, W, H, both["tscene"], both["tbvh"],
                        init_render_state(W, H, 42, "cpu"), both["tcam"], tset,
                        tworld)
    ref, got = np.asarray(ref_state.accum), state.accum.numpy()
    assert np.isfinite(got).all()
    assert (got.sum(-1) > 0).mean() > 0.3
    close = np.all(np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= 0.97, close.mean()
    assert abs(got.mean() - ref.mean()) <= 0.02 * abs(ref.mean())
    rays_ref = float(ref_state.rays_traced)
    assert abs(int(state.rays_traced) - rays_ref) <= 0.005 * rays_ref
