"""Module-level parity of the port against the JAX package on seeded numpy
inputs: sampling, BSDFs and their dispatch, nested-dielectric stacks, light
sampling, scene packing, pixel order and camera rays.

Tolerances: the two packages run the same float32 formulas, but XLA's CPU
code may contract products into FMAs and uses its own sin/cos/sqrt, so
transcendental results differ in the last few bits (atol 1e-5 on unit
vectors and pdfs of order 1)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

N = 4096
ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=1e-5)


def _frame(seed):
    """Normals, outgoing directions above them, incoming directions, uniforms."""
    rng = _rng(seed)
    n = _unit(rng, N)
    wo = _unit(rng, N)
    wo = np.where((wo * n).sum(-1, keepdims=True) < 0, -wo, wo).astype(np.float32)
    wi = _unit(rng, N)
    u1, u2 = rng.random((2, N), dtype=np.float32)
    return n, wo, wi, u1, u2


def test_sampling_primitives_match_jax():
    from hiprt_pt_tpu.ops import sampling as js
    from hiprt_pt_tpu_torch.ops import sampling as tsm

    n, wo, wi, u1, u2 = _frame(1)
    for a, b in zip(js.build_onb(jnp.asarray(n)), tsm.build_onb(_t(n))):
        _close(b, a)
    _close(tsm.to_local(_t(wi), _t(n)), js.to_local(jnp.asarray(wi), jnp.asarray(n)))
    dj, pj = js.sample_cosine_hemisphere(jnp.asarray(n), jnp.asarray(u1), jnp.asarray(u2))
    dt, pt = tsm.sample_cosine_hemisphere(_t(n), _t(u1), _t(u2))
    _close(dt, dj)
    _close(pt, pj)
    a, b = _rng(2).random((2, N), dtype=np.float32) * 5
    _close(tsm.balance_heuristic(_t(a), _t(b)), js.balance_heuristic(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("model", ["lambert", "oren_nayar"])
def test_bsdf_eval_and_sample_match_jax(model):
    import importlib

    jm = importlib.import_module(f"hiprt_pt_tpu.models.{model}")
    tm = importlib.import_module(f"hiprt_pt_tpu_torch.models.{model}")
    n, wo, wi, u1, u2 = _frame(3)
    base = _rng(4).random((N, 3), dtype=np.float32)
    extra_j = (jnp.asarray(np.full(N, 0.35, np.float32)),) if model == "oren_nayar" else ()
    extra_t = (_t(np.full(N, 0.35, np.float32)),) if model == "oren_nayar" else ()
    fj, pj = jm.eval_pdf(jnp.asarray(base), *extra_j, jnp.asarray(n), jnp.asarray(wo), jnp.asarray(wi))
    ft, pt = tm.eval_pdf(_t(base), *extra_t, _t(n), _t(wo), _t(wi))
    _close(ft, fj)
    _close(pt, pj)
    sj = jm.sample(jnp.asarray(base), *extra_j, jnp.asarray(n), jnp.asarray(wo),
                   jnp.asarray(u1), jnp.asarray(u2))
    st = tm.sample(_t(base), *extra_t, _t(n), _t(wo), _t(u1), _t(u2))
    for a, b in zip(sj, st):
        _close(b, a, atol=1e-4)


@pytest.mark.parametrize("override", ["LAMBERTIAN", "OREN_NAYAR"])
def test_dispatcher_draws_and_samples_match_jax(override):
    from hiprt_pt_tpu.core import rng as jrng
    from hiprt_pt_tpu.core.material import MaterialBank as JBank
    from hiprt_pt_tpu.core.settings import BSDFOverride as JO, RenderOptions as JOpts
    from hiprt_pt_tpu.models.dispatcher import bsdf_eval as jeval, bsdf_sample as jsample
    from hiprt_pt_tpu_torch.core import rng as trng
    from hiprt_pt_tpu_torch.core.material import MaterialBank as TBank
    from hiprt_pt_tpu_torch.core.settings import BSDFOverride as TO, RenderOptions as TOpts
    from hiprt_pt_tpu_torch.models.dispatcher import bsdf_eval as teval, bsdf_sample as tsample

    rows = [{"base_color": [0.2, 0.5, 0.9], "oren_nayar_sigma": 0.5},
            {"base_color": [0.9, 0.1, 0.1]}]
    ids = _rng(5).integers(0, 2, N).astype(np.int32)
    jm = JBank.from_rows(rows).to_device().at_indices(jnp.asarray(ids))
    tm = TBank.from_rows(rows).at_indices(_t(ids))
    n, wo, wi, _, _ = _frame(6)
    jo, to = JOpts(bsdf_override=JO[override]), TOpts(bsdf_override=TO[override])
    for a, b in zip(jeval(jo, jm, jnp.asarray(n), jnp.asarray(wo), jnp.asarray(wi)),
                    teval(to, tm, _t(n), _t(wo), _t(wi))):
        _close(b, a)
    js = jrng.seed(jnp.arange(N, dtype=jnp.uint32), 1, 9)
    tsd = trng.seed(torch.arange(N), 1, 9)
    rj, wij, fj, pj, auxj = jsample(jo, jm, jnp.asarray(n), jnp.asarray(wo), js)
    rt, wit, ft, pt, auxt = tsample(to, tm, _t(n), _t(wo), tsd)
    assert np.array_equal(np.asarray(rj).astype(np.int64), rt.numpy())
    _close(wit, wij, atol=1e-4)
    _close(pt, pj, atol=1e-4)
    assert not auxt["refracted"].any()


def test_nested_dielectric_stack_ops_match_jax():
    from hiprt_pt_tpu.models import nested_dielectrics as jnd
    from hiprt_pt_tpu_torch.models import nested_dielectrics as tnd

    rng = _rng(7)
    k = 3
    mats = rng.integers(-1, 4, (N, k)).astype(np.int32)
    pri = np.where(mats >= 0, rng.integers(0, 3, (N, k)), -1).astype(np.int32)
    mats = np.where(pri >= 0, mats, -1).astype(np.int32)
    m = rng.integers(0, 4, N).astype(np.int32)
    p = rng.integers(0, 3, N).astype(np.int32)
    mask = rng.random(N) < 0.5
    J = lambda x: jnp.asarray(x)  # noqa: E731
    pairs = [
        (jnd.top_priority(J(pri)), tnd.top_priority(_t(pri))),
        (jnd.top_material(J(mats), J(pri)), tnd.top_material(_t(mats), _t(pri))),
        (jnd.contains(J(mats), J(pri), J(m)), tnd.contains(_t(mats), _t(pri), _t(m))),
    ]
    pairs += list(zip(jnd.top_excluding(J(mats), J(pri), J(m)),
                      tnd.top_excluding(_t(mats), _t(pri), _t(m))))
    pairs += list(zip(jnd.push(J(mats), J(pri), J(m), J(p), J(mask)),
                      tnd.push(_t(mats), _t(pri), _t(m), _t(p), _t(mask))))
    pairs += list(zip(jnd.remove(J(mats), J(pri), J(m), J(mask)),
                      tnd.remove(_t(mats), _t(pri), _t(m), _t(mask))))
    for a, b in pairs:
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.fixture(scope="module")
def small_scenes():
    """A random triangle soup with two emissive materials, packed by both
    packages' build_scene."""
    from hiprt_pt_tpu.assets.scene import build_scene as jbuild
    from hiprt_pt_tpu.core.material import MaterialBank as JBank
    from hiprt_pt_tpu_torch.assets.scene import build_scene as tbuild
    from hiprt_pt_tpu_torch.core.material import MaterialBank as TBank

    rng = _rng(8)
    t = 400
    c = rng.uniform(-2, 2, (t, 1, 3))
    verts = (c + rng.normal(0, 0.3, (t, 3, 3))).reshape(-1, 3).astype(np.float32)
    tris = np.arange(3 * t, dtype=np.int32).reshape(t, 3)
    mat_ids = rng.integers(0, 4, t).astype(np.int32)
    rows = [{"base_color": [0.8, 0.8, 0.8]},
            {"emission": [1.0, 0.9, 0.7], "emission_strength": 20.0},
            {"base_color": [0.2, 0.3, 0.9], "specular_transmission": 1.0},
            {"emission": [0.3, 0.4, 1.0], "emission_strength": 5.0}]
    uvs = rng.random((verts.shape[0], 2), dtype=np.float32)
    js = jbuild(verts, tris, mat_ids, JBank.from_rows(rows), uvs=uvs)
    tsc = tbuild(verts, tris, mat_ids, TBank.from_rows(rows), uvs=uvs,
                 device="cpu")
    return js, tsc


def test_build_scene_matches_jax(small_scenes):
    js, tsc = small_scenes
    for name in ("tri_data", "emissive_rows", "emissive_tri_indices",
                 "emissive_alias_prob", "emissive_alias", "emissive_pmf",
                 "emissive_power_cdf", "emissive_slot_of_tri", "normals"):
        assert np.array_equal(getattr(tsc, name).numpy(), np.asarray(getattr(js, name))), name
    assert tsc.num_emissives == int(js.num_emissives)
    assert tsc.emissive_total_area == pytest.approx(float(js.emissive_total_area))


def test_light_sampling_matches_jax(small_scenes):
    from hiprt_pt_tpu.core import rng as jrng
    from hiprt_pt_tpu.lights import light_sampling as jl
    from hiprt_pt_tpu_torch.core import rng as trng
    from hiprt_pt_tpu_torch.lights import light_sampling as tl

    js, tsc = small_scenes
    p = _rng(9).uniform(-3, 3, (N, 3)).astype(np.float32)
    jr, jd = jl.sample_emissive_triangle(js, jnp.asarray(p),
                                         jrng.seed(jnp.arange(N, dtype=jnp.uint32), 0, 5))
    tr, td = tl.sample_emissive_triangle(tsc, _t(p), trng.seed(torch.arange(N), 0, 5))
    assert np.array_equal(np.asarray(jr).astype(np.int64), tr.numpy())
    assert np.array_equal(np.asarray(jd["tri_index"]), td["tri_index"].numpy())
    assert np.array_equal(np.asarray(jd["valid"]), td["valid"].numpy())
    for k in ("wi", "dist", "radiance", "light_point"):
        _close(td[k], jd[k])
    np.testing.assert_allclose(td["pdf"].numpy(), np.asarray(jd["pdf"]), rtol=1e-4)

    prim = _rng(10).integers(-1, js.triangles.shape[0], N).astype(np.int32)
    hit_t = _rng(11).uniform(0.1, 4, N).astype(np.float32)
    wi = _unit(_rng(12), N)
    pj, ej = jl.emissive_pdf_of_direction(js, jnp.asarray(p), jnp.asarray(prim),
                                          jnp.asarray(hit_t), jnp.asarray(wi))
    pt, et = tl.emissive_pdf_of_direction(tsc, _t(p), _t(prim), _t(hit_t), _t(wi))
    assert np.array_equal(np.asarray(ej), et.numpy())
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5)


@pytest.mark.parametrize("size", [(64, 32), (48, 24), (30, 20)])
def test_pixel_order_matches_jax(size):
    from hiprt_pt_tpu.ops import pixel_order as jp
    from hiprt_pt_tpu_torch.ops import pixel_order as tpo

    w, h = size
    for a, b in zip(jp.pixel_coords(w, h), tpo.pixel_coords(w, h)):
        assert np.array_equal(np.asarray(a), b.numpy())
    flat = _rng(13).random((w * h, 3), dtype=np.float32)
    assert np.array_equal(tpo.unscramble(flat, w, h), jp.unscramble(flat, w, h))


def test_camera_rays_and_offset_match_jax():
    from hiprt_pt_tpu.core.camera import camera_from_lookat as jcam_of, generate_camera_rays as jgen
    from hiprt_pt_tpu.ops.intersect import offset_ray_origin as joff
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat as tcam_of, generate_camera_rays as tgen
    from hiprt_pt_tpu_torch.ops.intersect import offset_ray_origin as toff

    args = dict(eye=(-8.8, 2.2, 0.0), target=(10.0, 1.6, 0.0), vfov_deg=55.0, aspect=2.0)
    jc, tc = jcam_of(**args), tcam_of(**args, device="cpu")
    w, h = 64, 32
    jit = _rng(14).random((w * h, 2), dtype=np.float32)
    oj, dj = jgen(jc, w, h, jnp.asarray(jit))
    ot, dt = tgen(tc, w, h, _t(jit))
    _close(ot, oj, atol=0.0)
    _close(dt, dj, atol=1e-6)
    ng = _unit(_rng(15), w * h)
    p = _rng(16).uniform(-20, 20, (w * h, 3)).astype(np.float32)
    _close(toff(_t(p), _t(ng), dt), joff(jnp.asarray(p), jnp.asarray(ng), dj), atol=1e-6)


def test_ray_aabb_matches_jax():
    from hiprt_pt_tpu.ops.intersect import ray_aabb as jslab
    from hiprt_pt_tpu_torch.ops.intersect import ray_aabb as tslab

    rng = _rng(19)
    o = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    lo = rng.uniform(-2, 0, (N, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.1, 2, (N, 3))).astype(np.float32)
    # half the rays aim at their box's center, half go anywhere
    d = np.where(np.arange(N)[:, None] < N // 2, (lo + hi) / 2 - o, _unit(rng, N))
    inv = (1.0 / (d / np.linalg.norm(d, axis=-1, keepdims=True))).astype(np.float32)
    hj, tj = jslab(jnp.asarray(o), jnp.asarray(inv), jnp.asarray(lo), jnp.asarray(hi), 5.0)
    ht, tt = tslab(_t(o), _t(inv), _t(lo), _t(hi), 5.0)
    assert np.array_equal(ht.numpy(), np.asarray(hj))
    assert 0.1 < ht.numpy().mean() < 0.9
    _close(tt, tj, atol=0.0)


def test_tonemap_matches_jax():
    from hiprt_pt_tpu.ops import tonemap as jt
    from hiprt_pt_tpu_torch.ops import tonemap as tt

    x = _rng(17).uniform(0, 4, (N, 3)).astype(np.float32)
    _close(tt.luminance(_t(x)), jt.luminance(jnp.asarray(x)), atol=1e-6)
    _close(tt.tonemap_gamma(_t(x), 1.5), jt.tonemap_gamma(jnp.asarray(x), 1.5), atol=1e-6)
    _close(tt.resolve_accumulation(_t(x), 4), jt.resolve_accumulation(jnp.asarray(x), 4), atol=0.0)


def test_material_gathers_match_jax():
    from hiprt_pt_tpu.core.material import MaterialBank as JBank
    from hiprt_pt_tpu_torch.core.material import FIELD_NAMES, MaterialBank as TBank

    rows = [{"roughness": 0.0, "base_color": [0.1, 0.2, 0.3], "ior": 1.7},
            {"emission": [1, 1, 1], "emission_strength": 3.0,
             "normal_map_texture_index": 4, "absorption_color": [0.0, 0.5, 1.0]},
            {}]
    ids = _rng(18).integers(0, 3, N).astype(np.int32)
    jm = JBank.from_rows(rows).to_device().at_indices(jnp.asarray(ids)).make_safe()
    tm = TBank.from_rows(rows).at_indices(_t(ids)).make_safe()
    for name in FIELD_NAMES:
        assert np.array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name))), name
    assert np.array_equal(tm.effective_emission().numpy(), np.asarray(jm.effective_emission()))
    jf = JBank.from_rows(rows).to_device().fields_at(jnp.asarray(ids), ("ior", "absorption_color"))
    tf = TBank.from_rows(rows).fields_at(_t(ids), ("ior", "absorption_color"))
    for k in jf:
        assert np.array_equal(tf[k].numpy(), np.asarray(jf[k])), k
