"""The port's BVH8 tables, their plain walk ``traverse8`` and the router,
against the JAX package.

- ``nodes8l``, ``leaf_rows8`` and ``depth8`` bit for bit, and the lane8
  table sizes, on the ~122k-triangle stress interior of the parity tests and
  on the ~470k-triangle one of tests/test_scale.py.
- ``traverse8`` against the JAX package's K4 (``traverse_pallas_stream8l``)
  and K5 (``traverse_pallas_lane8log``) in interpret mode, as
  tests/test_bvh.py runs them, on 1,024 camera and incoherent rays, closest
  and any-hit, with inactive rays and finite t_max: prim agreement >= 0.999
  and t within rtol 1e-4 where the prims agree, the bound that
  tests/test_bvh.py:148-182 holds K5 to (K5's winners re-intersected
  exactly, as the JAX package's integrator does). Also against brute force.
- The routes: on the 2.04M-triangle interior (tri_scale=14) the port picks
  trace_stream8 for coherent and trace_lane8log for incoherent rays, where
  the JAX gates (backend check patched to "tpu", as tests/test_scale.py
  does) pick K4 and K5; the stress and Cornell routes stay as they were; a
  scene past every gate goes to the BVH8 kernels.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402

from hiprt_pt_tpu_torch.accel.build import build_bvh  # noqa: E402
from hiprt_pt_tpu_torch.ops import traverse as plain  # noqa: E402
from hiprt_pt_tpu_torch.ops.intersect import brute_force_closest  # noqa: E402
from hiprt_pt_tpu_torch.ops.routing import route, routed_tables  # noqa: E402

N = 1024


def _t(x):
    return torch.from_numpy(np.array(x))


def _both(tri_scale):
    from hiprt_pt_tpu.accel.build import build_bvh as jbuild
    from hiprt_pt_tpu.assets.stress import generate_stress_scene

    p = generate_stress_scene(tri_scale=tri_scale, texture_size=32)
    v, f = np.asarray(p.vertices), np.asarray(p.triangles)
    return v, f, p.camera, jbuild(v, f), build_bvh(v, f, "cpu", all_tables=True)


@pytest.fixture(scope="module")
def small():
    return _both(tp.TRI_SCALE)


def _assert_tables_equal(jbvh, tbvh):
    for k in ("nodes8l", "leaf_rows8"):
        ref = np.asarray(getattr(jbvh, k))
        got = getattr(tbvh, k).numpy()
        assert got.shape == ref.shape, k
        # bit for bit: int32 words and prim ids in f32 columns, NaN padding
        assert np.array_equal(got.view(np.int32), ref.view(np.int32)), k
    assert tbvh.depth8 == jbvh.depth8
    s = tbvh.lane8
    assert s.nodes == jbvh.nodes_lane8.shape[0]
    assert (s.leaves, s.row_bytes) == tuple(jbvh.leaves_lane8.shape)
    assert s.depth == jbvh.lane8_depth


def test_bvh8_tables_match_jax(small):
    _v, f, _c, jbvh, tbvh = small
    _assert_tables_equal(jbvh, tbvh)
    assert tbvh.lane8.row_bytes == 18 * 128 + 16  # 16-bit leaves below 600k
    assert 7 * tbvh.depth8 + 1 <= plain.STACK8


def test_bvh8_tables_match_jax_at_scale():
    v, f, _c, jbvh, tbvh = _both(3.0)
    assert f.shape[0] > 400_000
    _assert_tables_equal(jbvh, tbvh)


def test_interop_carries_the_bvh8_tables(small):
    from hiprt_pt_tpu_torch import interop

    _v, _f, _cam, jbvh, tbvh = small
    got = interop.bvh_from_numpy(tp.bvh_dict(jbvh), "cpu")
    assert torch.equal(got.nodes8l.view(torch.int32), tbvh.nodes8l.view(torch.int32))
    assert got.depth8 == tbvh.depth8 and got.lane8 == tbvh.lane8
    # without them the BVH has no BVH8 and no lane8 sizes
    bare = interop.bvh_from_numpy({k: np.asarray(getattr(jbvh, k))
                                   for k in ("nodes4", "leaf_rows", "tri_rows")},
                                  "cpu")
    assert bare.nodes8l is None and bare.lane8 is None


def _rays(kind, cam, seed=0):
    """1,024 camera rays (a 32x32 image in tile order) or incoherent rays in
    the hall; a quarter get a finite t_max, a tenth are inactive."""
    if kind == "camera":
        o, d = tp.camera_rays_np(cam, 32, 32)
    else:
        o, d = tp.incoherent_rays_np(N, seed)
    rng = np.random.default_rng(seed + 7)
    t_max = np.where(rng.random(N) < 0.25, rng.uniform(0.5, 6.0, N),
                     np.inf).astype(np.float32)
    active = rng.random(N) >= 0.1
    return o, d, t_max, active


def _compare(ref, rec, active, any_hit):
    pr, pt = np.asarray(ref.prim), rec.prim.numpy()
    assert np.all(pt[~active] == -1) and np.all(np.isinf(rec.t.numpy()[~active]))
    if any_hit:
        assert np.mean((pr >= 0) == (pt >= 0)) >= 0.999
        assert 0.05 < (pt >= 0).mean() < 0.95
        assert np.all(rec.u.numpy() == 0.0)
        return
    assert tp.prim_agreement(pr, pt) >= 0.999
    m = (pr == pt) & (pr >= 0)
    assert m.sum() > 0.3 * len(pr)
    np.testing.assert_allclose(rec.t.numpy()[m], np.asarray(ref.t)[m], rtol=1e-4)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kind", ["camera", "incoherent"])
@pytest.mark.parametrize("kernel", ["stream8l", "lane8log"])
def test_traverse8_matches_pallas_interpret(small, kernel, kind, any_hit):
    from hiprt_pt_tpu.ops import pallas_traverse as pt

    _v, _f, cam, jbvh, tbvh = small
    o, d, t_max, active = _rays(kind, cam, seed=3)
    t_min = 1e-4 if any_hit else 0.0
    fn = (pt.traverse_pallas_stream8l if kernel == "stream8l"
          else pt.traverse_pallas_lane8log)
    ref = fn(jbvh, jnp.asarray(o), jnp.asarray(d), t_min, jnp.asarray(t_max),
             jnp.asarray(active), any_hit=any_hit, interpret=True)
    if kernel == "lane8log" and not any_hit:
        # K5's t comes from triangles on its 16-bit lattice (up to 1.9e-4
        # relative off here); the JAX package re-intersects each winner
        # exactly before it uses t (integrator.py:863-866), and so does this
        ref = pt.refine_hit_record(jbvh, jnp.asarray(o), jnp.asarray(d), ref)
    rec = plain.traverse8(tbvh, _t(o), _t(d), t_min, _t(t_max), _t(active),
                          any_hit=any_hit)
    _compare(ref, rec, active, any_hit)
    assert np.all(t_max[rec.prim.numpy() >= 0] > rec.t.numpy()[rec.prim.numpy() >= 0])


@pytest.mark.parametrize("kind", ["camera", "incoherent"])
def test_traverse8_matches_brute_force_and_bvh4_walk(small, kind):
    v, f, cam, _jb, tbvh = small
    o, d, _tm, _a = _rays(kind, cam, seed=5)
    o, d = o[:256], d[:256]
    stats = {}
    rec = plain.traverse8(tbvh, _t(o), _t(d), 0.0, stats=stats)
    bt, bp, _, _ = brute_force_closest(_t(v), _t(f), _t(o), _t(d), t_min=0.0)
    assert tp.prim_agreement(bp.numpy(), rec.prim.numpy()) >= 0.996
    m = bp.numpy() >= 0
    assert m.mean() > 0.5
    np.testing.assert_allclose(rec.t.numpy()[m], bt.numpy()[m], rtol=1e-5)
    rec4 = plain.traverse(tbvh, _t(o), _t(d), 0.0)
    assert torch.equal(rec.prim, rec4.prim)
    # the counts that chip_smoke.py turns into a kernel's bound
    assert stats["box_tests"] == 8 * stats["node_visits"] > 0
    assert stats["tri_tests"] >= stats["leaf_visits"] > 0


def test_stack8_check_raises_past_the_stack():
    import dataclasses

    rng = np.random.default_rng(1)
    verts = rng.normal(size=(300, 3)).astype(np.float32)
    bvh = build_bvh(verts, np.arange(300, dtype=np.int32).reshape(100, 3),
                    "cpu", all_tables=True)
    plain.check_stack8_depth(bvh)
    with pytest.raises(ValueError, match="stack"):
        plain.check_stack8_depth(dataclasses.replace(bvh, depth8=14))
    with pytest.raises(ValueError, match="BVH8"):
        plain.check_stack8_depth(dataclasses.replace(bvh, nodes8l=None))


def test_build_keeps_the_routed_tables(small):
    """build_bvh keeps only the tables that the routed kernels read: the
    BVH4 leaves on the stress interior, the meganode table on the Cornell
    box (the BVH8 where a BVH8 kernel is routed: tri_scale=14, below)."""
    v, f, _c, _j, full = small
    bvh = build_bvh(v, f, "cpu")
    assert routed_tables(bvh) == {"nodes4", "leaf_rows"}
    assert bvh.leaf_rows is not None and bvh.nodes is None
    assert bvh.nodes8l is None and bvh.leaf_rows8 is None
    assert bvh.lane8 == full.lane8
    assert torch.equal(bvh.leaf_rows.view(torch.int32), full.leaf_rows.view(torch.int32))
    cv, cf, *_ = tp.cornell_spheres_arrays()
    cbvh = build_bvh(cv, cf, "cpu")
    assert routed_tables(cbvh) == {"nodes"}
    assert cbvh.nodes is not None and cbvh.leaf_rows is None
    assert cbvh.nodes8l is None and cbvh.lane8 is None


def test_routes_match_the_jax_gates(small, monkeypatch):
    """tri_scale=14: the JAX gates (TPU backend forced) pick K4 for
    coherent and K5 for incoherent rays, and so does the port. The stress
    interior and the Cornell box keep their routes."""
    from hiprt_pt_tpu.ops import pallas_traverse as pt

    monkeypatch.setattr(pt.jax, "default_backend", lambda: "tpu")
    v, f, _c, jbvh, tbvh = _both(14.0)
    assert f.shape[0] == 2_042_048
    n = 1920 * 1080
    # the reference's order (render/integrator.py:100-140)
    assert not pt.pallas_supported(jbvh, n)
    assert not pt.pallas_wide_supported(jbvh, n)
    assert not pt.pallas_lane8s_supported(jbvh, n)
    assert pt.pallas_lane8_supported(jbvh, n)
    assert pt.pallas_stream8l_supported(jbvh, n)
    _assert_tables_equal(jbvh, tbvh)
    assert tbvh.lane8.row_bytes == 14 * 128 + 16  # 12-bit leaves above 600k
    assert tbvh.nodes4.shape[0] == jbvh.nodes4.shape[0] == 108_534
    assert route(tbvh, coherent=True) == "trace_stream8"
    assert route(tbvh, coherent=False) == "trace_lane8log"
    assert routed_tables(tbvh) == {"nodes8l", "leaf_rows8"}
    assert 7 * tbvh.depth8 + 1 <= plain.STACK8
    del v, f, jbvh, tbvh

    # the stress interior: K2 / K1 in both packages
    _v, _f, _c, jsmall, tsmall = small
    assert pt.pallas_wide_supported(jsmall, n) and pt.pallas_lane8s_supported(jsmall, n)
    assert route(tsmall, True) == "trace_coherent"
    assert route(tsmall, False) == "trace_incoherent"
    # the Cornell box: every ray through K3
    cv, cf, *_ = tp.cornell_spheres_arrays()
    cbvh = build_bvh(cv, cf, "cpu")
    assert route(cbvh, True) == route(cbvh, False) == "trace_meganode"


def test_route_raises_past_every_gate(small):
    """Past every gate of the JAX package (its last caps bound a table held
    in on-chip memory) the port routes to the BVH8 kernels: coherent rays to
    trace_stream8, incoherent rays to trace_lane8log. What still raises: a
    tree deeper than the BVH8 walks' stack, and a BVH without BVH8 tables."""
    import dataclasses

    from hiprt_pt_tpu_torch.accel.build import Lane8Sizes
    from hiprt_pt_tpu_torch.ops import routing

    tbvh = small[4]
    big = dataclasses.replace(
        tbvh, nodes4=torch.zeros((100_000, 32)), nodes8l=torch.zeros((200_000, 64)),
        lane8=Lane8Sizes(nodes=70_000, leaves=30_000, row_bytes=1808, depth=9))
    assert big.nodes8l.shape[0] > routing.MAX_STREAM8L_NODES
    assert not (routing.meganode_ok(big) or routing.wide_ok(big)
                or routing.lane8s_tables_ok(big) or routing.lane8_ok(big)
                or routing.stream8_ok(big))
    assert route(big, coherent=False) == "trace_lane8log"
    assert route(big, coherent=True) == "trace_stream8"
    assert routing.needs_bvh8(big)
    assert routed_tables(big) == {"nodes8l", "leaf_rows8"}
    deep = dataclasses.replace(big, depth8=14)
    for coherent in (False, True):
        with pytest.raises(ValueError, match="stack"):
            route(deep, coherent=coherent)
        with pytest.raises(ValueError, match="BVH8"):
            route(dataclasses.replace(big, nodes8l=None), coherent=coherent)


def test_kernel_wrappers_run_traverse8_on_cpu(small):
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct

    _v, _f, cam, _jb, tbvh = small
    o, d, t_max, active = _rays("incoherent", cam, seed=9)
    ref = plain.traverse8(tbvh, _t(o), _t(d), 0.0, _t(t_max), _t(active))
    before = dict(ct.launch_counts)
    for fn in (ct.trace_stream8, ct.trace_lane8log):
        rec = fn(tbvh, _t(o), _t(d), 0.0, _t(t_max), _t(active))
        assert torch.equal(rec.prim, ref.prim) and torch.equal(rec.t, ref.t)
    # the plain version is not a launch
    assert ct.launch_counts == before
