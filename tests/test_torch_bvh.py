"""The port's BVH build and plain traversal against the JAX package: equal
tables, the exact XLA walk, the interpret-mode Pallas kernels K2
(traverse_pallas_wide) and K1 (traverse_pallas_lane8s), and brute force."""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402

from hiprt_pt_tpu_torch import interop  # noqa: E402
from hiprt_pt_tpu_torch.accel.build import build_bvh  # noqa: E402
from hiprt_pt_tpu_torch.ops import cuda_build, cuda_traverse  # noqa: E402
from hiprt_pt_tpu_torch.ops import traverse as plain  # noqa: E402
from hiprt_pt_tpu_torch.ops.intersect import brute_force_closest  # noqa: E402
from hiprt_pt_tpu_torch.ops.routing import KERNEL_TABLES  # noqa: E402


@pytest.fixture(scope="module")
def scenes():
    jscene, jcam, jbvh = tp.jax_stress(aspect=1.0)
    tbvh = build_bvh(np.asarray(jscene.vertices), np.asarray(jscene.triangles),
                     "cpu", all_tables=True)
    return jscene, jcam, jbvh, tbvh


def _rays(kind, jcam, n=1024):
    if kind == "camera":
        side = int(np.sqrt(n))
        return tp.camera_rays_np(jcam, side, n // side)
    return tp.incoherent_rays_np(n, seed=11)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("table", ["tri_rows", "leaf_rows", "nodes4"])
def test_tables_equal_jax(scenes, table):
    _, _, jbvh, tbvh = scenes
    ref = np.asarray(getattr(jbvh, table))
    got = getattr(tbvh, table).numpy()
    assert got.shape == ref.shape
    # bit-for-bit: the tables hold int32 ids in f32 columns and NaN padding
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


def test_depth_recorded_at_build(scenes):
    _, _, _, tbvh = scenes
    assert tbvh.depth4 == interop.bvh4_depth(tbvh.nodes4.numpy())
    assert 3 * tbvh.depth4 + 1 <= plain.STACK_SIZE


@pytest.mark.parametrize("kind", ["camera", "incoherent"])
def test_closest_matches_jax_walk(scenes, kind):
    from hiprt_pt_tpu.ops.traverse import closest_hit

    _, jcam, jbvh, tbvh = scenes
    o, d = _rays(kind, jcam)
    ref = closest_hit(jbvh, jnp.asarray(o), jnp.asarray(d), t_min=0.0)
    rec = plain.closest_hit(tbvh, _t(o), _t(d), t_min=0.0)
    pr, pt = np.asarray(ref.prim), rec.prim.numpy()
    assert tp.prim_agreement(pr, pt) >= 0.999
    m = (pr == pt) & (pr >= 0)
    assert m.sum() > 0.5 * len(pr)
    np.testing.assert_allclose(rec.t.numpy()[m], np.asarray(ref.t)[m], rtol=1e-5)
    # barycentrics cancel in their numerators, and XLA's CPU code contracts
    # products into FMAs where the port rounds each one: a few 1e-5 apart
    np.testing.assert_allclose(rec.u.numpy()[m], np.asarray(ref.u)[m], atol=2e-4)
    assert np.all(np.isinf(rec.t.numpy()[pt < 0]))


@pytest.mark.parametrize("kind", ["camera", "incoherent"])
def test_anyhit_matches_jax_walk(scenes, kind):
    from hiprt_pt_tpu.ops.traverse import occluded

    _, jcam, jbvh, tbvh = scenes
    o, d = _rays(kind, jcam)
    t_max = np.random.default_rng(5).uniform(0.1, 12.0, len(o)).astype(np.float32)
    ref = np.asarray(occluded(jbvh, jnp.asarray(o), jnp.asarray(d), 1e-4,
                              jnp.asarray(t_max)))
    got = plain.occluded(tbvh, _t(o), _t(d), 1e-4, _t(t_max)).numpy()
    assert np.array_equal(got, ref)
    assert 0.05 < got.mean() < 0.95


def test_matches_pallas_wide_k2_interpret(scenes):
    """K2 (_kernel_compact4) in interpret mode on 1,024 camera rays."""
    from hiprt_pt_tpu.ops.pallas_traverse import traverse_pallas_wide

    _, jcam, jbvh, tbvh = scenes
    o, d = _rays("camera", jcam)
    ref = traverse_pallas_wide(jbvh, jnp.asarray(o), jnp.asarray(d), t_min=0.0,
                               interpret=True)
    rec = plain.closest_hit(tbvh, _t(o), _t(d), t_min=0.0)
    pr, pt = np.asarray(ref.prim), rec.prim.numpy()
    assert tp.prim_agreement(pr, pt) >= 0.999
    m = (pr == pt) & (pr >= 0)
    np.testing.assert_allclose(rec.t.numpy()[m], np.asarray(ref.t)[m], rtol=1e-5)


def _k2_interpret(jbvh, o, d, t_min, t_max, active, any_hit):
    """K2 (_kernel_compact4) in interpret mode on any number of rays: its
    wrapper takes multiples of 1,024, so the rays are padded with inactive
    ones, as the JAX package's callers pad a ragged wavefront."""
    from hiprt_pt_tpu.ops.pallas_traverse import traverse_pallas_wide

    n = len(o)
    pad = -n % 1024

    def padded(x, fill):
        return jnp.asarray(np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, x.dtype)]))

    ref = traverse_pallas_wide(
        jbvh, padded(o, 0.0), padded(d, 1.0), t_min=t_min,
        t_max=padded(t_max, 1.0), active=padded(active, False),
        any_hit=any_hit, interpret=True)
    return np.asarray(ref.prim)[:n], np.asarray(ref.t)[:n]


def _shadow_like_rays(jcam, tbvh, n, seed):
    """Rays shaped like the first bounce's MIS shadow rays: from the camera
    hits of a 32 x 32 view toward a point per ray under the hall's ceiling,
    t_max just short of that point; rays whose camera ray missed, and one in
    eight of the others, are inactive."""
    rng = np.random.default_rng(seed)
    o, d = _rays("camera", jcam)
    first = plain.closest_hit(tbvh, _t(o), _t(d), t_min=0.0)
    hit = first.prim.numpy() >= 0
    p = o + d * np.where(hit, first.t.numpy(), 0.0)[:, None]
    target = rng.uniform([-9.0, 5.0, -5.0], [9.0, 5.8, 5.0], p.shape)
    to = (target - p).astype(np.float32)
    dist = np.linalg.norm(to, axis=1).astype(np.float32)
    wi = (to / dist[:, None]).astype(np.float32)
    origin = (p + 1e-3 * wi).astype(np.float32)
    active = hit & (rng.random(len(p)) >= 0.125)
    t_max = (dist * (1.0 - 1e-3)).astype(np.float32)
    return origin[:n], wi[:n], t_max[:n], active[:n]


@pytest.mark.parametrize("n", [1024, 1000])
def test_shadow_like_rays_match_pallas_wide_k2_interpret(scenes, n):
    """The plain walk against interpret-mode K2 on any-hit rays with a
    per-ray finite t_max and inactive lanes, on a full wavefront and on one
    whose size is no multiple of 32: equal occlusion on at least 0.999 of
    the rays (the file's threshold for K2: its packet walk and the per-ray
    walk differ only where a ray grazes a box), inactive rays all misses."""
    _, jcam, jbvh, tbvh = scenes
    o, d, t_max, active = _shadow_like_rays(jcam, tbvh, n, seed=21)
    assert 0.5 < active.mean() < 0.95
    ref_prim, ref_t = _k2_interpret(jbvh, o, d, 1e-4, t_max, active, True)
    rec = plain.traverse(tbvh, _t(o), _t(d), 1e-4, _t(t_max),
                         torch.from_numpy(active), any_hit=True)
    got = rec.prim.numpy() >= 0
    assert len(got) == n
    assert tp.prim_agreement(ref_prim >= 0, got) >= 0.999
    assert 0.02 < got[active].mean() < 0.98
    assert not got[~active].any() and np.all(np.isinf(rec.t.numpy()[~active]))
    assert not (ref_prim[~active] >= 0).any()
    assert not rec.u.any() and not rec.v.any()


def test_ragged_closest_hit_matches_pallas_wide_k2_interpret(scenes):
    """Closest hit on 1,000 camera rays (no multiple of 32) with a per-ray
    t_max and inactive lanes: prims agree on at least 0.999 of the rays and
    t within rtol 1e-5 where they do, as for the full wavefront above."""
    _, jcam, jbvh, tbvh = scenes
    o, d = (x[:1000] for x in _rays("camera", jcam))
    rng = np.random.default_rng(22)
    t_max = np.where(rng.random(1000) < 0.3, rng.uniform(0.5, 6.0, 1000),
                     np.inf).astype(np.float32)
    active = rng.random(1000) >= 0.1
    ref_prim, ref_t = _k2_interpret(jbvh, o, d, 0.0, t_max, active, False)
    rec = plain.traverse(tbvh, _t(o), _t(d), 0.0, _t(t_max),
                         torch.from_numpy(active))
    pt = rec.prim.numpy()
    assert tp.prim_agreement(ref_prim, pt) >= 0.999
    m = (ref_prim == pt) & (pt >= 0)
    assert m.sum() > 300
    np.testing.assert_allclose(rec.t.numpy()[m], ref_t[m], rtol=1e-5)
    assert np.all(pt[~active] == -1) and np.all(ref_prim[~active] == -1)


def test_matches_pallas_lane8s_k1_interpret(scenes):
    """K1 (_kernel_lane8s) in interpret mode on 1,024 incoherent rays. Its
    leaves sit on an int8 lattice, so its raw t carries an absolute error of
    about one lattice step (~1e-4 here): t within rtol 1e-3 or atol 2e-4.
    The JAX package's exact winner refinement then matches to rtol 1e-5."""
    from hiprt_pt_tpu.ops.pallas_traverse import (refine_hit_record,
                                                  traverse_pallas_lane8s)

    _, jcam, jbvh, tbvh = scenes
    o, d = _rays("incoherent", jcam)
    ref = traverse_pallas_lane8s(jbvh, jnp.asarray(o), jnp.asarray(d),
                                 t_min=0.0, interpret=True, refine=False)
    rec = plain.closest_hit(tbvh, _t(o), _t(d), t_min=0.0)
    pr, pt = np.asarray(ref.prim), rec.prim.numpy()
    assert tp.prim_agreement(pr, pt) >= 0.999
    m = (pr == pt) & (pr >= 0)
    np.testing.assert_allclose(rec.t.numpy()[m], np.asarray(ref.t)[m],
                               rtol=1e-3, atol=2e-4)
    exact = refine_hit_record(jbvh, jnp.asarray(o), jnp.asarray(d), ref)
    np.testing.assert_allclose(rec.t.numpy()[m], np.asarray(exact.t)[m], rtol=1e-5)


def test_matches_brute_force(scenes):
    from hiprt_pt_tpu.ops.intersect import brute_force_closest as jbrute

    jscene, jcam, _, tbvh = scenes
    o, d = tp.incoherent_rays_np(256, seed=3)
    rec = plain.closest_hit(tbvh, _t(o), _t(d), t_min=0.0)
    verts = torch.from_numpy(np.asarray(jscene.vertices))
    tris = torch.from_numpy(np.asarray(jscene.triangles))
    bt, bp, _, _ = brute_force_closest(verts, tris, _t(o), _t(d), t_min=0.0)
    assert tp.prim_agreement(bp.numpy(), rec.prim.numpy()) >= 0.999
    m = bp.numpy() >= 0
    np.testing.assert_allclose(rec.t.numpy()[m], bt.numpy()[m], rtol=1e-5)
    # the port's oracle is the JAX package's oracle
    jt, jp, _, _ = jbrute(jscene.vertices, jscene.triangles, jnp.asarray(o[:64]),
                          jnp.asarray(d[:64]), t_min=0.0)
    assert np.array_equal(np.asarray(jp), bp.numpy()[:64])


def test_inactive_rays_miss_and_tmax_is_respected(scenes):
    _, jcam, _, tbvh = scenes
    o, d = _rays("incoherent", jcam, n=512)
    full = plain.closest_hit(tbvh, _t(o), _t(d), t_min=0.0)
    rng = np.random.default_rng(9)
    active = rng.random(len(o)) < 0.7
    t_max = rng.uniform(0.2, 5.0, len(o)).astype(np.float32)
    for any_hit in (False, True):
        rec = plain.traverse(tbvh, _t(o), _t(d), 0.0, _t(t_max),
                             torch.from_numpy(active), any_hit=any_hit)
        p, t = rec.prim.numpy(), rec.t.numpy()
        assert np.all(p[~active] == -1) and np.all(np.isinf(t[~active]))
        expect = active & (full.prim.numpy() >= 0) & (full.t.numpy() < t_max)
        assert np.array_equal(p >= 0, expect)
        assert np.all(t[p >= 0] < t_max[p >= 0])
        if not any_hit:
            assert np.array_equal(p[expect], full.prim.numpy()[expect])


def test_wrappers_run_the_plain_version_on_cpu(scenes):
    _, jcam, _, tbvh = scenes
    o, d = _rays("camera", jcam, n=256)
    cuda_build.reset_launch_counts()
    ref = plain.closest_hit(tbvh, _t(o), _t(d), t_min=0.0)
    for fn in (cuda_traverse.trace_coherent, cuda_traverse.trace_incoherent):
        rec = fn(tbvh, _t(o), _t(d), t_min=0.0)
        assert np.array_equal(rec.prim.numpy(), ref.prim.numpy())
        assert np.array_equal(rec.t.numpy(), ref.t.numpy())
    assert set(KERNEL_TABLES) <= set(cuda_build.launch_counts)
    assert not any(cuda_build.launch_counts.values())


def test_single_leaf_scene():
    """A scene small enough to be one leaf still traverses (root row with
    the leaf as its only child)."""
    rng = np.random.default_rng(4)
    verts = (rng.normal(size=(15, 3)) * 0.5).astype(np.float32)
    tris = np.arange(15, dtype=np.int32).reshape(5, 3)
    bvh = build_bvh(verts, tris, "cpu", all_tables=True)
    assert bvh.nodes4.shape[0] == 1
    o = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
    d = (-o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    rec = plain.closest_hit(bvh, _t(o), _t(d), t_min=0.0)
    bt, bp, _, _ = brute_force_closest(_t(verts), _t(tris), _t(o), _t(d), t_min=0.0)
    assert np.array_equal(rec.prim.numpy(), bp.numpy())
    assert (bp.numpy() >= 0).sum() > 10
