"""The meganode table and its walk (the plain version of trace_meganode, the
K3 port) against the JAX package on the procedural Cornell scene: equal
tables, the exact XLA walk, the interpret-mode Pallas kernel K3
(traverse_pallas) and brute force; the route of the render path; and the
near-zero direction guard, repaired in the port.

Tolerances: prim agreement >= 0.999 (an equal-t tie goes to the smaller
prim id in the port and to the first triangle visited in the JAX walks);
t within rtol 1e-5 where the prims agree (XLA's CPU code may contract
products into FMAs, the port rounds every product)."""

import dataclasses
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402

from hiprt_pt_tpu_torch import interop  # noqa: E402
from hiprt_pt_tpu_torch.accel.build import (MAX_MEGANODE_ROWS,  # noqa: E402
                                            build_bvh)
from hiprt_pt_tpu_torch.ops import cuda_build, cuda_traverse  # noqa: E402
from hiprt_pt_tpu_torch.ops import traverse as plain  # noqa: E402
from hiprt_pt_tpu_torch.ops.intersect import brute_force_closest  # noqa: E402

N = 1024


@pytest.fixture(scope="module")
def cornell():
    """(vertices, triangles, JAX camera, JAX BVHData, the port's BVHData)."""
    from hiprt_pt_tpu.accel.build import build_bvh as jbuild
    from hiprt_pt_tpu.core.camera import camera_from_lookat

    v, f, _m, _rows, cam = tp.cornell_spheres_arrays(1.0)
    return (v, f, camera_from_lookat(**cam), jbuild(v, f),
            build_bvh(v, f, "cpu", all_tables=True))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rays(kind, jcam, n=N, seed=11):
    """Camera rays (tile-major, pixel centres) or rays from inside the box
    in directions uniform on the sphere; a tenth inactive, a quarter with a
    finite t_max."""
    if kind == "camera":
        o, d = tp.camera_rays_np(jcam, 32, n // 32)
    else:
        rng = np.random.default_rng(seed)
        o = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (n, 3))
        d = rng.normal(size=(n, 3))
        o, d = o.astype(np.float32), (d / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    t_max = np.where(rng.random(n) < 0.25, rng.uniform(0.3, 3.0, n),
                     np.inf).astype(np.float32)
    active = rng.random(n) >= 0.1
    return o, d, t_max, active


def _tree_depth(rows: np.ndarray) -> int:
    """Row depth of a meganode table by recursion (root = 1)."""
    meta = rows[:, 12:16].copy().view(np.int32)

    def depth(r):
        kids = [meta[r, 2 * c] for c in range(2) if meta[r, 2 * c + 1] == 0]
        return 1 + max((depth(k) for k in kids), default=0)

    return depth(0)


def test_nodes_table_equals_jax(cornell):
    _v, f, _c, jbvh, tbvh = cornell
    ref = np.asarray(jbvh.nodes)
    got = tbvh.nodes.numpy()
    assert got.shape == ref.shape and got.shape[0] <= MAX_MEGANODE_ROWS
    # bit for bit: int32 meta and prim ids in f32 columns, NaN padding
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    assert f.shape[0] == 35_852
    assert tbvh.depth2 == _tree_depth(ref)
    assert tbvh.depth2 <= plain.MEGANODE_STACK


def test_interop_carries_the_meganode_table(cornell):
    _v, _f, _c, jbvh, tbvh = cornell
    keys = ("nodes4", "leaf_rows", "tri_rows", "nodes")
    got = interop.bvh_from_numpy({k: np.asarray(getattr(jbvh, k)) for k in keys},
                                 "cpu")
    assert np.array_equal(got.nodes.numpy().view(np.int32),
                          tbvh.nodes.numpy().view(np.int32))
    assert got.depth2 == tbvh.depth2
    # a table above the cap is dropped, as build_bvh drops it
    big = np.zeros((MAX_MEGANODE_ROWS + 1, 128), np.float32)
    big[:, 12:16] = np.asarray([0, 1, 0, 1], np.int32).view(np.float32)
    d = {k: np.asarray(getattr(jbvh, k)) for k in keys[:3]}
    assert interop.bvh_from_numpy(dict(d, nodes=big), "cpu").nodes is None
    assert interop.bvh_from_numpy(d, "cpu").nodes is None


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kind", ["camera", "incoherent"])
def test_matches_jax_walk(cornell, kind, any_hit):
    from hiprt_pt_tpu.ops.traverse import traverse as jtraverse

    _v, _f, jcam, jbvh, tbvh = cornell
    o, d, t_max, active = _rays(kind, jcam)
    t_min = 1e-4 if any_hit else 0.0
    ref = jtraverse(jbvh, jnp.asarray(o), jnp.asarray(d), t_min,
                    jnp.asarray(t_max), jnp.asarray(active), any_hit=any_hit)
    rec = plain.traverse_meganode(tbvh, _t(o), _t(d), t_min, _t(t_max),
                                  _t(active), any_hit=any_hit)
    pr, pt = np.asarray(ref.prim), rec.prim.numpy()
    assert np.all(pt[~active] == -1) and np.all(np.isinf(rec.t.numpy()[~active]))
    if any_hit:
        assert np.array_equal(pt >= 0, pr >= 0)
        assert 0.05 < (pt >= 0).mean() < 0.95
        assert np.all(rec.u.numpy() == 0.0)
        return
    assert tp.prim_agreement(pr, pt) >= 0.999
    m = (pr == pt) & (pr >= 0)
    assert m.sum() > 0.3 * len(pr)
    np.testing.assert_allclose(rec.t.numpy()[m], np.asarray(ref.t)[m], rtol=1e-5)
    np.testing.assert_allclose(rec.u.numpy()[m], np.asarray(ref.u)[m], atol=2e-4)
    assert np.all(t_max[pt >= 0] > rec.t.numpy()[pt >= 0])


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kind", ["camera", "incoherent"])
def test_matches_pallas_k3_interpret(cornell, kind, any_hit):
    """K3 (_kernel / traverse_pallas) in interpret mode on 1,024 rays."""
    from hiprt_pt_tpu.ops.pallas_traverse import traverse_pallas

    _v, _f, jcam, jbvh, tbvh = cornell
    o, d, t_max, active = _rays(kind, jcam, seed=21)
    t_min = 1e-4 if any_hit else 0.0
    ref = traverse_pallas(jbvh, jnp.asarray(o), jnp.asarray(d), t_min,
                          jnp.asarray(t_max), jnp.asarray(active),
                          any_hit=any_hit, interpret=True)
    rec = plain.traverse_meganode(tbvh, _t(o), _t(d), t_min, _t(t_max),
                                  _t(active), any_hit=any_hit)
    pr, pt = np.asarray(ref.prim), rec.prim.numpy()
    if any_hit:
        assert np.mean((pr >= 0) == (pt >= 0)) >= 0.999
        return
    assert tp.prim_agreement(pr, pt) >= 0.999
    m = (pr == pt) & (pr >= 0)
    np.testing.assert_allclose(rec.t.numpy()[m], np.asarray(ref.t)[m], rtol=1e-5)


def test_matches_brute_force(cornell):
    v, f, jcam, _jb, tbvh = cornell
    o, d, _tm, _a = _rays("incoherent", jcam, n=256, seed=3)
    rec = plain.traverse_meganode(tbvh, _t(o), _t(d), 0.0)
    bt, bp, _, _ = brute_force_closest(_t(v), _t(f), _t(o), _t(d), t_min=0.0)
    assert tp.prim_agreement(bp.numpy(), rec.prim.numpy()) >= 0.999
    m = bp.numpy() >= 0
    assert m.mean() > 0.75  # the box is open at the front
    np.testing.assert_allclose(rec.t.numpy()[m], bt.numpy()[m], rtol=1e-5)


def test_single_leaf_row_with_an_empty_slot():
    """A scene of one leaf is one row whose second child is an empty slot:
    meta [0, count, 0, -1] and a zero box. The empty slot is neither
    descended nor intersected, though its box can pass the slab test."""
    rng = np.random.default_rng(4)
    verts = (rng.normal(size=(12, 3)) * 0.5 + 1.0).astype(np.float32)
    tris = np.arange(12, dtype=np.int32).reshape(4, 3)
    bvh = build_bvh(verts, tris, "cpu", all_tables=True)
    meta = bvh.nodes.numpy()[:, 12:16].copy().view(np.int32)
    assert bvh.nodes.shape[0] == 1 and bvh.depth2 == 1
    assert meta.tolist() == [[0, 4, 0, -1]]
    assert np.all(bvh.nodes.numpy()[0, 6:12] == 0.0)
    # rays through the origin, inside the zero box of the empty slot
    o = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
    d = (-o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d[:128] = ((1.0 - o[:128]) / np.linalg.norm(1.0 - o[:128], axis=-1,
                                                keepdims=True))
    rec = plain.traverse_meganode(bvh, _t(o), _t(d), 0.0)
    bt, bp, _, _ = brute_force_closest(_t(verts), _t(tris), _t(o), _t(d), t_min=0.0)
    assert np.array_equal(rec.prim.numpy(), bp.numpy())
    assert (bp.numpy() >= 0).sum() > 10


def test_route_picks_the_meganode_kernel_only_for_a_kept_table(cornell):
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene
    from hiprt_pt_tpu_torch.render.integrator import _tracer

    tbvh = cornell[4]
    for coherent in (True, False):
        assert _tracer(tbvh, coherent) is cuda_traverse.trace_meganode
    big = dataclasses.replace(
        tbvh, nodes=torch.zeros((MAX_MEGANODE_ROWS + 1, 128)))
    for b in (dataclasses.replace(tbvh, nodes=None), big):
        assert _tracer(b, True) is cuda_traverse.trace_coherent
        assert _tracer(b, False) is cuda_traverse.trace_incoherent
    # the stress interior's meganode table is past the cap and is not kept
    scene, _cam = load_stress_scene(tri_scale=tp.TRI_SCALE, with_textures=False,
                                    device="cpu")
    sbvh = build_bvh(scene.vertices.numpy(), scene.triangles.numpy(), "cpu")
    assert sbvh.nodes is None and sbvh.depth2 > 0
    assert _tracer(sbvh, True) is cuda_traverse.trace_coherent
    assert _tracer(sbvh, False) is cuda_traverse.trace_incoherent


def test_wrapper_runs_the_plain_walk_on_cpu(cornell):
    _v, _f, jcam, _jb, tbvh = cornell
    o, d, t_max, active = _rays("camera", jcam, n=256)
    cuda_build.reset_launch_counts()
    for any_hit in (False, True):
        ref = plain.traverse_meganode(tbvh, _t(o), _t(d), 1e-4, _t(t_max),
                                      _t(active), any_hit=any_hit)
        rec = cuda_traverse.trace_meganode(tbvh, _t(o), _t(d), 1e-4, _t(t_max),
                                           _t(active), any_hit=any_hit)
        assert np.array_equal(rec.prim.numpy(), ref.prim.numpy())
        assert np.array_equal(rec.t.numpy(), ref.t.numpy())
    assert cuda_build.launch_counts["trace_meganode"] == 0


def test_walk_raises_on_a_tree_deeper_than_its_stack(cornell):
    tbvh = cornell[4]
    o, d = _t(np.zeros((4, 3), np.float32)), _t(np.ones((4, 3), np.float32))
    with pytest.raises(ValueError, match="stack"):
        plain.traverse_meganode(
            dataclasses.replace(tbvh, depth2=plain.MEGANODE_STACK + 1), o, d)
    with pytest.raises(ValueError, match="no meganode table"):
        cuda_traverse.trace_meganode(dataclasses.replace(tbvh, nodes=None), o, d)


# --- the near-zero direction guard -----------------------------------------

def _floor_rays():
    """Rays from (0.1, 1, 0.2) straight down onto a 2 x 2 quad at y = 0,
    with x and z components of -1e-13, +1e-13, -0 and +0."""
    comps = [-1e-13, 1e-13, -0.0, 0.0]
    d = np.asarray([[cx, -1.0, cz] for cx in comps for cz in comps], np.float32)
    o = np.tile(np.asarray([[0.1, 1.0, 0.2]], np.float32), (len(d), 1))
    verts = np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, tris, o, d


def test_tiny_negative_direction_components_hit():
    """A component in (-1e-12, 0) used to give 1/d = 0, which collapsed the
    slab on that axis: the ray missed every box not around its origin. The
    port's guard gives -1e12; every walk hits what brute force hits."""
    verts, tris, o, d = _floor_rays()
    bvh = build_bvh(verts, tris, "cpu", all_tables=True)
    bt, bp, _, _ = brute_force_closest(_t(verts), _t(tris), _t(o), _t(d), t_min=0.0)
    assert np.all(bp.numpy() >= 0) and np.allclose(bt.numpy(), 1.0)
    inv = plain.inverse_direction(_t(d)).numpy()
    tiny = np.abs(d) <= 1e-12
    assert np.all(inv[tiny & (d < 0.0)] == -1e12)
    assert np.all(inv[tiny & (d >= 0.0)] == 1e12)  # +1e12 for -0 too
    for walk in (plain.traverse, plain.traverse_meganode):
        rec = walk(bvh, _t(o), _t(d), 0.0)
        assert np.array_equal(rec.prim.numpy(), bp.numpy()), walk.__name__
        np.testing.assert_allclose(rec.t.numpy(), bt.numpy(), rtol=1e-6)
        occ = walk(bvh, _t(o), _t(d), 1e-4, 2.0, any_hit=True).prim.numpy() >= 0
        assert occ.all(), walk.__name__


@pytest.mark.xfail(strict=True, reason=(
    "known fault in the reference (ROADMAP §3): the JAX walks' guard "
    "sign(c)*1e12 + 1e12 gives 1/d = 0 for a component in (-1e-12, 0), so "
    "such a ray misses the floor it points at"))
def test_reference_walk_misses_with_a_tiny_negative_component():
    from hiprt_pt_tpu.accel.build import build_bvh as jbuild
    from hiprt_pt_tpu.ops.traverse import closest_hit

    verts, tris, o, d = _floor_rays()
    ref = closest_hit(jbuild(verts, tris), jnp.asarray(o), jnp.asarray(d), t_min=0.0)
    assert np.all(np.asarray(ref.prim) >= 0)
