"""The port's CUDA traversal kernels against their plain PyTorch version, on
the card. Every test here needs an NVIDIA GPU (sm_90a) and nvcc, and skips
when torch.cuda.is_available() is false. On a GPU host without JAX (the
tests' conftest.py imports JAX, which this file does not need):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

chip_smoke.py checks the same at full scale.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402
from hiprt_pt_tpu_torch.ops import cuda_build  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gpu_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene

    dev = torch.device("cuda:0")
    scene, cam = load_stress_scene(aspect=2.0, tri_scale=0.01,
                                   with_textures=False, device=dev)
    # every table: the BVH8 kernels are tested here beside the routed ones
    bvh = build_bvh(scene.vertices.cpu().numpy(), scene.triangles.cpu().numpy(),
                    dev, all_tables=True)
    return scene, cam, bvh, dev


def _rays(dev, n=16384, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-9.5, 0.4, -5.5], [9.5, 5.5, 5.5], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.random(n) < 0.3, rng.uniform(0.2, 4.0, n), np.inf)
    active = rng.random(n) >= 0.1
    return (torch.from_numpy(o).to(dev), torch.from_numpy(d.astype(np.float32)).to(dev),
            torch.from_numpy(t_max.astype(np.float32)).to(dev),
            torch.from_numpy(active).to(dev))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kernel", ["trace_coherent", "trace_incoherent"])
def test_kernel_matches_plain(gpu_scene, kernel, any_hit):
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops import traverse as plain

    _, _, bvh, dev = gpu_scene
    o, d, t_max, active = _rays(dev)
    before = cuda_build.launch_counts[kernel]
    rk = getattr(ct, kernel)(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts[kernel] == before + 1
    rp = plain.traverse(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    pk, pp = rk.prim.cpu().numpy(), rp.prim.cpu().numpy()
    act = active.cpu().numpy()
    assert np.all(pk[~act] == -1) and np.all(np.isinf(rk.t.cpu().numpy()[~act]))
    if any_hit:
        assert np.mean((pk >= 0) == (pp >= 0)) >= 0.9999
    else:
        assert np.mean(pk == pp) >= 0.9999
        m = (pk == pp) & (pk >= 0)
        np.testing.assert_allclose(rk.t.cpu().numpy()[m], rp.t.cpu().numpy()[m],
                                   rtol=1e-5)


@pytest.mark.parametrize("coherent", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kernel", ["trace_stream8", "trace_lane8log"])
def test_bvh8_kernel_matches_plain(gpu_scene, kernel, any_hit, coherent):
    """trace_stream8 (K4 port) and trace_lane8log (K5 port) against
    traverse8 on incoherent rays and on camera rays in tile order."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops import traverse as plain

    _, cam, bvh, dev = gpu_scene
    o, d, t_max, active = _rays(dev)
    if coherent:
        o, d = (torch.from_numpy(x).to(dev) for x in tp.camera_rays_np_torch(cam, 128, 128))
    before = cuda_build.launch_counts[kernel]
    rk = getattr(ct, kernel)(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts[kernel] == before + 1
    rp = plain.traverse8(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    pk, pp = rk.prim.cpu().numpy(), rp.prim.cpu().numpy()
    act = active.cpu().numpy()
    assert np.all(pk[~act] == -1) and np.all(np.isinf(rk.t.cpu().numpy()[~act]))
    assert (pk >= 0).mean() > 0.2
    if any_hit:
        assert np.mean((pk >= 0) == (pp >= 0)) >= 0.9999
    else:
        assert np.mean(pk == pp) >= 0.9999
        m = (pk == pp) & (pk >= 0)
        np.testing.assert_allclose(rk.t.cpu().numpy()[m], rp.t.cpu().numpy()[m],
                                   rtol=1e-5)


@pytest.fixture(scope="module")
def gpu_cornell():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.accel.build import build_bvh

    v, f, _m, _rows, _cam = tp.cornell_spheres_arrays(1.0)
    dev = torch.device("cuda:0")
    return build_bvh(v, f, dev), dev


@pytest.mark.parametrize("any_hit", [False, True])
def test_meganode_kernel_matches_plain(gpu_cornell, any_hit):
    """trace_meganode (K3 port) on the Cornell scene: rays from inside the
    box in all directions, a tenth inactive, some with a finite t_max."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops import traverse as plain

    bvh, dev = gpu_cornell
    assert bvh.nodes is not None and bvh.nodes.is_cuda
    rng = np.random.default_rng(1)
    n = 16384
    o = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.random(n) < 0.3, rng.uniform(0.2, 2.0, n), np.inf)
    o, d, t_max = (torch.from_numpy(x.astype(np.float32)).to(dev)
                   for x in (o, d, t_max))
    active = torch.from_numpy(rng.random(n) >= 0.1).to(dev)
    before = cuda_build.launch_counts["trace_meganode"]
    rk = ct.trace_meganode(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["trace_meganode"] == before + 1
    rp = plain.traverse_meganode(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    pk, pp = rk.prim.cpu().numpy(), rp.prim.cpu().numpy()
    act = active.cpu().numpy()
    assert np.all(pk[~act] == -1) and np.all(np.isinf(rk.t.cpu().numpy()[~act]))
    assert (pk >= 0).mean() > 0.5
    if any_hit:
        assert np.mean((pk >= 0) == (pp >= 0)) >= 0.9999
    else:
        assert np.mean(pk == pp) >= 0.9999
        m = (pk == pp) & (pk >= 0)
        np.testing.assert_allclose(rk.t.cpu().numpy()[m], rp.t.cpu().numpy()[m],
                                   rtol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take(gpu_scene):
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct

    _, _, bvh, dev = gpu_scene
    o, d, _, _ = _rays(dev, n=256)
    with pytest.raises(ValueError, match="contiguous"):
        ct.trace_incoherent(bvh, o, d.t().contiguous().t())
    with pytest.raises(TypeError):
        ct.trace_coherent(bvh, o.double(), d)


def test_gpu_render_matches_cpu(gpu_scene):
    from hiprt_pt_tpu_torch.core import settings as ts
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    scene, cam, bvh, _ = gpu_scene
    opts = ts.RenderOptions(direct_light_sampling=ts.LightSamplingStrategy.MIS,
                            bsdf_override=ts.BSDFOverride.LAMBERTIAN,
                            do_dispersion=False, max_bounces_static=4)
    settings = ts.RenderSettings(nb_bounces=4)
    world = ts.WorldSettings(ambient_light_type=int(ts.AmbientLightType.NONE))
    cpu = torch.device("cpu")
    imgs = []
    for sc, c, b in ((scene, cam, bvh), (scene.to(cpu), cam.to(cpu), bvh.to(cpu))):
        r = Renderer(sc, c, 64, 32, options=opts, settings=settings, world=world,
                     bvh=b, seed=42)
        r.step()
        imgs.append(r.hdr_image())
    got, ref = imgs
    close = np.all(np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= 0.98


@pytest.mark.parametrize("case", ["mm-int8-g1", "mm-int8-g8", "mm-bf16-g2",
                                  "dg-per-lane", "dg-broadcast"])
def test_probe_kernels_match_plain(case):
    """mm_probe_kernel (P1) and dg_probe_kernel (P2) equal their plain
    versions exactly on seeded integer inputs; the P1 shapes leave masked
    rows (W = 100), a ragged K (L = 300) and, at 8 groups, columns past a
    group's end (NL / groups = 25)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.probes import r5probe2 as probes

    dev = torch.device("cuda:0")
    rounds = 6
    if case.startswith("mm"):
        dtype = torch.int8 if "int8" in case else torch.bfloat16
        groups = int(case.split("-g")[1])
        tab, idx = probes.mm_gate_inputs(300, 100, 200, dtype, seed=4, device=dev)
        kernel = "mm_probe"
        before = cuda_build.launch_counts[kernel]
        got = probes.mm_probe_kernel(probes.mm_table(tab), idx, rounds, groups)
        want = probes.mm_probe_plain(tab, idx, rounds, groups)
    else:
        tab, idx = probes.dg_gate_inputs(512, 3, seed=6, device=dev,
                                         per_lane=case == "dg-per-lane")
        kernel = "dg_probe"
        before = cuda_build.launch_counts[kernel]
        got = probes.dg_probe_kernel(tab, idx, rounds)
        want = probes.dg_probe_plain(tab, idx, rounds)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts[kernel] == before + 1
    assert got.dtype == torch.float32 and got.shape == (1, 1) and got.is_cuda
    assert float(got) == float(want)


@pytest.mark.parametrize("groups", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
@pytest.mark.parametrize("shape", [(300, 100, 200), (129, 65, 1048),
                                   (2731, 333, 1096)],
                         ids=["L300-W100-NL200", "L129-W65-NL1048",
                              "L2731-W333-NL1096"])
def test_mm_probe_kernel_off_the_tile(shape, dtype, groups):
    """The wgmma version of mm_probe_kernel (P1) equals mm_probe_plain
    exactly (integer tables, every sum below 2^24) at shapes that are no
    multiple of its tile: W off the 128 table rows of a tile and the 16 of
    the padding, L off the 128 bytes of a stage and the 32 columns of the
    padding, NL / groups off the 256 gathered rows of a block (25, 131 and
    137 at 8 groups, 1,048 and 1,096 fused), so that blocks hold masked
    rows, the last tile masked table rows and the last stage zero fill. Two
    runs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.probes import r5probe2 as probes

    L, W, NL = shape
    dev = torch.device("cuda:0")
    tab, idx = probes.mm_gate_inputs(L, W, NL, dtype, seed=7, device=dev)
    table = probes.mm_table(tab)
    before = cuda_build.launch_counts["mm_probe"]
    got = probes.mm_probe_kernel(table, idx, 5, groups)
    again = probes.mm_probe_kernel(table, idx, 5, groups)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["mm_probe"] == before + 2
    assert float(got) == float(probes.mm_probe_plain(tab, idx, 5, groups))
    assert torch.equal(got, again)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n", [16389, 77, 1])
def test_lane8log_ragged_counts(gpu_scene, n, any_hit):
    """trace_lane8log (K5 port) against traverse8 on ray counts that are no
    multiple of its 128-thread blocks or of a warp, with finite t_max and
    inactive rays: prim agreement >= 0.9999 (any-hit: occlusion), t within
    rtol 1e-5 where the prims agree, inactive rays all misses."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops import traverse as plain

    _, _, bvh, dev = gpu_scene
    o, d, t_max, active = _rays(dev, n=n, seed=3)
    rk = ct.trace_lane8log(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    torch.cuda.synchronize()
    rp = plain.traverse8(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    pk, pp = rk.prim.cpu().numpy(), rp.prim.cpu().numpy()
    act = active.cpu().numpy()
    assert np.all(pk[~act] == -1) and np.all(np.isinf(rk.t.cpu().numpy()[~act]))
    if any_hit:
        assert np.mean((pk >= 0) == (pp >= 0)) >= 0.9999
        assert not rk.u.any() and not rk.v.any()
    else:
        assert np.mean(pk == pp) >= 0.9999
        m = (pk == pp) & (pk >= 0)
        np.testing.assert_allclose(rk.t.cpu().numpy()[m], rp.t.cpu().numpy()[m],
                                   rtol=1e-5)


def test_lane8log_tiny_negative_direction_components():
    """Rays straight down onto a quad with x and z components of -1e-13,
    +1e-13, -0 and +0 (tests/test_torch_meganode.py): trace_lane8log hits
    what brute force hits, at t = 1 (rtol 1e-6), and reports occlusion."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops.intersect import brute_force_closest

    comps = [-1e-13, 1e-13, -0.0, 0.0]
    d = np.asarray([[cx, -1.0, cz] for cx in comps for cz in comps], np.float32)
    o = np.tile(np.asarray([[0.1, 1.0, 0.2]], np.float32), (len(d), 1))
    verts = np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    dev = torch.device("cuda:0")
    bvh = build_bvh(verts, tris, dev, all_tables=True)
    o_t, d_t = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    bt, bp, _, _ = brute_force_closest(
        torch.from_numpy(verts).to(dev), torch.from_numpy(tris).to(dev), o_t, d_t,
        t_min=0.0)
    rec = ct.trace_lane8log(bvh, o_t, d_t, 0.0)
    torch.cuda.synchronize()
    assert np.all(bp.cpu().numpy() >= 0)
    assert np.array_equal(rec.prim.cpu().numpy(), bp.cpu().numpy())
    np.testing.assert_allclose(rec.t.cpu().numpy(), bt.cpu().numpy(), rtol=1e-6)
    occ = ct.trace_lane8log(bvh, o_t, d_t, 1e-4, 2.0, any_hit=True)
    assert (occ.prim >= 0).all()


# --- the per-ray while-while walks over the BVH4 (K1) and the meganode
# table (K3), and the warp-packet walk over the BVH4 (K2) ---

def _walk_case(kernel, gpu_scene, gpu_cornell, n, seed):
    """(bvh, plain walk, o, d, t_max, active) for ``kernel``: rays in the
    stress hall for trace_incoherent, the first n camera rays of a 256x128
    view in tile order for trace_coherent, rays inside the Cornell box for
    trace_meganode; finite t_max on three rays in ten, a tenth inactive."""
    from hiprt_pt_tpu_torch.ops import traverse as plain

    if kernel in ("trace_incoherent", "trace_coherent"):
        _, cam, bvh, dev = gpu_scene
        o, d, t_max, active = _rays(dev, n=n, seed=seed)
        if kernel == "trace_coherent":
            o, d = (torch.from_numpy(x[:n].copy()).to(dev)
                    for x in tp.camera_rays_np_torch(cam, 256, 128))
        return bvh, plain.traverse, o, d, t_max, active
    bvh, dev = gpu_cornell
    rng = np.random.default_rng(seed)
    o = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.random(n) < 0.3, rng.uniform(0.2, 2.0, n), np.inf)
    o, d, t_max = (torch.from_numpy(x.astype(np.float32)).to(dev)
                   for x in (o, d, t_max))
    active = torch.from_numpy(rng.random(n) >= 0.1).to(dev)
    return bvh, plain.traverse_meganode, o, d, t_max, active


def _hold_against_plain(rk, rp, active, any_hit):
    pk, pp = rk.prim.cpu().numpy(), rp.prim.cpu().numpy()
    act = active.cpu().numpy()
    assert np.all(pk[~act] == -1) and np.all(np.isinf(rk.t.cpu().numpy()[~act]))
    if any_hit:
        assert np.mean((pk >= 0) == (pp >= 0)) >= 0.9999
        assert not rk.u.any() and not rk.v.any()
    else:
        assert np.mean(pk == pp) >= 0.9999
        m = (pk == pp) & (pk >= 0)
        np.testing.assert_allclose(rk.t.cpu().numpy()[m], rp.t.cpu().numpy()[m],
                                   rtol=1e-5)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n", [16389, 77, 1])
@pytest.mark.parametrize("kernel", ["trace_incoherent", "trace_meganode",
                                    "trace_coherent"])
def test_walk_kernels_ragged_counts(gpu_scene, gpu_cornell, kernel, n, any_hit):
    """trace_incoherent (K1 port), trace_meganode (K3 port) and
    trace_coherent (K2 port) against their plain walks on ray counts that
    are no multiple of their 128-thread blocks or of a warp (so the last
    packet of trace_coherent is ragged), with finite t_max and inactive
    rays: prim agreement >= 0.9999 (any-hit: occlusion), t within rtol 1e-5
    where the prims agree, inactive rays all misses."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct

    bvh, walk, o, d, t_max, active = _walk_case(kernel, gpu_scene, gpu_cornell,
                                                n, seed=3)
    before = cuda_build.launch_counts[kernel]
    rk = getattr(ct, kernel)(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts[kernel] == before + 1
    rp = walk(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    _hold_against_plain(rk, rp, active, any_hit)


@pytest.mark.parametrize("kernel", ["trace_incoherent", "trace_meganode",
                                    "trace_coherent", "trace_stream8"])
def test_walk_kernels_tiny_negative_direction_components(kernel):
    """Rays straight down onto a quad with x and z components of -1e-13,
    +1e-13, -0 and +0 (tests/test_torch_meganode.py): the kernel hits what
    brute force hits, at t = 1 (rtol 1e-6), and reports occlusion."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops.intersect import brute_force_closest

    comps = [-1e-13, 1e-13, -0.0, 0.0]
    d = np.asarray([[cx, -1.0, cz] for cx in comps for cz in comps], np.float32)
    o = np.tile(np.asarray([[0.1, 1.0, 0.2]], np.float32), (len(d), 1))
    verts = np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    dev = torch.device("cuda:0")
    bvh = build_bvh(verts, tris, dev, all_tables=True)
    o_t, d_t = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    bt, bp, _, _ = brute_force_closest(
        torch.from_numpy(verts).to(dev), torch.from_numpy(tris).to(dev), o_t, d_t,
        t_min=0.0)
    trace = getattr(ct, kernel)
    rec = trace(bvh, o_t, d_t, 0.0)
    torch.cuda.synchronize()
    assert np.all(bp.cpu().numpy() >= 0)
    assert np.array_equal(rec.prim.cpu().numpy(), bp.cpu().numpy())
    np.testing.assert_allclose(rec.t.cpu().numpy(), bt.cpu().numpy(), rtol=1e-6)
    occ = trace(bvh, o_t, d_t, 1e-4, 2.0, any_hit=True)
    assert (occ.prim >= 0).all()


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kernel", ["trace_incoherent", "trace_coherent"])
def test_incoherent_on_a_table_past_the_old_leaf_cap(kernel, any_hit):
    """trace_incoherent and trace_coherent against traverse on the
    70,000-triangle table of
    tests/test_torch_routing.py (shaped like tests/test_scale.py::
    test_lane8s_beyond_old_leaf_cap), 2,048 rays: equal prims (any-hit:
    equal occlusion), t within rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops import traverse as plain

    rng = np.random.default_rng(11)
    ntri = 70_000
    c = rng.uniform(-1, 1, (ntri, 3)).astype(np.float32)
    verts = (c[:, None, :] + rng.uniform(-0.01, 0.01, (ntri, 3, 3))
             ).astype(np.float32).reshape(-1, 3)
    tris = np.arange(ntri * 3).reshape(-1, 3).astype(np.int32)
    dev = torch.device("cuda:0")
    bvh = build_bvh(verts, tris, dev)
    n = 2048
    o = torch.from_numpy(rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)).to(dev)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True)).to(dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    rk = getattr(ct, kernel)(bvh, o, d, any_hit=any_hit)
    torch.cuda.synchronize()
    rp = plain.traverse(bvh, o, d, any_hit=any_hit)
    assert 0.1 < float((rp.prim >= 0).float().mean()) < 0.9
    _hold_against_plain(rk, rp, active, any_hit)
    if not any_hit:
        assert torch.equal(rk.prim, rp.prim)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kernel", ["trace_incoherent", "trace_meganode",
                                    "trace_coherent"])
def test_walk_kernels_all_inactive_and_repeatable(gpu_scene, gpu_cornell,
                                                  kernel, any_hit):
    """A wavefront whose rays are all inactive comes back all misses, and
    two launches on the same rays give bit-identical records (each ray's
    record is written once, by the thread that walked it, whatever the
    order in which the threads drew their rays)."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct

    bvh, _walk, o, d, t_max, active = _walk_case(kernel, gpu_scene, gpu_cornell,
                                                 5000, seed=8)
    trace = getattr(ct, kernel)
    none = trace(bvh, o, d, 1e-4, t_max, torch.zeros_like(active), any_hit=any_hit)
    torch.cuda.synchronize()
    assert (none.prim == -1).all() and torch.isinf(none.t).all()
    assert not none.u.any() and not none.v.any()
    first = trace(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    again = trace(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    torch.cuda.synchronize()
    assert (first.prim >= 0).any()
    for a, b in zip((first.t, first.prim, first.u, first.v),
                    (again.t, again.prim, again.u, again.v)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("rays", ["camera", "scattered"])
def test_coherent_packets_with_one_live_lane(gpu_scene, gpu_cornell, rays, any_hit):
    """trace_coherent on packets that hold a single live lane (lane p mod 32
    of packet p), every fourth packet with none: the live rays get what the
    plain walk gives them, all others are misses, and the count of packets
    that left packet mode stays within the packets launched."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct

    kernel = "trace_coherent" if rays == "camera" else "trace_incoherent"
    bvh, walk, o, d, t_max, _ = _walk_case(kernel, gpu_scene, gpu_cornell,
                                           8192, seed=5)
    i = torch.arange(8192, device=o.device)
    active = (i % 32 == (i // 32) % 32) & ((i // 32) % 4 != 3)
    rk = ct.trace_coherent(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    torch.cuda.synchronize()
    left, packets = ct.coherent_packets()
    assert packets == 256 and 0 <= left <= packets
    rp = walk(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    assert int(active.sum()) == 192 and (rp.prim[active] >= 0).any()
    _hold_against_plain(rk, rp, active, any_hit)
    if not any_hit:
        assert torch.equal(rk.prim, rp.prim)


def _small_integer_table(S, tiles, per_lane, seed, dev):
    """dg_gate_inputs with the table brought into [0, 16): every sum of 33
    rounds x 19 tiles stays below 2^24, so the f32 result is exact."""
    from hiprt_pt_tpu_torch.probes import r5probe2 as probes

    tab, idx = probes.dg_gate_inputs(S, tiles, seed=seed, device=dev,
                                     per_lane=per_lane)
    return torch.remainder(tab, 16.0).contiguous(), idx


@pytest.mark.parametrize("rounds", [1, 32, 33])
@pytest.mark.parametrize("per_lane", [True, False], ids=["per-lane", "broadcast"])
@pytest.mark.parametrize("tiles", [1, 4, 19])
def test_dg_probe_kernel_from_shared_memory(tiles, per_lane, rounds):
    """dg_probe_kernel (P2) with its strips in shared memory equals
    dg_probe_plain exactly at 1, 4 and 19 tiles (S = 1,000 at one tile,
    which no slice count divides, else the probe's 4,096), with per-lane and
    broadcast indices, some negative, at 1 round, at the 32 of one pass and
    at 33 (a second pass); two runs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.probes import r5probe2 as probes

    dev = torch.device("cuda:0")
    S = 1000 if tiles == 1 else 4096
    tab, idx = _small_integer_table(S, tiles, per_lane, 12, dev)
    idx = (idx - S * (idx % 5 == 0).int()).contiguous()
    assert probes.dg_plan(S, tiles)[0] != 0
    before = cuda_build.launch_counts["dg_probe"]
    got = probes.dg_probe_kernel(tab, idx, rounds)
    again = probes.dg_probe_kernel(tab, idx, rounds)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["dg_probe"] == before + 2
    assert float(got) == float(probes.dg_probe_plain(tab, idx, rounds))
    assert torch.equal(got, again)


@pytest.mark.parametrize("plan", [(0, 0), (2, 64), (2, 1024), (4, 128), (4, 512)],
                         ids=["L2", "g2-64", "g2-1024", "g4-128", "g4-512"])
def test_dg_probe_kernel_at_every_plan(plan):
    """Every strip width and block size the kernel takes, and its L2
    kernel, give dg_probe_plain's sum at S = 1,500 (no multiple of a block's
    slices), 3 tiles, 33 rounds; a plan the kernel does not take raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.probes import r5probe2 as probes

    dev = torch.device("cuda:0")
    tab, idx = _small_integer_table(1500, 3, True, 13, dev)
    got = probes.dg_probe_kernel(tab, idx, 33, plan)
    torch.cuda.synchronize()
    assert float(got) == float(probes.dg_probe_plain(tab, idx, 33))
    for bad in ((3, 256), (4, 100), (4, 2048), (8, 256)):
        with pytest.raises(ValueError, match="plan"):
            probes.dg_probe_kernel(tab, idx, 33, bad)


@pytest.mark.parametrize("per_lane", [True, False], ids=["per-lane", "broadcast"])
def test_dg_probe_kernel_past_the_shared_memory_size(per_lane):
    """A table of 30,000 rows has no strip that fits a block's shared
    memory: the wrapper plans the L2 kernel, which equals dg_probe_plain
    exactly, negative indices included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.probes import r5probe2 as probes

    dev = torch.device("cuda:0")
    S, tiles, rounds = 30000, 2, 3
    assert probes.dg_plan(S, tiles) == (0, 0)
    tab, idx = _small_integer_table(S, tiles, per_lane, 14, dev)
    idx = (idx - S * (idx % 5 == 0).int()).contiguous()
    got = probes.dg_probe_kernel(tab, idx, rounds)
    torch.cuda.synchronize()
    assert float(got) == float(probes.dg_probe_plain(tab, idx, rounds))


# --- trace_stream8 (K4 port): the per-ray BVH8 walk with half-warp refills ---

def _tile_shadow_rays(bvh, cam, dev, width=256, height=128, seed=21):
    """RIS-shaped shadow rays: from the camera hits of a width x height view
    in tile order toward one light point per 128-ray tile (seeded, in the
    hall), t_max short of the light per ray; active where the camera ray
    hit."""
    from hiprt_pt_tpu_torch.ops import traverse as plain

    o_c, d_c = (torch.from_numpy(x).to(dev)
                for x in tp.camera_rays_np_torch(cam, width, height))
    rec = plain.traverse8(bvh, o_c, d_c, 0.0)
    hit = rec.prim >= 0
    p = o_c + d_c * torch.where(hit, rec.t, 0.0)[:, None] - 1e-3 * d_c
    rng = np.random.default_rng(seed)
    n = p.shape[0]
    lights = rng.uniform(tp.HALL_LO, tp.HALL_HI, (-(-n // 128), 3)).astype(np.float32)
    to = torch.from_numpy(np.repeat(lights, 128, axis=0)[:n]).to(dev) - p
    dist = to.norm(dim=1)
    return (p.contiguous(), (to / dist[:, None]).contiguous(),
            (dist * (1.0 - 1e-3)).contiguous(), hit)


@pytest.mark.parametrize("kind", ["camera-closest", "camera-any-hit",
                                  "tile-shadow"])
def test_stream8_on_the_rays_it_serves(gpu_scene, kind):
    """trace_stream8 against traverse8 on camera rays in tile order (a
    256x128 view, a tenth inactive, finite t_max on some) and on RIS-shaped
    tile-shared any-hit rays with a per-ray t_max: prim agreement >= 0.9999
    (any-hit: occlusion), t bit-identical where the prims agree, inactive
    rays all misses."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops import traverse as plain

    _, cam, bvh, dev = gpu_scene
    if kind == "tile-shadow":
        o, d, t_max, active = _tile_shadow_rays(bvh, cam, dev)
        any_hit = True
    else:
        o, d = (torch.from_numpy(x).to(dev)
                for x in tp.camera_rays_np_torch(cam, 256, 128))
        _, _, t_max, active = _rays(dev, n=o.shape[0], seed=4)
        any_hit = kind == "camera-any-hit"
    before = cuda_build.launch_counts["trace_stream8"]
    rk = ct.trace_stream8(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["trace_stream8"] == before + 1
    rp = plain.traverse8(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    _hold_against_plain(rk, rp, active, any_hit)
    assert 0.05 < float((rk.prim >= 0).float().mean()) < 1.0
    m = (rk.prim == rp.prim) & (rk.prim >= 0)
    if not any_hit:
        assert torch.equal(rk.t[m], rp.t[m])


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n", [1, 127, 129, 65537])
def test_stream8_ragged_counts(gpu_scene, n, any_hit):
    """trace_stream8 against traverse8 on ray counts that are no multiple
    of a warp, a tile or a block, with finite t_max and a tenth of the rays
    inactive."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops import traverse as plain

    _, _, bvh, dev = gpu_scene
    o, d, t_max, active = _rays(dev, n=n, seed=9)
    rk = ct.trace_stream8(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    torch.cuda.synchronize()
    rp = plain.traverse8(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    _hold_against_plain(rk, rp, active, any_hit)


def test_stream8_equal_t_ties_go_to_the_smaller_prim():
    """Two coincident quads (prims 0, 1 and 2, 3 cover the same points):
    every ray straight down hits both at the same t, and trace_stream8, like
    traverse8, reports the smaller prim id of the pair it hits."""
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops import traverse as plain

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    dev = torch.device("cuda:0")
    verts = np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32)
    quad = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    bvh = build_bvh(verts, np.concatenate([quad, quad]), dev, all_tables=True)
    rng = np.random.default_rng(2)
    n = 4096
    o = np.concatenate([rng.uniform(-0.9, 0.9, (n, 1)), np.ones((n, 1)),
                        rng.uniform(-0.9, 0.9, (n, 1))], axis=1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    o_t, d_t = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    rk = ct.trace_stream8(bvh, o_t, d_t, 0.0)
    rp = plain.traverse8(bvh, o_t, d_t, 0.0)
    torch.cuda.synchronize()
    assert torch.equal(rk.prim, rp.prim) and torch.equal(rk.t, rp.t)
    assert set(rk.prim.cpu().tolist()) == {0, 1}


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream8_repeatable(gpu_scene, any_hit):
    """Two launches of trace_stream8 on the same rays give the same bits."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct

    _, cam, bvh, dev = gpu_scene
    o, d = (torch.from_numpy(x).to(dev) for x in tp.camera_rays_np_torch(cam, 256, 128))
    _, _, t_max, active = _rays(dev, n=o.shape[0], seed=7)
    first = ct.trace_stream8(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    again = ct.trace_stream8(bvh, o, d, 1e-4, t_max, active, any_hit=any_hit)
    torch.cuda.synchronize()
    for a, b in zip((first.t, first.prim, first.u, first.v),
                    (again.t, again.prim, again.u, again.v)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def gpu_envmap():
    """The envmap path (paths.py) on the card: the Cornell box with the
    "sky" test envmap, and its options."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch import paths

    scene, cam, bvh, _secs = paths.load("envmap", torch.device("cuda:0"))
    return scene, cam, bvh, paths.slice_options("envmap")


@pytest.mark.parametrize("strategy", ["ALIAS_TABLE", "CDF_BINARY"])
def test_sample_envmap_on_the_card_matches_the_cpu(gpu_envmap, strategy):
    """The same texel on every ray (the radiance is fetched from it), the
    same direction and pdf, from the same PCG state."""
    from hiprt_pt_tpu_torch.core import rng
    from hiprt_pt_tpu_torch.core import settings as ts
    from hiprt_pt_tpu_torch.lights.envmap_sampling import sample_envmap

    scene, _cam, _bvh, (opts, _settings, world) = gpu_envmap
    opts = opts.replace(envmap_sampling=getattr(ts.EnvmapSamplingStrategy, strategy))
    env = scene.envmap
    out = [sample_envmap(opts, world, e, rng.seed(torch.arange(65536, device=dev),
                                                  5, 42))
           for e, dev in ((env, env.texels.device), (env.to("cpu"), "cpu"))]
    (s_g, wi_g, rad_g, pdf_g), (s_c, wi_c, rad_c, pdf_c) = out
    assert torch.equal(s_g.cpu(), s_c) and torch.equal(rad_g.cpu(), rad_c)
    np.testing.assert_allclose(wi_g.cpu().numpy(), wi_c.numpy(), rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(pdf_g.cpu().numpy(), pdf_c.numpy(), rtol=1e-5)


@pytest.mark.parametrize("any_hit", [False, True])
def test_meganode_kernel_on_envmap_shadow_rays(gpu_envmap, any_hit):
    """trace_meganode on the envmap path's shadow rays (t_max = inf) against
    its plain walk: the prims agree, t bit-identical where they do."""
    import chip_smoke as cs
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops import traverse as plain

    scene, cam, bvh, _ = gpu_envmap
    rays = cs.kind_rays("envmap", scene, bvh, cam, 256, 128,
                        plain.traverse_meganode, 1, None)
    o, d, _t, active = rays["envmap"]
    rk = ct.trace_meganode(bvh, o, d, 1e-4, float("inf"), active, any_hit=any_hit)
    rp = plain.traverse_meganode(bvh, o, d, 1e-4, float("inf"), active,
                                 any_hit=any_hit)
    pk, pp = rk.prim.cpu().numpy(), rp.prim.cpu().numpy()
    assert (pk >= 0).mean() > 0.3 and int(active.sum()) > 1000
    if any_hit:
        assert np.mean((pk >= 0) == (pp >= 0)) >= 0.9999
    else:
        assert np.mean(pk == pp) >= 0.9999
        m = (pk == pp) & (pk >= 0)
        assert np.array_equal(rk.t.cpu().numpy()[m], rp.t.cpu().numpy()[m])


def test_renderer_frame_loop_on_the_card(gpu_envmap, monkeypatch):
    """The Renderer's frame loop on the envmap path at 128x64: blocking
    steps and their metrics, the frame poll on a finished and an
    unfinished frame, the stop at
    max_sample_count, profile() (the live state left as it was),
    kernel_stats() from the kernel library, the images; and the image
    against the CPU's."""
    from hiprt_pt_tpu_torch.render import renderer as renderer_mod
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    scene, cam, bvh, (opts, settings, world) = gpu_envmap
    r = Renderer(scene, cam, 128, 64, options=opts, settings=settings,
                 world=world, bvh=bvh, seed=42)
    assert r.frame_render_done() in (True, False)
    cuda_build.reset_launch_counts()
    r.step(block=True)
    assert cuda_build.launch_counts["trace_meganode"] == 19
    assert r.frame_render_done()
    # a frame whose last queued work is about a second of device sleep is
    # unfinished when step() returns
    real_step = renderer_mod.render_step

    def slow_step(*args, **kw):
        state = real_step(*args, **kw)
        torch.cuda._sleep(2 * 10**9)
        return state

    monkeypatch.setattr(renderer_mod, "render_step", slow_step)
    r.step()
    assert not r.frame_render_done()
    monkeypatch.setattr(renderer_mod, "render_step", real_step)
    torch.cuda.synchronize()
    assert r.frame_render_done()
    assert len(r.metrics.values("frame_ms")) == 1
    r.reset()
    r.max_sample_count = 2
    r.render(total_samples=5)
    assert r.state.sample_count == 2
    accum = r.state.accum.clone()
    prof = r.profile(frames=1)
    assert prof["nb_bounces"] == 6 and prof["full_frame_ms"] > prof["camera_pass_ms"] > 0
    assert r.state.sample_count == 2 and torch.equal(r.state.accum, accum)
    stats = r.kernel_stats()
    assert stats["kernel"] == "render_step" and set(stats["kernels"]) == {"trace_meganode"}
    for mode in ("closest", "any_hit"):
        info = stats["kernels"]["trace_meganode"][mode]
        assert info["registers"] > 0 and info["blocks_per_sm"] > 0
    assert stats["launch_counts"]["trace_meganode"] > 19
    assert stats["peak_device_memory_bytes"] > 0
    alb, nrm = r.aov_images()
    for img in (r.ldr_image(), alb, nrm):
        assert img.shape == (64, 128, 3) and np.isfinite(img).all()
    cpu = torch.device("cpu")
    ref = Renderer(scene.to(cpu), cam.to(cpu), 128, 64, options=opts,
                   settings=settings, world=world, bvh=bvh.to(cpu), seed=42)
    ref.render(total_samples=2)
    got, want = r.hdr_image(), ref.hdr_image()
    close = np.all(np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want), axis=-1)
    assert close.mean() >= 0.98


@pytest.fixture(scope="module")
def gpu_gltf(tmp_path_factory):
    """The stress interior at tri_scale 0.01 with the gltf path's cutouts,
    written as a .glb and loaded on the card with imageio unimportable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch import paths
    from hiprt_pt_tpu_torch.assets.gltf_testscene import write_glb
    from hiprt_pt_tpu_torch.assets.loader import load_scene_file
    from hiprt_pt_tpu_torch.assets.stress import generate_stress_scene

    dev = torch.device("cuda:0")
    path = str(tmp_path_factory.mktemp("gltf") / "stress.glb")
    write_glb(path, generate_stress_scene(tri_scale=0.01, texture_size=32),
              alpha_materials=paths.GLTF_CUTOUTS)
    saved = {k: sys.modules.pop(k, None) for k in ("imageio", "imageio.v3")}
    sys.modules["imageio"] = sys.modules["imageio.v3"] = None
    try:
        scene, cam, bvh = load_scene_file(path, aspect=2.0, parallel=True,
                                          with_bvh=True, device=dev)
    finally:
        for k, mod in saved.items():
            if mod is None:
                del sys.modules[k]
            else:
                sys.modules[k] = mod
    assert scene.textures.has_alpha and scene.tri_data.device.type == "cuda"
    return scene, cam, bvh, dev


@pytest.mark.parametrize("kernel", ["trace_coherent", "trace_incoherent"])
def test_alpha_march_kinds_match_plain(gpu_gltf, kernel):
    """The alpha march's two ray kinds on the card: its any-hit prune and
    its closest-hit segments (origins moved past a surface, t_max what is
    left) through the kernel give the plain walk's hits, t bit-identical,
    so the march ends with the same occluded mask and RNG state."""
    from hiprt_pt_tpu_torch.core import rng
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops import traverse as plain

    scene, _cam, bvh, dev = gpu_gltf
    o, d, t_max, active = _rays(dev, n=65536, seed=4)
    t_max = torch.where(torch.isinf(t_max), 3.0, t_max)  # shadow rays end
    calls = []

    def held(bvh, o, d, t_min, t_max, active, any_hit):
        rk = getattr(ct, kernel)(bvh, o, d, t_min, t_max, active, any_hit=any_hit)
        rp = plain.traverse(bvh, o, d, t_min, t_max, active, any_hit=any_hit)
        calls.append(any_hit)
        assert torch.equal(rk.prim >= 0, rp.prim >= 0)
        if not any_hit:
            assert torch.equal(rk.prim, rp.prim)
            assert torch.equal(rk.t, rp.t)
        return rk

    before = cuda_build.launch_counts[kernel]
    state = rng.seed(torch.arange(o.shape[0], device=dev), 0, 5)
    s_k, occ_k = plain.occluded_alpha(bvh, scene, o, d, state, t_max=t_max,
                                      active=active, trace=held)
    s_p, occ_p = plain.occluded_alpha(bvh, scene, o, d, state, t_max=t_max,
                                      active=active, trace=plain.traverse)
    assert cuda_build.launch_counts[kernel] == before + len(calls)
    assert calls[0] and not any(calls[1:]) and len(calls) >= 3
    assert torch.equal(occ_k, occ_p) and torch.equal(s_k, s_p)
    assert 0 < int(occ_k.sum()) < int(active.sum())



@pytest.mark.parametrize("kernel", ["trace_stream8", "trace_lane8log"])
def test_alpha_march_on_the_bvh8_kernels_in_their_spans(gpu_gltf, kernel):
    """The alpha march's prune and segments through K4 / K5 (the route of a
    scene at Bistro's scale) give the BVH8 plain walk's hits, t
    bit-identical, and the same occluded mask and RNG state; inside one
    step each call is one span ``trace/<kernel>`` on the card's stream and
    one count of its launches and rays."""
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.core import rng
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops import traverse as plain
    from hiprt_pt_tpu_torch.utils import spans

    scene, _cam, _bvh, dev = gpu_gltf
    bvh = build_bvh(scene.vertices.cpu().numpy(), scene.triangles.cpu().numpy(),
                    dev, all_tables=True)
    o, d, t_max, active = _rays(dev, n=65536, seed=6)
    t_max = torch.where(torch.isinf(t_max), 3.0, t_max)  # shadow rays end
    calls = []

    def held(bvh, o, d, t_min, t_max, active, any_hit):
        rk = getattr(ct, kernel)(bvh, o, d, t_min, t_max, active, any_hit=any_hit)
        rp = plain.traverse8(bvh, o, d, t_min, t_max, active, any_hit=any_hit)
        calls.append(o.shape[0])
        assert torch.equal(rk.prim >= 0, rp.prim >= 0)
        if not any_hit:
            assert torch.equal(rk.prim, rp.prim)
            assert torch.equal(rk.t, rp.t)
        return rk

    spans.reset()
    before = cuda_build.launch_counts[kernel]
    state = rng.seed(torch.arange(o.shape[0], device=dev), 0, 5)
    with spans.step(dev) as sid:
        s_k, occ_k = plain.occluded_alpha(bvh, scene, o, d, state, t_max=t_max,
                                          active=active, trace=held)
    s_p, occ_p = plain.occluded_alpha(bvh, scene, o, d, state, t_max=t_max,
                                      active=active, trace=plain.traverse8)
    assert cuda_build.launch_counts[kernel] == before + len(calls) and len(calls) >= 3
    assert torch.equal(occ_k, occ_p) and torch.equal(s_k, s_p)
    assert 0 < int(occ_k.sum()) < int(active.sum())
    spans.flush()
    (st,) = [st for st in spans.steps() if st.id == sid]
    traced = [r for r in st.records if r.name == "trace/" + kernel]
    assert len(traced) == len(calls)
    assert all(r.parent == "march" and r.stream_ms > 0 for r in traced)
    assert st.counters["launches/" + kernel] == len(calls)
    assert st.counters["rays/" + kernel] == sum(calls)
    spans.reset()

def _denoiser_inputs(dev, h=180, w=320, seed=0):
    """Seeded denoiser inputs on ``dev``: an HDR image with fireflies, its
    albedo and unit normals, the variance of the mean and sample counts
    (some below 2)."""
    g = np.random.default_rng(seed)
    color = g.gamma(2.0, 0.3, (h, w, 3)).astype(np.float32)
    color[g.random((h, w)) < 0.02] *= 60.0
    normal = g.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    arrays = {"color": color, "albedo": g.random((h, w, 3)).astype(np.float32),
              "normal": normal,
              "variance": (g.random((h, w)) * 0.05).astype(np.float32),
              "spp_map": g.integers(1, 48, (h, w)).astype(np.float32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


@pytest.mark.parametrize("variance", [True, False], ids=["variance", "fixed-sigma"])
def test_denoisers_on_the_card_match_the_cpu(variance):
    """The à-trous filter (atol 1e-6 + rtol 1e-5) and the CNN with the
    shipped weights in f32 (atol 1e-5 + rtol 1e-4) on the card against the
    same functions on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    import importlib

    dn = importlib.import_module("hiprt_pt_tpu_torch.render.denoise")
    nn = importlib.import_module("hiprt_pt_tpu_torch.render.denoise_nn")
    dev = torch.device("cuda:0")
    x, c = _denoiser_inputs(dev), _denoiser_inputs("cpu")
    maps = ("variance", "spp_map")
    kw = {k: x[k] for k in maps} if variance else {}
    kc = {k: c[k] for k in maps} if variance else {}
    got = dn.atrous_denoise(x["color"], x["albedo"], x["normal"], **kw)
    want = dn.atrous_denoise(c["color"], c["albedo"], c["normal"], **kc)
    torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=1e-5)
    out = nn.apply(nn.load_params(device=dev), x["color"], got, x["albedo"],
                   x["normal"], *(x[k] for k in maps))
    ref = nn.apply(nn.load_params(device="cpu"), c["color"], want, c["albedo"],
                   c["normal"], *(c[k] for k in maps))
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=1e-4)


def test_cli_main_on_the_card(tmp_path):
    """python -m hiprt_pt_tpu_torch.app.cli without --cpu renders on the
    card through its kernel (the Cornell box: trace_meganode) and writes
    the HDR that --cpu writes, under the render gate; --resume continues
    a checkpoint written on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.app.cli import main
    from hiprt_pt_tpu_torch.assets.image_io import read_hdr

    glb = tp.write_cornell_glb(str(tmp_path / "c.glb"), 2.0)
    common = [glb, "--w=128", "--h=64", "--bounces=2", "--spp-per-frame=1",
              "--denoise", "--strategy=restir"]
    cuda_build.reset_launch_counts()
    stats = {}
    assert main(common + ["--samples=2", f"--out={tmp_path}/g.png",
                          f"--hdr-out={tmp_path}/g.hdr",
                          f"--checkpoint={tmp_path}/g"], stats) == 0
    assert cuda_build.launch_counts["trace_meganode"] > 0 and stats["samples"] == 2
    launches = dict(cuda_build.launch_counts)
    assert main(common + ["--samples=2", "--cpu", f"--out={tmp_path}/c.png",
                          f"--hdr-out={tmp_path}/c.hdr"]) == 0
    assert cuda_build.launch_counts == launches
    got, want = read_hdr(f"{tmp_path}/g.hdr"), read_hdr(f"{tmp_path}/c.hdr")
    close = np.all(np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want), axis=-1)
    assert close.mean() >= 0.98
    assert main(common + ["--samples=3", f"--resume={tmp_path}/g.npz",
                          f"--out={tmp_path}/r.png"], stats) == 0
    assert stats["samples"] == 3


BAKES = ("bake_ggx_conductor_ess", "bake_ggx_glossy_dielectric_ess",
         "bake_glossy_base_ess", "bake_ggx_fresnel_ess", "bake_ggx_glass_ess",
         "bake_ggx_glass_inv_ess", "bake_ggx_thin_glass_ess")


@pytest.mark.parametrize("name", BAKES)
def test_bake_on_the_card_matches_the_cpu(name):
    """Each bake at res 4 and 256 samples on the card and on the CPU, under
    chip_smoke.py's gate: every cell within 1e-5, but at most 1 in 50 of a
    table's cells, each within 6e-3 (one lane whose lobe choice rounds the
    other way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    import chip_smoke as cs
    from hiprt_pt_tpu_torch.bake import baker

    card = getattr(baker, name)(res=4, n_samples=256)
    cpu = getattr(baker, name)(res=4, n_samples=256, device="cpu")
    diff = np.abs(card - cpu)
    assert diff.max() <= cs.BAKE_FLIP_TOL
    assert (diff > cs.BAKE_CELL_TOL).sum() <= diff.size // cs.BAKE_FLIP_SHARE


def test_sheen_fit_row_on_the_card():
    """One alpha row at 4,096 paths on the card against the CPU's (other
    generators, so statistically: R within 4.5 sigma of the difference of
    two binomial shares); the SGGX self-test on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.bake import sheen_ltc_fit as sf

    n, alpha = 4096, 0.703125
    rows = [sf.fit_alpha_row(torch.Generator(dev).manual_seed(1256), alpha, n,
                             thickness=alpha)
            for dev in (torch.device("cuda:0"), torch.device("cpu"))]
    r_card, r_cpu = rows[0][2].cpu().numpy(), rows[1][2].numpy()
    sigma = np.sqrt(2.0 * r_cpu * (1.0 - r_cpu) / n)
    assert (np.abs(r_card - r_cpu) <= 4.5 * sigma + 1.0 / n).all()
    assert np.isfinite(rows[0][0].cpu().numpy()).all()
    assert all(abs(e) < 0.02 for e in sf.selftest_sggx_sampler())


def test_viewer_views_on_the_card_match_the_cpu(tmp_path):
    """The viewer on a renderer on the card: its frames launch the routed
    kernel, and each of the nine views of the state it rendered equals the
    view of the same state (through a checkpoint) on the CPU within 1 LSB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.app.viewer import VIEWS, ViewerServer
    from hiprt_pt_tpu_torch.assets.image_io import decode_png
    from hiprt_pt_tpu_torch.assets.loader import load_scene_file
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    glb = tp.write_cornell_glb(str(tmp_path / "c.glb"), 2.0)
    renderers = []
    for dev in ("cuda", "cpu"):
        scene, cam = load_scene_file(glb, aspect=2.0, device=dev)
        renderers.append(Renderer(scene, cam, 64, 32))
    card, cpu = renderers
    cuda_build.reset_launch_counts()
    card.step(block=True)
    card.step(block=True)
    assert cuda_build.launch_counts["trace_meganode"] > 0
    save_checkpoint(str(tmp_path / "st"), card.state)
    cpu.state = load_checkpoint(str(tmp_path / "st"),
                                init_render_state(64, 32, device="cpu"))
    for view in VIEWS:
        got = decode_png(ViewerServer(card)._image_png(view)).astype(int)
        want = decode_png(ViewerServer(cpu)._image_png(view)).astype(int)
        assert got.shape == (32, 64, 3)
        assert np.abs(got - want).max() <= 1, view


def test_pixel_dp_ranks_on_the_card_are_one_process(tmp_path):
    """parallel/: 2 gloo ranks on the card (the default device: cuda:0 when
    they share one card), pixel DP of the stress interior at 64x32 under
    MIS, 2 samples, the gathered state bit-identical to one process on the
    card; the ranks launch trace_coherent and trace_incoherent."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene
    from hiprt_pt_tpu_torch.core import settings as ts
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.parallel import jobs
    from hiprt_pt_tpu_torch.parallel.launch import launch
    from hiprt_pt_tpu_torch.render.renderer import render_step

    w, h = 64, 32
    opts = ts.RenderOptions(bsdf_override=ts.BSDFOverride.LAMBERTIAN,
                            do_dispersion=False, max_bounces_static=2)
    settings = ts.RenderSettings(nb_bounces=2)
    world = ts.WorldSettings(ambient_light_type=int(ts.AmbientLightType.NONE))
    inputs = {}
    for dev in ("cpu", "cuda"):
        scene, cam = load_stress_scene(aspect=w / h, tri_scale=0.01,
                                       with_textures=False, device=dev)
        inputs[dev] = (scene, cam, build_bvh(scene.vertices.cpu().numpy(),
                                             scene.triangles.cpu().numpy(), dev))
    scene, cam, bvh = inputs["cuda"]
    ref = render_step(opts, w, h, scene, bvh, init_render_state(w, h), cam,
                      settings, world, n_samples=2)
    run = dict(name="p", input="s", options=opts, settings=settings,
               world=world, width=w, height=h, samples=2)
    out = launch(jobs.render, 2, ({"runs": [run],
                                   "inputs": {"s": inputs["cpu"]}},),
                 backend="gloo", timeout=300)
    rep = [o["p"] for o in out]
    assert [r["device"] for r in rep] == (
        ["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2
        else ["cuda:0", "cuda:0"])
    assert rep[0]["digests"] == jobs.state_digests(ref)
    for r in rep:
        assert r["launches"]["trace_coherent"] > 0
        assert r["launches"]["trace_incoherent"] > 0


def test_spans_keep_the_syncs_and_put_nothing_in_the_trace(gpu_envmap):
    """A frame with spans on makes the same synchronising runtime calls as
    with spans off, and at most one launch more a bounce (the live count's
    cast where spans off ask only whether any path lives); its trace holds
    no user annotation and no span name; its spans resolve to stream
    milliseconds."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from hiprt_pt_tpu_torch.render.renderer import Renderer
    from hiprt_pt_tpu_torch.utils import spans

    scene, cam, bvh, (opts, settings, world) = gpu_envmap
    r = Renderer(scene, cam, 128, 64, options=opts, settings=settings,
                 world=world, bvh=bvh, seed=42)

    def traced(on):
        spans.enable(on)
        try:
            r.step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                r.step()
                torch.cuda.synchronize()
        finally:
            spans.enable(True)
        return list(prof.profiler.kineto_results.events())

    def calls(events, names):
        return Counter(e.name() for e in events if e.name() in names)

    spans.reset()
    on = traced(True)
    spans.flush()
    recs = spans.records()
    off = traced(False)
    assert calls(on, spans.SYNCS) == calls(off, spans.SYNCS)
    assert sum(calls(on, spans.SYNCS).values()) >= settings.nb_bounces
    bounces = sum(1 for rec in recs if rec.name == "bounce") // 2
    extra = (sum(calls(on, spans.LAUNCHES).values())
             - sum(calls(off, spans.LAUNCHES).values()))
    assert 0 <= extra <= bounces, (extra, bounces)
    names = {rec.name for rec in recs}
    assert {"step", "camera", "bounce", "bounce/direct", "accumulate"} <= names
    for e in on:
        annotation = getattr(e, "is_user_annotation", None)
        assert annotation is None or not annotation(), e.name()
        assert e.name() not in names
    steps = [rec for rec in recs if rec.name == "step"]
    assert len(steps) == 2
    for rec in recs:
        assert rec.stream_ms is not None and rec.stream_ms >= 0.0
        assert rec.self_ms is not None and rec.self_ms > -1e-3
    assert all(rec.stream_ms > 0.0 for rec in steps)


# --- the dense emissive sweep (csrc/emissive_sweep.cu) ---

def _emitter_rows(e, seed, dev):
    """An (e, 32) emissive table of random triangles in the hall's box (only
    columns 0:9, v0 e1 e2, are read by the sweep)."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((e, 32), np.float32)
    rows[:, 0:3] = rng.uniform([-9.5, 0.5, -5.5], [9.5, 5.5, 5.5], (e, 3))
    rows[:, 3:9] = rng.normal(scale=0.8, size=(e, 6))
    return torch.from_numpy(rows).to(dev)


def _rays_at(rows, n, seed, dev, spread=0.05):
    """n rays from the hall toward points near the centroids of rows drawn
    at random, so that most hit an emitter; 10% of them inactive."""
    rng = np.random.default_rng(seed)
    p, _ = tp.incoherent_rays_np(n, seed)
    r = rows.cpu().numpy()[rng.integers(0, rows.shape[0], n)]
    target = r[:, 0:3] + (r[:, 3:6] + r[:, 6:9]) / 3.0
    target = target + rng.normal(scale=spread, size=target.shape)
    d = (target - p).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    active = rng.random(n) >= 0.1
    return (torch.from_numpy(p.astype(np.float32)).to(dev),
            torch.from_numpy(d).to(dev), torch.from_numpy(active).to(dev))


def _sweep_equals_plain(rows, o, d, active, t_min=1e-5):
    """The kernel, in one launch, against the plain sweep on the same CUDA
    tensors: t and slot equal on every lane. Returns the kernel's slots."""
    from hiprt_pt_tpu_torch.lights.light_sampling import _closest_emissive_hit_plain
    from hiprt_pt_tpu_torch.ops import cuda_sweep

    before = cuda_build.launch_counts["emissive_sweep"]
    tk, sk = cuda_sweep.emissive_sweep(rows, o, d, active, t_min)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["emissive_sweep"] == before + 1
    tp_, sp = _closest_emissive_hit_plain(rows, o, d, active, t_min)
    assert tk.dtype == torch.float32 and sk.dtype == torch.int64
    assert torch.equal(sk, sp)
    assert torch.equal(tk, tp_)
    return sk


@pytest.mark.parametrize("e", [1, 240, 1024, 1500])
@pytest.mark.parametrize("n", [1, 255, 257, 2_073_600])
def test_emissive_sweep_matches_plain(n, e):
    """Every lane's t and slot, at ragged ray counts and emitter counts on
    both sides of a shared-memory tile (1,024 emitters)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    dev = torch.device("cuda:0")
    rows = _emitter_rows(e, seed=e, dev=dev)
    o, d, active = _rays_at(rows, n, seed=n + e, dev=dev)
    slot = _sweep_equals_plain(rows, o, d, active)
    if n >= 255:
        assert (slot >= 0).float().mean() > 0.2


def test_emissive_sweep_on_the_stress_emitters(gpu_scene):
    """Rays aimed at the stress interior's 240 emitters (quads of two
    triangles sharing an edge), as tests/test_torch_ris.py aims them, with
    and without the active mask, and every lane inactive."""
    scene, _, _, dev = gpu_scene
    rows = scene.emissive_rows
    assert rows.shape[0] == 240
    o, d, active = _rays_at(rows, 65536, seed=2, dev=dev)
    slot = _sweep_equals_plain(rows, o, d, active)
    assert (slot >= 0).float().mean() > 0.2
    assert torch.all(slot[~active] == -1)
    everyone = _sweep_equals_plain(rows, o, d, None)
    assert torch.equal(everyone[active], slot[active])
    nobody = _sweep_equals_plain(rows, o, d, torch.zeros_like(active))
    assert torch.all(nobody == -1)


def test_emissive_sweep_ties_degenerate_rows_and_t_min():
    """Duplicated rows give an equal t, which goes to the smaller slot;
    zero-area rows (det 0 or about 0) never hit; hits at t <= t_min do not
    count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    dev = torch.device("cuda:0")
    base = _emitter_rows(300, seed=5, dev=dev)
    degenerate = base[:100].clone()
    degenerate[:50, 6:9] = degenerate[:50, 3:6] * 2.0   # e2 parallel to e1
    degenerate[50:, 3:9] = 0.0                           # a point
    rows = torch.cat([base, base[:200], degenerate, base[200:]]).contiguous()
    o, d, active = _rays_at(base, 100_000, seed=6, dev=dev)
    slot = _sweep_equals_plain(rows, o, d, active)
    hit = slot >= 0
    assert hit.float().mean() > 0.2
    # a duplicate of rows 0..199 sits at 300..499 and one of 200..299 at
    # 600..699: each hit goes to the first copy
    assert not torch.any((slot >= 300) & (slot < 500))
    assert not torch.any(slot >= 600)
    # a point has det = 0 exactly; a segment's det is its rounding
    assert not torch.any((slot >= 550) & (slot < 600))
    assert float(((slot >= 500) & (slot < 550)).float().mean()) < 1e-3
    # t_min past most hits
    far = _sweep_equals_plain(rows, o, d, active, t_min=4.0)
    assert 0 < int((far >= 0).sum()) < int(hit.sum())


def test_emissive_sweep_rejects_what_the_kernel_does_not_take(gpu_scene):
    from hiprt_pt_tpu_torch.ops import cuda_sweep

    scene, _, _, dev = gpu_scene
    rows = scene.emissive_rows
    o, d, active = _rays_at(rows, 256, seed=1, dev=dev)
    before = cuda_build.launch_counts["emissive_sweep"]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep.emissive_sweep(rows.cpu(), o.cpu(), d.cpu(), active.cpu())
    with pytest.raises(ValueError):
        cuda_sweep.emissive_sweep(rows.cpu(), o, d, active)
    with pytest.raises(TypeError):
        cuda_sweep.emissive_sweep(rows, o.double(), d, active)
    with pytest.raises(TypeError):
        cuda_sweep.emissive_sweep(rows.double(), o, d, active)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_sweep.emissive_sweep(rows, o, d.t().contiguous().t(), active)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_sweep.emissive_sweep(rows[:, :16], o, d, active)
    with pytest.raises(TypeError):
        cuda_sweep.emissive_sweep(rows, o, d, active.to(torch.uint8))
    assert cuda_build.launch_counts["emissive_sweep"] == before
    info = cuda_build.kernel_info("emissive_sweep")
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1


@pytest.mark.parametrize("strategy", ["RIS_BSDF_LIGHT", "RESTIR_DI"])
def test_render_steps_sweep_once_a_bounce_and_keep_their_bits(gpu_scene,
                                                              monkeypatch,
                                                              strategy):
    """Two frames on the card with the kernel and with the plain sweep in
    its place (the sweep as it ran before the kernel) give the same state
    bit for bit; a frame launches the kernel once a bounce, and once more
    under ReSTIR for the initial candidates, each inside its span."""
    from hiprt_pt_tpu_torch.core import settings as ts
    from hiprt_pt_tpu_torch.lights import light_sampling as tls
    from hiprt_pt_tpu_torch.ops import cuda_sweep
    from hiprt_pt_tpu_torch.parallel import jobs
    from hiprt_pt_tpu_torch.render.renderer import Renderer
    from hiprt_pt_tpu_torch.utils import spans

    scene, cam, bvh, _ = gpu_scene
    strat = getattr(ts.LightSamplingStrategy, strategy)
    opts = ts.RenderOptions(direct_light_sampling=strat, max_bounces_static=4)
    settings = ts.RenderSettings(nb_bounces=4)

    def frames():
        r = Renderer(scene, cam, 256, 128, options=opts, settings=settings,
                     bvh=bvh, seed=42)
        spans.reset()
        cuda_build.reset_launch_counts()
        r.step()
        r.step()
        torch.cuda.synchronize()
        spans.flush()
        return r, dict(cuda_build.launch_counts), spans.records()

    with monkeypatch.context() as m:
        m.setattr(cuda_sweep, "emissive_sweep",
                  lambda rows, o, d, a, t_min:
                  tls._closest_emissive_hit_plain(rows, o, d, a, t_min))
        ref, plain_counts, _ = frames()
    got, counts, recs = frames()
    assert plain_counts["emissive_sweep"] == 0
    sweeps = [rec for rec in recs if rec.name == "emissive_sweep"]
    direct = sum(1 for rec in recs if rec.name == "bounce/direct")
    initial = 2 if strategy == "RESTIR_DI" else 0
    assert counts["emissive_sweep"] == len(sweeps) == direct + initial
    assert direct == 2 * 4
    assert {rec.parent for rec in sweeps} == (
        {"bounce/direct", "restir/initial candidates"} if initial
        else {"bounce/direct"})
    assert jobs.state_digests(got.state) == jobs.state_digests(ref.state)
