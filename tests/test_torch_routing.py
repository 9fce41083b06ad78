"""``RenderOptions.use_pallas_traversal`` and the tables past the TPU
kernels' caps, on the CPU.

- With the option off the integrator's tracers are the plain walks of the
  routed kernels (ops/routing.py:PLAIN_WALKS) for each of the three table
  kinds (BVH4, meganode, BVH8), no wrapper of ops/cuda_traverse.py is
  called, no launch is counted, and the image equals the image with the
  option on bit for bit (on CPU tensors a wrapper runs the same plain walk).
  The JAX package's switch: ``hiprt_pt_tpu/render/integrator.py:74, 199``.
- ``ops/traverse.py:traverse`` against brute force on a table shaped like
  tests/test_scale.py::test_lane8s_beyond_old_leaf_cap (70,000 small random
  triangles, 2,048 rays), whose 4-triangle cluster table is past the 16,384
  leaf rows that the TPU kernel's packed refs once held.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402

from hiprt_pt_tpu_torch.accel.build import (Lane8Sizes, build_bvh,  # noqa: E402
                                            lane8_sizes)
from hiprt_pt_tpu_torch.core import settings as ts  # noqa: E402
from hiprt_pt_tpu_torch.ops import cuda_traverse as ct  # noqa: E402
from hiprt_pt_tpu_torch.ops import routing  # noqa: E402
from hiprt_pt_tpu_torch.ops import traverse as plain  # noqa: E402
from hiprt_pt_tpu_torch.ops.intersect import brute_force_closest  # noqa: E402

W, H = 32, 16
KINDS = {"bvh4": ("trace_coherent", "trace_incoherent"),
         "meganode": ("trace_meganode", "trace_meganode"),
         "bvh8": ("trace_stream8", "trace_lane8log")}


@pytest.fixture(scope="module")
def scenes():
    """{table kind: (scene, camera, bvh)} on the CPU: the small stress
    interior over its BVH4, the same interior with its BVH4 gates failed so
    that the BVH8 kernels are routed (they read neither nodes4 nor the
    lane8 sizes), and the Cornell box over its meganode table."""
    from hiprt_pt_tpu_torch.assets.scene import build_scene
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat
    from hiprt_pt_tpu_torch.core.material import MaterialBank

    scene, cam = load_stress_scene(aspect=W / H, tri_scale=tp.TRI_SCALE,
                                   with_textures=False, device="cpu")
    full = build_bvh(scene.vertices.numpy(), scene.triangles.numpy(), "cpu",
                     all_tables=True)
    past = dataclasses.replace(
        full, nodes=None, nodes4=torch.zeros((100_000, 32)),
        lane8=Lane8Sizes(nodes=20_000, leaves=2_000, row_bytes=2320, depth=5))
    v, f, m, rows, cam_kw = tp.cornell_spheres_arrays(W / H)
    cscene = build_scene(v, f, m, MaterialBank.from_rows(rows), device="cpu")
    return {"bvh4": (scene, cam, dataclasses.replace(full, nodes=None)),
            "bvh8": (scene, cam, past),
            "meganode": (cscene, camera_from_lookat(**cam_kw, device="cpu"),
                         build_bvh(v, f, "cpu"))}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_tracer_without_kernels_is_the_plain_walk(scenes, kind):
    _scene, _cam, bvh = scenes[kind]
    for coherent, kernel in zip((True, False), KINDS[kind]):
        assert routing.route(bvh, coherent) == kernel
        assert routing.tracer(bvh, coherent) is getattr(ct, kernel)
        walk = routing.tracer(bvh, coherent, use_kernels=False)
        assert walk is getattr(plain, routing.PLAIN_WALKS[kernel])
    assert set(routing.PLAIN_WALKS) == set(routing.KERNEL_TABLES) == set(ct.launch_counts)


def _render(scene, cam, bvh, use_kernels):
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    opts = ts.RenderOptions(direct_light_sampling=ts.LightSamplingStrategy.MIS,
                            bsdf_override=ts.BSDFOverride.LAMBERTIAN,
                            do_dispersion=False, max_bounces_static=2,
                            use_pallas_traversal=use_kernels)
    r = Renderer(scene, cam, W, H, options=opts,
                 settings=ts.RenderSettings(nb_bounces=2),
                 world=ts.WorldSettings(
                     ambient_light_type=int(ts.AmbientLightType.NONE)),
                 bvh=bvh, seed=42)
    r.step()
    return r.hdr_image(), r.rays_traced


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_render_without_kernels_equals_the_render_with(scenes, kind, monkeypatch):
    """use_pallas_traversal=False: the render calls no kernel wrapper (each
    is replaced by one that raises), counts no launch, and gives the image
    of use_pallas_traversal=True bit for bit."""
    scene, cam, bvh = scenes[kind]
    before = dict(ct.launch_counts)
    with_kernels, rays_with = _render(scene, cam, bvh, True)

    def refuse(*_a, **_k):
        raise AssertionError("a kernel wrapper was called")

    for kernel in ct.launch_counts:
        monkeypatch.setattr(ct, kernel, refuse)
    without, rays_without = _render(scene, cam, bvh, False)
    assert ct.launch_counts == before
    assert (with_kernels.sum(-1) > 0).mean() > 0.1
    assert np.array_equal(with_kernels, without)
    assert rays_with == rays_without


def test_ris_without_kernels_takes_the_plain_walk(scenes, monkeypatch):
    """lights/ris.py takes its tracer with the option too."""
    from hiprt_pt_tpu_torch.core import rng
    from hiprt_pt_tpu_torch.lights.ris import ris_direct_lighting

    scene, _cam, bvh = scenes["bvh4"]
    for kernel in ct.launch_counts:
        monkeypatch.setattr(ct, kernel, None)   # calling one would raise
    n = 256
    p, d = tp.incoherent_rays_np(n, 3)
    p, d = torch.from_numpy(p), torch.from_numpy(d)
    mats = scene.materials.at_indices(torch.zeros(n, dtype=torch.int64)).make_safe()
    opts = ts.RenderOptions(
        direct_light_sampling=ts.LightSamplingStrategy.RIS_BSDF_LIGHT,
        bsdf_override=ts.BSDFOverride.LAMBERTIAN, use_pallas_traversal=False)
    _state, contrib, rays = ris_direct_lighting(
        opts, scene, bvh, ts.RenderSettings(), mats, p, d, d, d,
        rng.seed(torch.arange(n), 0, 1), torch.ones(n, dtype=torch.bool),
        torch.full((n,), 1.5))
    assert torch.isfinite(contrib).all() and int(rays) > 0


def test_traverse_on_a_table_past_the_old_leaf_cap():
    rng = np.random.default_rng(11)
    ntri = 70_000
    c = rng.uniform(-1, 1, (ntri, 3)).astype(np.float32)
    verts = (c[:, None, :] + rng.uniform(-0.01, 0.01, (ntri, 3, 3))
             ).astype(np.float32).reshape(-1, 3)
    tris = np.arange(ntri * 3).reshape(-1, 3).astype(np.int32)
    assert lane8_sizes(verts, tris, leaf_tris=4).leaves > 16384
    bvh = build_bvh(verts, tris, "cpu")
    assert routing.route(bvh, coherent=False) == "trace_incoherent"
    n = 2048
    o = torch.from_numpy(rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    rec = plain.traverse(bvh, o, d)
    bt, bp, _u, _v = brute_force_closest(torch.from_numpy(verts),
                                         torch.from_numpy(tris), o, d)
    assert 0.1 < (bp >= 0).float().mean() < 0.9
    assert torch.equal(rec.prim, bp)
    hit = bp >= 0
    np.testing.assert_allclose(rec.t[hit].numpy(), bt[hit].numpy(), rtol=1e-5)
    assert torch.isinf(rec.t[~hit]).all()
