"""The ``headline`` path of hiprt_pt_tpu_torch/paths.py (cell
stress-1080p-principled-ris): bench.py's headline configuration
(bench.py:112-134), the stress interior at tri_scale=1 with textures, the
full principled BSDF and RIS_BSDF_LIGHT, 4 bounces.

- Its options are the 2.04M-triangle path's and equal, field by field, the
  options bench.py's make_renderer builds in the JAX package.
- Its scene (built here on the CPU at full size) has the stress path's
  geometry plus the 18 textures and routes coherent rays to trace_coherent
  and incoherent rays to trace_incoherent.
- chip_smoke.py's launch count for it: trace_coherent 2 (camera, the first
  bounce's RIS shadow rays), trace_incoherent 7 (4 bounce wavefronts, 3
  later RIS shadow wavefronts) a frame.
- A render under these options (64x32, 2 bounces, the ~122k-triangle stress
  interior of the parity tests) against the JAX package from the same
  scene arrays, at the tolerance tests/test_torch_ris.py states for the
  render step: radiance within atol 1e-3 + rtol 1e-3 on >= 97% of the
  pixels, the image mean within 2%, rays traced within 0.5%.
"""

import dataclasses
import enum
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch_parity as tp  # noqa: E402

from hiprt_pt_tpu_torch import paths  # noqa: E402
from hiprt_pt_tpu_torch.core import settings as ts  # noqa: E402

W, H = 64, 32


def test_headline_is_a_path_with_the_bvh4_routes():
    assert paths.PATHS == ("stress", "cornell", "stress14", "headline", "restir",
                           "envmap", "gltf", "cli", "viewer")
    assert set(paths.ROUTES) == set(paths.PATHS)
    assert paths.ROUTES["headline"] == ("trace_coherent", "trace_incoherent")
    with pytest.raises(ValueError, match="unknown path"):
        paths.load("headline2", "cpu")


def test_headline_options_are_bench_pys():
    """slice_options("headline") equals stress14's, and every field that the
    JAX package's RenderOptions shares equals what bench.py's make_renderer
    sets (RIS_BSDF_LIGHT, max_bounces_static=4, the rest defaults); 4
    bounces, one sample a frame, ambient NONE."""
    from hiprt_pt_tpu.core import settings as js

    opts, settings, world = paths.slice_options("headline")
    assert (opts, settings, world) == paths.slice_options("stress14")
    ref = js.RenderOptions(
        direct_light_sampling=js.LightSamplingStrategy.RIS_BSDF_LIGHT,
        max_bounces_static=4)
    shared = 0
    for f in dataclasses.fields(opts):
        if not hasattr(ref, f.name):
            continue
        got, want = getattr(opts, f.name), getattr(ref, f.name)
        if isinstance(got, enum.Enum):
            got, want = int(got), int(want)
        assert got == want, f.name
        shared += 1
    assert shared >= 20
    assert opts.direct_light_sampling == ts.LightSamplingStrategy.RIS_BSDF_LIGHT
    assert opts.bsdf_override == ts.BSDFOverride.NONE
    assert opts.ris_proxy_target and opts.ris_tile_light_candidates == 128
    assert opts.use_pallas_traversal
    assert (settings.nb_bounces, settings.samples_per_frame) == (4, 1)
    assert (settings.ris.number_of_light_candidates,
            settings.ris.number_of_bsdf_candidates) == (4, 1)
    assert world.ambient_light_type == int(ts.AmbientLightType.NONE)
    # the stress path differs: Lambertian override under MIS
    assert paths.slice_options("stress")[0] != opts


@pytest.fixture(scope="module")
def headline():
    return paths.load("headline", "cpu")


def test_headline_scene_routes_to_the_bvh4_kernels(headline):
    from hiprt_pt_tpu_torch.ops.routing import route, routed_tables

    scene, cam, bvh, secs = headline
    assert scene.num_triangles == 259_120 and scene.num_emissives == 240
    assert scene.textures is not None and scene.textures.num_layers == 18
    assert (route(bvh, True), route(bvh, False)) == paths.ROUTES["headline"]
    assert routed_tables(bvh) == {"nodes4", "leaf_rows"}
    assert bvh.nodes is None and bvh.nodes8l is None
    assert set(secs) == {"scene", "bvh"}
    assert abs(float(cam.proj[0, 0] / cam.proj[1, 1]) - 9 / 16) < 1e-5


def test_headline_launches_per_frame(headline):
    import chip_smoke

    scene = headline[0]
    per_kind = chip_smoke.launches_per_frame("headline", scene)
    assert per_kind == {("headline", "trace_coherent", "camera"): 1,
                        ("headline", "trace_coherent", "shadow"): 1,
                        ("headline", "trace_incoherent", "shadow"): 3,
                        ("headline", "trace_incoherent", "bounce"): 4}
    assert dict(chip_smoke.PATH_CASES)["headline"] == (
        ("trace_coherent", "shadow"), ("trace_incoherent", "shadow"))
    assert chip_smoke.shadow_tile("headline") == 128
    assert chip_smoke.shadow_tile("stress") is None
    # the stress path's count, keyed by its own path
    assert sum(chip_smoke.launches_per_frame("stress", scene).values()) == 9


def test_headline_render_matches_jax():
    from hiprt_pt_tpu.core import settings as js
    from hiprt_pt_tpu.core.state import init_render_state as jinit
    from hiprt_pt_tpu.render.renderer import render_step as jstep
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    jscene, jcam, jbvh = tp.jax_stress(aspect=W / H, with_textures=True)
    # the dense Moller-Trumbore sweep in both (tests/test_torch_ris.py)
    jscene = jscene.replace(emissive_woop=None)
    tscene, tcam, tbvh = tp.port_of(jscene, jcam, jbvh)
    topts, tset, tworld = paths.slice_options("headline")
    topts, tset = topts.replace(max_bounces_static=2), tset.replace(nb_bounces=2)
    jopts = js.RenderOptions(
        direct_light_sampling=js.LightSamplingStrategy.RIS_BSDF_LIGHT,
        max_bounces_static=2)
    jset = js.RenderSettings().replace(nb_bounces=jnp.int32(2))
    jworld = js.WorldSettings().replace(
        ambient_light_type=jnp.int32(int(js.AmbientLightType.NONE)))
    ref_state = jstep(jopts, W, H, (jscene, jbvh), jinit(W, H, 42), jcam, jset,
                      jworld)
    state = render_step(topts, W, H, tscene, tbvh,
                        init_render_state(W, H, 42, "cpu"), tcam, tset, tworld)
    ref, got = np.asarray(ref_state.accum), state.accum.numpy()
    assert np.isfinite(got).all()
    assert (got.sum(-1) > 0).mean() > 0.2
    close = np.all(np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= 0.97, close.mean()
    assert abs(got.mean() - ref.mean()) <= 0.02 * abs(ref.mean())
    rays_ref = float(ref_state.rays_traced)
    assert abs(int(state.rays_traced) - rays_ref) <= 0.005 * rays_ref
