"""The alpha-aware shadow march in the port against the JAX package: the
march itself (ops/traverse.py:occluded_alpha) with and without its any-hit
prune, and one render sample of a scene with alpha textures under MIS, RIS
and ReSTIR DI, whose emissive shadow rays (NEE, RIS's winner, ReSTIR's
final visibility) take the march. The scene is the procedural Cornell box
(tests/torch_parity.py:cornell_spheres_arrays) with planar uvs, a cutout
texture on the white walls and half-transparent spheres, built by the JAX
package and carried into the port through hiprt_pt_tpu_torch.interop.

Image gates, as for the other render paths: >= 98% of pixels within
1e-3 + 1e-3·|ref| per channel, image mean within 1%, rays within 0.5%."""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402
from test_torch_envmap import assert_images_agree  # noqa: E402

from hiprt_pt_tpu_torch import interop  # noqa: E402
from hiprt_pt_tpu_torch.core import settings as ts  # noqa: E402

W, H = 32, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as in test_torch_envmap.py: the runner's
    workers share the cores, and the plain walks' small parallel ops would
    oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _cutout(n: int = 16) -> np.ndarray:
    """(n, n, 4) uint8: a light checker whose dark squares are holes
    (alpha 0), the rest opaque."""
    yy, xx = np.mgrid[0:n, 0:n]
    solid = ((yy // 4 + xx // 4) % 2 == 0)
    img = np.full((n, n, 4), 230, np.uint8)
    img[..., 3] = np.where(solid, 255, 0)
    return img


@pytest.fixture(scope="module")
def alpha_scene():
    """The Cornell scene with alpha: the white walls (material 0) cut out
    by a checker texture's alpha, the spheres at alpha_opacity 0.5."""
    from hiprt_pt_tpu.accel.build import build_bvh as jbvh
    from hiprt_pt_tpu.assets.scene import build_scene as jscene
    from hiprt_pt_tpu.assets.textures import build_texture_atlas as jatlas
    from hiprt_pt_tpu.core.camera import camera_from_lookat as jcam
    from hiprt_pt_tpu.core.material import MaterialBank as JBank
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat

    v, f, m, rows, cam = tp.cornell_spheres_arrays(W / H)
    rows = [dict(r) for r in rows]
    rows[0]["base_color_texture_index"] = 0
    for r in rows[4:]:
        r["alpha_opacity"] = 0.5
    uvs = np.stack([0.37 * (v[:, 0] + v[:, 2]), 0.37 * (v[:, 1] + v[:, 2])],
                   axis=-1).astype(np.float32)
    atlas = jatlas([_cutout()], srgb_indices={0}, layer_size=16)
    assert atlas.has_alpha
    jsc = jscene(v, f, m, JBank.from_rows(rows), uvs=uvs, textures=atlas)
    bvh = jbvh(v, f)
    tsc = interop.scene_from_numpy(tp.to_numpy_dict(jsc), "cpu")
    assert tsc.textures.has_alpha
    return dict(jscene=jsc, jcam=jcam(**cam), jbvh=bvh, tscene=tsc,
                tcam=camera_from_lookat(**cam, device="cpu"),
                tbvh=interop.bvh_from_numpy(tp.bvh_dict(bvh), "cpu"))


@pytest.mark.parametrize("prune", [True, False])
def test_occluded_alpha_matches_jax(alpha_scene, prune):
    """From the same rays and PCG state both marches report the same
    occluded mask and leave the same RNG state, bit for bit; rays pass
    through cutouts and half-transparent spheres, so the march runs
    several segments."""
    from hiprt_pt_tpu.core import rng as jrng
    from hiprt_pt_tpu.ops import traverse as jtrav
    from hiprt_pt_tpu_torch.core import rng
    from hiprt_pt_tpu_torch.ops import traverse as plain

    s = alpha_scene
    n = 4096
    g = np.random.default_rng(7)
    o = g.uniform([-1.5, 0.2, -0.8], [1.5, 1.8, 0.8], (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(g.random(n) < 0.3, g.uniform(0.2, 2.0, n),
                     np.inf).astype(np.float32)
    active = g.random(n) >= 0.1
    js0 = jrng.seed(jnp.arange(n, dtype=jnp.uint32), 0, 3)
    js1, jocc = jtrav.occluded_alpha(
        s["jbvh"], s["jscene"], None, None, jnp.asarray(o), jnp.asarray(d),
        js0, t_max=jnp.asarray(t_max), active=jnp.asarray(active),
        closest_fn=jtrav.closest_hit,
        occluded_fn=jtrav.occluded if prune else None)
    plain.reset_march_counts(tally=True)
    s1, occ = plain.occluded_alpha(
        s["tbvh"], s["tscene"], torch.from_numpy(o), torch.from_numpy(d),
        rng.seed(torch.arange(n), 0, 3), t_max=torch.from_numpy(t_max),
        active=torch.from_numpy(active), trace=plain.traverse, prune=prune)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(s1.numpy().astype(np.uint32), np.asarray(js1))
    counts = plain.march_counts
    assert counts["calls"] == 1 and int(counts["rays"]) == int(active.sum())
    # rays cross surfaces, and some are occluded behind a crossed one
    assert int(counts["passed"]) > 0 and counts["segments"]["traverse"] >= 2
    assert 0 < int(occ.sum()) < int(counts["entered"])
    if prune:
        assert int(counts["entered"]) < int(active.sum())


def _configs(strategy: str):
    """(JAX options, settings, world; the port's) at 2 bounces under the
    light strategy ``strategy``, with the Lambertian override and no
    dispersion, which keeps the JAX package's compile short; ambient NONE."""
    from hiprt_pt_tpu.core import settings as js

    kw = dict(max_bounces_static=2, do_dispersion=False)
    jopts = js.RenderOptions(
        direct_light_sampling=getattr(js.LightSamplingStrategy, strategy),
        bsdf_override=js.BSDFOverride.LAMBERTIAN, **kw)
    jset = js.RenderSettings().replace(nb_bounces=jnp.int32(2))
    jworld = js.WorldSettings().replace(
        ambient_light_type=jnp.int32(int(js.AmbientLightType.NONE)))
    opts = ts.RenderOptions(
        direct_light_sampling=getattr(ts.LightSamplingStrategy, strategy),
        bsdf_override=ts.BSDFOverride.LAMBERTIAN, **kw)
    return (jopts, jset, jworld, opts, ts.RenderSettings(nb_bounces=2),
            interop.world_from_numpy(tp.to_numpy_dict(jworld)))


@pytest.mark.parametrize("strategy", ["MIS", "RIS_BSDF_LIGHT", "RESTIR_DI"])
def test_alpha_scene_renders_like_jax(alpha_scene, strategy):
    """One sample at 32x16 of the alpha scene; each strategy's shadow rays
    go through the march (NEE under MIS, the winner's ray under RIS,
    ReSTIR's final visibility at the camera vertex and RIS after it), whose
    draws every later draw of the pixel depends on."""
    from hiprt_pt_tpu.core.state import init_render_state as jinit
    from hiprt_pt_tpu.render.renderer import render_step as jstep
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.ops import traverse as plain
    from hiprt_pt_tpu_torch.render.renderer import render_step

    jopts, jset, jworld, opts, settings, world = _configs(strategy)
    restir = strategy == "RESTIR_DI"
    s = alpha_scene
    ref = jstep(jopts, W, H, (s["jscene"], s["jbvh"]),
                jinit(W, H, 42, with_restir=restir), s["jcam"], jset, jworld)
    plain.reset_march_counts(tally=True)
    got = render_step(opts, W, H, s["tscene"], s["tbvh"],
                      init_render_state(W, H, seed=42, device="cpu",
                                        with_restir=restir),
                      s["tcam"], settings, world)
    assert plain.march_counts["calls"] > 0
    assert int(plain.march_counts["passed"]) > 0
    assert_images_agree(got.accum.numpy(), np.asarray(ref.accum),
                        int(got.rays_traced), float(ref.rays_traced))
