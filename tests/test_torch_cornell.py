"""The Cornell path against the JAX package at a small size: the procedural
Cornell scene (tests/torch_parity.py:cornell_spheres_arrays, 35,852
triangles, seven principled sphere materials) rendered at 64x32 with the
full principled BSDF, MIS NEE, dispersion and thin film, 4 bounces, one
sample, seed 42. Every traversal of the port's render goes through the
meganode walk (trace_meganode's plain version on the CPU).

Image gates, as for the stress slice: >= 98% of pixels within
1e-3 + 1e-3·|ref| per channel, image mean within 1%, rays within 0.5%."""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402

W, H = 64, 32


@pytest.fixture(scope="module")
def cornell():
    """The scene built by both packages from the same arrays, and one JAX
    render step."""
    from hiprt_pt_tpu.accel.build import build_bvh as jbvh
    from hiprt_pt_tpu.assets.scene import build_scene as jscene
    from hiprt_pt_tpu.core import settings as js
    from hiprt_pt_tpu.core.camera import camera_from_lookat as jcam
    from hiprt_pt_tpu.core.material import MaterialBank as JBank
    from hiprt_pt_tpu.core.state import init_render_state
    from hiprt_pt_tpu.render.renderer import render_step
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.assets.scene import build_scene
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat
    from hiprt_pt_tpu_torch.core.material import MaterialBank

    v, f, m, rows, cam = tp.cornell_spheres_arrays(W / H)
    jsc, jc, jb = jscene(v, f, m, JBank.from_rows(rows)), jcam(**cam), jbvh(v, f)
    opts = js.RenderOptions(direct_light_sampling=js.LightSamplingStrategy.MIS,
                            max_bounces_static=4)
    settings = js.RenderSettings().replace(nb_bounces=jnp.int32(4))
    world = js.WorldSettings().replace(
        ambient_light_type=jnp.int32(int(js.AmbientLightType.NONE)))
    jstate = render_step(opts, W, H, (jsc, jb), init_render_state(W, H, 42), jc,
                         settings, world)
    return dict(jscene=jsc, jcam=jc, jstate=jstate,
                tscene=build_scene(v, f, m, MaterialBank.from_rows(rows),
                                   device="cpu"),
                tcam=camera_from_lookat(**cam, device="cpu"),
                tbvh=build_bvh(v, f, "cpu"))


def _port_config():
    from hiprt_pt_tpu_torch.core import settings as ts

    opts = ts.RenderOptions(direct_light_sampling=ts.LightSamplingStrategy.MIS,
                            max_bounces_static=4)
    assert opts.bsdf_override == ts.BSDFOverride.NONE
    assert opts.do_dispersion and opts.do_thin_film
    return (opts, ts.RenderSettings(nb_bounces=4),
            ts.WorldSettings(ambient_light_type=int(ts.AmbientLightType.NONE)))


def test_cornell_scene_matches_jax(cornell):
    from hiprt_pt_tpu_torch import interop

    ref = tp.to_numpy_dict(cornell["jscene"])
    got = interop.to_numpy(cornell["tscene"])
    assert got["vertices"].shape[0] > 0 and ref["triangles"].shape[0] == 35_852
    for k, v in got.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(v, ref[k], equal_nan=v.dtype.kind == "f"), k
    for k, v in got["materials"].items():
        assert np.array_equal(v, ref["materials"][k]), k
    for k in ("view", "view_inv", "proj", "proj_inv", "position"):
        assert np.array_equal(getattr(cornell["tcam"], k).numpy(),
                              np.asarray(getattr(cornell["jcam"], k))), k


def test_cornell_render_step_matches_jax(cornell, monkeypatch):
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.ops import traverse as plain
    from hiprt_pt_tpu_torch.render.renderer import render_step

    # every traversal goes through the meganode walk, none through BVH4
    calls = []
    walk = plain.traverse_meganode

    def counted(*a, **k):
        calls.append(k.get("any_hit", False))
        return walk(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the Cornell path reached the BVH4 walk")

    monkeypatch.setattr(plain, "traverse_meganode", counted)
    monkeypatch.setattr(plain, "traverse", refuse)

    opts, settings, world = _port_config()
    state = render_step(opts, W, H, cornell["tscene"], cornell["tbvh"],
                        init_render_state(W, H, 42, "cpu"), cornell["tcam"], settings,
                        world)
    assert False in calls and True in calls
    jstate = cornell["jstate"]
    ref, got = np.asarray(jstate.accum), state.accum.numpy()
    assert np.isfinite(got).all()
    close = np.all(np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= 0.98, close.mean()
    assert abs(got.mean() - ref.mean()) <= 0.01 * abs(ref.mean())
    rays_ref = float(jstate.rays_traced)
    assert abs(int(state.rays_traced) - rays_ref) <= 0.005 * rays_ref
    assert (got.sum(-1) > 0).mean() > 0.9


def test_cornell_dispersion_changes_the_image(cornell):
    """With dispersion on, the u_lam draw shifts the RNG stream and the
    clear-glass sphere's hero wavelengths tint its paths: the image differs
    from the same render without dispersion, and both stay finite."""
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    opts, settings, world = _port_config()
    imgs = []
    for o in (opts, opts.replace(do_dispersion=False)):
        s = render_step(o, 32, 16, cornell["tscene"], cornell["tbvh"],
                        init_render_state(32, 16, 7, "cpu"), cornell["tcam"],
                        settings, world)
        imgs.append(s.accum.numpy())
    assert all(np.isfinite(i).all() for i in imgs)
    assert not np.array_equal(imgs[0], imgs[1])
    assert torch.is_tensor(cornell["tbvh"].nodes)
