"""The port's scene, interop, camera pass and render step against the JAX
package on the stress interior at a small size (64x32, ~122k triangles),
under the slice configuration: Lambertian override, MIS NEE, 4 bounces, no
dispersion, no textures, ambient NONE."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402

from hiprt_pt_tpu_torch import interop  # noqa: E402
from hiprt_pt_tpu_torch.core import settings as ts  # noqa: E402

W, H = 64, 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_config():
    from hiprt_pt_tpu.core import settings as js

    opts = js.RenderOptions(
        direct_light_sampling=js.LightSamplingStrategy.MIS,
        bsdf_override=js.BSDFOverride.LAMBERTIAN, do_dispersion=False,
        max_bounces_static=4)
    settings = js.RenderSettings().replace(nb_bounces=jnp.int32(4))
    world = js.WorldSettings().replace(
        ambient_light_type=jnp.int32(int(js.AmbientLightType.NONE)))
    return opts, settings, world


def _port_config():
    opts = ts.RenderOptions(
        direct_light_sampling=ts.LightSamplingStrategy.MIS,
        bsdf_override=ts.BSDFOverride.LAMBERTIAN, do_dispersion=False,
        max_bounces_static=4)
    return (opts, ts.RenderSettings(nb_bounces=4),
            ts.WorldSettings(ambient_light_type=int(ts.AmbientLightType.NONE)))


@pytest.fixture(scope="module")
def both():
    """JAX scene/camera/BVH, the port's copies, and one JAX render step."""
    from hiprt_pt_tpu.core.state import init_render_state
    from hiprt_pt_tpu.render.renderer import render_step

    jscene, jcam, jbvh = tp.jax_stress(aspect=W / H)
    tscene, tcam, tbvh = tp.port_of(jscene, jcam, jbvh)
    opts, settings, world = _jax_config()
    jstate = render_step(opts, W, H, (jscene, jbvh), init_render_state(W, H, 42),
                         jcam, settings, world)
    return dict(jscene=jscene, jcam=jcam, jbvh=jbvh, jstate=jstate,
                tscene=tscene, tcam=tcam, tbvh=tbvh)


def _assert_tree_equal(got, ref, path=""):
    if isinstance(ref, dict):
        for k, v in ref.items():
            _assert_tree_equal(got[k], v, f"{path}.{k}")
    elif isinstance(ref, np.ndarray):
        assert np.array_equal(np.asarray(got), ref, equal_nan=ref.dtype.kind == "f"), path
    else:
        assert got == ref, path


def test_interop_scene_roundtrip(both):
    ref = tp.to_numpy_dict(both["jscene"])
    got = interop.to_numpy(interop.scene_from_numpy(ref, "cpu"))
    for k, v in got.items():
        if k == "materials":
            _assert_tree_equal(v, ref["materials"], k)
        elif isinstance(v, np.ndarray):
            assert np.array_equal(v, ref[k]), k
        elif v is not None:
            assert v == pytest.approx(float(ref[k])), k


def test_interop_bvh_roundtrip(both):
    jbvh, tbvh = both["jbvh"], both["tbvh"]
    back = interop.to_numpy(tbvh)
    for k in ("nodes4", "leaf_rows", "tri_rows"):
        ref = np.asarray(getattr(jbvh, k))
        assert np.array_equal(back[k].view(np.int32), ref.view(np.int32)), k
    assert back["depth4"] == interop.bvh4_depth(np.asarray(jbvh.nodes4))


def test_interop_state_roundtrip(both):
    ref = tp.to_numpy_dict(both["jstate"])
    state = interop.state_from_numpy(ref, "cpu")
    assert state.sample_count == 1 and state.seed == 42
    got = interop.to_numpy(state)
    for k, v in got.items():
        if isinstance(v, dict):
            _assert_tree_equal(v, ref[k], k)
        elif k in ("rays_traced", "nb_pixels_converged"):
            assert int(v) == int(ref[k]), k
        elif isinstance(v, np.ndarray):
            assert np.array_equal(v, ref[k]), k
        elif k == "restir":  # a state without ReSTIR reservoirs
            assert v is None and ref[k] is None
        else:
            assert v == int(ref[k]), k


@pytest.fixture(scope="module")
def port_stress():
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene

    return load_stress_scene(aspect=W / H, tri_scale=tp.TRI_SCALE,
                             with_textures=False, device="cpu")


@pytest.mark.parametrize("group", [
    ("vertices", "triangles", "normals", "uvs", "material_ids"),
    ("tri_data",),
    ("emissive_tri_indices", "emissive_power_cdf", "emissive_alias_prob",
     "emissive_alias", "emissive_pmf", "emissive_rows", "emissive_slot_of_tri"),
    ("materials",),
    ("camera",),
])
def test_stress_generator_matches_jax(both, port_stress, group):
    """The port's own stress generator and scene build give the JAX
    package's arrays, bit for bit."""
    tscene, tcam = port_stress
    jscene, jcam = both["jscene"], both["jcam"]
    for name in group:
        if name == "materials":
            _assert_tree_equal(interop.to_numpy(tscene.materials),
                               tp.to_numpy_dict(jscene.materials))
        elif name == "camera":
            for k in ("view", "view_inv", "proj", "proj_inv", "position"):
                assert np.array_equal(getattr(tcam, k).numpy(),
                                      np.asarray(getattr(jcam, k))), k
        else:
            assert np.array_equal(getattr(tscene, name).numpy(),
                                  np.asarray(getattr(jscene, name))), name
    assert tscene.num_emissives == int(jscene.num_emissives) == 240


def test_camera_rays_pass_gbuffer(both):
    from hiprt_pt_tpu.core import rng as jrng
    from hiprt_pt_tpu.core.state import init_render_state as jinit
    from hiprt_pt_tpu.render.integrator import camera_rays_pass as jpass
    from hiprt_pt_tpu_torch.core import rng as trng
    from hiprt_pt_tpu_torch.core.state import init_render_state as tinit
    from hiprt_pt_tpu_torch.render.integrator import camera_rays_pass as tpass

    jopts, jset, _ = _jax_config()
    topts, tset, _ = _port_config()
    n = W * H
    jr = jrng.seed(jnp.arange(n, dtype=jnp.uint32), 3, 42)
    tr = trng.seed(torch.arange(n), 3, 42)
    jr, jg, ja = jpass(both["jscene"], both["jbvh"], both["jcam"], jset,
                       jinit(W, H, 42), W, H, 3, jr, jopts)
    tr, tg, ta = tpass(both["tscene"], both["tbvh"], both["tcam"], tset,
                       tinit(W, H, 42, "cpu"), W, H, 3, tr, topts)
    assert np.array_equal(np.asarray(jr).astype(np.int64), tr.numpy())
    assert np.array_equal(np.asarray(ja), ta.numpy())
    jp, tpi = np.asarray(jg.prim_index), tg.prim_index.numpy()
    assert tp.prim_agreement(jp, tpi) >= 0.999
    m = (jp == tpi) & (jp >= 0)
    assert m.mean() > 0.9
    for k in ("position", "shading_normal", "geometric_normal"):
        np.testing.assert_allclose(getattr(tg, k).numpy()[m],
                                   np.asarray(getattr(jg, k))[m], atol=1e-4)
    assert np.array_equal(tg.material_id.numpy()[m], np.asarray(jg.material_id)[m])


def test_render_step_matches_jax(both):
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    opts, settings, world = _port_config()
    state = render_step(opts, W, H, both["tscene"], both["tbvh"],
                        init_render_state(W, H, 42, "cpu"), both["tcam"], settings, world)
    ref = np.asarray(both["jstate"].accum)
    got = state.accum.numpy()
    assert np.isfinite(got).all()
    close = np.all(np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= 0.98
    assert abs(got.mean() - ref.mean()) <= 0.01 * abs(ref.mean())
    rays_ref = float(both["jstate"].rays_traced)
    assert abs(int(state.rays_traced) - rays_ref) <= 0.005 * rays_ref
    assert (got.sum(-1) > 0).mean() > 0.3
    np.testing.assert_array_equal(state.pixel_sample_count.numpy(),
                                  np.asarray(both["jstate"].pixel_sample_count))


def test_second_sample_from_jax_state_with_runtime_settings(both):
    """The port continues the JAX package's state (through interop) for a
    second sample with low-resolution masking and adaptive sampling on; the
    JAX step reuses its compiled program, since these settings are traced."""
    from hiprt_pt_tpu.render.renderer import render_step as jstep
    from hiprt_pt_tpu_torch.render.renderer import render_step

    jopts, jset, jworld = _jax_config()
    jset = jset.replace(render_low_resolution=jnp.bool_(True),
                        low_resolution_scale=jnp.int32(2),
                        enable_adaptive_sampling=jnp.bool_(True),
                        adaptive_sampling_min_samples=jnp.int32(1),
                        adaptive_sampling_noise_threshold=jnp.float32(0.5))
    import jax

    state = interop.state_from_numpy(tp.to_numpy_dict(both["jstate"]), "cpu")
    # the JAX step donates its state argument: hand it a copy
    ref = jstep(jopts, W, H, (both["jscene"], both["jbvh"]),
                jax.tree.map(jnp.copy, both["jstate"]), both["jcam"], jset, jworld)
    opts, settings, world = _port_config()
    settings = settings.replace(render_low_resolution=True, low_resolution_scale=2,
                                enable_adaptive_sampling=True,
                                adaptive_sampling_min_samples=1,
                                adaptive_sampling_noise_threshold=0.5)
    got = render_step(opts, W, H, both["tscene"], both["tbvh"], state,
                      both["tcam"], settings, world)
    assert got.sample_count == 2
    np.testing.assert_array_equal(got.pixel_sample_count.numpy(),
                                  np.asarray(ref.pixel_sample_count))
    conv_ref = np.asarray(ref.pixel_converged)
    assert 0.0 < conv_ref.mean() < 1.0
    assert np.mean(got.pixel_converged.numpy() == conv_ref) >= 0.98
    acc, acc_ref = got.accum.numpy(), np.asarray(ref.accum)
    close = np.all(np.abs(acc - acc_ref) <= 1e-3 + 1e-3 * np.abs(acc_ref), axis=-1)
    assert close.mean() >= 0.98
    rays_ref = float(ref.rays_traced)
    assert abs(int(got.rays_traced) - rays_ref) <= 0.005 * rays_ref


def test_renderer_image_matches_jax(both):
    from hiprt_pt_tpu.render.renderer import Renderer as JRenderer
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    jopts, jset, jworld = _jax_config()
    jr = JRenderer(both["jscene"], both["jcam"], W, H, options=jopts,
                   settings=jset.replace(samples_per_frame=jnp.int32(2)),
                   world=jworld, bvh=both["jbvh"], seed=42)
    jr.step(block=True)
    opts, settings, world = _port_config()
    r = Renderer(both["tscene"], both["tcam"], W, H, options=opts,
                 settings=settings.replace(samples_per_frame=2), world=world,
                 bvh=both["tbvh"], seed=42)
    r.step()
    ref, got = jr.hdr_image(), r.hdr_image()
    assert got.shape == ref.shape == (H, W, 3)
    close = np.all(np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= 0.98
    assert r.state.sample_count == 2


@pytest.mark.parametrize("feature", ["white-furnace", "automatic-stack",
                                     "envmap-restir"])
def test_formerly_refused_features_render(both, feature):
    """White-furnace mode, the AUTOMATIC interior stack and an envmap (here
    under ReSTIR DI) were refused before the port carried them; each now
    renders a sample of the stress slice (tests/test_torch_renderer.py and
    test_torch_envmap.py hold them against the JAX package)."""
    from hiprt_pt_tpu_torch.assets.envmap import build_envmap, make_test_envmap
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    opts, settings, world = _port_config()
    scene, restir = both["tscene"], False
    if feature == "white-furnace":
        opts = opts.replace(white_furnace_mode=True)
    elif feature == "automatic-stack":
        opts = opts.replace(
            interior_stack_strategy=ts.InteriorStackStrategy.AUTOMATIC)
    else:
        opts = opts.replace(direct_light_sampling=ts.LightSamplingStrategy.RESTIR_DI)
        scene = dataclasses.replace(scene, envmap=build_envmap(
            make_test_envmap(16, 32, "sky"), device="cpu"))
        world = world.replace(ambient_light_type=int(ts.AmbientLightType.ENVMAP))
        restir = True
    state = render_step(opts, 16, 8, scene, both["tbvh"],
                        init_render_state(16, 8, device="cpu", with_restir=restir),
                        both["tcam"], settings, world)
    img = state.accum.numpy()
    assert state.sample_count == 1 and int(state.rays_traced) > 128
    assert np.isfinite(img).all()
    if feature == "white-furnace":
        # a uniform white world and no emission: the closed interior, whose
        # 4-bounce paths never reach the world, is black
        assert img.max() == 0.0
    else:
        assert img.sum() > 0.0


def test_port_imports_no_jax():
    """Every module of the port imports with jax, flax, the JAX package and
    imageio made unimportable; so does chip_smoke.py."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'flax', 'hiprt_pt_tpu', 'imageio'):\n"
        "    sys.modules[m] = None\n"
        "import hiprt_pt_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    hiprt_pt_tpu_torch.__path__, 'hiprt_pt_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'hiprt_pt_tpu',\n"
        "                                   'imageio')\n"
        "               and sys.modules[k] is not None for k in sys.modules)\n"
        "print(len(names))\n"
        "print(' '.join(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.strip().splitlines()[-2:]
    assert int(count) >= 25
    # the modules of the frame loop, the envmaps and the scene files among them
    assert {"hiprt_pt_tpu_torch.assets.envmap",
            "hiprt_pt_tpu_torch.lights.envmap_sampling",
            "hiprt_pt_tpu_torch.render.renderer",
            "hiprt_pt_tpu_torch.utils.perf",
            "hiprt_pt_tpu_torch.assets.gltf",
            "hiprt_pt_tpu_torch.assets.gltf_testscene",
            "hiprt_pt_tpu_torch.assets.image_io",
            "hiprt_pt_tpu_torch.assets.loader",
            "hiprt_pt_tpu_torch.utils.threads"} <= set(names.split())


def test_render_state_replace_is_not_in_place(both):
    """render_step returns a new state and leaves its input untouched."""
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    opts, settings, world = _port_config()
    s0 = init_render_state(16, 8, device="cpu")
    s1 = render_step(opts, 16, 8, both["tscene"], both["tbvh"], s0,
                     both["tcam"], settings.replace(nb_bounces=1), world)
    assert s0.sample_count == 0 and float(s0.accum.abs().sum()) == 0.0
    assert s1.sample_count == 1 and int(s1.rays_traced) > 0
    assert dataclasses.is_dataclass(s1)


def test_entry_points_default_to_the_gpu(monkeypatch):
    """An entry point given no device runs on the GPU, and without one it
    raises: the CPU runs only when the caller asks for it."""
    from hiprt_pt_tpu_torch import interop
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat
    from hiprt_pt_tpu_torch.core.device import resolve_device
    from hiprt_pt_tpu_torch.core.state import init_render_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: load_stress_scene(tri_scale=0.01),
        lambda: build_bvh(np.eye(3, dtype=np.float32), np.asarray([[0, 1, 2]])),
        lambda: camera_from_lookat((0, 0, 1), (0, 0, 0)),
        lambda: init_render_state(16, 8),
        lambda: interop.state_from_numpy({}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device() == torch.device("cuda", 0)
