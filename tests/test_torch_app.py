"""The port's entry point and what follows a render against the JAX
package: checkpoints (render/checkpoint.py) crossing between the packages
both ways and a bit-exact resume, the animations (render/animation.py),
the debug views (render/debug.py), the command-line renderer
(app/cli.py) and its screenshot names (app/screenshot.py), and the copies
of utils/image_compare.py and utils/logger.py.

Scenes are a test-written Cornell .glb loaded by each package's loader.
The CLI is held against the port's own pieces run by hand (load, Renderer,
denoise, write_png, write_hdr); tests/test_torch_gltf.py holds the loader
and the render step against the JAX package. No JAX render step is
compiled here: JAX's debug_pixel runs its integrator eagerly on 9 rays."""

import datetime
import importlib
import io
import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402

from hiprt_pt_tpu_torch import interop  # noqa: E402
from hiprt_pt_tpu_torch.core import settings as ts  # noqa: E402

W, H = 32, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as in test_torch_envmap.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    return tp.write_cornell_glb(str(tmp_path_factory.mktemp("app") / "c.glb"),
                                W / H)


def _renderer(glb, strategy="MIS", spf=1, bounces=2, w=W, h=H, **opts):
    from hiprt_pt_tpu_torch.assets.loader import load_scene_file
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    scene, cam, bvh = load_scene_file(glb, aspect=w / h, with_bvh=True,
                                      device="cpu")
    return Renderer(scene, cam, w, h, bvh=bvh, options=ts.RenderOptions(
        direct_light_sampling=getattr(ts.LightSamplingStrategy, strategy),
        max_bounces_static=bounces, **opts),
        settings=ts.RenderSettings(nb_bounces=bounces, samples_per_frame=spf))


# --- checkpoints ---

def _random_port_state(with_restir: bool):
    """A port state whose every leaf holds seeded values; rays_traced past
    2^24, where an f32 count is inexact."""
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.checkpoint import _leaves, _rebuild

    g = np.random.default_rng(9)
    st = init_render_state(W, H, 1234567, "cpu", with_restir=with_restir)
    values = {}
    for name, v in _leaves(st):
        if not isinstance(v, torch.Tensor):
            values[name] = {"sample_count": 5, "seed": 1234567}[name[0]]
        elif name == ("rays_traced",):
            values[name] = torch.tensor(2**24 + 3)
        elif name == ("nb_pixels_converged",):
            values[name] = torch.tensor(17)
        elif v.dtype == torch.bool:
            values[name] = torch.from_numpy(g.random(v.shape) < 0.5)
        elif v.dtype == torch.int32:
            values[name] = torch.from_numpy(g.integers(-1, 99, v.shape, np.int32))
        else:
            values[name] = torch.from_numpy(g.normal(size=v.shape).astype(np.float32))
    return _rebuild(st, values)


@pytest.mark.parametrize("with_restir", [False, True], ids=["plain", "restir"])
def test_port_checkpoint_loads_in_jax(tmp_path, with_restir):
    """Saved by the port, loaded by the JAX package's load_checkpoint into
    its init_render_state: equal leaf by leaf, in JAX's dtypes."""
    from hiprt_pt_tpu.core.state import init_render_state as jinit
    from hiprt_pt_tpu.render.checkpoint import load_checkpoint as jload
    from hiprt_pt_tpu_torch.render.checkpoint import _leaves, save_checkpoint

    st = _random_port_state(with_restir)
    path = str(tmp_path / "ck")
    save_checkpoint(path, st)
    template = jinit(W, H, with_restir=with_restir)
    js = jload(path, template)
    jleaves = jax.tree_util.tree_leaves(js)
    tleaves = jax.tree_util.tree_leaves(template)
    ours = list(_leaves(st))
    assert len(jleaves) == len(ours) == 11 + 2 * 10 + 8 * with_restir
    with np.load(path + ".npz") as data:
        for i, (t, j, (name, v)) in enumerate(zip(tleaves, jleaves, ours)):
            assert data[f"leaf_{i}"].dtype == t.dtype, name
            want = v.numpy() if isinstance(v, torch.Tensor) else v
            if name == ("rays_traced",):
                want = np.float32(2**24 + 3)
            np.testing.assert_array_equal(np.asarray(j), want, err_msg=str(name))
        assert int(data["rays_traced_int64"]) == 2**24 + 3
    assert int(js.sample_count) == 5 and int(js.seed) == 1234567


@pytest.mark.parametrize("with_restir", [False, True], ids=["plain", "restir"])
def test_jax_checkpoint_loads_in_port(tmp_path, with_restir):
    """Saved by the JAX package (compressed), loaded by the port: equal to
    interop.state_from_numpy of the same JAX state."""
    from hiprt_pt_tpu.core.state import init_render_state as jinit
    from hiprt_pt_tpu.render.checkpoint import save_checkpoint as jsave
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.checkpoint import load_checkpoint

    g = np.random.default_rng(3)

    def fill(x):
        x = np.asarray(x)
        if x.shape == ():
            return jnp.asarray(np.asarray(12345, x.dtype))
        if x.dtype == np.bool_:
            return jnp.asarray(g.random(x.shape) < 0.5)
        return jnp.asarray(g.normal(size=x.shape).astype(np.float32) * 9
                           ).astype(x.dtype)

    js = jax.tree_util.tree_map(fill, jinit(W, H, with_restir=with_restir))
    path = str(tmp_path / "jax.npz")
    jsave(path, js)
    got = load_checkpoint(path, init_render_state(W, H, device="cpu",
                                                  with_restir=with_restir))
    want = interop.state_from_numpy(tp.to_numpy_dict(js), "cpu")
    assert (got.restir is None) == (not with_restir)
    _assert_states_equal(got, want)
    assert got.sample_count == 12345 and got.rays_traced.dtype == torch.int64


def _assert_states_equal(a, b):
    from hiprt_pt_tpu_torch.render.checkpoint import _leaves

    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        else:
            assert x == y, name


def test_resume_is_bit_exact(glb, tmp_path):
    """ReSTIR DI (reservoirs and the previous G-buffer carry over): 2
    samples, a checkpoint, a fresh Renderer that loads it and takes 2 more
    samples: every state tensor equals a straight 4-sample run's."""
    from hiprt_pt_tpu_torch.render.checkpoint import (load_checkpoint,
                                                      save_checkpoint)

    straight = _renderer(glb, "RESTIR_DI", spf=2, bounces=1)
    straight.step()
    straight.step()
    first = _renderer(glb, "RESTIR_DI", spf=2, bounces=1)
    first.step()
    save_checkpoint(str(tmp_path / "half.npz"), first.state)
    resumed = _renderer(glb, "RESTIR_DI", spf=2, bounces=1)
    resumed.state = load_checkpoint(str(tmp_path / "half.npz"), resumed.state)
    assert resumed.state.sample_count == 2
    resumed.step()
    assert resumed.state.sample_count == 4
    _assert_states_equal(resumed.state, straight.state)


def test_checkpoint_mismatch_raises(glb, tmp_path):
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.checkpoint import (load_checkpoint,
                                                      save_checkpoint)

    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, init_render_state(W, H, device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, init_render_state(W, 2 * H, device="cpu"))
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(path, init_render_state(W, H, device="cpu",
                                                with_restir=True))


# --- animation ---

def test_camera_orbit_matches_jax():
    from hiprt_pt_tpu.core.camera import camera_from_lookat as jcam
    from hiprt_pt_tpu.render.animation import CameraOrbitAnimation as JOrbit
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat
    from hiprt_pt_tpu_torch.render.animation import CameraOrbitAnimation

    kw = dict(eye=(2.0, 1.5, 6.0), target=(0.5, 1.0, 0.0), vfov_deg=40.0,
              aspect=16 / 9)
    jc, tc = jcam(**kw), camera_from_lookat(**kw, device="cpu")
    ja = JOrbit(target=(0.5, 1.0, 0.0), degrees_per_frame=25.0)
    ta = CameraOrbitAnimation(target=(0.5, 1.0, 0.0), degrees_per_frame=25.0)
    for frame in (1, 2, 1):
        jc, tc = ja.step(jc, frame), ta.step(tc, frame)
        for k in ("view", "proj", "position"):
            np.testing.assert_allclose(getattr(tc, k).numpy(),
                                       np.asarray(getattr(jc, k)), atol=2e-6,
                                       rtol=1e-6, err_msg=k)
    assert abs(tc.vfov - float(jc.vfov)) < 1e-6


def test_envmap_rotation_matches_jax():
    from hiprt_pt_tpu.core import settings as js
    from hiprt_pt_tpu.render.animation import EnvmapRotationAnimation as JRot
    from hiprt_pt_tpu_torch.render.animation import EnvmapRotationAnimation

    c, s = np.cos(0.3), np.sin(0.3)
    base = np.asarray([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    jw = js.WorldSettings().replace(envmap_to_world=jnp.asarray(base),
                                    world_to_envmap=jnp.asarray(base.T))
    tw = ts.WorldSettings(envmap_to_world=tuple(map(tuple, base.tolist())))
    jw, tw = JRot(17.0).step(jw, 3), EnvmapRotationAnimation(17.0).step(tw, 3)
    np.testing.assert_array_equal(np.asarray(tw.envmap_to_world, np.float32),
                                  np.asarray(jw.envmap_to_world))
    np.testing.assert_array_equal(np.asarray(tw.world_to_envmap, np.float32),
                                  np.asarray(jw.world_to_envmap))
    assert isinstance(tw.envmap_to_world[0][0], float)


def test_render_frame_sequence_writes_differing_frames(glb, tmp_path):
    from hiprt_pt_tpu_torch.assets.image_io import decode_png
    from hiprt_pt_tpu_torch.render.animation import (CameraOrbitAnimation,
                                                     render_frame_sequence)

    r = _renderer(glb, bounces=1)
    paths = render_frame_sequence(
        r, num_frames=3, samples_per_frame_image=1,
        out_dir=str(tmp_path / "anim"), denoise_frames=True,
        camera_animation=CameraOrbitAnimation(target=(0.0, 1.0, 0.0),
                                              degrees_per_frame=20.0))
    assert [os.path.basename(p) for p in paths] == [
        "frame_0000.png", "frame_0001.png", "frame_0002.png"]
    imgs = []
    for p in paths:
        with open(p, "rb") as f:
            imgs.append(decode_png(f.read()).astype(np.float64))
    assert imgs[0].shape == (H, W, 3) and imgs[0].mean() > 1
    assert all(np.abs(a - b).mean() > 0.5 for a, b in
               ((imgs[0], imgs[1]), (imgs[1], imgs[2]), (imgs[0], imgs[2])))
    assert r.state.sample_count == 0  # reset after the last frame


# --- debug views ---

def test_nan_view_matches_jax(glb):
    jdebug = importlib.import_module("hiprt_pt_tpu.render.debug")
    from hiprt_pt_tpu_torch.render.debug import nan_view

    r = _renderer(glb, bounces=1)
    r.step()
    accum = r.state.accum.clone()
    accum[3, 1] = float("nan")
    accum[70, 0] = -0.5
    accum[200] = float("inf")
    r.state = r.state.replace(accum=accum)
    stub = types.SimpleNamespace(width=W, height=H, ldr_image=r.ldr_image,
                                 state=types.SimpleNamespace(
                                     accum=jnp.asarray(accum.numpy())))
    got = nan_view(r)
    np.testing.assert_array_equal(got, jdebug.nan_view(stub))
    assert (got == [1.0, 0.0, 1.0]).all(-1).sum() == 3


def test_debug_pixel_matches_jax(glb):
    """debug_pixel at neighborhood 1 under MIS (Lambertian override, 2
    bounces): the first hit's prim, t, material, position, normal and uv
    equal JAX's, and the 9 radiances agree at the render gate's per-pixel
    tolerance (1e-3 + 1e-3·|ref|)."""
    from hiprt_pt_tpu.accel.build import build_bvh as jbvh
    from hiprt_pt_tpu.assets.loader import load_scene_file as jload
    from hiprt_pt_tpu.core import settings as js
    from hiprt_pt_tpu.core.state import init_render_state as jinit
    from hiprt_pt_tpu_torch.render.debug import debug_pixel

    jdebug = importlib.import_module("hiprt_pt_tpu.render.debug")
    r = _renderer(glb, bsdf_override=ts.BSDFOverride.LAMBERTIAN,
                  do_dispersion=False)
    jscene, jcam = jload(glb, aspect=W / H)
    jr = types.SimpleNamespace(
        width=W, height=H, state=jinit(W, H, 42), camera=jcam,
        scene=jscene,
        bvh=jbvh(np.asarray(jscene.vertices), np.asarray(jscene.triangles)),
        options=js.RenderOptions(
            direct_light_sampling=js.LightSamplingStrategy.MIS,
            max_bounces_static=2, bsdf_override=js.BSDFOverride.LAMBERTIAN,
            do_dispersion=False),
        world=js.WorldSettings(),
        settings=js.RenderSettings().replace(nb_bounces=jnp.int32(2)))
    ref = jdebug.debug_pixel(jr, 13, 6, neighborhood=1, sample_number=3)
    got = debug_pixel(r, 13, 6, neighborhood=1, sample_number=3)
    assert got["prim"] == ref["prim"] >= 0
    assert got["material_id"] == ref["material_id"]
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-5)
    for k in ("position", "normal", "uv"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), atol=1e-5,
                                   err_msg=k)
    want = np.asarray(ref["neighborhood"])
    assert got["neighborhood"].shape == (3, 3, 3)
    assert (np.abs(got["neighborhood"] - want) <= 1e-3 + 1e-3 * np.abs(want)).all()
    np.testing.assert_array_equal(got["radiance"], got["neighborhood"][1, 1])
    assert got["radiance"].sum() > 0


# --- the command-line renderer ---

ARGV = [
    ["s.glb"],
    ["scene.gltf", "--samples=8", "--bounces=3", "--w=64", "--h=32",
     "--strategy=restir", "--denoise", "--cpu", "--hdr-out=x.hdr",
     "--spp-per-frame=2", "--clamp=3.5", "--max-time=2", "--adaptive",
     "--sky=e.hdr", "--resume=r.npz", "--checkpoint=c", "--seed=7",
     "--exposure=2", "--gamma=1.8", "--out=o.png"],
    ["a.glb", "--strategy", "nee", "--w", "16"],
]


@pytest.mark.parametrize("argv", ARGV, ids=["defaults", "every-flag", "spaced"])
def test_build_parser_matches_jax(argv):
    from hiprt_pt_tpu.app.cli import build_parser as jparser
    from hiprt_pt_tpu_torch.app.cli import _STRATEGY, build_parser

    assert vars(build_parser().parse_args(argv)) == vars(jparser().parse_args(argv))
    jcli = importlib.import_module("hiprt_pt_tpu.app.cli")
    assert _STRATEGY == jcli._STRATEGY
    with pytest.raises(SystemExit):
        build_parser().parse_args(argv + ["--strategy=path"])


def test_auto_filename_matches_jax(monkeypatch):
    jshot = importlib.import_module("hiprt_pt_tpu.app.screenshot")
    tshot = importlib.import_module("hiprt_pt_tpu_torch.app.screenshot")

    class Frozen(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2026, 3, 4, 5, 6, 7)

    clock = types.SimpleNamespace(datetime=Frozen)
    monkeypatch.setattr(jshot, "datetime", clock)
    monkeypatch.setattr(tshot, "datetime", clock)
    args = ("scenes/room.glb", 12, 640, 360, "out")
    assert tshot.auto_filename(*args) == jshot.auto_filename(*args) == \
        os.path.join("out", "room_03.04.2026.05.06.07_12sp@640x360.png")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_cli_main_on_the_cpu(glb, tmp_path):
    """main(--cpu) with --sky, --denoise, --hdr-out and --checkpoint at
    32x18 writes the PNG and HDR that the port's pieces make by hand; a
    second call with --resume continues to 4 samples as the hand-run
    renderer does."""
    from hiprt_pt_tpu_torch.app.cli import main
    from hiprt_pt_tpu_torch.assets.envmap import load_envmap, make_test_envmap
    from hiprt_pt_tpu_torch.assets.image_io import decode_png, write_hdr
    from hiprt_pt_tpu_torch.assets.loader import load_scene_file
    from hiprt_pt_tpu_torch.ops.tonemap import tonemap_gamma
    from hiprt_pt_tpu_torch.render.denoise import denoise
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    w, h = 32, 18
    sky = str(tmp_path / "sky.hdr")
    write_hdr(sky, make_test_envmap(16, 32, "sky"))
    common = [glb, "--cpu", f"--w={w}", f"--h={h}", "--bounces=1",
              "--spp-per-frame=1", "--denoise", f"--sky={sky}",
              "--exposure=1.5"]
    stats = {}
    assert main(common + ["--samples=2", f"--out={tmp_path}/a.png",
                          f"--hdr-out={tmp_path}/a.hdr",
                          f"--checkpoint={tmp_path}/a"], stats) == 0
    assert stats["samples"] == 2 and stats["rays"] > 0
    assert {"load", "bvh", "render", "denoise", "png", "hdr",
            "checkpoint"} <= set(stats)

    env = load_envmap(sky, device="cpu")
    scene, cam = load_scene_file(glb, aspect=w / h, envmap=env, device="cpu")
    r = Renderer(scene, cam, w, h, seed=42, options=ts.RenderOptions(
        direct_light_sampling=ts.LightSamplingStrategy.MIS,
        max_bounces_static=1))
    r.settings = r.settings.replace(nb_bounces=1, samples_per_frame=1)
    r.world = r.world.replace(ambient_light_type=int(ts.AmbientLightType.ENVMAP))

    def files(prefix):
        hdr = denoise(r)
        ldr = tonemap_gamma(torch.from_numpy(hdr), 1.5).numpy()
        write_hdr(str(tmp_path / f"{prefix}_ref.hdr"), hdr)
        png = decode_png(_read(tmp_path / f"{prefix}.png"))
        want = (np.clip(ldr, 0, 1) * 255.0 + 0.5).astype(np.uint8)
        assert png.shape == (h, w, 3)
        np.testing.assert_array_equal(png, want)
        assert _read(tmp_path / f"{prefix}.hdr") == _read(
            tmp_path / f"{prefix}_ref.hdr")

    r.render(2)
    files("a")
    assert main(common + ["--samples=4", f"--resume={tmp_path}/a.npz",
                          f"--out={tmp_path}/b.png",
                          f"--hdr-out={tmp_path}/b.hdr"]) == 0
    r.render(4)
    assert r.state.sample_count == 4
    files("b")


def test_cli_path_runs_on_the_cpu(glb, tmp_path, monkeypatch):
    """The cli path's flags (paths.CLI_FLAGS: ReSTIR DI, the denoiser, a
    checkpoint) at 32x16 on the CPU: main builds the options, settings and
    world of paths.slice_options("cli") and writes its three files."""
    from hiprt_pt_tpu_torch import paths
    from hiprt_pt_tpu_torch.app.cli import main
    from hiprt_pt_tpu_torch.render import renderer as renderer_mod
    from hiprt_pt_tpu_torch.render.checkpoint import load_checkpoint

    made = []

    class Kept(renderer_mod.Renderer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(renderer_mod, "Renderer", Kept)
    argv = paths.cli_argv(glb, str(tmp_path)) + ["--cpu", f"--w={W}",
                                                 f"--h={H}"]
    assert main(argv) == 0
    (r,) = made
    assert (r.options, r.settings, r.world) == paths.slice_options("cli")
    assert r.state.sample_count == 4 and r.state.restir is not None
    back = load_checkpoint(str(tmp_path / "cli.npz"), r.state)
    _assert_states_equal(back, r.state)
    assert os.path.getsize(tmp_path / "cli.png") > 0
    assert os.path.getsize(tmp_path / "cli.hdr") > 0


def test_cli_main_needs_a_gpu_without_cpu(glb, tmp_path, monkeypatch):
    from hiprt_pt_tpu_torch.app.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([glb, "--samples=1", f"--out={tmp_path}/x.png"])
    assert not os.path.exists(tmp_path / "x.png")


def test_screenshot_writes_the_display_image(glb, tmp_path):
    from hiprt_pt_tpu_torch.app.screenshot import screenshot
    from hiprt_pt_tpu_torch.assets.image_io import decode_png

    r = _renderer(glb, bounces=1)
    r.step()
    path = screenshot(r, str(tmp_path / "shot.png"), exposure=2.0)
    want = (np.clip(r.ldr_image(2.0), 0, 1) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(decode_png(_read(path)), want)


# --- the numpy utilities ---

def test_image_compare_matches_jax():
    from hiprt_pt_tpu.utils import image_compare as jic
    from hiprt_pt_tpu_torch.utils import image_compare as tic

    g = np.random.default_rng(2)
    a, b = g.gamma(2.0, 0.5, (2, 16, 24, 3)).astype(np.float32)
    assert tic.compare_report(a, b) == jic.compare_report(a, b)
    assert tic.tonemapped_rmse(a, b, 1.8) == jic.tonemapped_rmse(a, b, 1.8)
    assert tic.rel_mse(a, b, 0.5) == jic.rel_mse(a, b, 0.5)


def test_logger_matches_jax(monkeypatch):
    from hiprt_pt_tpu.utils import logger as jlog
    from hiprt_pt_tpu_torch.utils import logger as tlog

    outs = []
    for mod in (jlog, tlog):
        monkeypatch.setattr(mod.time, "strftime", lambda fmt: "12:34:56")
        s = io.StringIO()
        log = mod.Logger(s)
        log.info("scene loaded")
        log.warn("slow")
        log.update_line("render", "[render] 1/4 spp")
        log.update_line("render", "[render] 2/4 spp")
        log.end_line("render")
        log.error("bad")
        log.debug("detail")
        outs.append(s.getvalue())
        assert isinstance(mod.get_logger(), mod.Logger)
    assert outs[0] == outs[1] and "[12:34:56][WARN] slow" in outs[1]
