"""Multi-process rendering in the port (hiprt_pt_tpu_torch/parallel/) on
the CPU: gloo ranks spawned by parallel/launch.py, held against one
process and against the JAX package's parallel/ on the conftest's eight
virtual CPU devices.

- Pixel DP on 4 and on 2 ranks (the first 2 of the same launch) is bit for
  bit one process's render: every per-pixel field, the G-buffers, the
  reservoirs and both counters, under MIS with adaptive sampling on the
  stress interior, under the alpha march on an alpha-textured Cornell box
  (a rank runs march segments for which it has no searching ray), and
  under ReSTIR DI (temporal reuse, spatial taps across the shards).
- Sample DP with ReSTIR on 2 ranks: each rank is one process's render with
  its seed (42 + 9176·rank); the merge is their mean.
- Against the JAX package (render tolerance of test_torch_render.py):
  distributed_render's image and sample_dp_render + merge_sample_dp's;
  frame_assignment exactly. JAX states carried into the port
  (interop.shard_state_from_numpy, sample_dp_state_from_numpy) continue
  in the ranks bit for bit as in one process.
- render_distributed_sequence: two explicit indices, and 2 ranks with the
  group's defaults, write one process's PNGs byte for byte.

Two JAX compiles: distributed_render's sharded step and sample_dp_render's
shard_map. Two launches: 4 ranks for the renders (in the background while
JAX compiles), then 2 for the carried JAX states and the sequence."""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402
from test_torch_envmap import assert_images_agree  # noqa: E402

from hiprt_pt_tpu_torch import interop  # noqa: E402
from hiprt_pt_tpu_torch.core import settings as ts  # noqa: E402

# 4 tiles: one a rank of 4, two a rank of 2
W, H = 32, 16
# pixel DP: adaptive sampling skips pixels from step 3, and ReSTIR's
# temporal reuse finds a previous G-buffer from step 3 (it reads the one
# before the previous step's, as the JAX package does)
STEPS = 3
SDP_SAMPLES = 3    # sample DP with ReSTIR (temporal reuse from the third)
SEED_STRIDE = 9176


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as in test_torch_envmap.py (the runner's workers
    share the cores); the spawned ranks set theirs to one too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _settings(jax_side: bool):
    """Lambertian, MIS, 2 bounces, adaptive sampling from 2 samples (the
    configuration of tests/test_parallel.py:_setup, converging pixels by
    its noise test from the second step), ambient NONE."""
    kw = dict(nb_bounces=2, samples_per_frame=1, enable_adaptive_sampling=True,
              adaptive_sampling_min_samples=2,
              adaptive_sampling_noise_threshold=0.5, stop_noise_threshold=0.1)
    if not jax_side:
        return ts.RenderSettings(**kw)
    from hiprt_pt_tpu.core.settings import RenderSettings

    return RenderSettings(
        nb_bounces=jnp.int32(2), samples_per_frame=jnp.int32(1),
        enable_adaptive_sampling=jnp.bool_(True),
        adaptive_sampling_min_samples=jnp.int32(2),
        adaptive_sampling_noise_threshold=jnp.float32(0.5),
        stop_noise_threshold=jnp.float32(0.1))


def _options(strategy: str = "MIS"):
    return ts.RenderOptions(
        bsdf_override=ts.BSDFOverride.LAMBERTIAN, do_dispersion=False,
        direct_light_sampling=getattr(ts.LightSamplingStrategy, strategy),
        max_bounces_static=2)


def _world():
    return ts.WorldSettings(ambient_light_type=int(ts.AmbientLightType.NONE))


@pytest.fixture(scope="module")
def stress():
    jscene, jcam, jbvh = tp.jax_stress(aspect=W / H)
    tscene, tcam, tbvh = tp.port_of(jscene, jcam, jbvh)
    return dict(jscene=jscene, jcam=jcam, jbvh=jbvh,
                port=(tscene, tcam, tbvh))


def _cutout(n: int = 16) -> np.ndarray:
    """A light checker whose dark squares are holes (alpha 0)."""
    yy, xx = np.mgrid[0:n, 0:n]
    img = np.full((n, n, 4), 230, np.uint8)
    img[..., 3] = np.where((yy // 4 + xx // 4) % 2 == 0, 255, 0)
    return img


@pytest.fixture(scope="module")
def alpha():
    """The procedural Cornell box with its white walls cut out by a
    checker's alpha and half-transparent spheres (as in
    test_torch_alpha.py), built by the port."""
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.assets.scene import build_scene
    from hiprt_pt_tpu_torch.assets.textures import build_texture_atlas
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat
    from hiprt_pt_tpu_torch.core.material import MaterialBank

    v, f, m, rows, cam = tp.cornell_spheres_arrays(W / H)
    rows = [dict(r) for r in rows]
    rows[0]["base_color_texture_index"] = 0
    for r in rows[4:]:
        r["alpha_opacity"] = 0.5
    uvs = np.stack([0.37 * (v[:, 0] + v[:, 2]), 0.37 * (v[:, 1] + v[:, 2])],
                   axis=-1).astype(np.float32)
    atlas = build_texture_atlas([_cutout()], srgb_indices={0}, layer_size=16)
    scene = build_scene(v, f, m, MaterialBank.from_rows(rows), uvs=uvs,
                        textures=atlas, device="cpu")
    assert scene.textures.has_alpha
    return (scene, camera_from_lookat(**cam, device="cpu"),
            build_bvh(v, f, "cpu"))


@pytest.fixture(scope="module")
def jax_runs(stress):
    """The JAX package's pixel DP over 8 devices (STEPS steps; the state
    after the first, as numpy) and sample DP over 2 (one step, merged)."""
    from hiprt_pt_tpu.core.settings import (AmbientLightType, BSDFOverride,
                                            LightSamplingStrategy,
                                            RenderOptions, WorldSettings)
    from hiprt_pt_tpu.parallel import mesh as jm

    assert len(jax.devices()) >= 8, "conftest should provide 8 cpu devices"
    s = stress
    jopts = RenderOptions(bsdf_override=BSDFOverride.LAMBERTIAN,
                          direct_light_sampling=LightSamplingStrategy.MIS,
                          max_bounces_static=2, do_dispersion=False)
    jworld = WorldSettings(
        ambient_light_type=jnp.int32(int(AmbientLightType.NONE)))
    args = (jopts, W, H, s["jscene"], s["jbvh"], s["jcam"], _settings(True),
            jworld)
    mesh = jm.make_mesh(jax.devices()[:8])
    st = jm.init_sharded_render_state(W, H, mesh)
    first = None
    for i in range(STEPS):
        st = jm.distributed_render(*args, mesh, st)
        if i == 0:
            first = tp.to_numpy_dict(jax.device_get(st))
    smesh = jm.make_sample_mesh(jax.devices()[:2])
    sst = jm.sample_dp_render(*args, smesh,
                              jm.init_sample_dp_state(W, H, smesh, seed=42))
    merged, total = jm.merge_sample_dp(sst)
    return dict(pixel_first=first, accum=np.asarray(jax.device_get(st.accum)),
                rays=float(st.rays_traced),
                sample=tp.to_numpy_dict(jax.device_get(sst)),
                merged=np.asarray(jax.device_get(merged)), total=int(total))


def _one_process(inputs, options, settings, steps, seed=42, state=None,
                 restir=False):
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    scene, cam, bvh = inputs
    if state is None:
        state = init_render_state(W, H, seed, "cpu", with_restir=restir)
    return render_step(options, W, H, scene, bvh, state, cam, settings,
                       _world(), n_samples=steps)


PIXEL_CASES = ["mis", "alpha", "restir", "restir-perm", "restir-fused"]


def _case(name: str):
    """(input, options, settings) of a pixel-DP case: MIS on the
    stress interior and on the alpha scene; ReSTIR DI (temporal reuse, 2
    spatial passes), also with the temporal tap's permutation sampling
    (frame bits from pixel 0's stream) and with the fused spatiotemporal
    pass."""
    if name in ("mis", "alpha"):
        inp = "stress" if name == "mis" else "alpha"
        return inp, _options(), _settings(False)
    opts, settings = _options("RESTIR_DI"), _settings(False)
    if name == "restir-perm":
        settings = settings.replace(restir_di=ts.ReSTIRDISettings(
            temporal_use_permutation_sampling=True))
    if name == "restir-fused":
        opts = opts.replace(restir_di_fused_spatiotemporal=True)
    return "stress", opts, settings
SEQUENCE = dict(size=32, frames=4, spp=2,
                orbit=dict(target=(0.0, 2.0, 0.0), degrees_per_frame=20.0))


def _sequence_config():
    return (_options().replace(max_bounces_static=1),
            ts.RenderSettings(nb_bounces=1, samples_per_frame=SEQUENCE["spp"]))


@pytest.fixture(scope="module")
def renders(stress, alpha):
    """The launch of 4 gloo ranks on the CPU that renders every case that
    needs no JAX state, started in the background (the JAX compiles run
    meanwhile): the pixel-DP cases on 4 ranks and on the first 2, sample
    DP with ReSTIR and with MIS on 2."""
    from hiprt_pt_tpu_torch.parallel import jobs
    from hiprt_pt_tpu_torch.parallel.launch import launch

    runs = []
    for name in PIXEL_CASES:
        inp, opts, settings = _case(name)
        base = dict(input=inp, options=opts, settings=settings,
                    world=_world(), width=W, height=H, samples=STEPS,
                    keep=("accum", "rays_traced"))
        runs += [dict(base, name=f"{name}-4"),
                 dict(base, name=f"{name}-2", ranks=2)]
    sdp = dict(input="stress", mode="samples", ranks=2,
               settings=_settings(False), world=_world(), width=W, height=H,
               keep=("accum",))
    runs += [dict(sdp, name="sdp-restir", options=_options("RESTIR_DI"),
                  samples=SDP_SAMPLES),
             dict(sdp, name="sdp-mis", options=_options(), samples=1)]
    spec = {"device": "cpu", "runs": runs,
            "inputs": {"stress": stress["port"], "alpha": alpha}}
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_by_run, runs, launch, jobs.render, 4, spec)


def _by_run(runs, launch, job, nprocs, spec):
    """{run name: [each rank's report]} of one launch."""
    out = launch(job, nprocs, (spec,), backend="gloo", timeout=600)
    return {r["name"]: [rank[r["name"]] for rank in out] for r in runs}


@pytest.fixture(scope="module")
def launched(renders, jax_runs):
    return renders.result()


@pytest.fixture(scope="module")
def continued(stress, jax_runs, tmp_path_factory):
    """A launch of 2 gloo ranks: the JAX states carried into the port
    continue one step (pixel DP from the shards' rows, sample DP from the
    ranks' slices), and the frame sequence with the group's default
    shares. Returns (reports by run name, the carried states, the
    sequence's folder)."""
    from hiprt_pt_tpu_torch.parallel import jobs
    from hiprt_pt_tpu_torch.parallel.launch import launch

    whole = interop.state_from_numpy(jax_runs["pixel_first"], "cpu")
    slices = [interop.sample_dp_state_from_numpy(jax_runs["sample"], k, "cpu")
              for k in range(2)]
    folder = tmp_path_factory.mktemp("sequence")
    opts, settings = _sequence_config()
    base = dict(input="stress", options=_options(), settings=_settings(False),
                world=_world(), width=W, height=H, samples=1)
    runs = [dict(base, name="carried-pixels", state=whole),
            dict(base, name="carried-samples", mode="samples", state=slices),
            dict(name="sequence", mode="sequence", input="stress",
                 width=SEQUENCE["size"], height=SEQUENCE["size"],
                 options=opts, settings=settings, world=_world(),
                 frames=SEQUENCE["frames"], spp=SEQUENCE["spp"],
                 out_dir=str(folder / "ranks"), orbit=SEQUENCE["orbit"])]
    spec = {"device": "cpu", "runs": runs,
            "inputs": {"stress": stress["port"]}}
    return (_by_run(runs, launch, jobs.render, 2, spec),
            dict(whole=whole, slices=slices), folder)


def _differing(ref_state, digests) -> list:
    from hiprt_pt_tpu_torch.parallel.jobs import state_digests

    ref = state_digests(ref_state)
    assert set(ref) == set(digests)
    return sorted(k for k in ref if ref[k] != digests[k])


# ----------------------------------------------------------------- shards


@pytest.mark.parametrize("width,height,ranks", [
    (32, 16, 1), (32, 16, 2), (32, 16, 4), (64, 48, 3), (1920, 1080, 8),
    (1920, 1080, 2)])
def test_shards_cover_the_image_in_whole_tiles(width, height, ranks):
    from hiprt_pt_tpu_torch.parallel.mesh import shard_bounds

    bounds = [shard_bounds(width, height, ranks, r) for r in range(ranks)]
    assert bounds[0][0] == 0 and bounds[-1][1] == width * height
    for (a, b), (c, _d) in zip(bounds, bounds[1:]):
        assert b == c
    assert all(a % 128 == 0 and b - a == bounds[0][1] - bounds[0][0] > 0
               for a, b in bounds)


@pytest.mark.parametrize("width,height,ranks", [(32, 16, 3), (1920, 1080, 7),
                                                (30, 16, 2)])
def test_a_split_that_is_not_whole_tiles_raises(width, height, ranks):
    from hiprt_pt_tpu_torch.parallel.mesh import shard_bounds

    with pytest.raises(ValueError, match="tiles"):
        shard_bounds(width, height, ranks, 0)


def test_mesh_and_step_refuse_what_does_not_fit():
    """make_mesh needs a process group; a render step refuses a state that
    does not hold its shard's pixels."""
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.ops.pixel_order import PixelRange
    from hiprt_pt_tpu_torch.parallel.mesh import make_mesh
    from hiprt_pt_tpu_torch.render.renderer import render_step

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")
    shard = PixelRange(W, H, 0, 256)
    with pytest.raises(ValueError, match="256"):
        render_step(_options(), W, H, None, None,
                    init_render_state(W, H, device="cpu"), None,
                    _settings(False), _world(), shard=shard)


def test_frame_assignment_matches_jax():
    from hiprt_pt_tpu.parallel.frames import frame_assignment as jfa
    from hiprt_pt_tpu_torch.parallel.frames import frame_assignment

    for frames in (0, 1, 4, 7, 10):
        for count in (1, 2, 3, 4):
            for index in range(count):
                assert frame_assignment(frames, index, count) == jfa(
                    frames, index, count)
    # no process group here: the whole sequence, as JAX's one process
    assert frame_assignment(5) == jfa(5) == [0, 1, 2, 3, 4]


# ------------------------------------------------------------ pixel DP


@pytest.mark.parametrize("ranks", [4, 2])
@pytest.mark.parametrize("name", PIXEL_CASES)
def test_pixel_dp_is_one_process_bit_for_bit(launched, stress, alpha, name,
                                             ranks):
    reports = launched
    rep = reports[f"{name}-{ranks}"]
    assert [r is not None for r in rep] == [r < ranks for r in range(4)]
    assert {r["backend"] for r in rep[:ranks]} == {"gloo"}
    inp, opts, settings = _case(name)
    ref = _one_process(stress["port"] if inp == "stress" else alpha, opts,
                       settings, STEPS, restir=opts.direct_light_sampling
                       == ts.LightSamplingStrategy.RESTIR_DI)
    assert _differing(ref, rep[0]["digests"]) == []
    # the counters are the image's, and adaptive sampling skipped pixels
    assert int(rep[0]["arrays"]["rays_traced"]) == int(ref.rays_traced) > 0
    assert 0 < int(ref.pixel_sample_count.min()) < STEPS


def test_the_march_runs_segments_a_rank_has_no_ray_for(launched):
    """The alpha march's segment skip is the image's: on 4 ranks (and on
    2) some rank runs a segment with none of its own shadow rays searching,
    and every rank runs as many segments as the others."""
    reports = launched
    for ranks in (4, 2):
        rep = reports[f"alpha-{ranks}"][:ranks]
        assert len({r["segments"] for r in rep}) == 1
        assert rep[0]["segments"] > 0
        assert max(r["idle_segments"] for r in rep) > 0, rep


# ------------------------------------------------------------ sample DP


def test_sample_dp_ranks_are_one_process_renders_with_their_seeds(launched,
                                                                  stress):
    reports = launched
    rep = reports["sdp-restir"]
    accums = []
    for k in range(2):
        ref = _one_process(stress["port"], _options("RESTIR_DI"),
                           _settings(False), SDP_SAMPLES,
                           seed=42 + SEED_STRIDE * k, restir=True)
        assert ref.restir is not None
        assert _differing(ref, rep[k]["digests"]) == []
        accums.append(ref.accum.numpy())
    np.testing.assert_allclose(rep[0]["merged"], np.mean(accums, axis=0),
                               rtol=1e-6, atol=0.0)
    assert rep[0]["total"] == 2 * SDP_SAMPLES
    assert not np.array_equal(rep[0]["arrays"]["accum"],
                              rep[1]["arrays"]["accum"])


# ------------------------------------------------------- against JAX


def test_pixel_dp_agrees_with_jax_distributed_render(launched, jax_runs):
    reports = launched
    got = reports["mis-4"][0]["arrays"]
    assert_images_agree(got["accum"], jax_runs["accum"],
                        int(got["rays_traced"]), jax_runs["rays"])


def test_sample_dp_merge_agrees_with_jax(launched, jax_runs):
    reports = launched
    rep = reports["sdp-mis"][0]
    assert rep["total"] == jax_runs["total"] == 2
    got, ref = rep["merged"], jax_runs["merged"]
    close = np.all(np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref), axis=-1)
    assert close.mean() >= 0.98
    assert abs(got.mean() - ref.mean()) <= 0.01 * abs(ref.mean())


def test_jax_pixel_shards_continue_in_the_port(continued, stress, jax_runs):
    """The JAX package's pixel-sharded state after one step: each shard's
    rows carried into the port (interop.shard_state_from_numpy, here for
    4 shards) are the whole carried state's, which continues on 2 ranks as
    in one process."""
    from hiprt_pt_tpu_torch.parallel.mesh import shard_bounds

    reports, carried, _ = continued
    whole = carried["whole"]
    for k in range(4):
        a, b = shard_bounds(W, H, 4, k)
        rows = interop.shard_state_from_numpy(jax_runs["pixel_first"], a, b,
                                              "cpu")
        np.testing.assert_array_equal(rows.accum.numpy(),
                                      whole.accum.numpy()[a:b])
        assert int(rows.rays_traced) == int(whole.rays_traced)
    ref = _one_process(stress["port"], _options(), _settings(False), 1,
                       state=whole)
    assert ref.sample_count == 2
    assert _differing(ref, reports["carried-pixels"][0]["digests"]) == []


def test_jax_sample_dp_slices_continue_in_the_port(continued, stress,
                                                   jax_runs):
    """The JAX package's sample-DP state after one step: rank k's slice
    (interop.sample_dp_state_from_numpy, seed 42 + 9176·k) continues on
    rank k as in one process."""
    reports, carried, _ = continued
    for k, sl in enumerate(carried["slices"]):
        assert sl.seed == 42 + SEED_STRIDE * k and sl.sample_count == 1
        np.testing.assert_array_equal(
            sl.accum.numpy(), jax_runs["sample"]["accum"][k])
        ref = _one_process(stress["port"], _options(), _settings(False), 1,
                           state=sl)
        assert _differing(ref, reports["carried-samples"][k]["digests"]) == []


# ------------------------------------------------------- frame sequences


def test_sequence_split_is_one_process_byte_for_byte(stress, continued,
                                                    tmp_path):
    """Two explicit shares, and 2 gloo ranks with the group's default
    shares, write the PNGs of one process."""
    from hiprt_pt_tpu_torch.parallel.frames import render_distributed_sequence
    from hiprt_pt_tpu_torch.render.animation import CameraOrbitAnimation
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    scene, cam, bvh = stress["port"]
    opts, settings = _sequence_config()
    size, frames = SEQUENCE["size"], SEQUENCE["frames"]

    def share(index, count, folder):
        r = Renderer(scene, cam, size, size, options=opts, settings=settings,
                     world=_world(), bvh=bvh)
        return render_distributed_sequence(
            r, frames, SEQUENCE["spp"], str(tmp_path / folder),
            camera_animation=CameraOrbitAnimation(**SEQUENCE["orbit"]),
            process_index=index, process_count=count)

    single = share(0, 1, "all")
    p0, p1 = share(0, 2, "p0"), share(1, 2, "p1")
    ranks = continued[0]["sequence"]
    assert len(single) == frames and len(p0) == len(p1) == 2
    assert [len(r["paths"]) for r in ranks] == [2, 2]
    for path in p0 + p1 + ranks[0]["paths"] + ranks[1]["paths"]:
        name = os.path.basename(path)
        with open(path, "rb") as a, open(tmp_path / "all" / name, "rb") as b:
            assert a.read() == b.read(), name
    pngs = []
    for p in single:
        with open(p, "rb") as f:
            pngs.append(f.read())
    assert len(set(pngs)) == frames  # the camera moves


def test_a_rank_that_raises_fails_the_launch(stress):
    """Rank 1 of a sample-DP run is given no state and raises while rank 0
    waits for it in the merge's collective: the launch raises rank 1's
    exception and stops rank 0 instead of hanging."""
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.parallel import jobs
    from hiprt_pt_tpu_torch.parallel.launch import launch

    run = dict(name="broken", input="stress", mode="samples",
               options=_options(), settings=_settings(False), world=_world(),
               width=W, height=H, samples=1,
               state=[init_render_state(W, H, device="cpu"), None])
    spec = {"device": "cpu", "runs": [run],
            "inputs": {"stress": stress["port"]}}
    with pytest.raises(AttributeError):
        launch(jobs.render, 2, (spec,), backend="gloo", timeout=120)
