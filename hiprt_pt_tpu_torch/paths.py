"""The nine paths that chip_smoke.py drives and profile_frame.py profiles:
each path's scene, camera, BVH and render options, at the 16:9 aspect of a
1920x1080 frame; for the cli path also its command line.

- ``stress``: the procedural stress interior (259,120 triangles, 120
  emitters), Lambertian override, MIS NEE; camera rays and the first
  bounce's shadow rays go through trace_coherent, the others through
  trace_incoherent.
- ``cornell``: the procedural Cornell box with seven principled spheres
  (assets/cornell.py, 35,852 triangles), the full principled BSDF with
  dispersion and thin film, MIS NEE; every ray goes through trace_meganode.
- ``stress14``: bench.py's headline configuration at 8x the triangles: the
  stress interior at tri_scale=14 (2,042,048 triangles, 120 emitters, 18
  textures), the full principled BSDF, RIS; trace_stream8 and
  trace_lane8log.
- ``headline``: bench.py's headline configuration itself (bench.py:112-134;
  cell ``stress-1080p-principled-ris``): the stress interior at tri_scale=1
  (259,120 triangles, 120 emitters, 18 textures), the full principled BSDF,
  RIS; trace_coherent and trace_incoherent.
- ``restir``: bench.py's ReSTIR row (bench.py:175-187; cell
  ``stress-1080p-principled-restir``): the headline's scene and options
  with RESTIR_DI at the camera vertex (the defaults: temporal reuse, then 2
  spatial passes of 3 neighbours, pairwise-MIS-defensive bias correction,
  confidence weights, the proxy target, a presampled pool of 128 x 1,024
  lights; initial, last-spatial-pass and final visibility) and RIS at the
  later vertices; trace_coherent and trace_incoherent (ReSTIR's visibility
  rays take the incoherent route).
- ``envmap``: benchmarks/run_configs.py's config 3
  (``3-principled-alias-envmap``, run_configs.py:167-181; cell
  ``cornell-1080p-principled-envmap``) on the Cornell path's scene (its
  glTF scene is absent): the procedural Cornell box with its emitters and
  ``build_envmap(make_test_envmap(64, 128, "sky"))``, whose light enters
  through the box's open front; the full principled BSDF, MIS NEE,
  ALIAS_TABLE envmap sampling with BSDF MIS, 6 bounces, ambient ENVMAP at
  intensity 1 and identity rotations; every ray, the envmap's any-hit
  shadow rays to t_max = inf among them, goes through trace_meganode.
- ``gltf``: the headline configuration reached through the system's normal
  entry point, a scene file: the stress interior at tri_scale=1 (259,120
  triangles, 120 emitters, 18 textures) written as a binary glTF
  (assets/gltf_testscene.py:write_glb) with its camera as a camera node and
  cutouts on the materials of its large occluders (GLTF_CUTOUTS: the brick
  walls, the columns and the tables), loaded back with
  assets/loader.py:load_scene_file (thread pipeline, BVH on its thread).
  The cutouts give the scene alpha textures, so every emissive shadow ray
  takes the alpha-aware march (ops/traverse.py:occluded_alpha): an any-hit
  prune and closest-hit segments; bench.py's make_renderer options (RIS);
  trace_coherent and trace_incoherent.
- ``cli``: the system's documented command (README.md: ``python -m
  hiprt_pt_tpu.app.cli ... --strategy=restir --denoise``) through the
  port's app/cli.py on the gltf path's scene file: ``cli_argv`` gives
  ``python -m hiprt_pt_tpu_torch.app.cli stress.glb`` the flags of
  CLI_FLAGS (ReSTIR DI, the à-trous denoiser, 4 bounces, 4 samples in
  frames of 2 at 1920x1080) and writes a PNG, an HDR and a checkpoint.
  Cut against the README's command: 4 samples, not 256; 4 bounces, as
  bench.py's headline, not 8; 1920x1080, as every path, not 1280x720.
  ReSTIR's visibility rays take the alpha march; the world keeps the
  CLI's default uniform ambient; trace_coherent and trace_incoherent.
- ``viewer``: the system's second documented entry point (README.md:
  ``ViewerServer(Renderer(scene, cam, 1280, 720), port=8000).serve()`` on
  ``load_scene_file(..., aspect=16/9)``) through the port's app/viewer.py
  on the gltf path's scene file: the default RenderOptions (the principled
  BSDF, MIS) and RenderSettings (8 bounces) in the default world (uniform
  ambient), at 1920x1080 (the README has 1280x720); its presets switch to
  RIS at half the grid and to ReSTIR DI. trace_coherent and
  trace_incoherent.
- The ``parallel`` runs (parallel_runs; not one of PATHS, which one
  process profiles): the system's multi-process rendering (parallel/, one
  process a rank on torch.distributed) on the scenes above, in
  PARALLEL_RANKS ranks: pixel DP of the gltf path at
  1920x1080 (its scene loaded by rank 0 and replicated; the alpha march's
  segment skip and the counters the image's), sample DP of the restir
  path at 1920x1080 (each rank its own seed), pixel DP of the restir path
  at 256x128 (ReSTIR's neighbours across the shards) and the
  frame-sequence split of a camera orbit on the Cornell path at 256x144.
  trace_coherent and trace_incoherent, and trace_meganode in the
  sequence.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from .core.device import resolve_device

PATHS = ("stress", "cornell", "stress14", "headline", "restir", "envmap",
         "gltf", "cli", "viewer")
# the kernels that serve each path's (coherent, incoherent) rays
ROUTES = {"stress": ("trace_coherent", "trace_incoherent"),
          "cornell": ("trace_meganode", "trace_meganode"),
          "stress14": ("trace_stream8", "trace_lane8log"),
          "headline": ("trace_coherent", "trace_incoherent"),
          "restir": ("trace_coherent", "trace_incoherent"),
          "envmap": ("trace_meganode", "trace_meganode"),
          "gltf": ("trace_coherent", "trace_incoherent"),
          "cli": ("trace_coherent", "trace_incoherent"),
          "viewer": ("trace_coherent", "trace_incoherent")}
# the paths with the principled BSDF and textures under RIS or ReSTIR
# (bench.py's make_renderer)
_RIS_PATHS = ("stress14", "headline", "restir", "gltf", "cli")
ASPECT = 16 / 9
# the gltf path's alpha (MASK) materials, generate_stress_scene's large
# occluders: m_brick and m_brick2 (the four walls), m_column (the 12
# columns) and m_table (the 15 tables, boxes)
GLTF_CUTOUTS = (2, 3, 4, 17)
# the cli path's flags, after the scene file
CLI_FLAGS = ("--strategy=restir", "--denoise", "--w=1920", "--h=1080",
             "--bounces=4", "--samples=4", "--spp-per-frame=2")
# the parallel path: its ranks, the paths whose scenes its runs render
# (rank 0 loads each), and its sequence's size, frames, samples a frame and
# orbit (about the Cornell camera's target)
PARALLEL_RANKS = 2
PARALLEL_INPUTS = ("gltf", "restir", "cornell")
PARALLEL_SEQUENCE = dict(width=256, height=144, frames=4, spp=2,
                         orbit=dict(target=(0.0, 0.9, 0.0),
                                    degrees_per_frame=20.0))


def cli_argv(scene_file: str, folder: str) -> list:
    """The cli path's arguments to app/cli.py: ``scene_file``, CLI_FLAGS,
    and the PNG, HDR and checkpoint it writes into ``folder`` (cli.png,
    cli.hdr, cli.npz)."""
    out = os.path.join(folder, "cli")
    return [scene_file, *CLI_FLAGS, f"--out={out}.png", f"--hdr-out={out}.hdr",
            f"--checkpoint={out}.npz"]


def parallel_runs(folder: str) -> list:
    """The parallel runs (parallel/jobs.py:render): "pixels-gltf", pixel
    DP of the gltf path at 1920x1080, one warm-up sample, one whose
    collectives are timed with the device synchronised, and 2 timed ones;
    "samples-restir", sample DP of the restir path at 1920x1080, 2 samples
    a rank; "pixels-restir", pixel DP of the restir path at 256x128, 3
    samples (temporal reuse reads the G-buffer of the sample before the
    last, as in the JAX package, so it finds one from the third; spatial
    taps cross the shards); "sequence-cornell", the Cornell path's options
    at PARALLEL_SEQUENCE, its PNGs written into ``folder``."""
    gltf = dict(zip(("options", "settings", "world"), slice_options("gltf")))
    restir = dict(zip(("options", "settings", "world"),
                      slice_options("restir")))
    opts, settings, world = slice_options("cornell")
    seq = dict(PARALLEL_SEQUENCE)
    return [
        dict(name="pixels-gltf", input="gltf", width=1920, height=1080,
             warmup=1, synced=1, samples=2, **gltf),
        dict(name="samples-restir", input="restir", mode="samples",
             width=1920, height=1080, samples=2, keep=("accum",), **restir),
        dict(name="pixels-restir", input="restir", width=256, height=128,
             samples=3, **restir),
        dict(name="sequence-cornell", input="cornell", mode="sequence",
             options=opts, world=world, out_dir=folder,
             settings=settings.replace(samples_per_frame=seq["spp"]), **seq),
    ]


def write_gltf_scene(folder: str) -> str:
    """Write the gltf path's scene into ``folder`` as ``stress.glb``: the
    stress interior (generate_stress_scene(seed=7, tri_scale=1.0,
    num_emitters=120, texture_size=256)) with its camera and GLTF_CUTOUTS;
    returns the file's path."""
    from .assets.gltf_testscene import write_glb
    from .assets.stress import generate_stress_scene

    parsed = generate_stress_scene(seed=7, tri_scale=1.0, num_emitters=120,
                                   texture_size=256)
    out = os.path.join(folder, "stress.glb")
    write_glb(out, parsed, alpha_materials=GLTF_CUTOUTS)
    return out


def load(path: str, device=None):
    """(scene, camera, bvh, seconds) of a path on ``device`` (default: the
    GPU); ``seconds`` holds the host set-up times, {"scene": building the
    scene, "bvh": building the BVH and moving its tables to the device}; on
    the gltf, cli and viewer paths {"write": generating and writing the
    .glb, and load_scene_file's stages: "parse", "images", "atlas", "bvh",
    "scene" and "total"}."""
    from .accel.build import build_bvh
    from .assets.cornell import cornell_spheres_arrays
    from .assets.envmap import build_envmap, make_test_envmap
    from .assets.scene import build_scene
    from .assets.stress import load_stress_scene
    from .core.camera import camera_from_lookat
    from .core.material import MaterialBank

    if path not in PATHS:
        raise ValueError(f"unknown path {path!r}; the paths are {PATHS}")
    device = resolve_device(device)
    t0 = time.perf_counter()
    if path in ("gltf", "cli", "viewer"):
        from .assets.loader import load_scene_file

        with tempfile.TemporaryDirectory() as tmp:
            glb = write_gltf_scene(tmp)
            secs = {"write": time.perf_counter() - t0}
            scene, cam, bvh = load_scene_file(glb, aspect=ASPECT, parallel=True,
                                              with_bvh=True, device=device,
                                              timings=secs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return scene, cam, bvh, secs
    if path in ("cornell", "envmap"):
        v, f, m, rows, cam_kw = cornell_spheres_arrays(ASPECT)
        envmap = (build_envmap(make_test_envmap(64, 128, "sky"), device=device)
                  if path == "envmap" else None)
        scene = build_scene(v, f, m, MaterialBank.from_rows(rows),
                            envmap=envmap, device=device)
        cam = camera_from_lookat(**cam_kw, device=device)
    else:
        scene, cam = load_stress_scene(
            aspect=ASPECT, seed=7, tri_scale=14.0 if path == "stress14" else 1.0,
            num_emitters=120, with_textures=path in _RIS_PATHS, device=device)
        v, f = scene.vertices.cpu().numpy(), scene.triangles.cpu().numpy()
    t1 = time.perf_counter()
    bvh = build_bvh(v, f, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    return scene, cam, bvh, {"scene": t1 - t0, "bvh": t2 - t1}


def slice_options(path: str):
    """(RenderOptions, RenderSettings, WorldSettings) of a path. The stress
    path: Lambertian override, no dispersion, MIS NEE. The Cornell path: the
    defaults, i.e. the full principled BSDF with dispersion and thin film,
    MIS NEE. The 2.04M-triangle path and the headline path: bench.py's
    make_renderer, i.e. the defaults with RIS (4 light + 1 BSDF candidate,
    proxy target, 128-ray light tiles); so does the gltf path. The ReSTIR
    path: the same with RESTIR_DI and the default ReSTIRDISettings. All
    these with 4 bounces, one sample per frame and ambient NONE. The cli
    path: what app/cli.py builds from CLI_FLAGS, the ReSTIR path's options
    at 2 samples a frame in the default world (ambient UNIFORM). The
    envmap path: run_configs.py's
    config 3, i.e. the Cornell path's options with ALIAS_TABLE envmap
    sampling and BSDF MIS, 6 bounces, one sample per frame and ambient
    ENVMAP. The viewer path: the defaults of all three, as the README's
    viewer command builds its Renderer."""
    from .core.settings import (AmbientLightType, BSDFOverride,
                                EnvmapSamplingStrategy, LightSamplingStrategy,
                                RenderOptions, RenderSettings, WorldSettings)

    if path == "viewer":
        return RenderOptions(), RenderSettings(), WorldSettings()
    opts = RenderOptions(direct_light_sampling=LightSamplingStrategy.MIS,
                         max_bounces_static=4)
    if path == "stress":
        opts = opts.replace(bsdf_override=BSDFOverride.LAMBERTIAN,
                            do_dispersion=False)
    else:
        assert opts.bsdf_override == BSDFOverride.NONE
        assert opts.do_dispersion and opts.do_thin_film
    if path in _RIS_PATHS:
        opts = opts.replace(direct_light_sampling=LightSamplingStrategy.RIS_BSDF_LIGHT)
        assert opts.ris_proxy_target and opts.ris_tile_light_candidates == 128
    if path in ("restir", "cli"):
        opts = opts.replace(direct_light_sampling=LightSamplingStrategy.RESTIR_DI)
        assert not opts.restir_di_fused_spatiotemporal
    if path == "cli":
        return (opts, RenderSettings(nb_bounces=4, samples_per_frame=2),
                WorldSettings())
    if path == "envmap":
        opts = opts.replace(envmap_sampling=EnvmapSamplingStrategy.ALIAS_TABLE,
                            envmap_bsdf_mis=True, max_bounces_static=6)
        return (opts, RenderSettings(nb_bounces=6, samples_per_frame=1),
                WorldSettings(ambient_light_type=int(AmbientLightType.ENVMAP)))
    settings = RenderSettings(nb_bounces=4, samples_per_frame=1)
    world = WorldSettings(ambient_light_type=int(AmbientLightType.NONE))
    return opts, settings, world
