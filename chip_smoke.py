#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hiprt_pt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (any failure exits non-zero):
  1. device   — require CUDA; print the card's name and power limit.
  2. build    — compile every CUDA source of the port at once (nvcc, one per
                source: the five traversal kernels, the two probes, the
                emissive sweep and the principled BSDF's eval and sample)
                and the BVH build library (g++); print what ptxas says of
                every kernel (a spill in trace_coherent, trace_incoherent,
                trace_meganode, trace_stream8, dg_probe_kernel,
                emissive_sweep_kernel or the principled BSDF's two kernels
                fails the phase), and the registers per thread, local and
                shared memory and resident blocks per SM of every kernel
                of the registry (ops/cuda_build.py:KERNELS).
  2b. sweep   — the dense emissive sweep (csrc/emissive_sweep.cu) against
                its plain version on the stress interior's 240 emitters at
                2,073,600 and 518,400 rays (the 1080p wavefront, a pixel-DP
                rank's quarter): t and slot equal on every lane, one launch a
                call; the kernel's and the plain version's ms and the bound
                (a triangle test a pair at 67 TFLOP/s, or 37 B a ray at
                3.35 TB/s). These launches are the phase's own: the kernels
                line counts the main path's, from the slices (5.), the cli
                (7.), the viewer (7b.) and the ranks (10.), whose RIS and
                ReSTIR frames must launch it once a bounce, and ReSTIR
                once more (sweeps_per_frame).
  2c. bsdf    — the principled BSDF's kernels (csrc/principled.cu) against
                the plain version on the card at 2,073,600 and 518,400
                lanes of the stress interior's 138 materials (ids drawn at
                random), wo above the normal, wi over the sphere, relative
                IORs on both sides of 1, under the default options: the RNG
                state equal on every lane; on >= 99.99% of lanes eval's f
                and pdf within atol 1e-6 / rtol 1e-5, and sample's drawn
                lobe and refracted flag equal and its wi, f and pdf within
                the same; one launch a call; each kernel's and the plain
                version's ms, the bound (the lane's bytes at 3.35 TB/s;
                the plain version's f32 operations a lane at 67 TFLOP/s
                are printed beside it, an upper count that sets no
                bound), registers, local and shared memory and blocks an
                SM (a spill fails the build phase). The slices (5.), the
                cli (7.), the viewer (7b.) and the parallel ranks (10.)
                must launch them as bsdf_calls_per_frame says.
  Then, for each of the first seven paths of hiprt_pt_tpu_torch/paths.py:
  3. scene    — the path's scene and BVH (paths.load), with the host set-up
                times, the tables on the card and the router's decisions,
                which must be the path's routes (paths.ROUTES).
  4. kernels  — each kernel of the path against its plain PyTorch version
                on the card, on each ray kind: camera rays, cosine bounce
                rays from the camera hits, and shadow rays from the camera
                hits toward a point on an emissive triangle drawn as the
                path draws it (per ray under MIS, a triangle per 128-ray
                tile under RIS), t_max at the light; on the envmap path
                also envmap shadow rays from the camera hits toward the
                directions the envmap's alias table draws, t_max = inf
                (held in both modes, t bit-identical where the prims agree,
                and 1,024 of them against brute force); on the ReSTIR path
                ReSTIR's visibility rays instead, in a second frame: those
                of visibility reuse (toward the initial candidates'
                winners, many of them occluded) and those of final shading
                (reservoirs with temporal history, winners from
                neighbours' reservoirs, the last spatial pass having
                zeroed the occluded ones), and a shadow
                wavefront with every ray inactive, as the first bounce's
                masked RIS sends it. Closest and any-hit
                (shadow and ReSTIR rays: any-hit) on 65,536 rays and on the full
                1920x1080 wavefront, with finite t_max and inactive rays;
                1,024 camera or bounce rays also against brute force; then
                the kernel's and the plain version's time and the kernel's
                bound on each (kernel, ray kind) at 1080p; for
                trace_coherent the share of its 32-ray packets that left
                packet mode.
  5. slice    — the renderer at 1920x1080 with the path's options and
                bounce count (paths.slice_options): one warm-up frame and 4
                timed frames. Launch counts are reset just before and read
                just after; the path's kernels, and no other, must launch,
                as many times per frame and ray kind as render/integrator.py
                issues them.
  6. parity   — one sample at 256x128 rendered on the GPU and on the CPU
                (plain traversal), compared per pixel; on the headline and
                ReSTIR paths also on the GPU with use_pallas_traversal off
                (the plain walks on the card, which must launch no kernel),
                compared with both. The ReSTIR path renders 2 samples, so
                that temporal reuse has a frame before it, and holds the
                fused spatiotemporal mode's GPU render against the CPU's
                too; the envmap path renders with the alias table and with
                the CDF's binary search (run_configs.py config 2's
                strategy), GPU vs CPU, and with the plain walks on the
                card.
  6b. renderer — on the envmap path only, the Renderer's frame loop at
                1920x1080: step(block=True) and its metrics beside the
                frame's CUDA-event time, the host syncs of a step by
                line, frame_render_done() False on a frame that ends in a
                device sleep and True after a synchronise, render(total_samples=3) stopping at
                max_sample_count=2, profile() (leaving the live state as it
                was), kernel_stats() (the routed kernel's registers and
                resident blocks from its *_info function, the launch
                counts, the peak memory), ldr_image and aov_images.
  The paths: the stress interior (259,120 triangles; trace_coherent,
  trace_incoherent), the Cornell box with seven principled spheres (35,852
  triangles; trace_meganode), the stress interior at tri_scale=14
  (2,042,048 triangles, textures, RIS; trace_stream8, trace_lane8log) and
  the headline configuration of bench.py (the stress interior at
  tri_scale=1 with textures, the principled BSDF and RIS; trace_coherent,
  trace_incoherent; its geometry is the stress path's, so its kernel phase
  holds only the ray kind that is new, RIS's tile-shared shadow rays) and
  bench.py's ReSTIR row (the headline's scene and options with ReSTIR DI at
  the camera vertex; trace_coherent, trace_incoherent; its kernel phase
  holds the ray kind that is new, ReSTIR's visibility rays) and
  run_configs.py's config 3 (the Cornell box with the "sky" test envmap,
  the principled BSDF, MIS, alias-table envmap sampling with BSDF MIS, 6
  bounces; trace_meganode, the envmap's shadow rays a new kind).
  7. cli      — the eighth path, the system's documented command
                (paths.cli_argv: python -m hiprt_pt_tpu_torch.app.cli on
                the gltf path's .glb with ReSTIR DI, the à-trous denoiser,
                4 bounces, 4 samples in frames of 2 at 1920x1080, a PNG, an
                HDR and a checkpoint): e. main(argv) in this process with
                the launch counts reset just before and read just after,
                trace_coherent, trace_incoherent and the emissive sweep
                held against frame_launches for each sample (plus the
                march's segments), ms/frame and spp/s from
                Renderer.metrics, the seconds of load, BVH, render,
                denoise and the files, peak device memory; d. à-trous
                with and without the variance maps and the CNN on its
                1080p AOVs, card against CPU, with ms between CUDA events
                and host launches a call; a. the
                same command as a subprocess (exit 0, the PNG decodes to
                1920x1080x3); c. the command at 256x144 and 2 samples on
                the card and with --cpu (a second subprocess, beside the
                first and the in-process runs), raw and denoised HDR
                under the image gate; b. 2 samples with
                --checkpoint, then --resume to 4, against e's state leaf by
                leaf (bit-identical, or the image gate and the leaves that
                differ).
  7b. viewer  — the ninth path, the system's second documented entry point
                (README.md: ViewerServer(Renderer(scene, cam, ...)).serve()
                on load_scene_file(aspect=16/9)) on the gltf path's .glb
                at 1920x1080 with the default options and settings (MIS,
                the principled BSDF, 8 bounces): first the Precompiler on
                the six permutations, cold (a fresh build directory) and
                warm; then, with the launch counts reset just before serve
                and read after stop: the render loop's quiet frames, the
                page, the nine views and /stats over HTTP on a free port
                (frame times while they are served), the served beauty
                image against ldr_image() of the same state, the panels,
                /perf?passes=1, the camera controls, settings, material and
                option edits, the presets fastest (RIS at 960x536) and
                high_quality (ReSTIR DI), whose renderers keep every edit,
                /bake and /animate polled to done, stop() ending both
                threads; trace_coherent, trace_incoherent and (under the
                presets) the emissive sweep must launch.
  8. probes   — the round-5 gather probes (hiprt_pt_tpu_torch/probes/
                r5probe2.py), a path with no frame: its entry point main()
                at the TPU probe's shapes with the launch counts reset just
                before and read just after; each probe kernel against its
                plain version on seeded gate inputs at all seven probe
                configurations (exactly equal, and bit for bit the same
                in a second run), at shapes off mm_probe_kernel's tile, and
                on the probe's own inputs (the constant); kernel, plain
                and library times and the bounds at the probe shapes;
                dg_probe_kernel also on a table past the shared-memory
                size (its L2 kernel).
  9. bake     — the LUT baker and the sheen LTC fit, a path with no frame:
                bake_all into a temporary directory on the card (the seven
                tables at its sizes, each timed), each bake on the card
                against the CPU at res 4 and 256 samples, the five shipped
                tables against the fresh ones (within 0.02, beside the JAX
                package's own gap); run_fit at 32,768 paths, 200 steps
                over the 32x32 cells against the shipped table within
                twice the JAX package's seed-to-seed spread, fit_poly of
                it, the SGGX self-test (every |e| < 0.02).
  10. parallel — the tenth path, parallel/ (paths.parallel_runs) in
                paths.PARALLEL_RANKS spawned ranks (parallel/launch.py;
                NCCL with a card a rank, else gloo on cuda:0, printed):
                a. pixel DP of the gltf path at 1920x1080, rank 0 loading
                the .glb and replicating it, one warm-up sample, one
                whose collectives are timed with the device synchronised
                around each, and 2 timed samples, the gathered state
                bit-identical to this process's 4 samples, per rank ms a
                frame beside this process's, ms a frame in collectives,
                launches, march segments and those with none of the
                rank's own rays searching; b. sample DP of the
                restir path at 1920x1080, 2 samples a rank, each rank's
                state bit-identical to this process's render with seed
                42 + 9176·rank, the merge within rtol 1e-6 of their mean,
                the total, the ranks' images different; c. pixel DP of the
                restir path at 256x128, 3 samples (temporal reuse finds a
                G-buffer from the third), bit-identical; d. a camera orbit
                of the Cornell path at 256x144 split over the ranks, its
                PNGs byte-identical. The ranks' launches count in the
                kernels line; in a. and b. each rank's emissive sweeps are
                held to its samples x sweeps_per_frame.
The lines before the last hold one row per (kernel, ray kind) and the
kernels' JSON summary (each kernel's time on the 1080p rays it serves on
its path, or on its probe's reference configuration, its plain version's,
a library call's where one computes the same, and its bound: for a
traversal kernel the larger of the f32 operations of the plain walk on
those rays at 67 TFLOP/s and the bytes of rays, hit records and tables at
3.35 TB/s); the last line is the run's JSON result. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from hiprt_pt_tpu_torch.core.device import cuda_ms
from hiprt_pt_tpu_torch.ops import cuda_build
# each traversal kernel's tables and its plain PyTorch version (ops/traverse.py)
from hiprt_pt_tpu_torch.ops.routing import KERNEL_TABLES, PLAIN_WALKS as PLAIN
from hiprt_pt_tpu_torch.ops.traverse import alpha_shadows

WIDTH, HEIGHT = 1920, 1080
PARITY_RAYS = 65536
BRUTE_RAYS = 1024
# kernel vs plain on the card: prim agreement, t rtol where the prims agree
AGREE_MIN = 0.9999
T_RTOL = 1e-5
# GPU vs CPU render, as in tests/test_torch_render.py: per-pixel radiance
# within atol + rtol on >= PIX_FRAC of the pixels, image mean within 1%,
# rays traced within 0.5%
PIX_ATOL, PIX_RTOL, PIX_FRAC = 1e-3, 1e-3, 0.98

KERNELS = {
    "trace_coherent": "hiprt_pt_tpu/ops/pallas_traverse.py:381",
    "trace_incoherent": "hiprt_pt_tpu/ops/pallas_traverse.py:1866",
    "trace_meganode": "hiprt_pt_tpu/ops/pallas_traverse.py:55",
    "trace_stream8": "hiprt_pt_tpu/ops/pallas_traverse.py:724",
    "trace_lane8log": "hiprt_pt_tpu/ops/pallas_traverse.py:1331",
    "mm_probe_kernel": "benchmarks/r5probe2.py:58",
    "dg_probe_kernel": "benchmarks/r5probe2.py:112",
}
SOURCE = {k: "hiprt_pt_tpu_torch/csrc/traverse.cu" for k in KERNELS} | {
    "trace_stream8": "hiprt_pt_tpu_torch/csrc/traverse8.cu",
    "trace_lane8log": "hiprt_pt_tpu_torch/csrc/traverse8.cu",
    "mm_probe_kernel": "hiprt_pt_tpu_torch/csrc/probes.cu",
    "dg_probe_kernel": "hiprt_pt_tpu_torch/csrc/probes.cu"}
# the (kernel, ray kind) pairs each path holds against the plain version,
# times and bounds: every kind the path sends each kernel, and on the
# 2.04M-triangle path the kinds it does not (K4 on bounce rays, K5 on
# camera rays; on the stress path K1 on camera rays beside K2) for comparison
STRESS_CASES = (("trace_coherent", "camera"), ("trace_coherent", "shadow"),
                ("trace_incoherent", "bounce"), ("trace_incoherent", "shadow"),
                ("trace_incoherent", "camera"))
CORNELL_CASES = tuple(("trace_meganode", kind)
                      for kind in ("camera", "bounce", "shadow"))
STRESS14_CASES = tuple((k, kind) for k in ("trace_stream8", "trace_lane8log")
                       for kind in ("camera", "bounce", "shadow"))
HEADLINE_CASES = (("trace_coherent", "shadow"), ("trace_incoherent", "shadow"))
RESTIR_CASES = (("trace_coherent", "masked"), ("trace_incoherent", "initial"),
                ("trace_incoherent", "restir"))
ENVMAP_CASES = tuple(("trace_meganode", kind)
                     for kind in ("camera", "bounce", "shadow", "envmap"))
# the gltf path: only the alpha march's two ray kinds, which no other path
# sends (its camera, bounce and shadow rays are the headline's kinds)
GLTF_CASES = tuple((k, kind) for k in ("trace_coherent", "trace_incoherent")
                   for kind in ("prune", "segment"))
PATH_CASES = (("stress", STRESS_CASES), ("cornell", CORNELL_CASES),
              ("stress14", STRESS14_CASES), ("headline", HEADLINE_CASES),
              ("restir", RESTIR_CASES), ("envmap", ENVMAP_CASES),
              ("gltf", GLTF_CASES))
# the ray kinds the path traces any-hit: shadow rays, the ReSTIR path's
# first bounce's shadow rays (every one inactive), its visibility rays (of
# visibility reuse, "initial"; of the last spatial pass and final shading,
# "restir"), the envmap's shadow rays ("envmap") and the alpha march's
# alpha-blind prune of the shadow rays ("prune"); the march's segments
# ("segment": closest hits from origins moved past a surface the ray
# passed through, t_max what is left of the shadow ray) are closest-hit
ANY_HIT_KINDS = ("shadow", "masked", "initial", "restir", "envmap", "prune")
# any-hit kinds also held in closest-hit mode, t bit-identical, and against
# brute force: the rays to t_max = inf
UNBOUNDED_ANY_HIT_KINDS = ("envmap",)
# the kinds whose t must be bit-identical to the plain walk's where the
# prims agree
EXACT_T_KINDS = ("envmap", "segment")
# the march segment that the "segment" kind holds: the second, the first
# from origins moved past a surface
MARCH_SEGMENT = 2
# the paths whose parity phase also renders with the plain walks on the card
PLAIN_ON_GPU = ("headline", "restir", "envmap")
# the paths whose Renderer frame loop phase 6b drives
RENDERER_PATHS = ("envmap",)
# the gltf path's parity phase: the light strategies it renders besides
# the path's own RIS, so that every call site of the alpha march runs on
# the card, with their samples
GLTF_PARITY = (("MIS", 1), ("RESTIR_DI", 2))
# the device sleep (torch.cuda._sleep cycles, about a second on an H100)
# that phase 6b queues at the end of a frame, so that its poll sees the
# frame unfinished
SLEEP_CYCLES = 2 * 10**9
# the (path, ray kind) whose ms and bound a kernel's entry in the kernels
# line reports
SERVES = {"trace_coherent": ("stress", "camera"),
          "trace_incoherent": ("stress", "bounce"),
          "trace_meganode": ("cornell", "camera"),
          "trace_stream8": ("stress14", "camera"),
          "trace_lane8log": ("stress14", "bounce")}
# a kernel's bound (H100 SXM peak rates): f32
# operations of the plain walk on the rays over the f32 rate, and bytes
# over the memory rate, as the kernels move them: every ray's active flag
# and t_max in (1 + 4 B) and its hit record out (t, prim, u, v = 16 B); an
# active ray's o, d and t_min in (28 B); each table once if any ray is
# active
F32_OPS_PER_S = 67e12
BYTES_PER_S = 3.35e12
ACTIVE_BYTES, TMAX_BYTES, HIT_BYTES, RAY_BYTES = 1, 4, 16, 28
# a slab test: 6 sub + 6 mul, 6 min/max of the pairs, 3 + 3 min/max of the
# entry and exit, 1 compare; a triangle test (Moller-Trumbore): two cross
# products (18), four 3-term dots (20), the edge vector (3), u and v and t
# scaled (3), the reciprocal (1), 7 compares and the u + v sum (8)
SLAB_OPS, TRI_OPS = 25, 53
# the slice's frames that launch counts cover: a warm-up and 4 timed
SLICE_FRAMES = 5
# the dense emissive sweep (csrc/emissive_sweep.cu): the ray counts it is
# timed at (the 1080p wavefront, and a pixel-DP rank's quarter of it) over
# the stress interior's 240 emitters; its bound counts a triangle test
# (TRI_OPS) a (ray, emitter) pair and, a ray, o and d and the active flag
# in and t and the int64 slot out; the launches behind a timing's warm-up
SWEEP_RAYS = (2_073_600, 518_400)
SWEEP_RAY_BYTES = 12 + 12 + 1 + 4 + 8
SWEEP_REPS = 20
SWEEP_SOURCE = "hiprt_pt_tpu_torch/csrc/emissive_sweep.cu"
SWEEP_REPLACES = ("none: the JAX package's fused jnp sweep, "
                  "hiprt_pt_tpu/lights/light_sampling.py:199")
# the principled BSDF's kernels (csrc/principled.cu): the lanes they are
# timed at (the 1080p wavefront, a pixel-DP rank's quarter of it); a lane's
# bytes: eval reads 45 material floats, n, wo, wi and eta_rel (220 B) and
# writes f and pdf (16 B); sample reads the materials, n, wo, eta_rel and
# the int64 state (216 B) and writes the state, wi, f, pdf and the
# refracted flag (37 B); the lanes the f32 operations a lane are counted on
BSDF_LANES = (2_073_600, 518_400)
BSDF_BYTES = {"eval": 220 + 16, "sample": 216 + 37}
BSDF_OPS_LANES = 256
BSDF_REPS = 20
BSDF_SOURCE = "hiprt_pt_tpu_torch/csrc/principled.cu"
BSDF_REPLACES = ("none: the JAX package's jnp principled BSDF, which XLA "
                 "fuses, hiprt_pt_tpu/models/principled.py")
# launches behind the warm-up in one timing of a traversal kernel (several
# take a third of a millisecond a launch)
KERNEL_REPS = 10
# probes: the rounds of P2's exact gate on integer tables (every partial
# sum stays below 2^24: 4 rounds x 19 tiles x 128 lanes x 1000 < 2^24; P1's
# gate runs the probe's 32 rounds, 127 x 4096 x 32 < 2^24); the float
# table's tolerance, for an f32 sum of up to 77,824 maxima taken in another
# order than float64
DG_GATE_ROUNDS = 4
PROBE_FLOAT_RTOL = 1e-5
# the probe configurations the kernels line reports P1 and P2 at
P1_LINE, P2_LINE_TILES = "per-group(now)", 19
# P1's gates off its tile (128 table rows x 128 bytes of L a stage, 256
# gathered rows a block): (L, W, NL), each at int8 and bf16, 1, 2 and 8 groups
P1_OFF_TILE = ((300, 100, 200), (129, 65, 1048), (2731, 333, 1096))
P1_OFF_TILE_ROUNDS = 5
# a table past the shared-memory size of dg_probe_kernel's strips: (S, tiles)
P2_PAST_SHARED = (30000, 2)
# the cli path: the size and samples of its card-vs-CPU run, and the
# tolerances (atol, rtol) of the denoisers on the card against the CPU
CLI_PARITY = (256, 144, 2)
ATROUS_TOL, CNN_TOL = (1e-6, 1e-5), (1e-5, 1e-4)
# the profiler's names of a kernel launch from the host
LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")
# the viewer path: frames its loop renders before the first request, and
# the edits it makes before the preset switches (index, field, value)
VIEWER_QUIET_FRAMES = 3
VIEWER_EDITS = ((2, "roughness", 0.77), (1, "roughness", 0.55))
# the bake phase: the bakes at bake_all's sizes; the card's run at
# BAKE_SMALL (res, samples) against the CPU's: every cell within
# BAKE_CELL_TOL but at most 1 in BAKE_FLIP_SHARE of a table's cells, each
# within BAKE_FLIP_TOL (one lane of 256 whose lobe choice rounds the other
# way; tests/test_torch_bake.py holds the CPU against the JAX package so);
# against the shipped table, BAKE_SHIPPED_TOL (tests/test_baker.py's)
BAKE_SMALL = (4, 256)
BAKE_CELL_TOL, BAKE_FLIP_TOL, BAKE_FLIP_SHARE = 1e-5, 6e-3, 50
BAKE_SHIPPED_TOL = 0.02
# the bake's name in bake_all's result -> (bake function, shipped table or
# None); and the JAX package's own fresh bake at bake_all's sizes against
# each shipped table, max |diff| (JAX 0.9.0 on a CPU,
# tests/torch_parity.py:jax_spread)
BAKES = {"conductor": ("bake_ggx_conductor_ess", "data_ggx_conductor_ess_32"),
         "glossy_dielectric": ("bake_ggx_glossy_dielectric_ess", None),
         "glass": ("bake_ggx_glass_ess", "data_ggx_glass_ess_16"),
         "glass_inv": ("bake_ggx_glass_inv_ess", "data_ggx_glass_inv_ess_16"),
         "thin_glass": ("bake_ggx_thin_glass_ess", "data_ggx_thin_glass_ess_16"),
         "glossy_base": ("bake_glossy_base_ess", "data_glossy_base_ess_16"),
         "fresnel": ("bake_ggx_fresnel_ess", None)}
JAX_SHIPPED_GAP = {"data_ggx_conductor_ess_32": 0.0038196444511413574,
                   "data_ggx_glass_ess_16": 0.0006085038185119629,
                   "data_ggx_glass_inv_ess_16": 0.0012451410293579102,
                   "data_ggx_thin_glass_ess_16": 2.2649765014648438e-06,
                   "data_glossy_base_ess_16": 0.006270170211791992}
# the sheen fit at full size, and its gate: per channel (Ai, Bi, R), the max
# and median |fit - shipped| over the cells with R >= SHEEN_R_MIN within
# twice the spread between two JAX seeds (1234 and 99991) at the same path
# count over the whole table (tests/torch_parity.py:jax_spread, JAX 0.9.0
# on a CPU)
SHEEN_FIT = {"n_paths": 32768, "steps": 200, "seed": 1234}
SHEEN_R_MIN = 0.01
SHEEN_JAX_SPREAD = {"Ai": (0.06952342391014099, 0.005293548107147217),
                    "Bi": (0.1494530886411667, 0.009054824709892273),
                    "R": (0.01104736328125, 0.001800537109375)}
SGGX_SELFTEST_TOL = 0.02


def log(*a):
    print(*a, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    return name


def phase_build():
    """Build every source at once; returns {kernel: {mode: {registers,
    local_bytes, shared_bytes, blocks_per_sm}}} of every kernel of the
    registry (cuda_build.KERNELS), a mode for each set of flags its *_info
    function is asked with."""
    from hiprt_pt_tpu_torch.accel.native import get_lib
    from hiprt_pt_tpu_torch.probes import r5probe2 as pr

    t0 = time.perf_counter()
    cuda_build.load_libraries()
    t1 = time.perf_counter()
    get_lib()
    t2 = time.perf_counter()
    for line in cuda_build.build_log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "warning" in line or "(C7" in line):
            log("[build] ptxas:", line.strip().replace("ptxas info    : ", ""))
    # a walk's own stack is local memory, not a spill
    check_no_spill(cuda_build.build_log,
                   ("trace_coherent_kernel", "trace_incoherent_kernel",
                    "trace_meganode_kernel", "trace_stream8_kernel",
                    "dg_probe_kernel", "emissive_sweep_kernel",
                    "principled_eval_kernel", "principled_sample_kernel"))
    log(f"[build] kernels ({len(cuda_build.SOURCES)} sources at once) "
        f"{t1 - t0:.2f} s, BVH library {t2 - t1:.2f} s")
    # kernel -> {mode: flags of its *_info function}; dg_probe_kernel at the
    # probe's two configurations: strip width, block size and table rows as
    # its wrapper plans them on this card
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    modes = {k: {"closest": (0,), "any-hit": (1,)} for k in KERNEL_TABLES}
    modes["mm_probe"] = {"int8": (1,), "bf16": (0,)}
    modes["dg_probe"] = {f"{tiles} tiles": (*pr.dg_plan(S, tiles, sms), S)
                         for S, tiles in pr.DG_CONFIGS}
    info = {}
    for k in cuda_build.KERNELS:
        info[k] = {m: cuda_build.kernel_info(k, *f)
                   for m, f in modes.get(k, {"": ()}).items()}
        for mode, v in info[k].items():
            plan = (f", strips of {modes[k][mode][0]} lanes, blocks of "
                    f"{modes[k][mode][1]} threads" if k == "dg_probe" else "")
            log(f"[build] {k}{f' ({mode}{plan})' if mode else ''}: "
                f"{v['registers']} registers per thread, {v['local_bytes']} "
                f"bytes of local memory per thread, {v['shared_bytes']} bytes "
                f"of shared memory per block, {v['blocks_per_sm']} resident "
                f"blocks per SM")
    return info


def check_no_spill(build_log, kernels):
    """Raise if ptxas reports spill stores or loads for an entry function
    whose name holds one of ``kernels``."""
    import re

    entry = ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and any(k in entry for k in kernels) and (int(m.group(1))
                                                       or int(m.group(2))):
            raise AssertionError(f"ptxas spills in {entry}: {line.strip()}")


def phase_scene(tag, dev):
    """A path's scene and tables (hiprt_pt_tpu_torch/paths.py), with its
    host set-up times, table sizes and routes."""
    from hiprt_pt_tpu_torch import paths
    from hiprt_pt_tpu_torch.ops.routing import route

    scene, cam, bvh, secs = paths.load(tag, dev)
    routes = (route(bvh, True), route(bvh, False))
    tables = {k: tuple(getattr(bvh, k).shape)
              for k in ("nodes4", "leaf_rows", "nodes8l", "leaf_rows8", "nodes")
              if getattr(bvh, k) is not None}
    tex = scene.textures
    log(f"[{tag} scene] {scene.num_triangles} triangles, {scene.num_emissives} "
        f"emissive triangles, "
        f"{0 if tex is None else tex.num_layers} textures"
        f"{'' if tex is None else f' (atlas {tuple(tex.texels.shape)}, kinds {tex.kinds_used})'}, "
        f"{scene.materials.ior.shape[0]} materials; set-up: "
        f"{', '.join(f'{k} {v:.3f} s' for k, v in secs.items())}; tables on the "
        f"card {tables}, {bvh.nbytes} bytes; depth4 {bvh.depth4}, depth8 "
        f"{bvh.depth8}, depth2 {bvh.depth2}, lane8 {bvh.lane8}; routes: "
        f"coherent {routes[0]}, incoherent {routes[1]}")
    expect = {"stress": (259_120, 240, 0, None), "cornell": (35_852, 2, 0, None),
              "stress14": (2_042_048, 240, 18, None),
              "headline": (259_120, 240, 18, None),
              "restir": (259_120, 240, 18, None),
              "envmap": (35_852, 2, 0, (64, 128, 3)),
              # the stress interior's 18 textures and the four cutout copies
              "gltf": (259_120, 240, 22, None)}[tag]
    env = scene.envmap
    got = (scene.num_triangles, scene.num_emissives,
           0 if tex is None else tex.num_layers,
           None if env is None else tuple(env.texels.shape))
    if env is not None:
        log(f"[{tag} scene] envmap {tuple(env.texels.shape)} texels, total "
            f"sin-weighted luminance {env.total_luminance:.3f}")
    if got != expect:
        raise AssertionError(f"the {tag} scene has (triangles, emissive "
                             f"triangles, textures, envmap) {got}, expected "
                             f"{expect}")
    if routes != paths.ROUTES[tag]:
        raise AssertionError(f"the {tag} scene routes to {routes}, expected "
                             f"{paths.ROUTES[tag]}")
    if (tex is not None and tex.has_alpha) != (tag == "gltf"):
        raise AssertionError(f"the {tag} scene has alpha textures: "
                             f"{tex is not None and tex.has_alpha}")
    if tag == "gltf":
        gltf_serial_load(dev, secs)
    return scene, cam, bvh


def gltf_serial_load(dev, parallel):
    """The gltf path's scene file loaded once more with parallel=False:
    its stage times beside the parallel load's (``parallel``)."""
    import tempfile

    from hiprt_pt_tpu_torch import paths
    from hiprt_pt_tpu_torch.assets.loader import load_scene_file

    serial = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        glb = paths.write_gltf_scene(tmp)
        serial["write"] = time.perf_counter() - t0
        scene, _cam, _bvh = load_scene_file(glb, aspect=paths.ASPECT,
                                            parallel=False, with_bvh=True,
                                            device=dev, timings=serial)
    torch.cuda.synchronize()
    log(f"[gltf scene] load_scene_file, serial (parallel=False): "
        f"{', '.join(f'{k} {v:.3f} s' for k, v in serial.items())}; parallel: "
        f"{', '.join(f'{k} {v:.3f} s' for k, v in parallel.items())}")
    if scene.num_triangles != 259_120:
        raise AssertionError(f"the serial load gave {scene.num_triangles} triangles")


def phase_files(dev):
    """Scene files on the card with imageio unimportable: load_envmap of an
    .hdr that write_hdr wrote, within one RGBE step of the array written,
    and a .gltf with external .bin and .png files (the Cornell box with a
    textured wall and a cutout sphere) through load_scene_file, equal to
    its load on the CPU."""
    import tempfile

    from hiprt_pt_tpu_torch import paths
    from hiprt_pt_tpu_torch.assets.cornell import cornell_spheres_arrays
    from hiprt_pt_tpu_torch.assets.envmap import load_envmap, make_test_envmap
    from hiprt_pt_tpu_torch.assets.gltf import ParsedScene
    from hiprt_pt_tpu_torch.assets.gltf_testscene import write_gltf
    from hiprt_pt_tpu_torch.assets.image_io import write_hdr
    from hiprt_pt_tpu_torch.assets.loader import load_scene_file
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat

    saved = {k: sys.modules.pop(k, None) for k in ("imageio", "imageio.v3")}
    sys.modules["imageio"] = sys.modules["imageio.v3"] = None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            img = make_test_envmap(64, 128, "sky")
            write_hdr(os.path.join(tmp, "sky.hdr"), img)
            env = load_envmap(os.path.join(tmp, "sky.hdr"), device=dev)
            _m, e = np.frexp(img.max(-1))
            step = np.ldexp(1.0, e - 8)[..., None]
            err = np.abs(env.texels.cpu().numpy().astype(np.float64) - img)
            log(f"[files] load_envmap of a written .hdr on {env.texels.device}: "
                f"{tuple(env.texels.shape)} texels, max |err| / RGBE step "
                f"{float((err / step).max()):.4f}, max radiance "
                f"{float(env.texels.max()):.3f}")
            if not (err <= step).all() or env.texels.device.type != "cuda":
                raise AssertionError("load_envmap is not within one RGBE step")
            v, f, mids, rows, cam_kw = cornell_spheres_arrays(paths.ASPECT)
            rows = [dict(r) for r in rows]
            rows[0]["base_color_texture_index"] = 0
            yy, xx = np.mgrid[0:32, 0:32]
            checker = np.where(((yy // 8 + xx // 8) % 2)[..., None] == 0,
                               [220, 200, 180, 255], [60, 70, 90, 255])
            parsed = ParsedScene(
                vertices=v, triangles=f, normals=None,
                uvs=np.stack([v[:, 0] + v[:, 2], v[:, 1] - v[:, 2]], -1),
                material_ids=mids, material_rows=rows,
                camera=camera_from_lookat(**cam_kw, device="cpu"),
                images=[checker.astype(np.uint8)])
            path = os.path.join(tmp, "cornell.gltf")
            write_gltf(path, parsed, alpha_materials=(6,), external=True)
            t0 = time.perf_counter()
            scene, _cam, bvh = load_scene_file(path, aspect=paths.ASPECT,
                                               parallel=True, with_bvh=True,
                                               device=dev)
            secs = time.perf_counter() - t0
            ref, _c = load_scene_file(path, aspect=paths.ASPECT, device="cpu")
            files = sorted(os.listdir(tmp))
    finally:
        for k, mod in saved.items():
            if mod is None:
                del sys.modules[k]
            else:
                sys.modules[k] = mod
    tex = scene.textures
    log(f"[files] {files}: {scene.num_triangles} triangles, {tex.num_layers} "
        f"textures on {tex.texels.device}, has_alpha {tex.has_alpha}, BVH "
        f"{bvh.nbytes} bytes, {secs:.3f} s")
    if (scene.num_triangles, tex.num_layers, tex.has_alpha) != (35_852, 2, True) \
            or not torch.equal(scene.tri_data.cpu(), ref.tri_data) \
            or not torch.equal(tex.texels.cpu(), ref.textures.texels) \
            or tex.texels.device.type != "cuda":
        raise AssertionError("the external-file .gltf loaded otherwise on the card")


def camera_rays(cam, width, height):
    from hiprt_pt_tpu_torch.core.camera import generate_camera_rays
    from hiprt_pt_tpu_torch.ops.pixel_order import pixel_coords

    px, py = pixel_coords(width, height, cam.view.device)
    return generate_camera_rays(cam, width, height, None, px, py)


def camera_hits(scene, bvh, o, d, walk):
    """(points, face-forwarded geometric normals, hit mask) of camera rays,
    found by the plain walk ``walk``; a missed ray's point is its origin."""
    rec = walk(bvh, o, d, t_min=0.0)
    hit = rec.prim >= 0
    ng = scene.tri_data[rec.prim.clamp_min(0).long(), 25:28]
    ng = torch.where(((ng * d).sum(-1, keepdim=True) > 0.0), -ng, ng)
    p = o + d * torch.where(hit, rec.t, 0.0)[:, None]
    return p, ng, hit


def bounce_rays(p, ng, seed):
    """Incoherent rays: cosine-hemisphere directions (numpy, seeded) around
    the normals ng at the points p."""
    from hiprt_pt_tpu_torch.ops.intersect import offset_ray_origin
    from hiprt_pt_tpu_torch.ops.sampling import sample_cosine_hemisphere

    rng = np.random.default_rng(seed)
    n = p.shape[0]
    u1 = torch.from_numpy(rng.random(n, dtype=np.float32)).to(p.device)
    u2 = torch.from_numpy(rng.random(n, dtype=np.float32)).to(p.device)
    wi, _ = sample_cosine_hemisphere(ng, u1, u2)
    wi = (wi / torch.linalg.norm(wi, dim=-1, keepdim=True)).contiguous()
    return offset_ray_origin(p, ng, wi).contiguous(), wi


def shadow_rays(scene, p, ng, seed, tile):
    """Any-hit rays from the points p toward a point on an emissive
    triangle drawn as the path's light sampling draws it
    (lights/light_sampling.py:sample_emissive_triangle, the scene's power
    alias table, the PCG stream of seed ``seed``): a triangle per ray under
    MIS (``tile`` None), one per 128-ray tile under RIS (the point on it
    per ray). t_max stops short of the light, as the path's does.
    Returns (o, d, t_max, valid): valid where the light is drawn and lies
    above the surface."""
    from hiprt_pt_tpu_torch.core import rng
    from hiprt_pt_tpu_torch.lights.light_sampling import sample_emissive_triangle
    from hiprt_pt_tpu_torch.ops.intersect import offset_ray_origin

    n = p.shape[0]
    state = rng.seed(torch.arange(n, device=p.device), 0, seed)
    _state, ls = sample_emissive_triangle(scene, p, state, tile_size=tile)
    wi = ls["wi"].contiguous()
    valid = ls["valid"] & ((ng * wi).sum(-1) > 0.0)
    return (offset_ray_origin(p, ng, wi).contiguous(), wi,
            (ls["dist"] * (1.0 - 1e-3)).contiguous(), valid)


def shadow_tile(tag):
    """The light-candidate tile of a path's shadow rays: 128 rays under RIS
    (RenderOptions.ris_tile_light_candidates), None (per ray) under MIS."""
    from hiprt_pt_tpu_torch.core.settings import LightSamplingStrategy
    from hiprt_pt_tpu_torch.paths import slice_options

    opts = slice_options(tag)[0]
    if opts.direct_light_sampling == LightSamplingStrategy.RIS_BSDF_LIGHT:
        return opts.ris_tile_light_candidates or None
    return None


def envmap_rays(tag, scene, p, ng, seed):
    """Any-hit rays from the points p toward envmap directions drawn as
    the path's envmap NEE draws them (lights/envmap_sampling.py:
    sample_envmap with the path's options and world, the PCG stream of
    seed ``seed``), to t_max = inf. Returns (o, d, valid): valid where the
    pdf is positive and the direction lies above the surface."""
    from hiprt_pt_tpu_torch.core import rng
    from hiprt_pt_tpu_torch.lights.envmap_sampling import sample_envmap
    from hiprt_pt_tpu_torch.ops.intersect import offset_ray_origin
    from hiprt_pt_tpu_torch.paths import slice_options

    opts, _settings, world = slice_options(tag)
    state = rng.seed(torch.arange(p.shape[0], device=p.device), 0, seed)
    _state, wi, _rad, pdf = sample_envmap(opts, world, scene.envmap, state)
    wi = wi.contiguous()
    valid = (pdf > 0.0) & ((ng * wi).sum(-1) > 0.0)
    return offset_ray_origin(p, ng, wi).contiguous(), wi, valid


def kind_rays(tag, scene, bvh, cam, width, height, walk, seed, tile):
    """{kind: (o, d, t_max or None, active)} of the camera, bounce and
    shadow rays of a width x height view, and with an envmap its shadow
    rays; t_max None: unbounded (camera, bounce and envmap rays), or the
    caller's; active: the camera ray hit (bounce and shadow rays) and the
    light is valid (shadow rays)."""
    o_c, d_c = camera_rays(cam, width, height)
    p, ng, hit = camera_hits(scene, bvh, o_c, d_c, walk)
    o_b, d_b = bounce_rays(p, ng, seed)
    o_s, d_s, tmax_s, valid = shadow_rays(scene, p, ng, seed + 1, tile)
    rays = {"camera": (o_c, d_c, None, torch.ones_like(hit)),
            "bounce": (o_b, d_b, None, hit),
            "shadow": (o_s, d_s, tmax_s, hit & valid),
            "masked": (o_s, d_s, tmax_s, torch.zeros_like(hit))}
    if scene.envmap is not None:
        o_e, d_e, valid_e = envmap_rays(tag, scene, p, ng, seed + 2)
        rays["envmap"] = (o_e, d_e, None, hit & valid_e)
    if alpha_shadows(scene):
        rays.update(march_rays(scene, bvh, o_s, d_s, tmax_s, hit & valid,
                               walk, seed + 3))
    return rays


def march_rays(scene, bvh, o, d, t_max, active, walk, seed):
    """{"prune": ..., "segment": ...}: the alpha march's two ray kinds on
    the shadow rays (o, d, t_max, active), as ops/traverse.py:
    occluded_alpha forms them with the plain walk ``walk`` and the PCG
    stream of seed ``seed``: the prune's any-hit rays (the shadow rays
    themselves), and the closest-hit rays of its MARCH_SEGMENT-th segment
    (origins moved past the surface each passed through, t_max what is
    left, active: the rays still marching)."""
    from hiprt_pt_tpu_torch.core import rng
    from hiprt_pt_tpu_torch.ops.traverse import occluded_alpha

    calls = []

    def record(bvh, o, d, t_min, t_max, active, any_hit):
        calls.append((o, d, t_max, active, any_hit))
        return walk(bvh, o, d, t_min, t_max, active, any_hit=any_hit)

    state = rng.seed(torch.arange(o.shape[0], device=o.device), 0, seed)
    occluded_alpha(bvh, scene, o, d, state, t_min=1e-4, t_max=t_max,
                   active=active, trace=record)
    segments = [c[:4] for c in calls if not c[4]]
    log(f"[kernels] the march on {int(active.sum())} shadow rays: "
        f"{int(calls[0][3].sum())} pruned to {int(segments[0][3].sum())}, "
        f"segments of {[int(c[3].sum()) for c in segments]} rays")
    if len(segments) < MARCH_SEGMENT:
        raise AssertionError(f"the march ran {len(segments)} segments, fewer "
                             f"than {MARCH_SEGMENT}: no ray passed a surface")
    so, sd, st, sa = segments[MARCH_SEGMENT - 1]
    return {"prune": (o, d, t_max, active),
            "segment": (so.contiguous(), sd, st.contiguous(), sa)}


def compare(name, rk, rp, any_hit, active, exact_t=False):
    """Kernel record vs plain record; raises below the thresholds, and with
    ``exact_t`` unless t is bit-identical where the prims agree (closest
    hit). Returns the max |t| difference where the prims agree."""
    pk, pp = rk.prim.cpu().numpy(), rp.prim.cpu().numpy()
    act = active.cpu().numpy()
    if np.any(pk[~act] != -1) or np.any(np.isfinite(rk.t.cpu().numpy()[~act])):
        raise AssertionError(f"{name}: an inactive ray reported a hit")
    if any_hit:
        agree = float(np.mean((pk >= 0) == (pp >= 0)))
        err = 0.0
    else:
        agree = float(np.mean(pk == pp))
        m = (pk == pp) & (pk >= 0)
        tk, tp = rk.t.cpu().numpy()[m], rp.t.cpu().numpy()[m]
        err = float(np.max(np.abs(tk - tp), initial=0.0))
        if not np.allclose(tk, tp, rtol=T_RTOL, atol=0.0):
            raise AssertionError(f"{name}: t differs beyond rtol {T_RTOL}")
        if exact_t and not np.array_equal(tk, tp):
            raise AssertionError(f"{name}: t is not bit-identical")
    log(f"[kernels] {name}: agreement {agree:.6f} over {len(pk)} rays "
        f"({int((pk >= 0).sum())} hits, {int((~act).sum())} inactive), "
        f"max |dt| {err:.3e}")
    differ = (pk >= 0) != (pp >= 0) if any_hit else pk != pp
    for i in np.nonzero(differ)[0][:5]:
        log(f"[kernels]   ray {i}: kernel prim {pk[i]} t {float(rk.t[i]):.9g}, "
            f"reference prim {pp[i]} t {float(rp.t[i]):.9g}")
    if agree < AGREE_MIN:
        raise AssertionError(f"{name}: agreement {agree} < {AGREE_MIN}")
    return err


def bound(bvh, kernel, n, n_active, stats):
    """(ms, "bytes" or "operations"): the least time the card could take for
    the plain walk's work on n rays, n_active of them active (see
    F32_OPS_PER_S above)."""
    # a walk of no active ray visits nothing and counts nothing
    ops = stats.get("box_tests", 0) * SLAB_OPS + stats.get("tri_tests", 0) * TRI_OPS
    nbytes = n * (ACTIVE_BYTES + TMAX_BYTES + HIT_BYTES) + n_active * RAY_BYTES
    if n_active:
        nbytes += sum(getattr(bvh, t).numel() * 4 for t in KERNEL_TABLES[kernel])
    op_ms, byte_ms = ops / F32_OPS_PER_S * 1e3, nbytes / BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms > byte_ms else "bytes")


def limits(n, seed, dev):
    """Seeded (t_max, active) for n rays: a quarter of the rays get a finite
    t_max, a tenth are inactive."""
    rng = np.random.default_rng(seed)
    tmax = np.where(rng.random(n) < 0.25,
                    rng.uniform(0.2, 4.0, n), np.inf).astype(np.float32)
    act = rng.random(n) >= 0.1
    return torch.from_numpy(tmax).to(dev), torch.from_numpy(act).to(dev)


def modes(kind):
    """The hit modes a ray kind is held in (any_hit flags): shadow and
    ReSTIR visibility rays are any-hit rays; camera, bounce and envmap
    shadow rays both."""
    if kind in ANY_HIT_KINDS and kind not in UNBOUNDED_ANY_HIT_KINDS:
        return (True,)
    return (False, True)


def restir_rays(scene, cam, bvh, width, height):
    """{kind: (o, d, t_max, active)} of the ReSTIR path's visibility rays in
    its second frame at width x height: the renderer renders frame 1 (so the
    reservoirs carry history), then render_step renders frame 2 with a
    ``stage`` (render/renderer.py:restir_reuse) that forms the rays from the
    inputs the path hands its passes: "initial" (visibility reuse's, toward
    the initial candidates' winners) and "restir" (final shading's,
    restir/di.py:final_visibility_rays; the last spatial pass sends the
    same rays)."""
    import inspect

    from hiprt_pt_tpu_torch.paths import slice_options
    from hiprt_pt_tpu_torch.render.renderer import Renderer, render_step
    from hiprt_pt_tpu_torch.restir import di

    opts, settings, world = slice_options("restir")
    r = Renderer(scene, cam, width, height, options=opts, settings=settings,
                 world=world, bvh=bvh, seed=42)
    r.step()
    rays = {}

    def keep(name, fn, *args, **kw):
        a = inspect.signature(fn).bind(*args, **kw).arguments
        if name == "visibility reuse":
            rays["initial"] = di.visibility_rays(a["p"], a["ng"], a["res"],
                                                 a["active"])
        elif name == "final shading":
            rays["restir"] = di.final_visibility_rays(a["gbuf"], a["res"],
                                                      a["active"])
        return fn(*args, **kw)

    render_step(opts, width, height, scene, bvh, r.state, cam, settings,
                world, stage=keep)
    if set(rays) != {"initial", "restir"}:
        raise AssertionError(f"restir: the frame formed the rays {sorted(rays)}")
    return {kind: (o.contiguous(), d.contiguous(), t_max.contiguous(), a)
            for kind, (o, d, t_max, a) in rays.items()}


def phase_kernels(tag, scene, cam, bvh, dev, cases):
    """Each (kernel, ray kind) of ``cases`` against the kernel's plain
    version and brute force, then both timed on the 1080p wavefront, with
    the kernel's bound there. Returns ({kernel: max |dt|}, {(path, kernel,
    kind): row}); a row holds the kernel's and the plain version's ms in the
    kind's mode (closest for camera and bounce rays, any-hit for shadow
    rays), the any-hit ms, and the bound on those rays in that mode."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops import traverse as plain
    from hiprt_pt_tpu_torch.ops.intersect import brute_force_closest

    first_walk = getattr(plain, PLAIN[cases[0][0]])
    tile = shadow_tile(tag)
    side = int(np.sqrt(PARITY_RAYS))
    rays = kind_rays(tag, scene, bvh, cam, side, side, first_walk, 1, tile)
    with_restir = any(kind == "restir" for _k, kind in cases)
    if with_restir:
        rays.update(restir_rays(scene, cam, bvh, side, side))
    tmax, act = limits(side * side, 2, dev)
    errs = {}
    plain_recs = {}
    for kname, kind in cases:
        kern, walk = getattr(ct, kname), getattr(plain, PLAIN[kname])
        o, d, t_own, a = rays[kind]
        a = a & act
        t_max = tmax if t_own is None else torch.minimum(t_own, tmax)
        errs.setdefault(kname, 0.0)
        for any_hit in modes(kind):
            t_min = 1e-4 if any_hit else 0.0
            rk = kern(bvh, o, d, t_min, t_max, a, any_hit=any_hit)
            key = (PLAIN[kname], kind, any_hit)
            if key not in plain_recs:
                plain_recs[key] = walk(bvh, o, d, t_min, t_max, a, any_hit=any_hit)
            torch.cuda.synchronize()
            tag_ = f"{kname}[{kind}, {'any' if any_hit else 'closest'}]"
            errs[kname] = max(errs[kname], compare(
                tag_, rk, plain_recs[key], any_hit, a,
                exact_t=kind in EXACT_T_KINDS))
        if kind in ANY_HIT_KINDS and kind not in UNBOUNDED_ANY_HIT_KINDS:
            continue
        # brute force on 1,024 active rays with an unbounded t_max
        sel = torch.nonzero(a & torch.isinf(tmax)).squeeze(1)[:BRUTE_RAYS]
        o_sel, d_sel = o[sel].contiguous(), d[sel].contiguous()
        rk = kern(bvh, o_sel, d_sel, 0.0)
        bt, bp, _bu, _bv = brute_force_closest(scene.vertices, scene.triangles,
                                               o_sel, d_sel, t_min=0.0)
        rb = plain.HitRecord(t=bt, prim=bp, u=_bu, v=_bv)
        all_sel = torch.ones_like(sel, dtype=torch.bool)
        compare(f"{kname}[{kind}, brute force]", rk, rb, False, all_sel)
        if kind in UNBOUNDED_ANY_HIT_KINDS:
            # occlusion to t_max = inf, as the path traces these rays
            rk = kern(bvh, o_sel, d_sel, 1e-4, float("inf"), any_hit=True)
            bt, bp, _bu, _bv = brute_force_closest(
                scene.vertices, scene.triangles, o_sel, d_sel, t_min=1e-4)
            compare(f"{kname}[{kind}, any, t_max = inf, brute force]", rk,
                    plain.HitRecord(t=bt, prim=bp, u=_bu, v=_bv), True,
                    all_sel)
    del plain_recs, rays

    # the full 1080p wavefront: compare with finite t_max and inactive rays,
    # then time, and compare the timed results too
    full = kind_rays(tag, scene, bvh, cam, WIDTH, HEIGHT, first_walk, 3, tile)
    if with_restir:
        full.update(restir_rays(scene, cam, bvh, WIDTH, HEIGHT))
    tmax_f, act_f = limits(WIDTH * HEIGHT, 4, dev)
    plain_recs = {}
    for kname, kind in cases:
        kern, walk = getattr(ct, kname), getattr(plain, PLAIN[kname])
        o, d, t_own, a = full[kind]
        a = a & act_f
        t_max = tmax_f if t_own is None else torch.minimum(t_own, tmax_f)
        for any_hit in modes(kind):
            t_min = 1e-4 if any_hit else 0.0
            rk = kern(bvh, o, d, t_min, t_max, a, any_hit=any_hit)
            key = (PLAIN[kname], kind, any_hit)
            if key not in plain_recs:
                plain_recs[key] = walk(bvh, o, d, t_min, t_max, a, any_hit=any_hit)
            tag_ = (f"{kname}[{kind}, {'any' if any_hit else 'closest'}, 1080p, "
                    f"finite t_max]")
            errs[kname] = max(errs[kname], compare(
                tag_, rk, plain_recs[key], any_hit, a,
                exact_t=kind in EXACT_T_KINDS))
    del plain_recs
    rows, plain_ms = {}, {}
    for kname, kind in cases:
        kern, walk = getattr(ct, kname), getattr(plain, PLAIN[kname])
        o, d, t_own, a = full[kind]
        t_max = float("inf") if t_own is None else t_own
        row = {}
        for any_hit in modes(kind):
            t_min = 1e-4 if any_hit else 0.0
            k_ms, rk = cuda_ms(lambda: kern(bvh, o, d, t_min, t_max, a,
                                            any_hit=any_hit), reps=KERNEL_REPS)
            key = (PLAIN[kname], kind, any_hit)
            if key not in plain_ms:
                plain_ms[key] = cuda_ms(lambda: walk(
                    bvh, o, d, t_min, t_max, a, any_hit=any_hit), reps=1)
            p_ms, rp = plain_ms[key]
            tag_ = f"{kname}[{kind}, {'any' if any_hit else 'closest'}, 1080p]"
            errs[kname] = max(errs[kname], compare(
                tag_, rk, rp, any_hit, a,
                exact_t=kind in EXACT_T_KINDS))
            mode = "any" if any_hit else "closest"
            row[f"{mode}_ms"], row[f"{mode}_plain_ms"] = k_ms, p_ms
            packets = ""
            if kname == "trace_coherent":
                left, total = ct.coherent_packets()
                row[f"{mode}_left_share"] = left / total
                packets = (f"; {left} of {total} packets "
                           f"({left / total:.4f}) left packet mode")
            log(f"[kernels] {kname} {'any-hit' if any_hit else 'closest'} on "
                f"{o.shape[0]} {kind} rays ({int(a.sum())} active): kernel "
                f"{k_ms:.3f} ms, plain {p_ms:.3f} ms "
                f"({o.shape[0] / k_ms / 1e3:.1f} Mrays/s kernel){packets}")
        any_kind = kind in ANY_HIT_KINDS
        mode = "any" if any_kind else "closest"
        stats = {}
        walk(bvh, o, d, 1e-4 if any_kind else 0.0, t_max, a, any_hit=any_kind,
             stats=stats)
        b_ms, b_by = bound(bvh, kname, o.shape[0], int(a.sum()), stats)
        rows[(tag, kname, kind)] = {
            "path": tag, "mode": mode, "ms": row[f"{mode}_ms"],
            "plain_ms": row[f"{mode}_plain_ms"], "any_ms": row["any_ms"],
            "bound_ms": b_ms, "bound_by": b_by}
        if f"{mode}_left_share" in row:
            rows[(tag, kname, kind)] |= {
                "left_share": row[f"{mode}_left_share"],
                "any_left_share": row["any_left_share"]}
        log(f"[kernels] {kname} bound on {o.shape[0]} {kind} rays ({mode}): "
            f"{b_ms:.4f} ms ({b_by}); plain walk {stats}")
    return errs, rows


def sweep_rays(rows, n, seed, dev):
    """n rays from the hall toward points near the centroids of emitters
    drawn at random (most reach one, some pass between them), a tenth of
    them inactive."""
    rng = np.random.default_rng(seed)
    p = rng.uniform([-9.5, 0.4, -5.5], [9.5, 5.5, 5.5], (n, 3)).astype(np.float32)
    r = rows.cpu().numpy()[rng.integers(0, rows.shape[0], n)]
    target = r[:, 0:3] + (r[:, 3:6] + r[:, 6:9]) / 3.0
    target = target + rng.normal(scale=0.05, size=target.shape)
    d = (target - p).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    act = rng.random(n) >= 0.1
    return (torch.from_numpy(p).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(act).to(dev))


def phase_sweep(dev) -> tuple:
    """The dense emissive sweep's kernel against its plain version on the
    stress interior's 240 emitters at SWEEP_RAYS rays: t and slot equal on
    every lane, the kernel's ms (SWEEP_REPS launches), the plain ms, the
    bound. Returns {rays: row}; a row's launches are its check's and
    timings', which the kernels line leaves out (it counts the main
    path's)."""
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene
    from hiprt_pt_tpu_torch.lights.light_sampling import _closest_emissive_hit_plain
    from hiprt_pt_tpu_torch.ops import cuda_sweep

    scene, _cam = load_stress_scene(aspect=16 / 9, tri_scale=0.01,
                                    with_textures=False, device=dev)
    rows = scene.emissive_rows
    e = rows.shape[0]
    out = {}
    for n in SWEEP_RAYS:
        o, d, act = sweep_rays(rows, n, n, dev)
        before = cuda_build.launch_counts["emissive_sweep"]
        tk, sk = cuda_sweep.emissive_sweep(rows, o, d, act)
        torch.cuda.synchronize()
        if cuda_build.launch_counts["emissive_sweep"] != before + 1:
            raise AssertionError("the sweep is not one launch")
        tp_, sp = _closest_emissive_hit_plain(rows, o, d, act)
        if not (torch.equal(tk, tp_) and torch.equal(sk, sp)):
            bad = int(((tk != tp_) | (sk != sp)).sum())
            raise AssertionError(f"emissive_sweep_kernel differs from the plain "
                                 f"sweep on {bad} of {n} rays")
        hit = torch.isfinite(tk) & torch.isfinite(tp_)
        err = float((tk[hit] - tp_[hit]).abs().max()) if bool(hit.any()) else 0.0
        ms, _ = cuda_ms(lambda: cuda_sweep.emissive_sweep(rows, o, d, act),
                        reps=SWEEP_REPS)
        ms_again, _ = cuda_ms(lambda: cuda_sweep.emissive_sweep(rows, o, d, act),
                              reps=SWEEP_REPS)
        plain_ms, _ = cuda_ms(lambda: _closest_emissive_hit_plain(rows, o, d, act),
                              reps=2)
        op_ms = n * e * TRI_OPS / F32_OPS_PER_S * 1e3
        byte_ms = n * SWEEP_RAY_BYTES / BYTES_PER_S * 1e3
        row = {"rays": n, "emitters": e, "ms": ms, "ms_again": ms_again,
               "plain_ms": plain_ms, "bound_ms": max(op_ms, byte_ms),
               "bound_by": "operations" if op_ms > byte_ms else "bytes",
               "hit_share": float((sk >= 0).float().mean()),
               "max_abs_err": err,
               "launches": cuda_build.launch_counts["emissive_sweep"] - before}
        out[n] = row
        log(f"[sweep] emissive_sweep_kernel, {n} rays x {e} emitters: kernel "
            f"{ms:.3f} ms (again {ms_again:.3f}), plain {plain_ms:.3f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), x bound "
            f"{ms / row['bound_ms']:.2f}; bit-identical on every lane (max "
            f"|t diff| {err}), {row['hit_share']:.4f} of the rays hit")
    return out


def bsdf_lanes(n, seed, dev):
    """n lanes of the stress interior's materials (ids drawn at random),
    unit normals, wo above them, wi over the sphere, relative IORs on both
    sides of 1 and RNG states: (materials, n, wo, wi, eta_rel, state)."""
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene

    scene, _cam = load_stress_scene(aspect=16 / 9, tri_scale=0.01,
                                    with_textures=False, device=dev)
    rng = np.random.default_rng(seed)
    bank = scene.materials
    ids = torch.from_numpy(rng.integers(0, bank.num_materials, n)).to(dev)
    mats = bank.at_indices(ids).make_safe()

    def unit():
        v = rng.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)

    nrm, wo, wi = unit(), unit(), unit()
    wo = np.where((wo * nrm).sum(-1, keepdims=True) < 0, -wo, wo)
    eta = rng.uniform(0.6, 1.8, n).astype(np.float32)
    state = rng.integers(0, 2**32, n, dtype=np.int64)
    return (mats, *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (nrm, wo, wi, eta, state)))


def plain_ops_per_lane(opts, lanes) -> dict:
    """An upper count of the f32 operations a lane of eval and sample: the
    elements every (non-view) aten operation of the plain version writes,
    over the lanes, on BSDF_OPS_LANES lanes on the host. It counts work the
    kernels skip (the plain sample computes every lobe's direction, the
    kernel only the drawn one's) and selects and copies, so it sets no
    bound: the rows take the bytes' (phase_bsdf)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from hiprt_pt_tpu_torch.models import principled as pm

    class Count(TorchDispatchMode):
        elems = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                Count.elems += sum(t.numel() for t in tree_flatten(out)[0]
                                   if isinstance(t, torch.Tensor))
            return out

    nrm, wo, wi, eta, state = (x[:BSDF_OPS_LANES].cpu() for x in lanes[1:])
    mats = type(lanes[0])(**{k: getattr(lanes[0], k)[:BSDF_OPS_LANES].cpu()
                             for k in lanes[0].__dataclass_fields__})
    out = {}
    for name, call in (
            ("eval", lambda: pm._eval_pdf_plain(opts, mats, nrm, wo, wi,
                                                {"eta_rel": eta})),
            ("sample", lambda: pm._sample_plain(opts, mats, nrm, wo, state,
                                                {"eta_rel": eta}))):
        Count.elems = 0
        with Count():
            call()
        out[name] = Count.elems / BSDF_OPS_LANES
    return out


def plain_lobe(options, mats, nrm, wo, state):
    """The lobe the plain sample draws with the states ``state``: the first
    whose CDF, summed in _sample_plain's order, passes u_sel (0 coat, 1
    sheen, 2 metal, 3 glass, 4 specular, 5 diffuse), (N,) int8."""
    from hiprt_pt_tpu_torch.core import rng as rng_mod
    from hiprt_pt_tpu_torch.models import principled as pm

    probs, _ = pm._lobe_setup(options, mats, pm._to_local(nrm, wo))
    _, u_sel = rng_mod.next_float(state)
    cdf = probs[0]
    below = [u_sel < cdf]
    for p in probs[1:5]:
        cdf = cdf + p
        below.append(u_sel < cdf)
    below = torch.stack(below, -1)
    return torch.where(below.any(-1), below.to(torch.int8).argmax(-1),
                       5).to(torch.int8)


def phase_bsdf(dev) -> dict:
    """The principled BSDF's two kernels against the plain version at
    BSDF_LANES lanes (bsdf_lanes) under the default options: the state
    equal on every lane; eval's f and pdf close, and sample's drawn lobe
    and refracted flag equal and its wi, f and pdf close, on >= 99.99% of
    lanes each; one launch a call; the kernels' ms (BSDF_REPS launches),
    the plain ms and the bound (the lane's bytes at 3.35 TB/s). Returns
    {(kernel, lanes): row}; the rows' launches are the phase's own, which
    the kernels line leaves out."""
    from hiprt_pt_tpu_torch.core.settings import RenderOptions
    from hiprt_pt_tpu_torch.models import principled as pm
    from hiprt_pt_tpu_torch.ops import cuda_bsdf

    opts = RenderOptions()
    table = pm.device_coefficients(dev)
    out = {}
    ops = None
    for n in BSDF_LANES:
        lanes = bsdf_lanes(n, n + 1, dev)
        mats, nrm, wo, wi, eta, state = lanes
        if ops is None:
            ops = plain_ops_per_lane(opts, lanes)
        aux = {"eta_rel": eta}
        before = dict(cuda_build.launch_counts)
        f, pdf = cuda_bsdf.eval_pdf(opts, table, mats, nrm, wo, wi, eta)
        got = cuda_bsdf.sample(opts, table, mats, nrm, wo, state, eta,
                               with_lobe=True)
        torch.cuda.synchronize()
        if (cuda_build.launch_counts["principled_eval"] != before["principled_eval"] + 1
                or cuda_build.launch_counts["principled_sample"]
                != before["principled_sample"] + 1):
            raise AssertionError("a principled call is not one launch")
        fp, pp = pm._eval_pdf_plain(opts, mats, nrm, wo, wi, aux)
        ref = pm._sample_plain(opts, mats, nrm, wo, state, aux)
        if not torch.equal(got[0], ref[0]):
            raise AssertionError("principled_sample_kernel's RNG state differs "
                                 "from the plain version's")

        def close(a, b):
            ok = (a - b).abs() <= 1e-6 + 1e-5 * b.abs()
            return ok.all(-1) if ok.dim() > 1 else ok

        draw = ((got[5] == plain_lobe(opts, mats, nrm, wo, state))
                & (got[4] == ref[4]["refracted"]))
        agree = {"eval": float((close(f, fp) & close(pdf, pp)).float().mean()),
                 "sample": float((draw & close(got[1], ref[1])
                                  & close(got[2], ref[2])
                                  & close(got[3], ref[3])).float().mean())}
        log(f"[bsdf] {n} lanes: principled_sample_kernel draws the plain "
            f"version's lobe and refracted flag on "
            f"{float(draw.float().mean()):.7f} of the lanes")
        for kind, share in agree.items():
            if share < 0.9999:
                raise AssertionError(
                    f"principled_{kind}_kernel agrees with the plain version "
                    f"on {share:.6f} of the lanes")
        calls = {
            "eval": (lambda: cuda_bsdf.eval_pdf(opts, table, mats, nrm, wo, wi,
                                                eta),
                     lambda: pm._eval_pdf_plain(opts, mats, nrm, wo, wi, aux)),
            "sample": (lambda: cuda_bsdf.sample(opts, table, mats, nrm, wo,
                                                state, eta),
                       lambda: pm._sample_plain(opts, mats, nrm, wo, state, aux))}
        for kind, (kern, plain) in calls.items():
            ms, _ = cuda_ms(kern, reps=BSDF_REPS)
            ms_again, _ = cuda_ms(kern, reps=BSDF_REPS)
            plain_ms, _ = cuda_ms(plain, reps=2)
            op_ms = n * ops[kind] / F32_OPS_PER_S * 1e3
            byte_ms = n * BSDF_BYTES[kind] / BYTES_PER_S * 1e3
            name = f"principled_{kind}_kernel"
            row = {"kernel": name, "lanes": n, "ms": ms, "ms_again": ms_again,
                   "plain_ms": plain_ms, "plain_ops_per_lane": ops[kind],
                   "plain_ops_ms": op_ms, "bound_ms": byte_ms,
                   "bound_by": "bytes", "agree": agree[kind]}
            out[(name, n)] = row
            log(f"[bsdf] {name}, {n} lanes: kernel {ms:.3f} ms (again "
                f"{ms_again:.3f}), plain {plain_ms:.3f} ms, bound "
                f"{byte_ms:.4f} ms (bytes: {BSDF_BYTES[kind]} B a lane), "
                f"x bound {ms / byte_ms:.2f}; the plain version's "
                f"{ops[kind]:.0f} f32 operations a lane, an upper count, at "
                f"67 TFLOP/s: {op_ms:.4f} ms; within atol 1e-6 / rtol 1e-5 "
                f"of the plain version on {agree[kind]:.7f} of the lanes")
        del lanes, mats, f, pdf, got, fp, pp, ref
        torch.cuda.empty_cache()
    return out


def bsdf_calls_per_frame(opts, settings, scene=None) -> dict:
    """Launches a sample of the principled BSDF's kernels on a path whose
    every bounce has a live ray: {"principled_eval": e,
    "principled_sample": s}, or {} under the Lambertian and Oren-Nayar
    overrides. A sample a bounce; an eval a light sample a bounce under
    MIS NEE and under RIS (its winner; with the proxy target its
    candidates take the proxy), ReSTIR's first bounce included, one more
    in ReSTIR's final shading, and one a bounce for an importance-sampled
    envmap (``scene`` given)."""
    from hiprt_pt_tpu_torch.core.settings import BSDFOverride
    from hiprt_pt_tpu_torch.core.settings import LightSamplingStrategy as L
    from hiprt_pt_tpu_torch.lights.envmap_sampling import envmap_sampled
    from hiprt_pt_tpu_torch.render.integrator import _nee_enabled

    if opts.bsdf_override in (BSDFOverride.LAMBERTIAN, BSDFOverride.OREN_NAYAR):
        return {}
    bounces = min(opts.max_bounces_static, int(settings.nb_bounces))
    n_ls = max(int(settings.number_of_light_samples), 1)
    strategy = opts.direct_light_sampling
    if strategy in (L.RIS_BSDF_LIGHT, L.RESTIR_DI):
        if not opts.ris_proxy_target:
            raise AssertionError("RIS without the proxy target evaluates more "
                                 "than this count has")
        evals = bounces * n_ls + int(strategy == L.RESTIR_DI)
    else:
        evals = bounces * n_ls if _nee_enabled(opts) else 0
    if scene is not None and envmap_sampled(opts, scene):
        evals += bounces
    return {"principled_eval": evals, "principled_sample": bounces}


def launches_per_frame(tag, scene):
    """{(path, kernel, ray kind): launches per frame} of a path's slice, as
    render/integrator.py issues them when every bounce has a live ray:
    camera_rays_pass traces the camera rays once (coherent route); each of
    the nb_bounces bounces of render_sample traces number_of_light_samples
    shadow wavefronts (_direct_lighting: one any-hit trace per light
    sample under MIS; under RIS, lights/ris.py, one visibility trace per
    light sample when the visibility target is off and the BSDF
    candidates take the dense emissive sweep), on the coherent route at the
    first bounce and the incoherent one after, and one bounce wavefront
    (incoherent route). Under ReSTIR DI the first bounce's RIS runs with
    every ray masked and still traces its shadow wavefront (the RNG stream
    stays the JAX package's), later bounces run RIS, and the camera vertex's
    reservoir pipeline (restir/di.py) traces one visibility wavefront for
    each of initial candidates, the last spatial pass and final shading
    that the options switch on (incoherent route; its BSDF candidates take
    the dense emissive sweep). With an importance-sampled envmap every
    bounce also traces one envmap shadow wavefront (_envmap_nee,
    incoherent route, t_max = inf). With alpha textures each emissive
    shadow trace is the alpha march's any-hit prune ("prune"), followed by
    as many closest-hit segments as the data asks for (not counted here)."""
    from hiprt_pt_tpu_torch.core.settings import LightSamplingStrategy
    from hiprt_pt_tpu_torch.lights.envmap_sampling import envmap_sampled
    from hiprt_pt_tpu_torch.lights.ris import DENSE_EMISSIVE_MAX
    from hiprt_pt_tpu_torch.paths import ROUTES, slice_options

    opts, settings, _world = slice_options(tag)
    restir = opts.direct_light_sampling == LightSamplingStrategy.RESTIR_DI
    ris = opts.direct_light_sampling == LightSamplingStrategy.RIS_BSDF_LIGHT
    if (ris or restir) and (
            opts.ris_use_visibility_target
            or not 0 < scene.emissive_rows.shape[0] <= DENSE_EMISSIVE_MAX):
        raise AssertionError(f"{tag}: RIS traces more rays than this count has")
    coherent, incoherent = ROUTES[tag]
    bounces = min(opts.max_bounces_static, int(settings.nb_bounces))
    n_ls = max(int(settings.number_of_light_samples), 1)
    out = {}
    # with alpha textures every shadow trace is the march's prune (its
    # segments depend on the data: phase_slice adds the ones that ran)
    shadow = "prune" if alpha_shadows(scene) else "shadow"
    # ReSTIR's first bounce: the RIS shadow wavefront with every ray masked
    first = "masked" if restir else shadow
    for kernel, kind, n in ((coherent, "camera", 1), (coherent, first, n_ls),
                            (incoherent, shadow, (bounces - 1) * n_ls),
                            (incoherent, "bounce", bounces)):
        out[(tag, kernel, kind)] = out.get((tag, kernel, kind), 0) + n
    if envmap_sampled(opts, scene):
        out[(tag, incoherent, "envmap")] = bounces
    if restir:
        rs = settings.restir_di
        spatial = (rs.spatial_enabled and rs.num_spatial_passes > 0
                   and not opts.restir_di_fused_spatiotemporal)
        out[(tag, incoherent, "initial")] = int(opts.restir_di_initial_visibility)
        out[(tag, incoherent, "restir")] = (
            int(opts.restir_di_spatial_visibility_last_pass and spatial)
            + int(opts.restir_di_final_visibility))
    return out


def sweeps_per_frame(opts, settings) -> int:
    """Launches a frame of the dense emissive sweep (emissive_sweep_kernel)
    on a path whose every bounce has a live ray: under RIS and ReSTIR DI the
    BSDF candidates sweep once a bounce (ReSTIR's masked first bounce too)
    and, under ReSTIR, once more in the initial candidates; the emitters
    are within DENSE_EMISSIVE_MAX wherever launches_per_frame holds."""
    from hiprt_pt_tpu_torch.core.settings import LightSamplingStrategy as L

    if opts.direct_light_sampling not in (L.RIS_BSDF_LIGHT, L.RESTIR_DI):
        return 0
    bounces = min(opts.max_bounces_static, int(settings.nb_bounces))
    return bounces + int(opts.direct_light_sampling == L.RESTIR_DI)


def frame_launches(tag, scene) -> dict:
    """launches_per_frame and, under RIS and ReSTIR DI, the dense emissive
    sweep's launches: {(tag, "emissive_sweep", "sweep"): sweeps_per_frame};
    and the principled BSDF's: {(tag, "principled_eval" |
    "principled_sample", "bsdf"): bsdf_calls_per_frame}."""
    from hiprt_pt_tpu_torch.paths import slice_options

    out = launches_per_frame(tag, scene)
    opts, settings = slice_options(tag)[:2]
    sweeps = sweeps_per_frame(opts, settings)
    if sweeps:
        out[(tag, "emissive_sweep", "sweep")] = sweeps
    for k, v in bsdf_calls_per_frame(opts, settings, scene).items():
        if v:
            out[(tag, k, "bsdf")] = v
    return out


def path_kernels(tag) -> set:
    """The kernels a path's frames launch (keys of
    cuda_build.launch_counts): its routes' (paths.ROUTES), under RIS
    and ReSTIR DI the dense emissive sweep, and the principled BSDF's that
    its options call."""
    from hiprt_pt_tpu_torch.paths import ROUTES, slice_options

    opts, settings = slice_options(tag)[:2]
    sweeps = sweeps_per_frame(opts, settings)
    bsdf = {k for k, v in bsdf_calls_per_frame(opts, settings).items() if v}
    return set(ROUTES[tag]) | ({"emissive_sweep"} if sweeps else set()) | bsdf


def phase_slice(tag, scene, cam, bvh, kernels):
    """One warm-up frame and 4 timed frames at 1920x1080. Every kernel of
    ``kernels`` must be launched in them, and no other, as many times as
    frame_launches says."""
    from hiprt_pt_tpu_torch.ops import traverse
    from hiprt_pt_tpu_torch.paths import slice_options
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    opts, settings, world = slice_options(tag)
    r = Renderer(scene, cam, WIDTH, HEIGHT, options=opts, settings=settings,
                 world=world, bvh=bvh, seed=42)
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    traverse.reset_march_counts(tally=True)
    r.step()  # warm-up frame
    torch.cuda.synchronize()
    rays0 = r.rays_traced
    frames = SLICE_FRAMES - 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(frames):
        r.step()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_build.launch_counts)
    march = {k: v if isinstance(v, dict) else int(v)
             for k, v in traverse.march_counts.items()}
    ms = start.elapsed_time(end)
    rays = r.rays_traced - rays0
    img = r.hdr_image()
    nonblack = float(np.mean(img.sum(-1) > 0.0))
    per_kind = frame_launches(tag, scene)
    log(f"[{tag} slice] {WIDTH}x{HEIGHT}, {settings.nb_bounces} bounces, "
        f"{frames} timed frames: "
        f"{ms:.1f} ms ({ms / frames:.2f} ms/frame; {wall * 1e3:.1f} ms host "
        f"clock), {rays} rays, {rays / ms / 1e3:.3f} Mrays/s, "
        f"{frames / ms * 1e3:.3f} spp/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}; per frame by ray kind {per_kind}; image mean "
        f"{float(img.mean()):.6f}, non-black {nonblack:.4f}")
    segments = march["segments"]
    if alpha_shadows(scene):
        log(f"[{tag} slice] the alpha march, per frame: "
            f"{march['calls'] / SLICE_FRAMES:g} calls, "
            f"{march['rays'] / SLICE_FRAMES:.1f} shadow rays given, "
            f"{march['entered'] / SLICE_FRAMES:.1f} entered it (the prune "
            f"found a blocker), {march['passed'] / SLICE_FRAMES:.1f} passed "
            f"through at least one surface; segments run "
            f"{ {k: v / SLICE_FRAMES for k, v in segments.items()} }")
        if march["passed"] == 0:
            raise AssertionError(f"{tag}: no shadow ray passed through a "
                                 f"surface in {SLICE_FRAMES} frames")
        for k, v in segments.items():
            per_kind[(tag, k, "segment")] = v / SLICE_FRAMES
    elif march["calls"]:
        raise AssertionError(f"{tag}: the alpha march ran on a scene without "
                             f"alpha textures")
    for k, v in launches.items():
        if (v > 0) != (k in kernels):
            raise AssertionError(
                f"{k} was launched {v} times by the {tag} path, which should "
                f"launch exactly {sorted(kernels)}")
        want = segments.get(k, 0) + SLICE_FRAMES * sum(
            n for (_, kk, kind), n in per_kind.items()
            if kk == k and kind != "segment")
        if v != want:
            raise AssertionError(f"{k} was launched {v} times in {SLICE_FRAMES} "
                                 f"frames of the {tag} path; its ray kinds "
                                 f"{per_kind} make {want}")
    if alpha_shadows(scene):
        sites = host_syncs(r.step)
        log(f"[{tag} slice] one frame: {sum(sites.values())} host syncs, "
            f"{json.dumps(dict(sites.most_common()))}")
    if not np.isfinite(img).all():
        raise AssertionError(f"{tag} slice image is not finite")
    if nonblack <= 0.5:
        raise AssertionError(f"{tag} slice image is only {nonblack:.3f} non-black")
    return launches, per_kind


def images_agree(tag, what, got, ref, rays_got, rays_ref):
    """Hold one 256x128 render against another (PIX_* above); raises."""
    close = np.all(np.abs(got - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref), axis=-1)
    frac = float(close.mean())
    mean_rel = abs(float(got.mean()) - float(ref.mean())) / max(float(ref.mean()), 1e-12)
    rays_rel = abs(rays_got - rays_ref) / max(rays_ref, 1)
    log(f"[{tag} parity] {what}: {frac:.5f} of pixels close, image mean rel "
        f"diff {mean_rel:.2e}, rays {rays_got} vs {rays_ref}")
    if frac < PIX_FRAC or mean_rel > 0.01 or rays_rel > 0.005:
        raise AssertionError(f"{tag}: {what}: the renders disagree")


def phase_parity(tag, scene, cam, bvh):
    """One sample at 256x128 (two on the ReSTIR path) on the GPU (kernels)
    and on the CPU (plain walks); on the PLAIN_ON_GPU paths also on the GPU
    with use_pallas_traversal off, which must launch no traversal kernel; on the
    ReSTIR path also the fused spatiotemporal mode, GPU vs CPU; on the
    envmap path also the CDF's binary search in place of the alias table,
    GPU vs CPU."""
    from hiprt_pt_tpu_torch.paths import slice_options
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    opts, settings, world = slice_options(tag)
    settings = settings.replace(samples_per_frame=2 if tag == "restir" else 1)
    w, h = 256, 128
    cpu = torch.device("cpu")
    t0 = time.perf_counter()

    def render(sc, c, b, options, sets=settings):
        r = Renderer(sc, c, w, h, options=options, settings=sets,
                     world=world, bvh=b, seed=42)
        r.step()
        return r.hdr_image(), r.rays_traced

    gpu, rays_gpu = render(scene, cam, bvh, opts)
    ref, rays_ref = render(scene.to(cpu), cam.to(cpu), bvh.to(cpu), opts)
    images_agree(tag, "GPU vs CPU", gpu, ref, rays_gpu, rays_ref)
    if tag in PLAIN_ON_GPU:
        # the option is the walks': the emissive sweep and the principled
        # BSDF's kernels launch as before
        def walks():
            return {k: cuda_build.launch_counts[k] for k in KERNEL_TABLES}

        before = walks()
        oracle, rays_o = render(scene, cam, bvh,
                                opts.replace(use_pallas_traversal=False))
        if walks() != before:
            raise AssertionError(f"{tag}: use_pallas_traversal=False launched "
                                 f"kernels: {before} -> {walks()}")
        images_agree(tag, "GPU kernels vs GPU plain walks (no launches)", gpu,
                     oracle, rays_gpu, rays_o)
        images_agree(tag, "GPU plain walks vs CPU", oracle, ref, rays_o, rays_ref)
    if tag == "restir":
        fused = opts.replace(restir_di_fused_spatiotemporal=True)
        gpu_f, rays_gf = render(scene, cam, bvh, fused)
        ref_f, rays_cf = render(scene.to(cpu), cam.to(cpu), bvh.to(cpu), fused)
        images_agree(tag, "fused spatiotemporal, GPU vs CPU", gpu_f, ref_f,
                     rays_gf, rays_cf)
    if tag == "envmap":
        from hiprt_pt_tpu_torch.core.settings import EnvmapSamplingStrategy

        cdf = opts.replace(envmap_sampling=EnvmapSamplingStrategy.CDF_BINARY)
        gpu_c, rays_gc = render(scene, cam, bvh, cdf)
        ref_c, rays_cc = render(scene.to(cpu), cam.to(cpu), bvh.to(cpu), cdf)
        images_agree(tag, "CDF_BINARY envmap sampling, GPU vs CPU", gpu_c,
                     ref_c, rays_gc, rays_cc)
    if tag == "gltf":
        from hiprt_pt_tpu_torch.core.settings import LightSamplingStrategy
        from hiprt_pt_tpu_torch.ops import traverse

        for strategy, spp in GLTF_PARITY:
            other = opts.replace(direct_light_sampling=getattr(
                LightSamplingStrategy, strategy))
            sets = settings.replace(samples_per_frame=spp)
            traverse.reset_march_counts()
            gpu_s, rays_gs = render(scene, cam, bvh, other, sets)
            calls = traverse.march_counts["calls"]
            ref_s, rays_cs = render(scene.to(cpu), cam.to(cpu), bvh.to(cpu),
                                    other, sets)
            images_agree(tag, f"{strategy}, {spp} sample(s), GPU vs CPU "
                         f"({calls} marches on the card)", gpu_s, ref_s,
                         rays_gs, rays_cs)
            if not calls:
                raise AssertionError(f"{tag}: {strategy} ran no alpha march")
    log(f"[{tag} parity] {w}x{h}, {settings.samples_per_frame} sample(s): "
        f"{time.perf_counter() - t0:.1f} s")


def host_syncs(fn) -> collections.Counter:
    """The host syncs of one call of ``fn`` (each a device value read on
    the host or a blocking copy), counted by the line of the port that
    makes them."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchronizing" in str(w.message))


def phase_renderer(tag, scene, cam, bvh):
    """The Renderer's frame loop at 1920x1080 with the path's options: a
    blocking step and its metrics beside the frame's time between CUDA
    events, the host syncs of one step, frame_render_done() on an
    unfinished frame and after a synchronise,
    render() stopping at max_sample_count, profile() (the live state left
    as it was), kernel_stats() and the images; raises on any disagreement."""
    from hiprt_pt_tpu_torch.paths import ROUTES, slice_options
    from hiprt_pt_tpu_torch.render import renderer as renderer_mod
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    opts, settings, world = slice_options(tag)
    r = Renderer(scene, cam, WIDTH, HEIGHT, options=opts, settings=settings,
                 world=world, bvh=bvh, seed=42)
    r.step(block=True)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    r.step(block=True)
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end)
    frame_ms, sps = r.metrics.values("frame_ms"), r.metrics.values("samples_per_s")
    log(f"[{tag} renderer] step(block=True): metrics frame_ms {frame_ms}, "
        f"samples_per_s {sps}; the second frame {event_ms:.2f} ms between "
        f"CUDA events")
    if len(frame_ms) != 2 or min(frame_ms) <= 0.0 or min(sps) <= 0.0:
        raise AssertionError(f"{tag}: step(block=True) metrics {frame_ms} {sps}")
    sites = host_syncs(r.step)
    log(f"[{tag} renderer] one step: {sum(sites.values())} host syncs, "
        f"{json.dumps(dict(sites.most_common()))}")
    # a frame whose last queued work is about a second of device sleep
    # (render_step wrapped for one step), so it is unfinished when step()
    # returns whatever the step synchronises before that
    real_step = renderer_mod.render_step

    def slow_step(*args, **kw):
        state = real_step(*args, **kw)
        torch.cuda._sleep(SLEEP_CYCLES)
        return state

    renderer_mod.render_step = slow_step
    try:
        r.step()
        queued = r.frame_render_done()
    finally:
        renderer_mod.render_step = real_step
    torch.cuda.synchronize()
    done = r.frame_render_done()
    log(f"[{tag} renderer] frame_render_done(): {queued} on a frame that "
        f"ends in {SLEEP_CYCLES} cycles of sleep, {done} after a synchronise")
    if queued or not done:
        raise AssertionError(f"{tag}: frame_render_done() gave {queued} on "
                             f"an unfinished frame and {done} after a "
                             f"synchronise")
    r.reset()
    r.max_sample_count = 2
    t0 = time.perf_counter()
    r.render(total_samples=3)
    log(f"[{tag} renderer] render(total_samples=3) with max_sample_count=2: "
        f"{r.state.sample_count} samples, {time.perf_counter() - t0:.2f} s")
    if r.state.sample_count != 2 or not r.is_rendering_done():
        raise AssertionError(f"{tag}: render() stopped at "
                             f"{r.state.sample_count} samples, not 2")
    live, accum = r.state, r.state.accum.clone()
    prof = r.profile(frames=2)
    log(f"[{tag} renderer] profile(): {json.dumps(prof)}")
    if (r.state is not live or r.state.sample_count != 2
            or not torch.equal(r.state.accum, accum)):
        raise AssertionError(f"{tag}: profile() changed the live state")
    if prof["nb_bounces"] != settings.nb_bounces or not (
            0.0 < prof["camera_pass_ms"] < prof["full_frame_ms"]):
        raise AssertionError(f"{tag}: profile() gave {prof}")
    stats = r.kernel_stats()
    log(f"[{tag} renderer] kernel_stats(): {json.dumps(stats)}")
    if set(stats["kernels"]) != set(ROUTES[tag]) or any(
            m["registers"] <= 0 or m["blocks_per_sm"] <= 0
            for k in stats["kernels"].values() for m in k.values()):
        raise AssertionError(f"{tag}: kernel_stats() gave {stats['kernels']}")
    ldr = r.ldr_image()
    alb, nrm = r.aov_images()
    for name, img in (("ldr", ldr), ("albedo", alb), ("normal", nrm)):
        if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all():
            raise AssertionError(f"{tag}: the {name} image is {img.shape}, "
                                 f"finite {np.isfinite(img).all()}")
    if ldr.min() < 0.0 or ldr.max() > 1.0:
        raise AssertionError(f"{tag}: ldr_image() leaves [0, 1]")
    log(f"[{tag} renderer] ldr_image mean {float(ldr.mean()):.6f}, albedo "
        f"mean {float(alb.mean()):.6f}, normal |mean| "
        f"{float(np.abs(nrm).mean()):.6f}")


def run_cli(argv, stats=None):
    """app/cli.py's main(argv) in this process; returns the Renderer it
    made (kept by a subclass put in place for the call). Raises unless
    main returns 0."""
    from hiprt_pt_tpu_torch.app.cli import main
    from hiprt_pt_tpu_torch.render import renderer as renderer_mod

    made, real = [], renderer_mod.Renderer

    class Kept(real):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    renderer_mod.Renderer = Kept
    try:
        rc = main(argv, stats)
    finally:
        renderer_mod.Renderer = real
    if rc != 0 or len(made) != 1:
        raise AssertionError(f"cli main{argv} returned {rc}")
    return made[0]


def host_launches(calls) -> dict:
    """{name: kernel launches that one call of fn makes from the host} for
    each (name, fn) of ``calls``, in one torch.profiler session: the
    cudaLaunchKernel events inside each call's record_function range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in calls:
            with record_function(name):
                fn()
                torch.cuda.synchronize()
    names = {name for name, _fn in calls}
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = {e.name: e.time_range for e in events if e.name in names}
    starts = [e.time_range.start for e in events if e.name in LAUNCH_EVENTS]
    return {n: sum(r.start <= t <= r.end for t in starts)
            for n, r in spans.items()}


def states_differ(a, b) -> list:
    """The state leaves (field paths) in which two render states differ."""
    from hiprt_pt_tpu_torch.render.checkpoint import _leaves

    return [".".join(name) for (name, x), (_, y) in zip(_leaves(a), _leaves(b))
            if not (torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor)
                    else x == y)]


def phase_cli_denoisers(r):
    """d. The denoisers on the cli path's 1080p AOVs (render/denoise.py:
    collect_aovs of the renderer ``r``) on the card: ms between CUDA events
    and host launches of one call each. Returns the check of their results
    against the same functions on the CPU, a callable that raises, which
    phase_cli runs beside the subprocess."""
    import importlib

    from hiprt_pt_tpu_torch.render.denoise import atrous_denoise, collect_aovs

    nn = importlib.import_module("hiprt_pt_tpu_torch.render.denoise_nn")
    dev = r.device
    hdr, alb, nrm, var, spp = collect_aovs(r)
    alb, nrm = torch.from_numpy(alb.copy()).to(dev), torch.from_numpy(nrm.copy()).to(dev)
    params = nn.load_params(device=dev)
    calls = {  # name: (fn of (hdr, alb, nrm, var, spp, params, the filter's output))
        "atrous_denoise, variance maps":
            lambda h, a, n, v, s, p, f: atrous_denoise(h, a, n, variance=v,
                                                       spp_map=s),
        "atrous_denoise, fixed sigma":
            lambda h, a, n, v, s, p, f: atrous_denoise(h, a, n),
        "denoise_nn.apply (cuDNN, f32)":
            lambda h, a, n, v, s, p, f: nn.apply(p, h, f, a, n, v, s),
    }
    card, ms, run = {}, {}, {}
    for name, fn in calls.items():
        args = (hdr, alb, nrm, var, spp, params,
                card.get("atrous_denoise, variance maps"))
        run[name] = (lambda fn=fn, args=args: fn(*args))
        ms[name], card[name] = cuda_ms(run[name])
    launches = host_launches(list(run.items()))
    for name in calls:
        log(f"[cli denoise] {name} at {WIDTH}x{HEIGHT}: {ms[name]:.2f} ms, "
            f"{launches[name]} host launches a call")
    inputs = [x.cpu() for x in (hdr, alb, nrm, var, spp)]
    card = {k: v.cpu() for k, v in card.items()}

    def check():
        ref = {}
        params_cpu = nn.load_params(device="cpu")
        for name, fn in calls.items():
            ref[name] = fn(*inputs, params_cpu,
                           ref.get("atrous_denoise, variance maps"))
            err = float((card[name] - ref[name]).abs().max())
            log(f"[cli denoise] {name}: card vs CPU max |diff| {err:.3e}")
            atol, rtol = CNN_TOL if name.startswith("denoise_nn") else ATROUS_TOL
            torch.testing.assert_close(card[name], ref[name], atol=atol, rtol=rtol)

    return check


def phase_cli(dev) -> dict:
    """The cli path: python -m hiprt_pt_tpu_torch.app.cli on the gltf path's
    scene file with paths.CLI_FLAGS. e: the command in this process (the
    main path: launch counts reset just before and read just after, held
    against frame_launches for each of its samples); d: the denoisers
    on its AOVs, card vs CPU; a: the command as a subprocess, whose PNG
    decodes to 1920x1080x3; c: the command at CLI_PARITY on the card and
    with --cpu (a second subprocess, its raw HDR from its checkpoint), raw
    and denoised HDR under the image gate; b: 2 samples with --checkpoint,
    then --resume to 4, against e's render. The two subprocesses run
    beside c's card run, b and d's CPU side. Returns e's launches by
    kernel."""
    import tempfile

    from hiprt_pt_tpu_torch import paths
    from hiprt_pt_tpu_torch.assets.image_io import decode_png
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.ops import traverse
    from hiprt_pt_tpu_torch.ops.pixel_order import unscramble
    from hiprt_pt_tpu_torch.ops.tonemap import resolve_accumulation
    from hiprt_pt_tpu_torch.render.checkpoint import load_checkpoint

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        def folder(name):
            os.makedirs(os.path.join(tmp, name), exist_ok=True)
            return os.path.join(tmp, name)

        t0 = time.perf_counter()
        glb = paths.write_gltf_scene(tmp)
        log(f"[cli] wrote {os.path.basename(glb)} in "
            f"{time.perf_counter() - t0:.3f} s; argv "
            f"{paths.cli_argv('stress.glb', '<dir>')}")

        # e. the main path
        argv = paths.cli_argv(glb, folder("e"))
        stats = {}
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launch_counts()
        traverse.reset_march_counts()
        r = run_cli(argv, stats)
        launches = dict(cuda_build.launch_counts)
        segments = dict(traverse.march_counts["segments"])
        peak = torch.cuda.max_memory_allocated()
        per_kind = frame_launches("cli", r.scene)
        samples = r.state.sample_count
        log(f"[cli main] {stats['samples']} samples in frames of "
            f"{r.settings.samples_per_frame}: {stats['frame_ms']:.1f} ms/frame "
            f"({stats['frame_ms'] / r.settings.samples_per_frame:.1f} ms a "
            f"sample), {stats['samples_per_s']:.3f} spp/s (Renderer.metrics); "
            f"seconds: load {stats['load']:.3f}, bvh {stats['bvh']:.3f}, render "
            f"{stats['render']:.3f}, denoise {stats['denoise']:.3f}, png "
            f"{stats['png']:.3f}, hdr {stats['hdr']:.3f}, checkpoint "
            f"{stats['checkpoint']:.3f}; {stats['rays']} rays; peak device "
            f"memory {peak / 2**30:.2f} GiB; launches {launches}, march "
            f"segments {segments}; a sample by ray kind {per_kind}")
        for k, v in launches.items():
            want = segments.get(k, 0) + samples * sum(
                n for (_, kk, _kind), n in per_kind.items() if kk == k)
            if (v > 0) != (k in path_kernels("cli")) or v != want:
                raise AssertionError(f"the cli path launched {k} {v} times in "
                                     f"{samples} samples; its ray kinds make {want}")
        os.remove(os.path.join(tmp, "e", "cli.npz"))  # read by no later step
        hdr_e = r.hdr_image()
        if samples != 4 or not np.isfinite(hdr_e).all():
            raise AssertionError(f"the cli path rendered {samples} samples, "
                                 f"finite {np.isfinite(hdr_e).all()}")

        # d. the denoisers on its AOVs, timed on the card before the
        # subprocess starts and checked against the CPU beside it
        t0 = time.perf_counter()
        check_denoisers = phase_cli_denoisers(r)
        log(f"[cli denoise] on the card: {time.perf_counter() - t0:.1f} s")

        # a, and c's CPU side: the command as two subprocesses, the
        # documented command on the card and the parity size with --cpu,
        # beside c's card run, b and d's CPU side in this process
        w, h, spp = CLI_PARITY
        small = [f"--w={w}", f"--h={h}", f"--samples={spp}"]
        procs = {}
        t_sub = time.perf_counter()
        try:
            for name, extra in (("a", []), ("c_cpu", small + ["--cpu"])):
                with open(os.path.join(tmp, f"{name}.log"), "w") as out:
                    procs[name] = subprocess.Popen(
                        [sys.executable, "-m", "hiprt_pt_tpu_torch.app.cli",
                         *paths.cli_argv(glb, folder(name)), *extra], cwd=here,
                        stdout=out, stderr=subprocess.STDOUT)
            # c. the card's run at CLI_PARITY
            rg_stats = {}
            rg = run_cli(paths.cli_argv(glb, folder("c_gpu")) + small, rg_stats)
            # b. checkpoint and resume against e
            half = os.path.join(folder("b"), "half")
            run_cli(paths.cli_argv(glb, os.path.join(tmp, "b"))
                    + ["--samples=2", f"--checkpoint={half}"])
            rb = run_cli(paths.cli_argv(glb, os.path.join(tmp, "b"))
                         + [f"--resume={half}.npz"])
            t0 = time.perf_counter()
            check_denoisers()
            log(f"[cli denoise] the CPU's results: "
                f"{time.perf_counter() - t0:.1f} s")
            exits = {name: p.wait(timeout=900) for name, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        sub_s = time.perf_counter() - t_sub
        for name, code in exits.items():
            if code != 0:
                with open(os.path.join(tmp, f"{name}.log")) as f:
                    raise AssertionError(f"the cli subprocess {name} exited "
                                         f"{code}:\n{f.read()[-2000:]}")

        hdr_b = rb.hdr_image()
        diff = states_differ(rb.state, r.state)
        err = float(np.abs(hdr_b - hdr_e).max())
        log(f"[cli resume] 2 samples, checkpoint, --resume to "
            f"{rb.state.sample_count}: max |HDR - straight run's| {err:.3e}; "
            f"state leaves that differ: {diff or 'none (bit-identical)'}")
        if rb.state.sample_count != 4:
            raise AssertionError("the resumed run did not reach 4 samples")
        if diff:
            images_agree("cli", "resumed vs straight", hdr_b, hdr_e,
                         int(rb.state.rays_traced), int(r.state.rays_traced))

        with open(os.path.join(tmp, "a", "cli.png"), "rb") as f:
            png = decode_png(f.read())
        same = _read_bytes(os.path.join(tmp, "a", "cli.hdr")) == _read_bytes(
            os.path.join(tmp, "e", "cli.hdr"))
        log(f"[cli subprocess] a and c_cpu exited 0 within {sub_s:.1f} s of "
            f"their start; a's PNG {png.shape}, mean {float(png.mean()):.3f}; "
            f"its .hdr byte-identical to the in-process run's: {same}")
        if png.shape != (HEIGHT, WIDTH, 3):
            raise AssertionError(f"the cli PNG decodes to {png.shape}")

        cpu_state = load_checkpoint(
            os.path.join(tmp, "c_cpu", "cli.npz"),
            init_render_state(w, h, device="cpu", with_restir=True))
        raw_cpu = unscramble(resolve_accumulation(
            cpu_state.accum, cpu_state.sample_count).numpy(), w, h)[::-1]
        rays_cpu = int(cpu_state.rays_traced)
        log(f"[cli parity] {w}x{h}, {spp} samples: the card's render "
            f"{rg_stats['render']:.2f} s")
        images_agree("cli", "raw HDR, card vs CPU", rg.hdr_image(), raw_cpu,
                     rg_stats["rays"], rays_cpu)
        images_agree("cli", "denoised HDR (the .hdr files), card vs CPU",
                     _read_hdr(tmp, "c_gpu"), _read_hdr(tmp, "c_cpu"),
                     rg_stats["rays"], rays_cpu)
        del r, rb, rg
    torch.cuda.empty_cache()
    return launches


def _read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _read_hdr(tmp, name):
    from hiprt_pt_tpu_torch.assets.image_io import read_hdr

    return read_hdr(os.path.join(tmp, name, "cli.hdr"))


def probe_bound(cfg):
    """(ms, "bytes" or "operations") of a probe configuration on the H100
    SXM, from the work of the function the probe returns: the larger of its
    maxima, one operation each at the 67 T/s rate outside the tensor cores,
    and the table, indices and output once at 3.35 TB/s. P1's function,
    sum_r sum_j max_w tab[(idx[r % 8, j] + r) mod L, w], takes W NL rounds
    maxima (its one-hot product's 2 L W NL rounds operations are the
    probe's method, not the function's work: the row's "eff" reads the
    product against the tensor cores' peak); P2's takes S tiles 128 rounds."""
    if cfg["probe"] == "P1":
        op_ms = cfg["W"] * cfg["NL"] * cfg["rounds"] / F32_OPS_PER_S * 1e3
        size = torch.empty((), dtype=getattr(torch, cfg["dtype"])).element_size()
        nbytes = cfg["L"] * cfg["W"] * size + 8 * cfg["NL"] * 4 + 4
    else:
        op_ms = cfg["S"] * cfg["tiles"] * 128 * cfg["rounds"] / F32_OPS_PER_S * 1e3
        nbytes = cfg["S"] * cfg["tiles"] * 128 * 4 + cfg["S"] * 128 * 4 + 4
    byte_ms = nbytes / BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms > byte_ms else "bytes")


def mm_library_ms(table, idx, rounds):
    """The yardstick of P1: the one-hot product alone, rounds x (W x Lpad) .
    (Lpad x NL), through torch._int_mm (int8) or torch.matmul (bf16); no
    max, no sum. The one-hot operand is column-major, the layout cuBLAS
    takes on its fast path. (ms, None) or (None, the reason it was
    refused)."""
    tab = table.tab
    L, W = tab.shape
    l_pad, NL = table.tab_t.shape[1], idx.shape[1]
    a = table.tab_t[:W]
    hots = []
    for r in range(rounds):
        oh = torch.zeros((NL, l_pad), dtype=tab.dtype, device=tab.device)
        oh[torch.arange(NL, device=tab.device),
           torch.remainder(idx[r % 8].long() + r, L)] = 1
        hots.append(oh.t())
    mm = torch._int_mm if tab.dtype == torch.int8 else torch.matmul

    def run():
        for oh in hots:
            mm(a, oh)
    try:
        return cuda_ms(run, reps=3)[0], None
    except RuntimeError as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def dg_library_ms(tab, idx, rounds):
    """The yardstick of P2: rounds x tiles torch.gather of one (S, 128)
    tile."""
    S, tiles = tab.shape[0], tab.shape[1] // 128
    rows = [torch.remainder(idx.long() + r, S) for r in range(rounds)]
    cols = [tab[:, c * 128:(c + 1) * 128] for c in range(tiles)]

    def run():
        for rr in rows:
            for cc in cols:
                torch.gather(cc, 0, rr)
    return cuda_ms(run, reps=3)[0]


def phase_probes(dev):
    """The probe entry point (probes/r5probe2.py:main) at the TPU probe's
    shapes with the launch counts reset just before and read just after;
    each kernel against its plain version on gate inputs (exactly equal),
    and on the probe's own inputs (the constant); plain and library times
    and the bounds. Returns ({kernel: launches}, {kernel: max |err|}, the
    configurations' rows)."""
    from hiprt_pt_tpu_torch.probes import r5probe2 as pr

    where = pr.card()
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    results = pr.main(dev)
    launches = {k + "_kernel": cuda_build.launch_counts[k]
                for k in ("mm_probe", "dg_probe")}
    log(f"[probes] main() at the probe's shapes: {time.perf_counter() - t0:.1f} s, "
        f"launches {launches}")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"{k} was not launched by the probe entry point")
    # the probe's own inputs give the constant
    for res in results:
        if res["probe"] == "P1":
            want = 127 * res["NL"] * res["rounds"]
        elif res["probe"] == "P2":
            want = res["tiles"] * 128 * res["rounds"]
        else:
            want = 16 * res["N"] * res["C"]
        # Q3's library sum of 16.0s is exact in practice, not by contract
        if res["probe"] == "Q3" and abs(res["value"] - want) <= 1e-6 * want:
            continue
        if res["value"] != want:
            raise AssertionError(f"probe {res}: value {res['value']}, the "
                                 f"probe's inputs give {want}")
    log("[probes] every configuration gives the constant of the probe's own "
        "inputs")
    # the gate: seeded inputs whose answer is not constant, full widths;
    # errs: the largest |kernel - plain| of each kernel's gates
    errs = {"mm_probe_kernel": 0.0, "dg_probe_kernel": 0.0}
    for i, (label, L, W, NL, dtype, groups) in enumerate(pr.MM_CONFIGS):
        tab, idx = pr.mm_gate_inputs(L, W, NL, dtype, seed=10 + i, device=dev)
        table = pr.mm_table(tab)
        first = pr.mm_probe_kernel(table, idx, pr.ROUNDS, groups)
        again = pr.mm_probe_kernel(table, idx, pr.ROUNDS, groups)
        got = float(first)
        want = float(pr.mm_probe_plain(tab, idx, pr.ROUNDS, groups))
        errs["mm_probe_kernel"] = max(errs["mm_probe_kernel"], abs(got - want))
        log(f"[probes] mm_probe_kernel {label} gate (L={L} W={W} NL={NL} "
            f"{dtype} g={groups}, {pr.ROUNDS} rounds): kernel {got}, plain "
            f"{want}, a second run {float(again)}")
        if got != want:
            raise AssertionError(f"mm_probe_kernel {label}: {got} != {want}")
        if not torch.equal(first, again):
            raise AssertionError(f"mm_probe_kernel {label}: two runs differ")
    # off the kernel's tile: masked gathered rows, masked table rows, zero
    # fill past L
    for L, W, NL in P1_OFF_TILE:
        for dtype in pr.MM_DTYPES:
            tab, idx = pr.mm_gate_inputs(L, W, NL, dtype, seed=40, device=dev)
            table = pr.mm_table(tab)
            for groups in (1, 2, 8):
                got = float(pr.mm_probe_kernel(table, idx, P1_OFF_TILE_ROUNDS,
                                               groups))
                want = float(pr.mm_probe_plain(tab, idx, P1_OFF_TILE_ROUNDS,
                                               groups))
                errs["mm_probe_kernel"] = max(errs["mm_probe_kernel"],
                                              abs(got - want))
                if got != want:
                    raise AssertionError(
                        f"mm_probe_kernel off the tile (L={L} W={W} NL={NL} "
                        f"{dtype} g={groups}): {got} != {want}")
    log(f"[probes] mm_probe_kernel off its tile: {len(P1_OFF_TILE)} shapes "
        f"{P1_OFF_TILE} x int8, bf16 x 1, 2, 8 groups, {P1_OFF_TILE_ROUNDS} "
        f"rounds: every result equals the plain version's")
    for i, (S, tiles) in enumerate(pr.DG_CONFIGS):
        for per_lane in (True, False):
            tab, idx = pr.dg_gate_inputs(S, tiles, seed=20 + i, device=dev,
                                         per_lane=per_lane)
            first = pr.dg_probe_kernel(tab, idx, DG_GATE_ROUNDS)
            again = pr.dg_probe_kernel(tab, idx, DG_GATE_ROUNDS)
            got = float(first)
            want = float(pr.dg_probe_plain(tab, idx, DG_GATE_ROUNDS))
            errs["dg_probe_kernel"] = max(errs["dg_probe_kernel"], abs(got - want))
            log(f"[probes] dg_probe_kernel gate (S={S} tiles={tiles}, "
                f"{'per-lane' if per_lane else 'broadcast'} indices, "
                f"{DG_GATE_ROUNDS} rounds): kernel {got}, plain {want}, a "
                f"second run {float(again)}")
            if got != want:
                raise AssertionError(f"dg_probe_kernel S={S} tiles={tiles}: "
                                     f"{got} != {want}")
            if not torch.equal(first, again):
                raise AssertionError(f"dg_probe_kernel S={S} tiles={tiles}: two "
                                     f"runs differ")
    # past the shared-memory size the L2 kernel runs (negative indices too)
    S, tiles = P2_PAST_SHARED
    if pr.dg_plan(S, tiles)[0] != 0:
        raise AssertionError(f"S={S} should be past dg_probe_kernel's strips")
    tab, idx = pr.dg_gate_inputs(S, tiles, seed=25, device=dev)
    idx = (idx - S * (idx % 3 == 0).int()).contiguous()
    got = float(pr.dg_probe_kernel(tab, idx, DG_GATE_ROUNDS))
    want = float(pr.dg_probe_plain(tab, idx, DG_GATE_ROUNDS))
    errs["dg_probe_kernel"] = max(errs["dg_probe_kernel"], abs(got - want))
    log(f"[probes] dg_probe_kernel past the shared-memory size (S={S} "
        f"tiles={tiles}, negative indices, gathers served from "
        f"{pr.dg_served_from(0)}): kernel {got}, plain {want}")
    if got != want:
        raise AssertionError(f"dg_probe_kernel S={S} tiles={tiles}: {got} != {want}")
    S, tiles = pr.DG_CONFIGS[-1]
    tab, idx = pr.dg_gate_inputs(S, tiles, seed=30, device=dev, integer=False)
    first = pr.dg_probe_kernel(tab, idx, pr.ROUNDS)
    again = pr.dg_probe_kernel(tab, idx, pr.ROUNDS + 1)
    got = float(first)
    want = float(pr.dg_probe_plain(tab, idx, pr.ROUNDS))
    want33 = float(pr.dg_probe_plain(tab, idx, pr.ROUNDS + 1))
    errs["dg_probe_kernel"] = max(errs["dg_probe_kernel"], abs(got - want))
    log(f"[probes] dg_probe_kernel float table (S={S} tiles={tiles}, "
        f"{pr.ROUNDS} rounds): kernel {got!r}, plain (float64) {want!r}, "
        f"rel. diff {abs(got - want) / abs(want):.3e} (rtol {PROBE_FLOAT_RTOL}); "
        f"{pr.ROUNDS + 1} rounds (a second pass): kernel {float(again)!r}, "
        f"plain {want33!r}")
    if not abs(got - want) <= PROBE_FLOAT_RTOL * abs(want):
        raise AssertionError("dg_probe_kernel disagrees on the float table")
    if not abs(float(again) - want33) <= PROBE_FLOAT_RTOL * abs(want33):
        raise AssertionError("dg_probe_kernel disagrees on the float table in "
                             "a second pass of rounds")
    if not torch.equal(first, pr.dg_probe_kernel(tab, idx, pr.ROUNDS)):
        raise AssertionError("dg_probe_kernel: two runs on the float table differ")
    del tab, idx

    # times at the probe's shapes: the kernel's from main(), the plain
    # version's and the library's here
    rows = []
    for res in results:
        if res["probe"] == "Q3":
            continue
        row = dict(res)
        if res["probe"] == "P1":
            tab, idx = pr.mm_inputs(res["L"], res["W"], res["NL"],
                                    getattr(torch, res["dtype"]), dev)
            table = pr.mm_table(tab)
            row["plain_ms"] = cuda_ms(lambda: pr.mm_probe_plain(
                tab, idx, res["rounds"], res["groups"]), reps=1)[0]
            row["library_ms"], why = mm_library_ms(table, idx, res["rounds"])
            name = f"mm_probe_kernel {res['label']}"
            del table
        else:
            tab, idx = pr.dg_inputs(res["S"], res["tiles"], dev)
            row["plain_ms"] = cuda_ms(lambda: pr.dg_probe_plain(
                tab, idx, res["rounds"]), reps=1)[0]
            row["library_ms"], why = dg_library_ms(tab, idx, res["rounds"]), None
            name = f"dg_probe_kernel S={res['S']} tiles={res['tiles']}"
        del tab, idx
        row["bound_ms"], row["bound_by"] = probe_bound(res)
        if why is not None:
            log(f"[probes] {name}: the library yardstick was refused: {why}")
        lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.3f} ms"
        eff = ("" if "eff" not in row else f", one-hot product at "
               f"{row['eff'] * 100:.1f}% of the dense {row['dtype']} peak")
        if "gather_gbs" in row:
            eff = (f", {row['gather_gbs']:,.0f} GB/s of gathers served from "
                   f"{pr.dg_served_from(row['g'])}")
        log(f"[probes] {name}: kernel {row['ms']:.3f} ms "
            f"({row['ms'] / row['rounds'] * 1e3:.1f} us/round), plain "
            f"{row['plain_ms']:.3f} ms, library {lib}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), kernel / bound "
            f"{row['ms'] / row['bound_ms']:.2f}{eff} [{where}]")
        rows.append(row)
    torch.cuda.empty_cache()
    return launches, errs, rows


def _fetch(port, path, timeout=600):
    """(the body of GET path from the viewer on 127.0.0.1:port, seconds)."""
    import urllib.request

    t0 = time.perf_counter()
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=timeout).read()
    return body, time.perf_counter() - t0


def _poll(port, path, limit_s=600):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < limit_s:
        st = json.loads(_fetch(port, path)[0])
        if st["state"] != "running":
            if st["state"] != "done":
                raise AssertionError(f"{path}: {st}")
            return st
        time.sleep(0.2)
    raise AssertionError(f"{path} still running after {limit_s} s")


def _frames(r, after=0) -> list:
    """The frame_ms values of renderer r from the after-th on."""
    return r.metrics.values("frame_ms")[after:]


def _wait_frames(r, n, limit_s=300):
    t0 = time.perf_counter()
    while len(_frames(r)) < n:
        if time.perf_counter() - t0 > limit_s:
            raise AssertionError(f"the viewer's loop rendered {len(_frames(r))} "
                                 f"frames in {limit_s} s, not {n}")
        time.sleep(0.05)


def _wait_samples(r, n, limit_s=300):
    t0 = time.perf_counter()
    while r.state.sample_count < n:
        if time.perf_counter() - t0 > limit_s:
            raise AssertionError(f"the viewer's loop rendered "
                                 f"{r.state.sample_count} samples in "
                                 f"{limit_s} s, not {n}")
        time.sleep(0.05)


def phase_precompile(r):
    """Precompiler(max_workers=2).warm(r) on the six permutations, first
    with the build directory at a fresh temporary directory (a cold nvcc
    build), then again (warm). Returns the directory (left in force, so
    that the viewer's frames run the libraries built there) and the
    seconds of both."""
    import tempfile

    from hiprt_pt_tpu_torch.utils.precompile import (Precompiler,
                                                     enable_persistent_cache)

    cache = enable_persistent_cache(tempfile.mkdtemp(prefix="hpt_build_"))
    secs = {}
    for run in ("cold", "warm"):
        pc = Precompiler(max_workers=2)
        t0 = time.perf_counter()
        pc.warm(r)
        pc.wait(timeout=900)
        secs[run] = time.perf_counter() - t0
        pc.shutdown()
        log(f"[viewer precompile] {run}: compiled {pc.compiled}, failed "
            f"{pc.failed} in {secs[run]:.2f} s (build directory {cache}: "
            f"{sorted(os.listdir(cache))})")
        if (pc.compiled, pc.failed) != (6, 0):
            raise AssertionError(f"Precompiler {run}: compiled {pc.compiled}, "
                                 f"failed {pc.failed}, not 6 and 0")
    return cache, secs


def phase_viewer(dev) -> dict:
    """The viewer path: the README's viewer command through the port
    (load_scene_file(aspect=16/9) of the gltf path's .glb, Renderer(scene,
    cam, 1920, 1080) with the defaults, ViewerServer(...).serve() on
    127.0.0.1, a free port), after the Precompiler's cold and warm
    warm-ups. With the launch counts reset just before serve and read after
    stop: quiet frames, then the page, the nine views and /stats (frames
    rendered meanwhile: the busy ones), the served beauty image against
    ldr_image() of the same state (the loop paused), the panels, /perf with
    the passes, the camera controls, a settings, a material and an option
    edit, the presets fastest and high_quality (the edits still in force
    after each), /bake and /animate polled to done, stop() (both threads
    end). Returns the launches by kernel."""
    import shutil
    import tempfile

    from hiprt_pt_tpu_torch import paths
    from hiprt_pt_tpu_torch.app.viewer import VIEWS, ViewerServer
    from hiprt_pt_tpu_torch.assets.image_io import decode_png
    from hiprt_pt_tpu_torch.assets.loader import load_scene_file
    from hiprt_pt_tpu_torch.core.settings import LightSamplingStrategy as LSS
    from hiprt_pt_tpu_torch.render.renderer import Renderer
    from hiprt_pt_tpu_torch.utils.precompile import enable_persistent_cache

    with tempfile.TemporaryDirectory() as tmp:
        glb = paths.write_gltf_scene(tmp)
        t0 = time.perf_counter()
        scene, cam = load_scene_file(glb, aspect=16 / 9, device=dev)
        r = Renderer(scene, cam, WIDTH, HEIGHT)
        torch.cuda.synchronize()
        log(f"[viewer] load_scene_file + Renderer (its BVH "
            f"{r.bvh_build_time:.3f} s): {time.perf_counter() - t0:.3f} s; "
            f"options == RenderOptions(): "
            f"{(r.options, r.settings, r.world) == paths.slice_options('viewer')}")
        if (r.options, r.settings, r.world) != paths.slice_options("viewer"):
            raise AssertionError("the viewer's renderer is not the defaults")
        cache, pre = phase_precompile(r)
        cuda_build.reset_launch_counts()
        srv = ViewerServer(r, host="127.0.0.1", port=0).serve(blocking=False)
        port = srv._httpd.server_address[1]
        t_serve = time.perf_counter()
        try:
            _wait_frames(r, VIEWER_QUIET_FRAMES)
            quiet = _frames(r)
            n0 = len(quiet)
            secs = {}
            page, secs["/"] = _fetch(port, "/")
            if b"viewer" not in page:
                raise AssertionError("the page does not name the viewer")
            for view in VIEWS:
                png, secs[view] = _fetch(port, f"/image?view={view}")
                img = decode_png(png)
                if img.shape != (HEIGHT, WIDTH, 3):
                    raise AssertionError(f"/image?view={view}: {img.shape}")
            stats = json.loads(_fetch(port, "/stats")[0])
            busy = _frames(r, n0)
            log(f"[viewer] frames: {n0} before any request, median "
                f"{np.median(quiet):.1f} ms ({[round(x, 1) for x in quiet]}); "
                f"{len(busy)} while the page, the nine views and /stats were "
                f"served, median "
                f"{np.median(busy) if busy else float('nan'):.1f} ms; /stats "
                f"{stats}")
            log(f"[viewer] seconds a request at {WIDTH}x{HEIGHT}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in secs.items()))
            # the served beauty image is the renderer's display image of the
            # same state: the loop paused, the state read under the lock
            srv._busy.set()
            with srv._step_lock:
                state = r.state
                want = (np.clip(r.ldr_image(), 0, 1) * 255).astype(np.uint8)
            got = decode_png(_fetch(port, "/image?view=beauty")[0])
            same_state = r.state is state
            srv._busy.clear()
            log(f"[viewer] served beauty vs ldr_image() of the state at "
                f"{state.sample_count} samples: equal "
                f"{np.array_equal(got, want)}, state unchanged {same_state}")
            if not (same_state and np.array_equal(got, want)):
                raise AssertionError("the served beauty image is not the "
                                     "renderer's display image")
            panels = {}
            for path in ("/settings", "/materials", "/options", "/kernels",
                         "/bias", "/perf?passes=1"):
                body, dt = _fetch(port, path)
                panels[path] = json.loads(body)
                log(f"[viewer] {path}: {dt:.3f} s, {len(body)} bytes")
            if set(panels["/kernels"]["kernels"]) != set(paths.ROUTES["viewer"]):
                raise AssertionError(f"/kernels: {panels['/kernels']}")
            log(f"[viewer] /kernels: {panels['/kernels']['kernels']}; /perf "
                f"passes: {panels['/perf?passes=1']['passes_ms']}")
            (i0, key0, v0), (i1, key1, v1) = VIEWER_EDITS
            for q in ("rotate&yaw=0.1&pitch=0.05", "pan&dx=0.1&dy=-0.1",
                      "walk&dx=0&dy=0&dz=0.2", "orbit&value=10",
                      "zoom&value=0.3", "set&key=rr_min_depth&value=5",
                      f"material&index={i0}&key={key0}&value={v0}",
                      "option&key=do_thin_film&value=0",
                      "preset&value=fastest",
                      f"material&index={i1}&key={key1}&value={v1}",
                      "option&key=do_dispersion&value=0"):
                body, dt = _fetch(port, f"/control?cmd={q}")
                if not json.loads(body)["ok"]:
                    raise AssertionError(f"/control?cmd={q}: {body}")
                log(f"[viewer] /control?cmd={q}: {dt:.3f} s")
                if q == "preset&value=fastest":
                    half = srv.renderer
                    _wait_frames(half, 1)
                    log(f"[viewer] fastest: {half.width}x{half.height}, "
                        f"{half.options.direct_light_sampling.name}, a frame "
                        f"{_frames(half)[0]:.1f} ms")
                    _edits_in_force(half, 1, LSS.RIS_BSDF_LIGHT)
            _, dt = _fetch(port, "/control?cmd=preset&value=high_quality")
            hq = srv.renderer
            # the frame of the second sample starts after the first's time
            # is recorded
            _wait_samples(hq, 2)
            log(f"[viewer] high_quality in {dt:.3f} s: {hq.width}x"
                f"{hq.height}, {hq.options.direct_light_sampling.name}, a "
                f"frame {_frames(hq)[-1]:.1f} ms")
            if hq is not r:
                raise AssertionError("high_quality is not the base renderer")
            _edits_in_force(hq, 2, LSS.RESTIR_DI)
            t0 = time.perf_counter()
            _fetch(port, "/bake?what=conductor&res=16&samples=2048")
            bake = _poll(port, "/bake")
            bake_s = time.perf_counter() - t0
            if bake["shape"] != [16, 16]:
                raise AssertionError(f"/bake: {bake}")
            out = os.path.join(tmp, "anim")
            t0 = time.perf_counter()
            _fetch(port, f"/animate?frames=2&spp=1&out={out}")
            anim = _poll(port, "/animate")
            anim_s = time.perf_counter() - t0
            with open(anim["paths"][-1], "rb") as f:
                frame = decode_png(f.read())
            if anim["frames"] != 2 or frame.shape != (HEIGHT, WIDTH, 3):
                raise AssertionError(f"/animate: {anim}, {frame.shape}")
            log(f"[viewer] /bake conductor 16x16 x 2048: {bake_s:.2f} s "
                f"({bake['seconds']:.3f} s in the job); /animate 2 frames of "
                f"1 spp at {hq.width}x{hq.height}: {anim_s:.2f} s "
                f"({anim['seconds']:.2f} s in the job)")
        finally:
            srv.stop()
            enable_persistent_cache()
            shutil.rmtree(cache, ignore_errors=True)
        alive = (srv._render_thread.is_alive(), srv._serve_thread.is_alive())
        launches = dict(cuda_build.launch_counts)
        frames = sum(len(_frames(x)) for x in
                     [r, *srv._scaled_renderers.values()])
        log(f"[viewer] {time.perf_counter() - t_serve:.1f} s served, "
            f"{frames} frames (metrics keep the last 64 a renderer), "
            f"launches {launches}; stop(): render and server threads alive "
            f"{alive}; precompile cold {pre['cold']:.2f} s, warm "
            f"{pre['warm']:.2f} s")
        if any(alive):
            raise AssertionError("stop() left a thread running")
        # the fastest and high_quality presets run RIS and ReSTIR DI, which
        # take the emissive sweep; every frame takes the principled BSDF
        on_path = set(paths.ROUTES["viewer"]) | {
            "emissive_sweep", "principled_eval", "principled_sample"}
        for k, v in launches.items():
            if (v > 0) != (k in on_path):
                raise AssertionError(f"the viewer path launched {k} {v} times")
    torch.cuda.empty_cache()
    return launches


def _edits_in_force(r, n_edits, strategy):
    """The first n_edits of VIEWER_EDITS, the option edits made with them
    (do_thin_film off, then do_dispersion off) and rr_min_depth 5 are in
    force on r, under the preset's strategy."""
    rough = r.scene.materials.roughness.cpu()
    ok = (r.options.direct_light_sampling == strategy
          and not r.options.do_thin_film
          and r.options.do_dispersion == (n_edits < 2)
          and r.settings.rr_min_depth == 5
          and all(abs(float(rough[i]) - v) < 1e-6
                  for i, _key, v in VIEWER_EDITS[:n_edits]))
    log(f"[viewer] edits in force after the switch to "
        f"{r.width}x{r.height}: {ok}")
    if not ok:
        raise AssertionError("a preset switch dropped an edit")


def _sheen_diff(a, b) -> dict:
    """Per channel of two sheen tables, (max, median) |a - b| over the
    cells where both have R >= SHEEN_R_MIN."""
    cells = (a[..., 2] >= SHEEN_R_MIN) & (b[..., 2] >= SHEEN_R_MIN)
    return {name: (float(np.abs(a[..., ch] - b[..., ch])[cells].max()),
                   float(np.median(np.abs(a[..., ch] - b[..., ch])[cells])))
            for ch, name in enumerate(("Ai", "Bi", "R"))}


def phase_bake(dev):
    """The bake phase, a path with no frame: bake_all into a temporary
    directory on the card, each of the seven bakes timed; each held against
    the port's CPU run of the same function at BAKE_SMALL (the card's run
    at that size) and, where one is shipped, against the shipped table;
    the sheen fit at full size against the shipped table, fit_poly of it,
    and the SGGX self-test. Returns the seconds of its parts."""
    import tempfile

    from hiprt_pt_tpu_torch.bake import baker, sheen_ltc_fit as sf

    shipped_dir = os.path.dirname(baker.__file__)
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        real = {fn: getattr(baker, fn) for fn, _ in BAKES.values()}

        def timed(fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                out = real[fn](*a, **kw)
                secs[fn] = time.perf_counter() - t0
                return out
            return run

        try:
            for fn in real:
                setattr(baker, fn, timed(fn))
            t0 = time.perf_counter()
            tables = baker.bake_all(out_dir=tmp, device=dev)
            secs["bake_all"] = time.perf_counter() - t0
        finally:
            for fn, f in real.items():
                setattr(baker, fn, f)
        log(f"[bake] bake_all into {os.path.basename(tmp)}/ on the card: "
            f"{secs['bake_all']:.2f} s, files {sorted(os.listdir(tmp))}")
        res, n = BAKE_SMALL
        t0 = time.perf_counter()
        for name, (fn, shipped) in BAKES.items():
            card = getattr(baker, fn)(res=res, n_samples=n, device=dev)
            cpu = getattr(baker, fn)(res=res, n_samples=n, device="cpu")
            diff = np.abs(card - cpu)
            flips = int((diff > BAKE_CELL_TOL).sum())
            line = (f"[bake] {name}: {tables[name].shape} in {secs[fn]:.2f} s; "
                    f"card vs CPU at res {res}, {n} samples: max |diff| "
                    f"{diff.max():.3e}, median {np.median(diff):.3e}, "
                    f"{flips} of {diff.size} cells past {BAKE_CELL_TOL}")
            if shipped:
                ref = np.load(os.path.join(shipped_dir, shipped + ".npy"))
                gap = float(np.abs(tables[name] - ref).max())
                line += (f"; vs {shipped}.npy max |diff| {gap:.5f} (the JAX "
                         f"package's own fresh bake: "
                         f"{JAX_SHIPPED_GAP[shipped]:.5f})")
                if not gap <= BAKE_SHIPPED_TOL:
                    raise AssertionError(f"{name} is {gap} from {shipped}")
            log(line)
            if not (np.isfinite(tables[name]).all()
                    and diff.max() <= BAKE_FLIP_TOL
                    and flips <= diff.size // BAKE_FLIP_SHARE):
                raise AssertionError(f"{name}: the card's bake disagrees with "
                                     f"the CPU's")
        secs["card vs CPU"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        table = sf.run_fit(device=dev, verbose=False, **SHEEN_FIT)
        secs["sheen fit"] = time.perf_counter() - t0
        np.save(os.path.join(tmp, "sheen_ltc.npy"), table)
        shipped = np.load(sf.OUT_PATH)
        d = _sheen_diff(table, shipped)
        log(f"[bake] sheen fit {SHEEN_FIT} over {sf.RES}x{sf.RES} cells: "
            f"{secs['sheen fit']:.2f} s; vs the shipped table (cells with R >= "
            f"{SHEEN_R_MIN}), max / median |diff|: " + ", ".join(
                f"{k} {m:.4f} / {med:.4f} (gate {2 * SHEEN_JAX_SPREAD[k][0]:.4f}"
                f" / {2 * SHEEN_JAX_SPREAD[k][1]:.4f})"
                for k, (m, med) in d.items()))
        for k, (m, med) in d.items():
            lim_max, lim_med = SHEEN_JAX_SPREAD[k]
            if not (np.isfinite(table).all() and m <= 2 * lim_max
                    and med <= 2 * lim_med):
                raise AssertionError(f"sheen fit {k}: max {m}, median {med}, "
                                     f"past twice JAX's seed-to-seed spread")
        poly = sf.fit_poly(table)
        log(f"[bake] fit_poly of the fitted table (residuals above): max "
            f"|coeff - shipped poly's| "
            f"{np.abs(poly - np.load(sf.POLY_PATH)).max():.4f}")
        t0 = time.perf_counter()
        errs = sf.selftest_sggx_sampler(device=dev)
        secs["selftest"] = time.perf_counter() - t0
        log(f"[bake] SGGX self-test on the card (normalization + 3 moments): "
            f"{errs}, every |e| < {SGGX_SELFTEST_TOL}: "
            f"{all(abs(e) < SGGX_SELFTEST_TOL for e in errs)}")
        if not all(abs(e) < SGGX_SELFTEST_TOL for e in errs):
            raise AssertionError(f"SGGX self-test: {errs}")
    torch.cuda.empty_cache()
    return secs


def _states_digests(states) -> list:
    from hiprt_pt_tpu_torch.parallel.jobs import state_digests

    return [state_digests(st) for st in states]


def _digests_differ(ref: dict, got: dict) -> list:
    return sorted(k for k in ref if ref[k] != got.get(k))


def phase_parallel(dev) -> dict:
    """The tenth path, parallel/: paths.parallel_runs in
    paths.PARALLEL_RANKS spawned ranks (parallel/launch.py; NCCL with a
    card a rank, else gloo on cuda:0), each run held against this process:
    a. pixel DP of the gltf path at 1920x1080 (rank 0 loads the .glb and
    replicates it): the gathered state bit-identical to one process's 4
    samples; per rank ms a frame beside one process's in this call, ms a
    frame in collectives (as run, and in a sample with the device
    synchronised around each), launches, march segments and those it ran
    with none of its own rays searching.
    b. sample DP of the restir path at 1920x1080: each rank's state
    bit-identical to one process's render with seed 42 + 9176·rank, the
    merged mean within rtol 1e-6 of their mean, the total 2 x 2, the ranks'
    images different; in a. and b. each rank launches the emissive sweep
    samples x sweeps_per_frame times and each principled kernel samples x
    bsdf_calls_per_frame times. c. pixel DP of the restir path at 256x128, 3
    samples, bit-identical. d. the Cornell orbit's frames split over the ranks,
    byte-identical PNGs. Launch counts are the ranks' (each resets its
    counts just before its timed samples and reads them just after).
    Returns the launches by kernel."""
    import tempfile

    from hiprt_pt_tpu_torch import paths
    from hiprt_pt_tpu_torch.core.settings import LightSamplingStrategy
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.parallel import jobs
    from hiprt_pt_tpu_torch.parallel.frames import render_distributed_sequence
    from hiprt_pt_tpu_torch.parallel.launch import launch
    from hiprt_pt_tpu_torch.parallel.mesh import _SAMPLE_DP_SEED_STRIDE
    from hiprt_pt_tpu_torch.render.animation import CameraOrbitAnimation
    from hiprt_pt_tpu_torch.render.renderer import Renderer, render_step

    ranks = paths.PARALLEL_RANKS
    backend = "nccl" if torch.cuda.device_count() >= ranks else "gloo"
    log(f"[parallel] {ranks} ranks on {backend} "
        f"({torch.cuda.device_count()} card(s): "
        f"{'a card a rank' if backend == 'nccl' else 'the ranks share cuda:0'})")
    with tempfile.TemporaryDirectory() as tmp:
        runs = {r["name"]: r for r in paths.parallel_runs(
            os.path.join(tmp, "ranks"))}
        # this process's renders of the same runs
        t0 = time.perf_counter()
        ref = {}
        for inp in paths.PARALLEL_INPUTS:
            scene, cam, bvh = paths.load(inp, dev)[:3]
            for name, run in runs.items():
                if run["input"] != inp:
                    continue
                w, h = run.get("width"), run.get("height")
                if run.get("mode") == "sequence":
                    r = Renderer(scene, cam, w, h, options=run["options"],
                                 settings=run["settings"], world=run["world"],
                                 bvh=bvh)
                    files = render_distributed_sequence(
                        r, run["frames"], run["spp"],
                        os.path.join(tmp, "one"),
                        camera_animation=CameraOrbitAnimation(**run["orbit"]),
                        process_index=0, process_count=1)
                    ref[name] = {os.path.basename(f): _read_bytes(f)
                                 for f in files}
                    continue
                restir = (run["options"].direct_light_sampling
                          == LightSamplingStrategy.RESTIR_DI)
                seeds = ([42 + _SAMPLE_DP_SEED_STRIDE * k for k in range(ranks)]
                         if run.get("mode") == "samples" else [42])
                states, ms = [], []
                for sd in seeds:
                    # the ranks' untimed samples, then their timed ones,
                    # timed here too
                    def step(st, n):
                        return render_step(run["options"], w, h, scene, bvh,
                                           st, cam, run["settings"],
                                           run["world"], n_samples=n)
                    st = step(init_render_state(w, h, sd, dev,
                                                with_restir=restir),
                              run.get("warmup", 0) + run.get("synced", 0))
                    torch.cuda.synchronize(dev)
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                    st = step(st, run["samples"])
                    ev[1].record()
                    torch.cuda.synchronize(dev)
                    ms.append(ev[0].elapsed_time(ev[1]) / run["samples"])
                    states.append(st)
                ref[name] = (_states_digests(states),
                             [st.accum.cpu().numpy() for st in states], ms)
                del states, st
            del scene, cam, bvh
            torch.cuda.empty_cache()
        secs_one = time.perf_counter() - t0

        spec = {"runs": list(runs.values()),
                "inputs": {k: k for k in paths.PARALLEL_INPUTS}}
        t0 = time.perf_counter()
        out = launch(jobs.render, ranks, (spec,), backend=backend,
                     timeout=900)
        secs_ranks = time.perf_counter() - t0
        reps = {name: [o[name] for o in out] for name in runs}
        log(f"[parallel] one process {secs_one:.1f} s for the four runs; the "
            f"launch of {ranks} ranks {secs_ranks:.1f} s (spawn, rank 0's "
            f"loads, replicate, renders, gathers)")

        a = reps["pixels-gltf"]
        ra = runs["pixels-gltf"]
        frames, untimed = ra["samples"], ra["warmup"] + ra["synced"]
        log(f"[parallel a] one process: {ref['pixels-gltf'][2][0]:.2f} ms a "
            f"frame (CUDA events, the same {frames} frames)")
        for r in a:
            sy = r["synced"]
            log(f"[parallel a] rank {r['rank']} ({r['device']}, "
                f"{r['backend']}): {r['ms_per_sample']:.2f} ms a frame "
                f"(CUDA events, {frames} frames after {untimed} others), "
                f"{r['collective_ms'] / frames:.2f} ms a frame "
                f"in collectives {r['collective_calls']} (host clock); in a "
                f"frame with the device synchronised around each: "
                f"{sy['collective_ms'] / max(sy['samples'], 1):.2f} ms "
                f"{sy['collective_calls']}; launches {r['launches']}; "
                f"march segments {r['segments']}, with no searching ray of "
                f"its own {r['idle_segments']}")
        bad = _digests_differ(ref["pixels-gltf"][0][0], a[0]["digests"])
        log(f"[parallel a] gathered {ra['width']}x{ra['height']} state vs one "
            f"process's {untimed + frames} samples: "
            f"{'bit-identical' if not bad else f'differs in {bad}'} "
            f"({len(ref['pixels-gltf'][0][0])} fields)")
        if bad:
            raise AssertionError(f"pixel DP of the gltf path differs from one "
                                 f"process in {bad}")
        if len({r["segments"] for r in a}) != 1:
            raise AssertionError("the ranks ran different march segments")

        b = reps["samples-restir"]
        digests, accums, one_ms = ref["samples-restir"]
        for k, r in enumerate(b):
            bad = _digests_differ(digests[k], r["digests"])
            log(f"[parallel b] rank {k}: {r['ms_per_sample']:.2f} ms a sample "
                f"(one process: {one_ms[k]:.2f}), launches {r['launches']}; "
                f"its state vs one process with seed "
                f"{42 + _SAMPLE_DP_SEED_STRIDE * k}: "
                f"{'bit-identical' if not bad else f'differs in {bad}'}")
            if bad:
                raise AssertionError(f"sample DP rank {k} differs from one "
                                     f"process in {bad}")
        # a rank's timed samples at 1080p sweep and shade as its path's
        # frames do (neither run has an envmap)
        for name in ("pixels-gltf", "samples-restir"):
            run = runs[name]
            per_sample = {"emissive_sweep": sweeps_per_frame(run["options"],
                                                             run["settings"]),
                          **bsdf_calls_per_frame(run["options"], run["settings"])}
            for k, v in per_sample.items():
                want = run["samples"] * v
                got = [r["launches"][k] for r in reps[name]]
                log(f"[parallel] {name}: {k} launched {got} times by the "
                    f"ranks in {run['samples']} samples each")
                if got != [want] * ranks:
                    raise AssertionError(f"{name}: the ranks launched {k} "
                                         f"{got} times, not {want} each")
        mean = np.mean(accums, axis=0)
        err = float(np.max(np.abs(b[0]["merged"] - mean)
                           / np.maximum(np.abs(mean), 1e-30)))
        same = all(np.array_equal(b[0]["arrays"]["accum"], r["arrays"]["accum"])
                   for r in b[1:])
        log(f"[parallel b] merge_sample_dp: max relative |diff| to the mean "
            f"of one process's renders {err:.3e} (rtol 1e-6), total "
            f"{b[0]['total']}, ranks' images differ: {not same}")
        want = ranks * runs["samples-restir"]["samples"]
        if not (np.allclose(b[0]["merged"], mean, rtol=1e-6, atol=0.0)
                and b[0]["total"] == want and not same):
            raise AssertionError("merge_sample_dp disagrees with one process")

        c = reps["pixels-restir"]
        bad = _digests_differ(ref["pixels-restir"][0][0], c[0]["digests"])
        rc = runs["pixels-restir"]
        log(f"[parallel c] ReSTIR DI pixel DP at {rc['width']}x{rc['height']}, "
            f"{rc['samples']} samples: "
            f"{'bit-identical' if not bad else f'differs in {bad}'}; "
            f"collectives {c[0]['collective_calls']}")
        if bad:
            raise AssertionError(f"pixel DP with ReSTIR differs in {bad}")

        d = reps["sequence-cornell"]
        files = {os.path.basename(f): _read_bytes(f)
                 for r in d for f in r["paths"]}
        same = files == ref["sequence-cornell"]
        log(f"[parallel d] the Cornell orbit, {len(files)} frames over "
            f"{ranks} ranks ({[len(r['paths']) for r in d]}): PNGs "
            f"{'byte-identical' if same else 'differ'} to one process's; "
            f"launches {[r['launches'] for r in d]}")
        if not same or len(files) != paths.PARALLEL_SEQUENCE["frames"]:
            raise AssertionError("the frame sequence differs from one process")

    launches: dict = {}
    for rep in reps.values():
        for r in rep:
            for k, v in (r or {}).get("launches", {}).items():
                launches[k] = launches.get(k, 0) + v
    for k in ("trace_coherent", "trace_incoherent", "trace_meganode",
              "emissive_sweep", "principled_eval", "principled_sample"):
        if not launches.get(k):
            raise AssertionError(f"the parallel path's ranks launched no {k}")
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    t_start = time.perf_counter()
    name = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    build_info = phase_build()
    sweep_rows = phase_sweep(dev)
    t_bsdf = time.perf_counter()
    bsdf_rows = phase_bsdf(dev)
    log(f"[bsdf] {time.perf_counter() - t_bsdf:.1f} s")
    errs, rows, launches, per_frame = {}, {}, {}, {}
    for tag, cases in PATH_CASES:
        secs = {}

        def timed(phase, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            secs[phase] = time.perf_counter() - t0
            return out

        if tag == "gltf":
            timed("files", phase_files, dev)
        scene, cam, bvh = timed("scene", phase_scene, tag, dev)
        e, r = timed("kernels", phase_kernels, tag, scene, cam, bvh, dev, cases)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        rows.update(r)
        on_path = path_kernels(tag)
        counts, per_kind = timed("slice", phase_slice, tag, scene, cam, bvh,
                                 on_path)
        for k in on_path:
            launches[k] = launches.get(k, 0) + counts[k]
        per_frame.update(per_kind)
        timed("parity", phase_parity, tag, scene, cam, bvh)
        if tag in RENDERER_PATHS:
            timed("renderer", phase_renderer, tag, scene, cam, bvh)
        del scene, cam, bvh
        torch.cuda.empty_cache()
        log(f"[{tag}] phases: "
            f"{', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}; "
            f"{time.perf_counter() - t_start:.1f} s since the start")
    t_cli = time.perf_counter()
    for k, v in phase_cli(dev).items():
        launches[k] = launches.get(k, 0) + v
    log(f"[cli] {time.perf_counter() - t_cli:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s since the start")
    t_viewer = time.perf_counter()
    for k, v in phase_viewer(dev).items():
        launches[k] = launches.get(k, 0) + v
    log(f"[viewer] {time.perf_counter() - t_viewer:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s since the start")
    t_probes = time.perf_counter()
    p_launches, p_errs, p_rows = phase_probes(dev)
    log(f"[probes] {time.perf_counter() - t_probes:.1f} s")
    launches.update(p_launches)
    errs.update(p_errs)
    t_bake = time.perf_counter()
    secs = phase_bake(dev)
    log(f"[bake] {time.perf_counter() - t_bake:.1f} s: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in secs.items()))
    t_parallel = time.perf_counter()
    for k, v in phase_parallel(dev).items():
        launches[k] = launches.get(k, 0) + v
    log(f"[parallel] {time.perf_counter() - t_parallel:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s since the start")

    # one row per (path, kernel, ray kind): the kind's mode, launches per
    # frame, and what those launches cost above the bound
    table = []
    for (tag, k, kind), row in rows.items():
        n = per_frame.get((tag, k, kind), 0)
        table.append({"kernel": k, "kind": kind, **row, "launches_per_frame": n,
                      "excess_ms_per_frame": n * (row["ms"] - row["bound_ms"])})
        packets = ("" if "left_share" not in row else
                   f", {row['left_share']:.4f} of packets left packet mode")
        log(f"[rows] {k} {kind} ({row['mode']}, {row['path']}): kernel "
            f"{row['ms']:.3f} ms{packets}, plain {row['plain_ms']:.3f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), {n} launches/frame, "
            f"launches x (ms - bound) {table[-1]['excess_ms_per_frame']:.3f} ms/frame")
    print(json.dumps({"kernel_rows": table, "probe_rows": p_rows,
                      "sweep_rows": list(sweep_rows.values()),
                      "bsdf_rows": list(bsdf_rows.values()),
                      "build_info": build_info}), flush=True)

    # traversal kernels: closest hit on the 1080p rays each serves; probes:
    # P1 per-group(now), P2 at 19 tiles
    entry = {k: rows[(path, k, kind)] for k, (path, kind) in SERVES.items()}
    entry["mm_probe_kernel"] = next(r for r in p_rows if r.get("label") == P1_LINE)
    entry["dg_probe_kernel"] = next(r for r in p_rows
                                    if r.get("tiles") == P2_LINE_TILES)
    kernels = [{
        "name": k,
        "route": "cuda",
        "source": SOURCE[k],
        "replaces": KERNELS[k],
        "launches": launches[k],
        "max_abs_err": errs[k],
        "ms": entry[k]["ms"],
        "plain_ms": entry[k]["plain_ms"],
        "bound_ms": entry[k]["bound_ms"],
        "bound_by": entry[k]["bound_by"],
        # no PyTorch call computes a BVH walk
        "library_ms": entry[k].get("library_ms"),
    } for k in KERNELS]
    sweep = sweep_rows[SWEEP_RAYS[0]]
    kernels.append({
        "name": "emissive_sweep_kernel", "route": "cuda", "source": SWEEP_SOURCE,
        "replaces": SWEEP_REPLACES,
        "launches": launches["emissive_sweep"],
        "max_abs_err": max(r["max_abs_err"] for r in sweep_rows.values()),
        "ms": sweep["ms"], "plain_ms": sweep["plain_ms"],
        "bound_ms": sweep["bound_ms"], "bound_by": sweep["bound_by"],
        # no PyTorch call computes the sweep
        "library_ms": None})
    for kind in ("eval", "sample"):
        kname = f"principled_{kind}_kernel"
        row = bsdf_rows[(kname, BSDF_LANES[0])]
        kernels.append({
            "name": kname, "route": "cuda", "source": BSDF_SOURCE,
            "replaces": BSDF_REPLACES,
            "launches": launches.get(f"principled_{kind}", 0),
            "agree": min(r["agree"] for (k, _n), r in bsdf_rows.items()
                         if k == kname),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            # no PyTorch call computes the BSDF
            "library_ms": None})
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
