#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hiprt_pt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (any failure exits non-zero):
  1. device   — require CUDA; print the card's name and power limit.
  2. build    — compile the five traversal kernels (nvcc, both sources at
                once) and the BVH builder (g++).
  Then, for each of the three paths of hiprt_pt_tpu_torch/paths.py:
  3. scene    — the path's scene and BVH (paths.load), with the host set-up
                times, the tables on the card and the router's decisions,
                which must be the path's routes (paths.ROUTES).
  4. kernels  — each kernel of the path against its plain PyTorch version
                on the card, in closest- and any-hit form, on 65,536 camera
                or bounce rays and on the full 1920x1080 wavefront, both
                with finite t_max and inactive rays; 1,024 rays also against
                brute force; then the kernel's and the plain version's time
                on the 1920x1080 wavefront.
  5. slice    — the renderer at 1920x1080, 4 bounces, with the path's
                options (paths.slice_options): one warm-up frame and 4
                timed frames. Launch counts are reset just before and read
                just after; the path's kernels, and no other, must launch.
  6. parity   — one sample at 256x128 rendered on the GPU and on the CPU
                (plain traversal), compared per pixel.
  The paths: the stress interior (259,120 triangles; trace_coherent,
  trace_incoherent), the Cornell box with seven principled spheres (35,852
  triangles; trace_meganode) and the stress interior at tri_scale=14
  (2,042,048 triangles, textures, RIS; trace_stream8, trace_lane8log).
The line before the last is the kernels' JSON summary (each kernel's time on
the 1080p rays it serves on its path, its plain version's, and its bound:
the larger of the f32 operations of the plain walk on those rays at
67 TFLOP/s and the bytes of rays, hit records and tables at 3.35 TB/s); the
last line is the run's JSON result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

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
}
SOURCE = {k: "hiprt_pt_tpu_torch/csrc/traverse.cu" for k in KERNELS} | {
    "trace_stream8": "hiprt_pt_tpu_torch/csrc/traverse8.cu",
    "trace_lane8log": "hiprt_pt_tpu_torch/csrc/traverse8.cu"}
# the plain PyTorch version of each kernel (ops/traverse.py)
PLAIN = {"trace_coherent": "traverse", "trace_incoherent": "traverse",
         "trace_meganode": "traverse_meganode", "trace_stream8": "traverse8",
         "trace_lane8log": "traverse8"}
# the rays each kernel is held against and timed on: camera rays of the
# 1920x1080 wavefront, or cosine bounce rays from their hits
STRESS_CASES = (("trace_coherent", "camera"), ("trace_incoherent", "bounce"))
CORNELL_CASES = (("trace_meganode", "camera"), ("trace_meganode", "bounce"))
STRESS14_CASES = tuple((k, kind) for k in ("trace_stream8", "trace_lane8log")
                       for kind in ("camera", "bounce"))
# the rays of its path each kernel's ms and bound are reported on
SERVES = {"trace_coherent": "camera", "trace_incoherent": "bounce",
          "trace_meganode": "camera", "trace_stream8": "camera",
          "trace_lane8log": "bounce"}
# a kernel's bound (H100 SXM peak rates): f32
# operations of the plain walk on the rays over the f32 rate, and bytes
# (each ray in once: o, d, t_min, t_max, active = 33 B; each hit record out
# once: t, prim, u, v = 16 B; each table once) over the memory rate
F32_OPS_PER_S = 67e12
BYTES_PER_S = 3.35e12
RAY_BYTES, HIT_BYTES = 33, 16
# a slab test: 6 sub + 6 mul, 6 min/max of the pairs, 3 + 3 min/max of the
# entry and exit, 1 compare; a triangle test (Moller-Trumbore): two cross
# products (18), four 3-term dots (20), the edge vector (3), u and v and t
# scaled (3), the reciprocal (1), 7 compares and the u + v sum (8)
SLAB_OPS, TRI_OPS = 25, 53


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
    from hiprt_pt_tpu_torch.accel.native import get_lib
    from hiprt_pt_tpu_torch.ops import cuda_traverse

    t0 = time.perf_counter()
    cuda_traverse.load_library()
    t1 = time.perf_counter()
    get_lib()
    t2 = time.perf_counter()
    for line in cuda_traverse.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("[build] ptxas:", line.strip())
    log(f"[build] kernels {t1 - t0:.2f} s, bvh builder {t2 - t1:.2f} s")


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
        f"{scene.materials.ior.shape[0]} materials; set-up: scene "
        f"{secs['scene']:.3f} s, BVH build {secs['bvh']:.3f} s; tables on the "
        f"card {tables}, {bvh.nbytes} bytes; depth4 {bvh.depth4}, depth8 "
        f"{bvh.depth8}, depth2 {bvh.depth2}, lane8 {bvh.lane8}; routes: "
        f"coherent {routes[0]}, incoherent {routes[1]}")
    expect = {"stress": (259_120, 240, 0), "cornell": (35_852, 2, 0),
              "stress14": (2_042_048, 240, 18)}[tag]
    got = (scene.num_triangles, scene.num_emissives,
           0 if tex is None else tex.num_layers)
    if got != expect:
        raise AssertionError(f"the {tag} scene has (triangles, emissive "
                             f"triangles, textures) {got}, expected {expect}")
    if routes != paths.ROUTES[tag]:
        raise AssertionError(f"the {tag} scene routes to {routes}, expected "
                             f"{paths.ROUTES[tag]}")
    return scene, cam, bvh


def camera_rays(cam, width, height):
    from hiprt_pt_tpu_torch.core.camera import generate_camera_rays
    from hiprt_pt_tpu_torch.ops.pixel_order import pixel_coords

    px, py = pixel_coords(width, height, cam.view.device)
    return generate_camera_rays(cam, width, height, None, px, py)


def bounce_rays(scene, bvh, o, d, seed, walk):
    """Incoherent rays: origins at the camera hits (found by the plain walk
    ``walk``), cosine-hemisphere directions (numpy, seeded) around the
    face-forwarded geometric normal. Rays whose camera ray missed are
    inactive."""
    from hiprt_pt_tpu_torch.ops.intersect import offset_ray_origin
    from hiprt_pt_tpu_torch.ops.sampling import sample_cosine_hemisphere

    rec = walk(bvh, o, d, t_min=0.0)
    hit = rec.prim >= 0
    ng = scene.tri_data[rec.prim.clamp_min(0).long(), 25:28]
    ng = torch.where(((ng * d).sum(-1, keepdim=True) > 0.0), -ng, ng)
    p = o + d * torch.where(hit, rec.t, 0.0)[:, None]
    rng = np.random.default_rng(seed)
    n = o.shape[0]
    u1 = torch.from_numpy(rng.random(n, dtype=np.float32)).to(o.device)
    u2 = torch.from_numpy(rng.random(n, dtype=np.float32)).to(o.device)
    wi, _ = sample_cosine_hemisphere(ng, u1, u2)
    wi = (wi / torch.linalg.norm(wi, dim=-1, keepdim=True)).contiguous()
    return offset_ray_origin(p, ng, wi).contiguous(), wi, hit


def compare(name, rk, rp, any_hit, active):
    """Kernel record vs plain record; raises below the thresholds.
    Returns the max |t| difference where the prims agree (closest hit)."""
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


def cuda_ms(fn, reps):
    """Mean ms of ``reps`` back-to-back calls after a warm-up call, between
    CUDA events; also returns the warm-up call's result."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bound(bvh, kernel, n, stats):
    """(ms, "bytes" or "operations"): the least time the card could take for
    the plain walk's work on n rays (see F32_OPS_PER_S above)."""
    from hiprt_pt_tpu_torch.ops.routing import KERNEL_TABLES

    ops = stats["box_tests"] * SLAB_OPS + stats["tri_tests"] * TRI_OPS
    nbytes = n * (RAY_BYTES + HIT_BYTES) + sum(
        getattr(bvh, t).numel() * 4 for t in KERNEL_TABLES[kernel])
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


def phase_kernels(scene, cam, bvh, dev, cases):
    """Each (kernel, ray kind) of ``cases`` against the kernel's plain
    version and brute force, then both timed on the 1080p wavefront.
    Returns ({kernel: max |dt|}, {(kernel, kind, any_hit): (ms, plain ms)},
    {kernel: (bound ms, bound_by)} on the rays it serves)."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops import traverse as plain
    from hiprt_pt_tpu_torch.ops.intersect import brute_force_closest

    first_walk = getattr(plain, PLAIN[cases[0][0]])
    side = int(np.sqrt(PARITY_RAYS))
    o_c, d_c = camera_rays(cam, side, side)
    o_i, d_i, hit_c = bounce_rays(scene, bvh, o_c, d_c, 1, first_walk)
    tmax, act = limits(o_c.shape[0], 2, dev)
    rays = {"camera": (o_c, d_c, act), "bounce": (o_i, d_i, act & hit_c)}
    errs = {}
    plain_recs = {}
    for kname, kind in cases:
        kern, walk = getattr(ct, kname), getattr(plain, PLAIN[kname])
        o, d, a = rays[kind]
        errs.setdefault(kname, 0.0)
        for any_hit in (False, True):
            t_min = 1e-4 if any_hit else 0.0
            rk = kern(bvh, o, d, t_min, tmax, a, any_hit=any_hit)
            key = (PLAIN[kname], kind, any_hit)
            if key not in plain_recs:
                plain_recs[key] = walk(bvh, o, d, t_min, tmax, a, any_hit=any_hit)
            torch.cuda.synchronize()
            tag = f"{kname}[{kind}, {'any' if any_hit else 'closest'}]"
            errs[kname] = max(errs[kname],
                              compare(tag, rk, plain_recs[key], any_hit, a))
        # brute force on 1,024 active rays with an unbounded t_max
        sel = torch.nonzero(a & torch.isinf(tmax)).squeeze(1)[:BRUTE_RAYS]
        rk = kern(bvh, o[sel].contiguous(), d[sel].contiguous(), 0.0)
        bt, bp, _bu, _bv = brute_force_closest(scene.vertices, scene.triangles,
                                               o[sel], d[sel], t_min=0.0)
        rb = plain.HitRecord(t=bt, prim=bp, u=_bu, v=_bv)
        compare(f"{kname}[{kind}, brute force]", rk, rb, False,
                torch.ones_like(sel, dtype=torch.bool))
    del plain_recs

    # the full 1080p wavefront: compare with finite t_max and inactive rays,
    # then time, and compare the timed results too
    o_f, d_f = camera_rays(cam, WIDTH, HEIGHT)
    o_b, d_b, hit_f = bounce_rays(scene, bvh, o_f, d_f, 3, first_walk)
    tmax_f, act_f = limits(o_f.shape[0], 4, dev)
    full = {"camera": (o_f, d_f, torch.ones_like(hit_f)),
            "bounce": (o_b, d_b, hit_f)}
    plain_recs = {}
    for kname, kind in cases:
        kern, walk = getattr(ct, kname), getattr(plain, PLAIN[kname])
        o, d, a = full[kind]
        a = a & act_f
        for any_hit in (False, True):
            t_min = 1e-4 if any_hit else 0.0
            rk = kern(bvh, o, d, t_min, tmax_f, a, any_hit=any_hit)
            key = (PLAIN[kname], kind, any_hit)
            if key not in plain_recs:
                plain_recs[key] = walk(bvh, o, d, t_min, tmax_f, a, any_hit=any_hit)
            tag = (f"{kname}[{kind}, {'any' if any_hit else 'closest'}, 1080p, "
                   f"finite t_max]")
            errs[kname] = max(errs[kname],
                              compare(tag, rk, plain_recs[key], any_hit, a))
    del plain_recs
    times, plain_ms, bounds = {}, {}, {}
    for kname, kind in cases:
        kern, walk = getattr(ct, kname), getattr(plain, PLAIN[kname])
        o, d, a = full[kind]
        for any_hit in (False, True):
            t_min = 1e-4 if any_hit else 0.0
            k_ms, rk = cuda_ms(lambda: kern(bvh, o, d, t_min, float("inf"), a,
                                            any_hit=any_hit), reps=5)
            key = (PLAIN[kname], kind, any_hit)
            if key not in plain_ms:
                plain_ms[key] = cuda_ms(lambda: walk(
                    bvh, o, d, t_min, float("inf"), a, any_hit=any_hit), reps=1)
            p_ms, rp = plain_ms[key]
            tag = f"{kname}[{kind}, {'any' if any_hit else 'closest'}, 1080p]"
            errs[kname] = max(errs[kname], compare(tag, rk, rp, any_hit, a))
            times[(kname, kind, any_hit)] = (k_ms, p_ms)
            log(f"[kernels] {kname} {'any-hit' if any_hit else 'closest'} on "
                f"{o.shape[0]} {kind} rays: kernel {k_ms:.3f} ms, plain "
                f"{p_ms:.3f} ms ({o.shape[0] / k_ms / 1e3:.1f} Mrays/s kernel)")
        if kind == SERVES[kname]:
            stats = {}
            getattr(plain, PLAIN[kname])(bvh, o, d, 0.0, float("inf"), a,
                                         stats=stats)
            bounds[kname] = bound(bvh, kname, o.shape[0], stats)
            log(f"[kernels] {kname} bound on {o.shape[0]} {kind} rays: "
                f"{bounds[kname][0]:.4f} ms ({bounds[kname][1]}); plain walk "
                f"{stats}")
    return errs, times, bounds


def phase_slice(tag, scene, cam, bvh, kernels):
    """One warm-up frame and 4 timed frames at 1920x1080. Every kernel of
    ``kernels`` must be launched in them, and no other."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.paths import slice_options
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    opts, settings, world = slice_options(tag)
    r = Renderer(scene, cam, WIDTH, HEIGHT, options=opts, settings=settings,
                 world=world, bvh=bvh, seed=42)
    torch.cuda.reset_peak_memory_stats()
    ct.reset_launch_counts()
    r.step()  # warm-up frame
    torch.cuda.synchronize()
    rays0 = r.rays_traced
    frames = 4
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(frames):
        r.step()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ct.launch_counts)
    ms = start.elapsed_time(end)
    rays = r.rays_traced - rays0
    img = r.hdr_image()
    nonblack = float(np.mean(img.sum(-1) > 0.0))
    log(f"[{tag} slice] {WIDTH}x{HEIGHT}, 4 bounces, {frames} timed frames: "
        f"{ms:.1f} ms ({ms / frames:.2f} ms/frame; {wall * 1e3:.1f} ms host "
        f"clock), {rays} rays, {rays / ms / 1e3:.3f} Mrays/s, "
        f"{frames / ms * 1e3:.3f} spp/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}; image mean "
        f"{float(img.mean()):.6f}, non-black {nonblack:.4f}")
    for k, v in launches.items():
        if (v > 0) != (k in kernels):
            raise AssertionError(
                f"{k} was launched {v} times by the {tag} path, which should "
                f"launch exactly {sorted(kernels)}")
    if not np.isfinite(img).all():
        raise AssertionError(f"{tag} slice image is not finite")
    if nonblack <= 0.5:
        raise AssertionError(f"{tag} slice image is only {nonblack:.3f} non-black")
    return launches


def phase_parity(tag, scene, cam, bvh):
    from hiprt_pt_tpu_torch.paths import slice_options
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    opts, settings, world = slice_options(tag)
    w, h = 256, 128
    cpu = torch.device("cpu")
    scene_cpu = scene.to(cpu)
    imgs, rays = [], []
    t0 = time.perf_counter()
    for sc, c, b in ((scene, cam, bvh), (scene_cpu, cam.to(cpu), bvh.to(cpu))):
        r = Renderer(sc, c, w, h, options=opts, settings=settings, world=world,
                     bvh=b, seed=42)
        r.step()
        imgs.append(r.hdr_image())
        rays.append(r.rays_traced)
    gpu, ref = imgs
    close = np.all(np.abs(gpu - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref), axis=-1)
    frac = float(close.mean())
    mean_rel = abs(float(gpu.mean()) - float(ref.mean())) / max(float(ref.mean()), 1e-12)
    rays_rel = abs(rays[0] - rays[1]) / max(rays[1], 1)
    log(f"[{tag} parity] {w}x{h} GPU vs CPU: {frac:.5f} of pixels close, "
        f"image mean rel diff {mean_rel:.2e}, rays {rays[0]} vs {rays[1]} "
        f"({time.perf_counter() - t0:.1f} s)")
    if frac < PIX_FRAC or mean_rel > 0.01 or rays_rel > 0.005:
        raise AssertionError(f"{tag}: GPU render disagrees with the CPU render")


def main() -> int:
    name = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    phase_build()
    errs, times, bounds, launches = {}, {}, {}, {}
    paths = (("stress", STRESS_CASES), ("cornell", CORNELL_CASES),
             ("stress14", STRESS14_CASES))
    for tag, cases in paths:
        scene, cam, bvh = phase_scene(tag, dev)
        e, t, b = phase_kernels(scene, cam, bvh, dev, cases)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        times.update(t)
        bounds.update(b)
        counts = phase_slice(tag, scene, cam, bvh, {k for k, _ in cases})
        launches.update({k: counts[k] for k, _ in cases})
        phase_parity(tag, scene, cam, bvh)
        del scene, cam, bvh
        torch.cuda.empty_cache()

    # ms and plain ms: closest hit on the 1080p rays each kernel serves
    kernels = [{
        "name": k,
        "route": "cuda",
        "source": SOURCE[k],
        "replaces": KERNELS[k],
        "launches": launches[k],
        "max_abs_err": errs[k],
        "ms": times[(k, SERVES[k], False)][0],
        "plain_ms": times[(k, SERVES[k], False)][1],
        "bound_ms": bounds[k][0],
        "bound_by": bounds[k][1],
        # no PyTorch call computes a BVH walk
        "library_ms": None,
    } for k in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
