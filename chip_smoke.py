#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hiprt_pt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (any failure exits non-zero):
  1. device   — require CUDA; print the card's name and power limit.
  2. build    — compile the three traversal kernels (nvcc) and the BVH
                builder (g++).
  The stress path:
  3. scene    — the procedural stress interior at full scale (~259k
                triangles, 120 emitters) and its BVH.
  4. kernels  — trace_coherent and trace_incoherent against their plain
                PyTorch version on the card, in closest- and any-hit form,
                with finite t_max and inactive rays, 1,024 rays also against
                brute force; then each kernel's and the plain version's time
                on the 1920x1080 wavefront.
  5. slice    — the renderer at 1920x1080, 4 bounces, Lambertian override,
                MIS NEE: one warm-up frame and 4 timed frames. Launch counts
                are reset just before and read just after.
  6. parity   — one sample at 256x128 rendered on the GPU and on the CPU (plain
                traversal), compared per pixel.
  The Cornell path (every ray through trace_meganode):
  7. scene    — the procedural Cornell box with seven principled spheres
                (tests/torch_parity.py:cornell_spheres_arrays, 35,852
                triangles) and its BVH, whose meganode table is kept.
  8. kernels  — trace_meganode against its plain version, as in phase 4.
  9. slice    — the renderer at 1920x1080, 4 bounces, the full principled
                BSDF with dispersion and thin film, MIS NEE, as in phase 5.
  10. parity  — as phase 6, on the Cornell path.
The line before the last is the kernels' JSON summary; the last line is the
run's JSON result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
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
}
# the plain PyTorch version of each kernel (ops/traverse.py)
PLAIN = {"trace_coherent": "traverse", "trace_incoherent": "traverse",
         "trace_meganode": "traverse_meganode"}
# the rays each kernel is held against and timed on: camera rays of the
# 1920x1080 wavefront, or cosine bounce rays from their hits
STRESS_CASES = (("trace_coherent", "camera"), ("trace_incoherent", "bounce"))
CORNELL_CASES = (("trace_meganode", "camera"), ("trace_meganode", "bounce"))


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


def phase_scene(dev):
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene

    t0 = time.perf_counter()
    scene, cam = load_stress_scene(aspect=WIDTH / HEIGHT, seed=7, tri_scale=1.0,
                                   num_emitters=120, with_textures=False,
                                   device=dev)
    t1 = time.perf_counter()
    bvh = build_bvh(scene.vertices.cpu().numpy(), scene.triangles.cpu().numpy(),
                    dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"[scene] {scene.num_triangles} triangles, {scene.num_emissives} "
        f"emissive triangles ({(scene.num_emissives + 1) // 2} emitters), "
        f"scene {t1 - t0:.2f} s, BVH build {t2 - t1:.3f} s, "
        f"nodes4 {tuple(bvh.nodes4.shape)} leaf_rows {tuple(bvh.leaf_rows.shape)} "
        f"depth4 {bvh.depth4}, tables {bvh.nbytes} bytes")
    assert scene.num_triangles > 250_000 and scene.num_emissives == 240
    return scene, cam, bvh, t2 - t1


def camera_rays(cam, width, height):
    from hiprt_pt_tpu_torch.core.camera import generate_camera_rays
    from hiprt_pt_tpu_torch.ops.pixel_order import pixel_coords

    px, py = pixel_coords(width, height, cam.view.device)
    return generate_camera_rays(cam, width, height, None, px, py)


def bounce_rays(scene, bvh, o, d, seed):
    """Incoherent rays: origins at the camera hits, cosine-hemisphere
    directions (numpy, seeded) around the face-forwarded geometric normal.
    Rays whose camera ray missed are inactive."""
    from hiprt_pt_tpu_torch.ops.intersect import offset_ray_origin
    from hiprt_pt_tpu_torch.ops.sampling import sample_cosine_hemisphere
    from hiprt_pt_tpu_torch.ops.traverse import closest_hit

    rec = closest_hit(bvh, o, d, t_min=0.0)
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


def phase_kernels(scene, cam, bvh, dev, cases):
    """Each (kernel, ray kind) of ``cases`` against the kernel's plain
    version and brute force, then both timed on the 1080p wavefront.
    Returns ({kernel: max |dt|}, {(kernel, kind, any_hit): (ms, plain ms)})."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.ops import traverse as plain
    from hiprt_pt_tpu_torch.ops.intersect import brute_force_closest

    side = int(np.sqrt(PARITY_RAYS))
    o_c, d_c = camera_rays(cam, side, side)
    o_i, d_i, hit_c = bounce_rays(scene, bvh, o_c, d_c, seed=1)
    rng = np.random.default_rng(2)
    n = o_c.shape[0]
    # a quarter of the rays get a finite t_max, a tenth are inactive
    tmax_np = np.where(rng.random(n) < 0.25,
                       rng.uniform(0.2, 4.0, n), np.inf).astype(np.float32)
    act_np = rng.random(n) >= 0.1
    tmax = torch.from_numpy(tmax_np).to(dev)
    act = torch.from_numpy(act_np).to(dev)
    rays = {"camera": (o_c, d_c, act), "bounce": (o_i, d_i, act & hit_c)}
    errs = {}
    for kname, kind in cases:
        kern, walk = getattr(ct, kname), getattr(plain, PLAIN[kname])
        o, d, a = rays[kind]
        errs.setdefault(kname, 0.0)
        for any_hit in (False, True):
            t_min = 1e-4 if any_hit else 0.0
            rk = kern(bvh, o, d, t_min, tmax, a, any_hit=any_hit)
            rp = walk(bvh, o, d, t_min, tmax, a, any_hit=any_hit)
            torch.cuda.synchronize()
            tag = f"{kname}[{kind}, {'any' if any_hit else 'closest'}]"
            errs[kname] = max(errs[kname], compare(tag, rk, rp, any_hit, a))
        # brute force on 1,024 active rays with an unbounded t_max
        sel = torch.nonzero(a & torch.isinf(tmax)).squeeze(1)[:BRUTE_RAYS]
        rk = kern(bvh, o[sel].contiguous(), d[sel].contiguous(), 0.0)
        bt, bp, _bu, _bv = brute_force_closest(scene.vertices, scene.triangles,
                                               o[sel], d[sel], t_min=0.0)
        rb = plain.HitRecord(t=bt, prim=bp, u=_bu, v=_bv)
        compare(f"{kname}[{kind}, brute force]", rk, rb, False,
                torch.ones_like(sel, dtype=torch.bool))

    # the full 1080p wavefront: time, and compare once more at this shape
    o_f, d_f = camera_rays(cam, WIDTH, HEIGHT)
    o_b, d_b, hit_f = bounce_rays(scene, bvh, o_f, d_f, seed=3)
    full = {"camera": (o_f, d_f, torch.ones_like(hit_f)),
            "bounce": (o_b, d_b, hit_f)}
    times = {}
    for kname, kind in cases:
        kern, walk = getattr(ct, kname), getattr(plain, PLAIN[kname])
        o, d, a = full[kind]
        for any_hit in (False, True):
            t_min = 1e-4 if any_hit else 0.0
            k_ms, rk = cuda_ms(lambda: kern(bvh, o, d, t_min, float("inf"), a,
                                            any_hit=any_hit), reps=5)
            p_ms, rp = cuda_ms(lambda: walk(bvh, o, d, t_min, float("inf"), a,
                                            any_hit=any_hit), reps=1)
            tag = f"{kname}[{kind}, {'any' if any_hit else 'closest'}, 1080p]"
            errs[kname] = max(errs[kname], compare(tag, rk, rp, any_hit, a))
            times[(kname, kind, any_hit)] = (k_ms, p_ms)
            log(f"[kernels] {kname} {'any-hit' if any_hit else 'closest'} on "
                f"{o.shape[0]} {kind} rays: kernel {k_ms:.3f} ms, plain "
                f"{p_ms:.3f} ms ({o.shape[0] / k_ms / 1e3:.1f} Mrays/s kernel)")
    return errs, times


def slice_options(cornell: bool):
    """The stress path: Lambertian override, no dispersion. The Cornell
    path: the defaults, i.e. the full principled BSDF with dispersion and
    thin film. Both with MIS NEE, 4 bounces and ambient NONE."""
    from hiprt_pt_tpu_torch.core.settings import (
        AmbientLightType, BSDFOverride, LightSamplingStrategy, RenderOptions,
        RenderSettings, WorldSettings)

    opts = RenderOptions(direct_light_sampling=LightSamplingStrategy.MIS,
                         max_bounces_static=4)
    if cornell:
        assert opts.bsdf_override == BSDFOverride.NONE
        assert opts.do_dispersion and opts.do_thin_film
    else:
        opts = opts.replace(bsdf_override=BSDFOverride.LAMBERTIAN,
                            do_dispersion=False)
    settings = RenderSettings(nb_bounces=4, samples_per_frame=1)
    world = WorldSettings(ambient_light_type=int(AmbientLightType.NONE))
    return opts, settings, world


def phase_slice(tag, scene, cam, bvh, cornell, kernels):
    """One warm-up frame and 4 timed frames at 1920x1080. Every kernel of
    ``kernels`` must be launched in them, and no other."""
    from hiprt_pt_tpu_torch.ops import cuda_traverse as ct
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    opts, settings, world = slice_options(cornell)
    r = Renderer(scene, cam, WIDTH, HEIGHT, options=opts, settings=settings,
                 world=world, bvh=bvh, seed=42)
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
        f"{frames / ms * 1e3:.3f} spp/s; launches {launches}; image mean "
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


def phase_parity(tag, scene, cam, bvh, cornell):
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    opts, settings, world = slice_options(cornell)
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


def phase_cornell_scene(dev):
    """The procedural Cornell scene of the tests, at the 16:9 aspect."""
    from hiprt_pt_tpu_torch.accel.build import MAX_MEGANODE_ROWS, build_bvh
    from hiprt_pt_tpu_torch.assets.scene import build_scene
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat
    from hiprt_pt_tpu_torch.core.material import MaterialBank

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    from torch_parity import cornell_spheres_arrays

    t0 = time.perf_counter()
    v, f, m, rows, cam_kw = cornell_spheres_arrays(WIDTH / HEIGHT)
    scene = build_scene(v, f, m, MaterialBank.from_rows(rows), device=dev)
    cam = camera_from_lookat(**cam_kw, device=dev)
    t1 = time.perf_counter()
    bvh = build_bvh(v, f, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rows_n = 0 if bvh.nodes is None else bvh.nodes.shape[0]
    log(f"[cornell scene] {scene.num_triangles} triangles, "
        f"{scene.num_emissives} emissive triangles, {len(rows)} materials, "
        f"scene {t1 - t0:.2f} s, BVH build {t2 - t1:.3f} s, meganode rows "
        f"{rows_n} (cap {MAX_MEGANODE_ROWS}), depth2 {bvh.depth2}, "
        f"tables {bvh.nbytes} bytes")
    if bvh.nodes is None or not 0 < rows_n <= MAX_MEGANODE_ROWS:
        raise AssertionError("the Cornell scene's meganode table is not kept")
    assert scene.num_triangles == 35_852
    return scene, cam, bvh


def main() -> int:
    name = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    phase_build()
    scene, cam, bvh, _build_s = phase_scene(dev)
    errs, times = phase_kernels(scene, cam, bvh, dev, STRESS_CASES)
    launches = phase_slice("stress", scene, cam, bvh, False,
                           {k for k, _ in STRESS_CASES})
    phase_parity("stress", scene, cam, bvh, False)
    del scene, cam, bvh

    scene, cam, bvh = phase_cornell_scene(dev)
    c_errs, c_times = phase_kernels(scene, cam, bvh, dev, CORNELL_CASES)
    c_launches = phase_slice("cornell", scene, cam, bvh, True,
                             {k for k, _ in CORNELL_CASES})
    phase_parity("cornell", scene, cam, bvh, True)
    errs.update(c_errs)
    times.update(c_times)
    launches.update({k: c_launches[k] for k, _ in CORNELL_CASES})

    # ms and plain ms: closest hit on the 1080p rays each kernel serves
    timed = dict(STRESS_CASES + CORNELL_CASES[:1])
    kernels = [{
        "name": k,
        "route": "cuda",
        "source": "hiprt_pt_tpu_torch/csrc/traverse.cu",
        "replaces": KERNELS[k],
        "launches": launches[k],
        "max_abs_err": errs[k],
        "ms": times[(k, timed[k], False)][0],
        "plain_ms": times[(k, timed[k], False)][1],
    } for k in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
