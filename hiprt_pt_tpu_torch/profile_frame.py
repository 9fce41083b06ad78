"""Where one frame's time goes on the card, for one of the paths of
paths.py (the paths chip_smoke.py drives).

    python -m hiprt_pt_tpu_torch.profile_frame [stress|cornell|stress14|headline|restir|envmap|gltf|cli]

Builds the path's scene (paths.load), renders one warm-up frame at
1920x1080, then one frame under ``torch.profiler`` (CPU and CUDA
activities). Prints the frame's wall time unprofiled and profiled, the
device's self time (the sum over device kernels) and its busy share, the
host's launch count, and the operators and kernels with the most device
time (operators by the device time of the kernels they launch, then the
kernels themselves). For the paths under RIS (stress14, headline, gltf,
and restir and cli past the camera vertex) it also times, with CUDA events, the
parts of one RIS vertex wavefront on the camera pass's hits: the full
``ris_direct_lighting`` (on gltf with the alpha march), the dense emissive
sweep and the winner's alpha-blind visibility ray; for the ReSTIR paths
(restir, cli) also each pass of the camera vertex's reservoir pipeline in the
frame after the profiled one. Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import sys
import time

import torch

from .core.device import cuda_ms

WIDTH, HEIGHT = 1920, 1080


def _ris_parts(scene, cam, bvh, opts, settings):
    """CUDA-event times of one RIS vertex wavefront and two of its parts."""
    from .core import rng as rng_mod
    from .core.state import init_render_state
    from .lights.light_sampling import closest_emissive_hit
    from .lights.ris import ris_direct_lighting
    from .ops.intersect import offset_ray_origin
    from .ops.routing import tracer
    from .render.integrator import camera_rays_pass

    dev = scene.vertices.device
    n = WIDTH * HEIGHT
    rng = rng_mod.seed(torch.arange(n, device=dev), 0, 42)
    rng, g, active = camera_rays_pass(scene, bvh, cam, settings,
                                      init_render_state(WIDTH, HEIGHT, 42, dev),
                                      WIDTH, HEIGHT, 0, rng, opts)
    hit = active & (g.prim_index >= 0)
    mats = scene.materials.at_indices(g.material_id.clamp_min(0)).make_safe()
    eta = torch.full((n,), 1.5, device=dev)
    args = (opts, scene, bvh, settings, mats, g.position, g.shading_normal,
            g.geometric_normal, g.view_direction, rng, hit, eta)
    ris_ms = cuda_ms(lambda: ris_direct_lighting(*args, shadow_coherent=True))[0]
    wi = -g.view_direction
    o = offset_ray_origin(g.position, g.geometric_normal, wi)
    sweep_ms = cuda_ms(lambda: closest_emissive_hit(scene, o, wi, active=hit))[0]
    trace = tracer(bvh, coherent=True)
    shadow_ms = cuda_ms(lambda: trace(bvh, o, wi, t_min=1e-4, t_max=5.0,
                                      active=hit, any_hit=True))[0]
    print(f"[ris] one RIS vertex wavefront on {int(hit.sum())} camera hits: "
          f"{ris_ms:.2f} ms; dense emissive sweep (240 emitters) "
          f"{sweep_ms:.2f} ms; one coherent any-hit ray batch {shadow_ms:.3f} ms")


def _restir_parts(r) -> None:
    """CUDA-event times of each pass of the ReSTIR pipeline in the next
    frame of the renderer ``r`` (its reservoirs carry history): render_step
    runs each pass through a ``stage`` that times it (cuda_ms: a warm-up
    call, then three)."""
    from .render.renderer import render_step

    times = {}

    def timed(name, fn, *args, **kw):
        times[name], out = cuda_ms(lambda: fn(*args, **kw))
        return out

    st = render_step(r.options, r.width, r.height, r.scene, r.bvh, r.state,
                     r.camera, r.settings, r.world, stage=timed)
    hits = int((st.gbuffer.prim_index >= 0).sum())
    print(f"[restir] one frame's reservoir pipeline on {hits} camera hits: "
          + "; ".join(f"{name} {ms:.2f} ms" for name, ms in times.items()))


def main(path: str = "stress14") -> int:
    if not torch.cuda.is_available():
        print("profile_frame: CUDA is not available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from . import paths
    from .render.renderer import Renderer

    scene, cam, bvh, secs = paths.load(path, torch.device("cuda:0"))
    print(f"[setup] {path}: scene {secs['scene']:.3f} s, BVH build "
          f"{secs['bvh']:.3f} s")
    opts, settings, world = paths.slice_options(path)
    r = Renderer(scene, cam, WIDTH, HEIGHT, options=opts, settings=settings,
                 world=world, bvh=bvh, seed=42)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    print(f"[frame] {path}: unprofiled {', '.join(f'{w:.1f}' for w in walls)} "
          f"ms; profiled {prof_ms:.1f} ms; device self time "
          f"{device_us / 1e3:.1f} ms ({device_us / 1e3 / prof_ms:.1%} of the "
          f"profiled frame); host kernel launches {launches}")
    ops = [e for e in events if e.device_type != DeviceType.CUDA]
    for tag, group, top in (("op", ops, 20), ("kernel", kernels, 12)):
        for e in sorted(group, key=lambda e: e.self_device_time_total,
                        reverse=True)[:top]:
            if e.self_device_time_total <= 0:
                break
            print(f"[{tag}] {e.self_device_time_total / 1e3:9.2f} ms "
                  f"{e.self_device_time_total / device_us:6.1%} x{e.count:6d}  "
                  f"{e.key[:110]}")
    if path in ("stress14", "headline", "restir", "gltf", "cli"):
        _ris_parts(scene, cam, bvh, opts, settings)
    if path in ("restir", "cli"):
        _restir_parts(r)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
