"""Where one frame's time goes on the card, for one of the paths of
paths.py (the paths chip_smoke.py drives).

    python -m hiprt_pt_tpu_torch.profile_frame [stress|cornell|stress14|headline|restir|envmap|gltf|cli]

Builds the path's scene (paths.load), renders three warm-up frames at
1920x1080, then one frame under ``torch.profiler`` (CPU and CUDA
activities). Prints the frame's wall time unprofiled and profiled, the
device's busy time (the union of its intervals) and share, and the host's
launch and sync counts; for each span of the profiled frame
(utils/spans.py: the step, the camera pass, the ReSTIR passes, each
bounce's parts, the alpha march, the accumulation) its count, stream ms,
self stream ms and host ms, and the launches and syncs the host made while
it was the innermost span open; the ten longest idle gaps of the device,
each named by the innermost span open on the host at its midpoint (the
join is ``spans.attribute`` on the profiler's events, which share the
spans' clock); then the operators and kernels with the most device time.
Needs a GPU; exits non-zero without one.
"""

from __future__ import annotations

import sys
import time

import torch

from .utils import spans

WIDTH, HEIGHT = 1920, 1080


def _events(prof) -> list:
    """(name, start_ns, end_ns, on_device) of every event of a finished
    profiler but its user annotations."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        annotation = getattr(e, "is_user_annotation", None)
        if annotation is not None and annotation():
            continue
        start = int(e.start_ns())
        out.append((e.name(), start, start + int(e.duration_ns()),
                    e.device_type() == DeviceType.CUDA))
    return out


def _print_spans(recs, joined, frame_ms) -> None:
    rows: dict = {}
    for r in recs:
        row = rows.setdefault(r.name, [0, 0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += r.stream_ms or 0.0
        row[2] += r.self_ms or 0.0
        row[3] += r.host_ms
    print(f"[spans] {'span':<18} {'n':>3} {'stream ms':>10} {'self ms':>9} "
          f"{'self %':>7} {'host ms':>9} {'launches':>9} {'syncs':>6}")
    for name, (n, stream, own, host) in rows.items():
        calls = joined["spans"].get(name, {"launches": 0, "syncs": 0})
        print(f"[spans] {name:<18} {n:>3} {stream:>10.2f} {own:>9.2f} "
              f"{own / frame_ms:>7.1%} {host:>9.2f} {calls['launches']:>9} "
              f"{calls['syncs']:>6}")
    outside = joined["spans"].get(None)
    if outside:
        print(f"[spans] outside any span: {outside['launches']} launches, "
              f"{outside['syncs']} syncs")
    for name, ms in joined["gaps"]:
        print(f"[gap] {ms:8.3f} ms in {name or 'no span'}")


def main(path: str = "stress14") -> int:
    if not torch.cuda.is_available():
        print("profile_frame: CUDA is not available", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from . import paths
    from .render.renderer import Renderer

    dev = torch.device("cuda:0")
    scene, cam, bvh, secs = paths.load(path, dev)
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
        with spans.step(dev) as sid:
            r.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    spans.flush()
    recs = [rec for rec in spans.records() if rec.step == sid]
    joined = spans.attribute(_events(prof), recs)
    launches = sum(c["launches"] for c in joined["spans"].values())
    syncs = sum(c["syncs"] for c in joined["spans"].values())
    print(f"[frame] {path}: unprofiled {', '.join(f'{w:.1f}' for w in walls)} "
          f"ms; profiled {prof_ms:.1f} ms; device busy {joined['busy_ms']:.1f} "
          f"ms ({joined['busy_ms'] / prof_ms:.1%} of the profiled frame); "
          f"host launches {launches}, syncs {syncs}")
    frame_ms = sum(rec.stream_ms or 0.0 for rec in recs if rec.name == "step")
    _print_spans(recs, joined, max(frame_ms, 1e-9))
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    ops = [e for e in events if e.device_type != DeviceType.CUDA]
    for tag, group, top in (("op", ops, 20), ("kernel", kernels, 12)):
        for e in sorted(group, key=lambda e: e.self_device_time_total,
                        reverse=True)[:top]:
            if e.self_device_time_total <= 0:
                break
            print(f"[{tag}] {e.self_device_time_total / 1e3:9.2f} ms "
                  f"{e.self_device_time_total / device_us:6.1%} x{e.count:6d}  "
                  f"{e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
