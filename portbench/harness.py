"""The harness core: set-up, the measured window, the traced frames and the
result line of one run of one cell. What belongs to one configuration,
traffic or per-layer metric lives in its own file (cell.py finds them);
the comparison that decides ``correct`` is check.py's.

The window drives the port's public frame entry, Renderer.step(), in a
closed loop for ``seconds``: each frame's end is stamped with a CUDA event
and the loop adds no synchronise of its own; one synchronise closes the
window. Set-up (imports, inputs, load, BVH, the kernels' builds, the
warm-up frames) is timed apart. The renderer is reset after the warm-up,
so the window's image is the accumulation of its own frames only.
"""

from __future__ import annotations

import importlib.util
import os
import random
import sys
import time

import torch

from . import system, yardstick
from .cell import HERE, Cell, inputs as make_inputs
from .check import MID_FRAMES

# frames under the profiler in a traced run, after the window
TRACE_FRAMES = 2


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def check_frame(seed: int) -> int:
    """The middle check frame, drawn from the run's seed among frames 3 to
    MID_FRAMES (check.py)."""
    return random.Random(seed).randint(3, MID_FRAMES)


class Window:
    """The frames of the measured window and the render states the check
    keeps: for each check frame k, the state before it and after it.
    ``step()`` queues one frame and returns the new state; ``stop(elapsed)``
    says, after each frame, whether the window has closed (default: once
    ``seconds`` have passed on the host clock)."""

    def __init__(self, step, state, seconds: float, mid: int, cuda: bool,
                 stop=None):
        self.step = step
        self.state = state
        self.stop = stop or (lambda elapsed: elapsed >= seconds)
        self.mid = mid
        self.cuda = cuda
        self.kept: dict = {}
        self.frames = 0
        self.intervals_ms: list = []
        self.elapsed_s = 0.0

    def _stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def run(self) -> "Window":
        prev = self.state
        stamps = [self._stamp()]
        t0 = time.perf_counter()
        while True:
            state = self.step()
            stamps.append(self._stamp())
            self.frames += 1
            if self.frames in (1, self.mid):
                self.kept[self.frames] = (prev, state)
            last = (prev, state)
            prev = state
            if self.stop(time.perf_counter() - t0):
                break
        if self.cuda:
            torch.cuda.synchronize()
        self.elapsed_s = time.perf_counter() - t0
        self.kept[self.frames] = last
        if self.cuda:
            self.intervals_ms = [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
        else:
            self.intervals_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        return self


def metric_readers(names) -> dict:
    """{name: read(ctx)} of portbench/metrics/<name>.py."""
    out = {}
    for name in names:
        path = os.path.join(HERE, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.read
    return out


def _traced(r, cell: Cell) -> dict:
    """The per-layer readings of a traced run, after the window: TRACE_FRAMES
    frames under torch.profiler (with the port's march counter), the ReSTIR
    passes of one frame through the stage hook, and one frame whose
    traversal launches are captured for the roofline."""
    from torch.profiler import ProfilerActivity, profile

    from . import trace

    ctx: dict = {}
    torch.cuda.synchronize()
    system.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACE_FRAMES):
            r.step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    ctx["march_segments"] = system.march_segments() / TRACE_FRAMES
    ctx["trace"] = trace.summarize(prof, TRACE_FRAMES, window_s)
    del prof
    if cell.restir:
        ctx["restir_ms"] = sum(system.stage_timed_step(r) for _ in range(2)) / 2
    with system.RayCapture() as cap, profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        r.step()
        torch.cuda.synchronize()
    ctx["captured"] = cap.launches
    ctx["captured_traverse_s"] = trace.summarize(prof, 1, 0.0).traverse_s
    del prof
    return ctx


def _roofline(ctx: dict, ref_bvh, device) -> None:
    """The least time of the captured frame's traversal launches, counted by
    the reference's walk over its own BVH, beside their kernel time."""
    from .reference.ops.traverse import walk

    least = 0.0
    for _kernel, o, d, t_min, t_max, active, any_hit in ctx.pop("captured"):
        stats: dict = {}
        walk(ref_bvh, o, d, t_min=t_min, t_max=t_max, active=active,
             any_hit=any_hit, stats=stats)
        n = o.shape[0]
        n_active = n if active is None else int(active.sum())
        least += yardstick.least_seconds(
            int(stats.get("box_tests", 0)), int(stats.get("tri_tests", 0)),
            n, n_active, ref_bvh.table_bytes())
    ctx["roofline"] = {"least_s": least, "kernel_s": ctx.pop("captured_traverse_s")}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """One run of a one-rank cell on ``device``: set-up, the window, the
    traced frames when asked, then the check. Returns the result's fields
    (the caller prints the line)."""
    from . import check

    cuda = torch.device(device).type == "cuda"
    if cuda:
        system.enable_caches()
    inp = make_inputs(cell)
    scene, cam, bvh, load_s = system.load(cell, inp, device)
    r = system.renderer(cell, scene, cam, bvh, seed)
    for _ in range(int(cell.traffic.get("warmup_frames", 2))):
        r.step()
    if cuda:
        torch.cuda.synchronize()
    r.reset()
    setup_s = time.perf_counter() - t_start

    mid = check_frame(seed)
    log(f"set-up {setup_s:.3f} s (load {load_s})")
    win = Window(r.step, r.state, seconds, mid, cuda).run()
    spf = max(int(r.settings.samples_per_frame), 1)
    e2e = yardstick.window_metrics(win.frames, spf, win.elapsed_s, win.intervals_ms)
    e2e["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = {"setup": load_s}
    if trace and cuda:
        t0 = time.perf_counter()
        ctx.update(_traced(r, cell))
        log(f"traced frames {time.perf_counter() - t0:.3f} s")
    rays = int(win.kept[win.frames][1].rays_traced)
    del r, scene, cam, bvh
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    verdict = check.judge(cell, inp, seed, win.kept, device,
                          roofline=(lambda b: _roofline(ctx, b, device))
                          if "captured" in ctx else None)
    log(f"check {time.perf_counter() - t0:.3f} s")
    return {"e2e": e2e, "ctx": ctx, "frames": win.frames, "verdict": verdict,
            "memory_peak_bytes": peak, "window_s": win.elapsed_s,
            "mrays_per_s": rays / win.elapsed_s / 1e6,
            "check_frames": sorted(win.kept)}
