"""A cell whose traffic splits pixels over several ranks (pixel DP): the
port's public parallel entry points, one process a card.

parallel/launch.py:launch spawns the ranks (NCCL with a card a rank; gloo
on the host when rehearsed on the CPU). Rank 0 loads the scene through the
port's loader and parallel/mesh.py:replicate hands it to every rank; each
rank renders its Shard of the image (mesh.shard) with render_step(shard=)
frame after frame. The window's close is rank 0's host clock, handed to
the other ranks each frame over a gloo group on the host, so the window
adds no device synchronise. At the close every rank synchronises,
parallel/mesh.py:gather_render_state puts the kept states together on
rank 0, and rank 0 runs the check on the gathered image. Each rank reads
its own sys.modules for JAX and the JAX package once the window has closed
and again after the check, and returns what it found: run.py refuses the
run when any rank found something.
"""

from __future__ import annotations

import time

import torch

from . import harness, reap, system, yardstick
from .cell import Cell, inputs as make_inputs, options
from .guard import forbidden_modules

# seconds the launch may take, the collectives' time limit too
LAUNCH_TIMEOUT = 1100.0


def _rank(rank: int, spec: dict) -> dict:
    import torch.distributed as dist
    from hiprt_pt_tpu_torch.core import settings as sm
    from hiprt_pt_tpu_torch.parallel import mesh as pm
    from hiprt_pt_tpu_torch.render.renderer import render_step

    from . import check

    reap.die_with_parent()
    cell: Cell = spec["cell"]
    seed, seconds, trace = spec["seed"], spec["seconds"], spec["trace"]
    device = torch.device(spec["device"]) if spec["device"] else None
    mesh = pm.make_mesh(device=device)
    dev = mesh.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        system.enable_caches()
    host = dist.new_group(backend="gloo")
    w, h = cell.resolution
    inp = make_inputs(cell) if mesh.rank == 0 else None
    loaded = system.load(cell, inp, dev) if mesh.rank == 0 else None
    scene, cam, bvh, load_s = pm.replicate(loaded, mesh)
    opts, settings, world = options(cell, sm)
    shard = mesh.shard(w, h)
    spf = max(int(settings.samples_per_frame), 1)

    def fresh():
        return pm.init_sharded_render_state(w, h, mesh, seed,
                                            with_restir=cell.restir)

    box = {"state": fresh()}

    def step():
        box["state"] = render_step(opts, w, h, scene, bvh, box["state"], cam,
                                   settings, world, n_samples=spf, shard=shard)
        return box["state"]

    for _ in range(int(cell.traffic.get("warmup_frames", 2))):
        step()
    box["state"] = fresh()
    if cuda:
        torch.cuda.synchronize(dev)
    dist.barrier(group=host)
    setup_s = time.time() - spec["t_start_wall"]

    flag = torch.zeros((1,), dtype=torch.int32)

    def stop(elapsed: float) -> bool:
        flag[0] = int(mesh.rank == 0 and elapsed >= seconds)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=host)
        return bool(flag[0])

    pm.reset_collective_stats(sync=False)
    mid = harness.check_frame(seed)
    win = harness.Window(step, box["state"], seconds, mid, cuda, stop).run()
    forbidden = set(forbidden_modules())
    collective_s = sum(pm.collective_stats["seconds"].values())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    ctx: dict = {"setup": load_s,
                 "collective_ms": 1e3 * collective_s / win.frames}
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile

        from . import trace as tr

        system.reset_counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(harness.TRACE_FRAMES):
                step()
            torch.cuda.synchronize(dev)
            window_s = time.perf_counter() - t0
        ctx["march_segments"] = system.march_segments() / harness.TRACE_FRAMES
        ctx["trace"] = tr.summarize(prof, harness.TRACE_FRAMES, window_s)
        del prof
        with system.RayCapture() as cap, profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize(dev)
        if mesh.rank == 0:
            ctx["captured"] = cap.launches
            ctx["captured_traverse_s"] = tr.summarize(prof, 1, 0.0).traverse_s
        del prof, cap
    rays = int(win.kept[win.frames][1].rays_traced)
    kept = {k: tuple(pm.gather_render_state(s, mesh) for s in pair)
            for k, pair in win.kept.items()}
    del box, win.kept, scene, cam, bvh
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    out = {"rank": mesh.rank, "memory_peak_bytes": peak, "ctx": ctx}
    if mesh.rank != 0:
        out["ctx"].pop("setup")
        out["forbidden"] = sorted(forbidden | set(forbidden_modules()))
        return out
    verdict = check.judge(cell, inp, seed, kept, dev,
                          roofline=(lambda b: harness._roofline(ctx, b, dev))
                          if "captured" in ctx else None)
    out["forbidden"] = sorted(forbidden | set(forbidden_modules()))
    e2e = yardstick.window_metrics(win.frames, spf, win.elapsed_s, win.intervals_ms)
    e2e["setup_s"] = setup_s
    out.update(e2e=e2e, frames=win.frames, verdict=verdict,
               window_s=win.elapsed_s, mrays_per_s=rays / win.elapsed_s / 1e6,
               check_frames=sorted(kept))
    return out



def _mean_trace(summaries: list):
    """One Summary whose counts and times are the ranks' means."""
    import dataclasses

    first = summaries[0]
    n = len(summaries)
    return dataclasses.replace(
        first,
        launches=sum(s.launches for s in summaries) / n,
        syncs=sum(s.syncs for s in summaries) / n,
        busy_s=sum(s.busy_s for s in summaries) / n,
        window_s=sum(s.window_s for s in summaries) / n,
        traverse_s=sum(s.traverse_s for s in summaries) / n,
        kernel_s={k: sum(s.kernel_s.get(k, 0.0) for s in summaries) / n
                  for k in first.kernel_s})


def run_ranks(cell: Cell, seed: int, seconds: float, trace: bool,
              t_start: float, device=None, backend: str = "nccl",
              rank_fn=_rank) -> dict:
    """One run of a cell over ``cell.ranks`` spawned ranks; the same fields
    as harness.run_cell, the per-layer readings the ranks' means (the
    roofline rank 0's), and "forbidden": the JAX modules any rank held.
    ``rank_fn``: what each rank runs, ``_rank`` or a test's wrapper of it."""
    from hiprt_pt_tpu_torch.parallel.launch import launch

    spec = {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace,
            "device": device,
            "t_start_wall": time.time() - (time.perf_counter() - t_start)}
    outs = launch(rank_fn, cell.ranks, (spec,), backend=backend,
                  timeout=LAUNCH_TIMEOUT)
    res = outs[0]
    res["forbidden"] = sorted(set().union(*(o["forbidden"] for o in outs)))
    res["memory_peak_bytes"] = max(o["memory_peak_bytes"] for o in outs)
    ctx = res["ctx"]
    ctx["collective_ms"] = sum(o["ctx"]["collective_ms"] for o in outs) / len(outs)
    if "trace" in ctx:
        ctx["trace"] = _mean_trace([o["ctx"]["trace"] for o in outs])
        ctx["march_segments"] = sum(o["ctx"]["march_segments"] for o in outs) / len(outs)
    return res
