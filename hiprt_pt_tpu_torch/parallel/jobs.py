"""Rank jobs for parallel/launch.py: render through pixel DP, sample DP or
the frame-sequence split, and report what a caller holds against one
process (chip_smoke.py's ``parallel`` phase and the CPU tests run them).

``render(rank, spec)`` runs ``spec["runs"]`` in order on the ranks of one
launch (``spec["device"]``: the ranks' device, default make_mesh's).
Rank 0 holds each run's scene (``spec["inputs"][name]``: a (scene, camera,
bvh) tuple, or the name of a paths.py path that rank 0 loads on its
device); ``replicate`` gives it to the others. A run:

    name, input, mode ("pixels" or "samples"), ranks (the first k ranks
    render it, default all), options, settings, world, width, height,
    samples (timed), warmup (untimed, default 0), synced (default 0:
    samples after the warm-up whose collectives are timed with the device
    synchronised around each, so that their time is theirs and not the
    queued work they wait for), state (a whole-image state to carry on
    from: sharded under "pixels"; a list of per-rank states under
    "samples"), keep (fields returned as arrays); the state's seed is 42

or, with mode "sequence", render_distributed_sequence of a
CameraOrbitAnimation on every rank, each its share of the frames by its
rank in the group: input, width, height, options, settings, world,
frames, spp (samples a frame), out_dir, orbit (the animation's fields).

Each rank returns, per run, its counts (kernel launches, the alpha
march's segments and idle segments, collectives) and times of the timed
samples, and the synced samples' collective calls and ms; under "pixels" rank 0 adds the gathered whole-image state's
``state_digests`` and kept arrays; under "samples" every rank adds its own
state's, and rank 0 the merged mean and total; under "sequence" the
paths it wrote and its kernel launches.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import torch
import torch.distributed as dist

from ..core.settings import LightSamplingStrategy
from . import mesh as pm
from .frames import render_distributed_sequence


def state_digests(state, prefix: str = "") -> dict:
    """{field: sha256 of its dtype, shape and bytes} of a render state and
    its nested G-buffers and reservoirs; host integers by value."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        name = prefix + f.name
        if isinstance(v, torch.Tensor):
            a = v.detach().cpu().contiguous()
            h = hashlib.sha256(f"{a.dtype}{tuple(a.shape)}".encode())
            h.update(a.reshape(-1).view(torch.uint8).numpy().tobytes())
            out[name] = h.hexdigest()
        elif dataclasses.is_dataclass(v):
            out.update(state_digests(v, name + "."))
        else:
            out[name] = repr(v)
    return out


def kept_arrays(state, keep) -> dict:
    """{field: numpy array} of the named fields ("gbuffer.t" for nested
    ones) of a state."""
    out = {}
    for name in keep:
        v = state
        for part in name.split("."):
            v = getattr(v, part)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[name] = v
    return out


def _inputs(spec, mesh):
    """{name: (scene, camera, bvh)} on every rank, from rank 0's."""
    out = {}
    for name in sorted(spec["inputs"]):
        mine = None
        if mesh.rank == 0:
            src = spec["inputs"][name]
            if isinstance(src, str):
                from ..paths import load

                mine = load(src, mesh.device)[:3]
            else:
                mine = src
        out[name] = pm.replicate(mine, mesh)
    return out


class _Clock:
    """Milliseconds between two points: CUDA events on a card, the host
    clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self.ev[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.ev[1].record()
            torch.cuda.synchronize()
            return self.ev[0].elapsed_time(self.ev[1])
        return (time.perf_counter() - self.t0) * 1e3


def _counts_reset():
    from ..ops import cuda_traverse as ct
    from ..ops import traverse

    ct.reset_launch_counts()
    traverse.reset_march_counts(tally=True)


def _counts():
    from ..ops import cuda_traverse as ct
    from ..ops import traverse

    mc, cs = traverse.march_counts, pm.collective_stats
    return {"launches": dict(ct.launch_counts),
            "segments": sum(mc["segments"].values()),
            "idle_segments": int(mc["idle"]),
            "collective_calls": dict(cs["calls"]),
            "collective_ms": 1e3 * sum(cs["seconds"].values())}


def _sequence(run, inputs) -> dict:
    """A "sequence" run: render_distributed_sequence of a
    CameraOrbitAnimation on this rank."""
    from ..ops import cuda_traverse as ct
    from ..render.animation import CameraOrbitAnimation
    from ..render.renderer import Renderer

    scene, cam, bvh = inputs[run["input"]]
    r = Renderer(scene, cam, run["width"], run["height"],
                 options=run["options"], settings=run["settings"],
                 world=run["world"], bvh=bvh)
    ct.reset_launch_counts()
    paths = render_distributed_sequence(
        r, run["frames"], run["spp"], run["out_dir"],
        camera_animation=CameraOrbitAnimation(**run["orbit"]))
    return {"paths": paths, "launches": dict(ct.launch_counts)}


def _run(rank, world, run, inputs, device):
    """One run on the launch's ranks; returns this rank's report (None on
    a rank outside the run)."""
    mode = run.get("mode", "pixels")
    if mode == "sequence":
        return _sequence(run, inputs)
    k = run.get("ranks", world)
    group = None if k == world else dist.new_group(list(range(k)))
    if rank >= k:
        return None
    mesh = (pm.make_mesh(group, device) if mode == "pixels"
            else pm.make_sample_mesh(group, device))
    scene, cam, bvh = inputs[run["input"]]
    w, h = run["width"], run["height"]
    args = (run["options"], w, h, scene, bvh, cam, run["settings"],
            run["world"], mesh)
    restir = (run["options"].direct_light_sampling
              == LightSamplingStrategy.RESTIR_DI)
    carried = run.get("state")
    if mode == "pixels":
        step = pm.distributed_render
        state = (pm.shard_render_state(carried, mesh) if carried is not None
                 else pm.init_sharded_render_state(w, h, mesh,
                                                   with_restir=restir))
    else:
        step = pm.sample_dp_render
        state = (pm.map_tensors(carried[rank], lambda x: x.to(device))
                 if carried is not None
                 else pm.init_sample_dp_state(w, h, mesh, with_restir=restir))
    for _ in range(run.get("warmup", 0)):
        state = step(*args, state)
    pm.reset_collective_stats(sync=True)
    for _ in range(run.get("synced", 0)):
        state = step(*args, state)
    synced = {"samples": run.get("synced", 0),
              "collective_calls": dict(pm.collective_stats["calls"]),
              "collective_ms": 1e3 * sum(
                  pm.collective_stats["seconds"].values())}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    _counts_reset()
    pm.reset_collective_stats()
    clock = _Clock(device)
    for _ in range(run["samples"]):
        state = step(*args, state)
    ms = clock.stop()
    report = {"rank": rank, "ranks": k, "backend": mesh.backend,
              "device": str(device), "ms": ms,
              "ms_per_sample": ms / max(run["samples"], 1), **_counts(),
              "synced": synced}
    keep = run.get("keep", ())
    if mode == "pixels":
        full = pm.gather_render_state(state, mesh, dst=0)
        if full is not None:
            report.update(digests=state_digests(full),
                          arrays=kept_arrays(full, keep))
    else:
        merged, total = pm.merge_sample_dp(state, mesh)
        report.update(digests=state_digests(state),
                      arrays=kept_arrays(state, keep))
        if rank == 0:
            report.update(merged=merged.cpu().numpy(), total=total)
    return report


def render(rank: int, spec: dict) -> dict:
    """Run spec["runs"] (see the module's docstring); {run name: this
    rank's report}."""
    device = torch.device(spec["device"]) if spec.get("device") else None
    top = pm.make_mesh(device=device)
    inputs = _inputs(spec, top)
    return {run["name"]: _run(rank, top.size, run, inputs, top.device)
            for run in spec["runs"]}
