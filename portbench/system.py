"""The system under test: the port's public entry points, driven for a
cell. Everything of the program that the benchmark calls is called here
(the load, the Renderer, the traversal router that the roofline's capture
wraps, the port's counters); the rest of the harness reads what this
module returns.
"""

from __future__ import annotations

import os
import time

import torch

from .cell import CACHE, Cell, options


def enable_caches(cache: str = CACHE) -> None:
    """Point every build and kernel cache at fixed folders inside the
    checkout: the port's native libraries (utils/precompile.py), and the
    toolchains' caches that a library could use."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = os.path.join(cache, sub)
    from hiprt_pt_tpu_torch.utils.precompile import enable_persistent_cache

    enable_persistent_cache(os.path.join(cache, "build"))


def load(cell: Cell, inputs: dict, device) -> tuple:
    """(scene, camera, bvh, {"scene_load_s", "bvh_build_s"}) through the
    port's entry points: load_scene_file(parallel=True, with_bvh=True) for a
    scene file (its stages: scene_load_s is the total less the BVH's stage,
    which overlaps the atlas); build_scene and build_bvh for arrays, each
    timed here to a device synchronise."""
    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    if "glb" in inputs:
        from hiprt_pt_tpu_torch.assets.loader import load_scene_file

        spent: dict = {}
        scene, cam, bvh = load_scene_file(
            inputs["glb"], aspect=inputs["aspect"], parallel=True,
            with_bvh=True, device=device, timings=spent)
        sync()
        return scene, cam, bvh, {"scene_load_s": spent["total"] - spent["bvh"],
                                 "bvh_build_s": spent["bvh"]}
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.assets.envmap import build_envmap
    from hiprt_pt_tpu_torch.assets.scene import build_scene
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat
    from hiprt_pt_tpu_torch.core.material import MaterialBank

    v, f, m, rows, cam_kw = inputs["arrays"]
    t0 = time.perf_counter()
    envmap = (build_envmap(inputs["envmap"], device=device)
              if inputs.get("envmap") is not None else None)
    scene = build_scene(v, f, m, MaterialBank.from_rows(rows), envmap=envmap,
                        device=device)
    cam = camera_from_lookat(**cam_kw, device=device)
    sync()
    t1 = time.perf_counter()
    bvh = build_bvh(v, f, device)
    sync()
    t2 = time.perf_counter()
    return scene, cam, bvh, {"scene_load_s": t1 - t0, "bvh_build_s": t2 - t1}


def renderer(cell: Cell, scene, cam, bvh, seed: int):
    """The port's Renderer for the cell, with the render seed ``seed``."""
    from hiprt_pt_tpu_torch.core import settings as sm
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    opts, settings, world = options(cell, sm)
    w, h = cell.resolution
    return Renderer(scene, cam, w, h, options=opts, settings=settings,
                    world=world, bvh=bvh, seed=seed)


def reset_counters() -> None:
    from hiprt_pt_tpu_torch.ops import traverse

    traverse.reset_march_counts()


def march_segments() -> int:
    """Segments the port's alpha march ran since reset_counters()."""
    from hiprt_pt_tpu_torch.ops.traverse import march_counts

    return int(sum(march_counts["segments"].values()))


def stage_timed_step(r) -> float:
    """Advance the renderer ``r`` by one sample through render_step with a
    ``stage`` that brackets each ReSTIR pass once with CUDA events; returns
    the passes' device milliseconds."""
    from hiprt_pt_tpu_torch.render.renderer import render_step

    marks = []

    def timed(_name, fn, *args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kw)
        b.record()
        marks.append((a, b))
        return out

    r.state = render_step(r.options, r.width, r.height, r.scene, r.bvh, r.state,
                          r.camera, r.settings, r.world, stage=timed)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks)


class RayCapture:
    """Wraps the port's public traversal router (ops/routing.py:tracer) as
    the integrator, RIS and ReSTIR modules hold it, so that each traversal
    launch's rays are copied: (kernel, o, d, t_min, t_max, active, any_hit).
    Used as a context manager around a frame."""

    _HOLDERS = (("hiprt_pt_tpu_torch.render.integrator", "_tracer"),
                ("hiprt_pt_tpu_torch.lights.ris", "tracer"),
                ("hiprt_pt_tpu_torch.restir.di", "tracer"))

    def __init__(self):
        self.launches: list = []
        self._saved: list = []

    def __enter__(self):
        import importlib

        from hiprt_pt_tpu_torch.ops import routing

        def capture(bvh, coherent, use_kernels=True):
            fn = routing.tracer(bvh, coherent, use_kernels)
            kernel = routing.route(bvh, coherent)

            def traced(bvh_, o, d, t_min=1e-4, t_max=float("inf"),
                       active=None, any_hit=False, **kw):
                def keep(x):
                    return x.detach().clone() if torch.is_tensor(x) else x
                self.launches.append((kernel, keep(o), keep(d), keep(t_min),
                                      keep(t_max), keep(active), bool(any_hit)))
                return fn(bvh_, o, d, t_min=t_min, t_max=t_max, active=active,
                          any_hit=any_hit, **kw)
            traced.__name__ = getattr(fn, "__name__", "trace")
            return traced

        for mod, attr in self._HOLDERS:
            m = importlib.import_module(mod)
            self._saved.append((m, attr, getattr(m, attr)))
            setattr(m, attr, capture)
        return self

    def __exit__(self, *exc):
        for m, attr, fn in self._saved:
            setattr(m, attr, fn)
        self._saved.clear()
        return False
