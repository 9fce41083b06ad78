"""Command-line renderer — the system's headless entry point, mirroring
``hiprt_pt_tpu.app.cli`` (reference: ``main()`` + ``CommandlineArguments``,
src/main.cpp:28-104, src/Utils/CommandlineArguments.h:11-27, and the
GPU_RENDER=0 render-to-PNG mode, main.cpp:77-101), with the JAX package's
flags for the strategy, the denoiser and checkpoints.

Usage (on the GPU; ``--cpu`` runs the plain PyTorch version of every
kernel on the host):
    python -m hiprt_pt_tpu_torch.app.cli scene.glb --samples=64 --bounces=8 \
        --w=1280 --h=720 --sky=env.hdr --out=render.png
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hiprt_pt_tpu_torch",
        description="Physically-based path tracer on PyTorch and CUDA",
    )
    p.add_argument("scene", help="GLTF scene file")
    p.add_argument("--sky", default=None, help="equirectangular HDR envmap")
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--w", type=int, default=1280)
    p.add_argument("--h", type=int, default=720)
    p.add_argument("--out", default=None, help="output PNG (auto-named if omitted)")
    p.add_argument("--hdr-out", default=None, help="also write a .hdr")
    p.add_argument(
        "--strategy",
        choices=["nee", "mis", "bsdf", "ris", "restir"],
        default="mis",
        help="direct light sampling strategy",
    )
    p.add_argument("--denoise", action="store_true")
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=2.2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--spp-per-frame", type=int, default=4)
    p.add_argument("--adaptive", action="store_true", help="adaptive sampling")
    p.add_argument(
        "--clamp", type=float, default=0.0,
        help="per-sample contribution clamp (0=off, unbiased; reference: "
             "direct/indirect contribution clamps)",
    )
    p.add_argument("--checkpoint", default=None, help="save render state here")
    p.add_argument("--resume", default=None, help="resume render state from here")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain version of every kernel)")
    p.add_argument("--max-time", type=float, default=None, help="seconds")
    return p


_STRATEGY = {
    "nee": "UNIFORM_ONE",
    "mis": "MIS",
    "bsdf": "BSDF_ONLY",
    "ris": "RIS_BSDF_LIGHT",
    "restir": "RESTIR_DI",
}


def main(argv=None, stats: Optional[dict] = None) -> int:
    """Render the scene as the flags say and write the files. Runs on the
    GPU (raises where there is none) unless ``--cpu``. Given ``stats``, adds
    the seconds of each stage to it ("load": the envmap and the scene
    file, "bvh", "render", "denoise", "png", "hdr", "checkpoint") and the
    render's "samples", "rays", "frame_ms" and "samples_per_s" (the
    averages of Renderer.metrics)."""
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..assets.envmap import load_envmap
    from ..assets.image_io import write_hdr, write_png
    from ..assets.loader import load_scene_file
    from ..core.device import resolve_device
    from ..core.settings import (AmbientLightType, LightSamplingStrategy,
                                 RenderOptions)
    from ..ops.tonemap import tonemap_gamma
    from ..render.renderer import Renderer
    from ..utils.logger import get_logger
    from .screenshot import auto_filename

    spent = {} if stats is None else stats
    device = resolve_device("cpu" if args.cpu else None)
    log = get_logger()
    t0 = time.perf_counter()
    envmap = load_envmap(args.sky, device=device) if args.sky else None
    scene, camera = load_scene_file(
        args.scene, aspect=args.w / args.h, envmap=envmap, device=device)
    spent["load"] = time.perf_counter() - t0
    log.info(
        f"scene loaded on {device}: {scene.num_triangles} triangles, "
        f"{scene.materials.num_materials} materials ({spent['load']:.1f}s)"
    )

    options = RenderOptions(
        direct_light_sampling=LightSamplingStrategy[_STRATEGY[args.strategy]],
        max_bounces_static=args.bounces,
    )
    r = Renderer(scene, camera, args.w, args.h, options=options, seed=args.seed)
    spent["bvh"] = r.bvh_build_time
    log.info(f"BVH built in {r.bvh_build_time:.2f}s")
    r.settings = r.settings.replace(
        nb_bounces=args.bounces,
        samples_per_frame=args.spp_per_frame,
        enable_adaptive_sampling=args.adaptive,
        direct_contribution_clamp=args.clamp,
        indirect_contribution_clamp=args.clamp,
        envmap_contribution_clamp=args.clamp,
    )
    if envmap is not None:
        r.world = r.world.replace(ambient_light_type=int(AmbientLightType.ENVMAP))
    if args.resume:
        from ..render.checkpoint import load_checkpoint

        r.state = load_checkpoint(args.resume, r.state)
        log.info(f"resumed from {args.resume} at sample {r.state.sample_count}")
    r.max_sample_count = args.samples
    r.max_render_time = args.max_time

    t0 = time.perf_counter()
    last_log = 0.0
    while not r.is_rendering_done():
        r.step(block=True)
        now = time.perf_counter()
        if now - last_log > 2.0:
            sps = r.metrics.get_average("samples_per_s")
            log.update_line(
                "render", f"[render] {r.state.sample_count}/{args.samples} spp  "
                f"{sps:.2f} spp/s  {now - t0:.0f}s")
            last_log = now
    log.end_line("render")
    dt = time.perf_counter() - t0
    sc = r.state.sample_count
    rays = r.rays_traced
    spent.update(render=dt, samples=sc, rays=rays,
                 frame_ms=r.metrics.get_average("frame_ms"),
                 samples_per_s=r.metrics.get_average("samples_per_s"))
    log.info(f"rendered {sc} spp in {dt:.1f}s "
             f"({rays / max(dt, 1e-9) / 1e6:.1f} Mrays/s)")

    t0 = time.perf_counter()
    if args.denoise:
        from ..render.denoise import denoise

        hdr = denoise(r)
    else:
        hdr = r.hdr_image()
    spent["denoise"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = args.out or auto_filename(args.scene, sc, args.w, args.h)
    ldr = tonemap_gamma(torch.from_numpy(np.ascontiguousarray(hdr)),
                        args.exposure, args.gamma).numpy()
    write_png(out, ldr, gamma_encode=False)
    spent["png"] = time.perf_counter() - t0
    log.info(f"wrote {out}")
    if args.hdr_out:
        t0 = time.perf_counter()
        write_hdr(args.hdr_out, hdr)
        spent["hdr"] = time.perf_counter() - t0
        log.info(f"wrote {args.hdr_out}")
    if args.checkpoint:
        from ..render.checkpoint import save_checkpoint

        t0 = time.perf_counter()
        save_checkpoint(args.checkpoint, r.state)
        spent["checkpoint"] = time.perf_counter() - t0
        log.info(f"checkpoint saved to {args.checkpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
