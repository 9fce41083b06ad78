"""Frame-sequence distribution — each process renders its round-robin share
of an animation, mirroring ``hiprt_pt_tpu.parallel.frames``.

Frames are independent, and every process advances the animations from
frame 0 with the same per-frame seeds, so a process renders exactly the
frames one process would. The share comes from the initialised
``torch.distributed`` process group (rank, world size), or is given
explicitly (process_index, process_count).
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist


def frame_assignment(num_frames: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> list:
    """Round-robin frame indices owned by this process: with no
    ``process_index``, this rank's of the default process group, or (0, 1)
    when none is initialised."""
    if process_index is None:
        if dist.is_available() and dist.is_initialized():
            process_index = dist.get_rank()
            process_count = dist.get_world_size()
        else:
            process_index, process_count = 0, 1
    return list(range(process_index, num_frames, max(process_count, 1)))


def render_distributed_sequence(renderer, num_frames: int,
                                samples_per_frame_image: int, out_dir: str,
                                camera_animation=None, envmap_animation=None,
                                process_index: Optional[int] = None,
                                process_count: Optional[int] = None,
                                log=None) -> list:
    """Render this process's share of the animation into
    ``out_dir/frame_{f:04d}.png`` (assets/image_io.py:write_png); returns
    the paths written. Every frame's animation state is advanced from frame
    0, so any process writes exactly the frames one process would."""
    from ..assets.image_io import write_png

    os.makedirs(out_dir, exist_ok=True)
    mine = set(frame_assignment(num_frames, process_index, process_count))
    paths = []
    cam0 = renderer.camera
    world0 = renderer.world
    for f in range(num_frames):
        cam_f = (camera_animation.step(cam0, frame=f) if camera_animation
                 else cam0)
        world_f = (envmap_animation.step(world0, frame=f)
                   if envmap_animation else world0)
        if f not in mine:
            continue
        renderer.camera = cam_f
        renderer.world = world_f
        renderer.reset()
        renderer.max_sample_count = samples_per_frame_image
        renderer._render_start_time = None
        while not renderer.is_rendering_done():
            renderer.step(block=True)
        path = os.path.join(out_dir, f"frame_{f:04d}.png")
        write_png(path, renderer.ldr_image(), gamma_encode=False)
        paths.append(path)
        if log:
            log.info(f"[anim:p{process_index or 0}] frame {f} -> {path}")
    return paths
