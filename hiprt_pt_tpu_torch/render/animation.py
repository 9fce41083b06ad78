"""Animation — camera orbits, envmap rotation, frame-sequence rendering,
mirroring ``hiprt_pt_tpu.render.animation`` (reference: CameraAnimation's
rotate-around-point, src/Scene/CameraAnimation.h:16-41; RendererEnvmap's
per-frame yaw, src/Renderer/RendererEnvmap.cpp:54-103; the frame-sequence
dump of src/UI/RenderWindow.cpp:843-863).

The matrices are computed in f32 numpy, as the JAX package computes them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.camera import Camera, camera_from_lookat
from ..core.settings import WorldSettings


def _yaw(degrees: float) -> np.ndarray:
    ang = np.deg2rad(degrees)
    c, s = np.cos(ang), np.sin(ang)
    return np.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)


@dataclass
class CameraOrbitAnimation:
    """Rotate the camera around a target point by `degrees_per_frame`."""

    target: tuple = (0.0, 0.0, 0.0)
    degrees_per_frame: float = 1.0
    up: tuple = (0.0, 1.0, 0.0)

    def step(self, camera: Camera, frame: int = 1) -> Camera:
        eye = camera.position.cpu().numpy().astype(np.float32)
        tgt = np.asarray(self.target, np.float32)
        new_eye = tgt + _yaw(self.degrees_per_frame * frame) @ (eye - tgt)
        # recover the aspect from the projection matrix
        proj = camera.proj.cpu().numpy()
        aspect = proj[1, 1] / proj[0, 0]
        return camera_from_lookat(new_eye, tgt, self.up,
                                  np.rad2deg(float(camera.vfov)), float(aspect),
                                  device=camera.view.device)


@dataclass
class EnvmapRotationAnimation:
    """Animate the envmap yaw per frame (reference: RendererEnvmap yaw/pitch/
    roll animation)."""

    yaw_degrees_per_frame: float = 1.0

    def step(self, world: WorldSettings, frame: int = 1) -> WorldSettings:
        base = np.asarray(world.envmap_to_world, np.float32)
        m = _yaw(self.yaw_degrees_per_frame * frame) @ base

        def rows(x):
            return tuple(tuple(float(c) for c in r) for r in x)

        return world.replace(envmap_to_world=rows(m), world_to_envmap=rows(m.T))


def render_frame_sequence(
    renderer,
    num_frames: int,
    samples_per_frame_image: int,
    out_dir: str,
    camera_animation: Optional[CameraOrbitAnimation] = None,
    envmap_animation: Optional[EnvmapRotationAnimation] = None,
    denoise_frames: bool = False,
    log=None,
):
    """Render an animation: each frame accumulates to the target spp, is
    written as frame_%04d.png, then the animations advance and the
    accumulation resets. Returns the PNG paths."""
    from ..assets.image_io import write_png
    from ..ops.tonemap import tonemap_gamma
    from .denoise import denoise

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for f in range(num_frames):
        renderer.max_sample_count = samples_per_frame_image
        renderer._render_start_time = None
        while not renderer.is_rendering_done():
            renderer.step(block=True)
        if denoise_frames:
            img = tonemap_gamma(torch.from_numpy(denoise(renderer))).numpy()
        else:
            img = renderer.ldr_image()
        path = os.path.join(out_dir, f"frame_{f:04d}.png")
        write_png(path, img, gamma_encode=False)
        paths.append(path)
        if log:
            log.info(f"[anim] frame {f + 1}/{num_frames} -> {path}")
        if camera_animation is not None:
            renderer.set_camera(camera_animation.step(renderer.camera))
        if envmap_animation is not None:
            renderer.world = envmap_animation.step(renderer.world)
        renderer.reset()
    return paths
