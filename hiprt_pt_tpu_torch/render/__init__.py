from .integrator import render_sample, camera_rays_pass
from .renderer import Renderer, render_step
from .denoise import atrous_denoise, denoise, suppress_fireflies
from .checkpoint import load_checkpoint, save_checkpoint
from .animation import (
    CameraOrbitAnimation,
    EnvmapRotationAnimation,
    render_frame_sequence,
)

__all__ = [
    "render_sample",
    "camera_rays_pass",
    "Renderer",
    "render_step",
    "atrous_denoise",
    "denoise",
    "suppress_fireflies",
    "load_checkpoint",
    "save_checkpoint",
    "CameraOrbitAnimation",
    "EnvmapRotationAnimation",
    "render_frame_sequence",
]
