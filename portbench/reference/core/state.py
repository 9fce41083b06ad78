"""Render state, mirroring ``hiprt_pt_tpu.core.state``.

Buffers are (N, ...) tensors in the canonical tile-major pixel order
(ops/pixel_order.py). ``render_step`` returns a new state; it does not
update the old one in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .device import resolve_device


@dataclasses.dataclass
class GBuffer:
    """First-hit geometry written by the camera pass."""

    position: torch.Tensor          # (N,3)
    shading_normal: torch.Tensor    # (N,3)
    geometric_normal: torch.Tensor  # (N,3)
    view_direction: torch.Tensor    # (N,3) surface → camera
    material_id: torch.Tensor       # (N,) i32, -1 = miss
    prim_index: torch.Tensor        # (N,) i32, -1 = miss
    uv: torch.Tensor                # (N,2)
    t: torch.Tensor                 # (N,) inf = miss
    ray_dir: torch.Tensor           # (N,3)
    backface: torch.Tensor          # (N,) bool

    @classmethod
    def empty(cls, n: int, device) -> "GBuffer":
        f32 = dict(dtype=torch.float32, device=device)
        return cls(
            position=torch.zeros((n, 3), **f32),
            shading_normal=torch.zeros((n, 3), **f32),
            geometric_normal=torch.zeros((n, 3), **f32),
            view_direction=torch.zeros((n, 3), **f32),
            material_id=torch.full((n,), -1, dtype=torch.int32, device=device),
            prim_index=torch.full((n,), -1, dtype=torch.int32, device=device),
            uv=torch.zeros((n, 2), **f32),
            t=torch.full((n,), float("inf"), **f32),
            ray_dir=torch.zeros((n, 3), **f32),
            backface=torch.zeros((n,), dtype=torch.bool, device=device),
        )


@dataclasses.dataclass
class RenderState:
    """All cross-frame render state. ``sample_count`` and ``seed`` are host
    integers: they key the RNG and are known on the host anyway."""

    accum: torch.Tensor               # (N,3) running radiance sum
    sample_count: int
    accum_sq_luminance: torch.Tensor  # (N,)
    pixel_sample_count: torch.Tensor  # (N,) i32
    pixel_converged: torch.Tensor     # (N,) bool
    nb_pixels_converged: torch.Tensor  # () i64
    denoiser_albedo: torch.Tensor     # (N,3)
    denoiser_normal: torch.Tensor     # (N,3)
    gbuffer: GBuffer
    prev_gbuffer: GBuffer
    # camera + bounce + shadow rays traced so far; an exact integer count
    rays_traced: torch.Tensor         # () i64
    seed: int
    prev_view_proj: torch.Tensor      # (4,4)
    # ReSTIR DI reservoirs (restir/reservoir.py), None unless the ReSTIR
    # strategy runs
    restir: Optional[object] = None

    @property
    def num_pixels(self) -> int:
        return self.accum.shape[0]

    def replace(self, **kw) -> "RenderState":
        return dataclasses.replace(self, **kw)


def init_render_state(width: int, height: int, seed: int = 42,
                      device=None, with_restir: bool = False,
                      pixels: Optional[int] = None) -> RenderState:
    """A fresh render state on ``device`` (default: the GPU, see
    core/device.py:resolve_device); ``with_restir``: with empty ReSTIR
    reservoirs; ``pixels``: the pixels it holds (default width * height; a
    pixel shard of parallel/mesh.py holds a range of them)."""
    device = resolve_device(device)
    n = width * height if pixels is None else pixels
    f32 = dict(dtype=torch.float32, device=device)
    restir = None
    if with_restir:
        from ..restir.reservoir import Reservoir

        restir = Reservoir.empty(n, device)
    return RenderState(
        restir=restir,
        accum=torch.zeros((n, 3), **f32),
        sample_count=0,
        accum_sq_luminance=torch.zeros((n,), **f32),
        pixel_sample_count=torch.zeros((n,), dtype=torch.int32, device=device),
        pixel_converged=torch.zeros((n,), dtype=torch.bool, device=device),
        nb_pixels_converged=torch.zeros((), dtype=torch.int64, device=device),
        denoiser_albedo=torch.zeros((n, 3), **f32),
        denoiser_normal=torch.zeros((n, 3), **f32),
        gbuffer=GBuffer.empty(n, device),
        prev_gbuffer=GBuffer.empty(n, device),
        rays_traced=torch.zeros((), dtype=torch.int64, device=device),
        seed=int(seed),
        prev_view_proj=torch.eye(4, **f32),
    )
