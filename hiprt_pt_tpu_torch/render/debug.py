"""Debug tools — single-pixel debugging and invariant views, mirroring
``hiprt_pt_tpu.render.debug`` (reference: DEBUG_PIXEL /
DEBUG_RENDER_NEIGHBORHOOD in src/Renderer/CPURenderer.cpp:24-66, 317-390,
and the bright-pink NaN view of FullPathTracer.h:29-97).

``debug_pixel`` runs the real integrator on a tiny wavefront that holds
just the pixel (and optionally its neighborhood). Its first hit goes
through the router (ops/routing.py:tracer), like every trace of the port:
on the card the camera rays' kernel serves it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.camera import generate_camera_rays
from ..core.state import GBuffer
from ..ops.pixel_order import unscramble
from ..ops.routing import tracer
from .integrator import _face_forward, _interpolate_hit, render_sample


def debug_pixel(
    renderer,
    x: int,
    y: int,
    neighborhood: int = 0,
    sample_number: int = 0,
    disable_jit: bool = False,
):
    """Trace the paths of pixel (x, y) (row-major from the top-left, display
    convention) and optionally its (2k+1)^2 neighborhood.

    Returns a dict with the pixel's radiance, first-hit info and the
    neighborhood image. ``disable_jit`` is kept for the JAX package's
    callers and has no effect: the port runs eagerly.
    """
    r = renderer
    w, h = r.width, r.height
    dev = r.device
    # display row y (top) → NDC row (bottom-up)
    py0 = h - 1 - y
    k = neighborhood
    xs = np.clip(np.arange(x - k, x + k + 1), 0, w - 1)
    ys = np.clip(np.arange(py0 - k, py0 + k + 1), 0, h - 1)
    gx, gy = np.meshgrid(xs, ys)
    px = torch.from_numpy(gx.ravel().astype(np.int32)).to(dev)
    py = torch.from_numpy(gy.ravel().astype(np.int32)).to(dev)
    n = px.shape[0]

    pix_id = py.to(torch.int64) * w + px
    rng_state = rng_mod.seed(pix_id, sample_number, r.state.seed)
    rng_state, jx = rng_mod.next_float(rng_state)
    rng_state, jy = rng_mod.next_float(rng_state)
    o, d = generate_camera_rays(r.camera, w, h, torch.stack([jx, jy], dim=-1),
                                px, py)
    rec = tracer(r.bvh, True, r.options.use_pallas_traversal)(
        r.bvh, o, d, t_min=0.0)
    hit = rec.prim >= 0
    ns, ng, uv, mat_id, _tan = _interpolate_hit(r.scene, rec.prim, rec.u,
                                                rec.v, d)
    pos = o + d * torch.where(torch.isfinite(rec.t), rec.t, 0.0)[:, None]
    gbuf = GBuffer(
        position=pos,
        shading_normal=torch.where(hit[:, None], _face_forward(ns, d), 0.0),
        geometric_normal=torch.where(hit[:, None], _face_forward(ng, d), 0.0),
        view_direction=-d,
        material_id=torch.where(hit, mat_id, -1),
        prim_index=rec.prim,
        uv=uv,
        t=rec.t,
        ray_dir=d,
        backface=(ns * d).sum(dim=-1) > 0.0,
    )
    _rng, radiance, _albedo, _normal, _rays = render_sample(
        r.options, r.scene, r.bvh, r.world, r.settings, gbuf,
        torch.ones((n,), dtype=torch.bool, device=dev), rng_state)

    c = n // 2
    side = 2 * k + 1
    rad = radiance.cpu().numpy()
    return {
        "radiance": rad[c],
        "prim": int(rec.prim[c]),
        "t": float(rec.t[c]),
        "material_id": int(gbuf.material_id[c]),
        "position": pos[c].cpu().numpy(),
        "normal": gbuf.shading_normal[c].cpu().numpy(),
        "uv": uv[c].cpu().numpy(),
        "neighborhood": rad.reshape(side, side, 3),
    }


def nan_view(renderer, mark_color=(1.0, 0.0, 1.0)) -> np.ndarray:
    """Display image with non-finite / negative accumulation marked bright
    pink (reference: display_NaNs + NaN sanity visualization)."""
    accum = renderer.state.accum.cpu().numpy()
    bad = ~np.isfinite(accum).all(axis=-1) | (accum < 0).any(axis=-1)
    img = renderer.ldr_image().copy()
    img[unscramble(bad, renderer.width, renderer.height)[::-1]] = mark_color
    return img
