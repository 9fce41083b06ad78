"""Environment lighting: the equirectangular envmap's radiance, its
importance sampling (the CDF's binary search or the alias table) and the
solid-angle pdf of a direction, mirroring
``hiprt_pt_tpu.lights.envmap_sampling`` (reference: Envmap.h:1-248). The
tables are built on the host by assets/envmap.py.

The world↔envmap rotations are applied elementwise, so no matrix product
(and no TF32 on the card) enters a direction.
"""

from __future__ import annotations

import math

import torch

from ..core import rng as rng_mod
from ..core.settings import (AmbientLightType, EnvmapSamplingStrategy,
                             RenderOptions, WorldSettings)
from ..ops.sampling import equirect_uv_to_sphere, sphere_to_equirect_uv


def envmap_sampled(options: RenderOptions, scene) -> bool:
    """Is the scene's envmap importance-sampled (envmap NEE, its MIS weight,
    ReSTIR's envmap candidates)?"""
    return (scene.envmap is not None
            and options.envmap_sampling != EnvmapSamplingStrategy.NO_SAMPLING)


def _rotate(rows, d: torch.Tensor) -> torch.Tensor:
    """d (N,3) @ M.T for the 3x3 row tuples ``rows``, as three products."""
    m = torch.tensor(rows, dtype=torch.float32, device=d.device)
    return d[:, 0:1] * m[:, 0] + d[:, 1:2] * m[:, 1] + d[:, 2:3] * m[:, 2]


def eval_envmap(world: WorldSettings, envmap, d: torch.Tensor) -> torch.Tensor:
    """Radiance arriving from direction d (N,3) → (N,3), under the three
    ambient modes (reference: WorldSettings.h ambient type): the envmap
    fetched bilinearly (wrapping in u, clamped in v) in envmap space,
    times its intensity; the uniform color; or black. ENVMAP without an
    envmap is black."""
    n = d.shape[0]
    if world.ambient_light_type == int(AmbientLightType.UNIFORM):
        color = torch.as_tensor(world.uniform_light_color, dtype=torch.float32,
                                device=d.device)
        return color.expand(n, 3)
    if (world.ambient_light_type != int(AmbientLightType.ENVMAP)
            or envmap is None):
        return torch.zeros((n, 3), dtype=torch.float32, device=d.device)
    u, v = sphere_to_equirect_uv(_rotate(world.world_to_envmap, d))
    h, w = envmap.texels.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = y0.to(torch.int64).clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    tex = envmap.texels
    t00, t10 = tex[y0i, x0i], tex[y0i, x1i]
    t01, t11 = tex[y1i, x0i], tex[y1i, x1i]
    out = (t00 * (1 - fx) * (1 - fy) + t10 * fx * (1 - fy)
           + t01 * (1 - fx) * fy + t11 * fx * fy)
    return out * world.envmap_intensity


def texel_pdf_to_solid_angle(envmap, texel_pdf, v):
    """Discrete texel pdf → solid-angle pdf; a texel's solid angle is
    (2π/w)(π/h)sin(θ) (reference: Envmap.h pdf conversion)."""
    h, w = envmap.texels.shape[:2]
    sin_t = torch.sin(v * math.pi).clamp_min(1e-8)
    return texel_pdf / ((2.0 * math.pi / w) * (math.pi / h) * sin_t)


def texel_importance_pdf(envmap, texel):
    """The probability of drawing a texel, from the CDF."""
    prev = torch.where(texel > 0, envmap.cdf[(texel - 1).clamp_min(0)], 0.0)
    return envmap.cdf[texel] - prev


def sample_envmap(options: RenderOptions, world: WorldSettings, envmap,
                  rng_state):
    """One envmap direction per ray, in the JAX package's draw order: the
    texel draw, the jitter pair, then (ALIAS_TABLE) the alias draw.
    Returns (rng_state, wi (N,3) in world space, radiance (N,3), pdf (N,)
    in solid angle)."""
    h, w = envmap.texels.shape[:2]
    n_texels = h * w
    rng_state, u_sel = rng_mod.next_float(rng_state)
    rng_state, u_jit1, u_jit2 = rng_mod.next_float2(rng_state)
    if options.envmap_sampling == EnvmapSamplingStrategy.ALIAS_TABLE:
        rng_state, u_alias = rng_mod.next_float(rng_state)
        idx = (u_sel * n_texels).to(torch.int64).clamp(0, n_texels - 1)
        take_alias = u_alias >= envmap.alias_probas[idx]
        texel = torch.where(take_alias, envmap.alias_indices[idx].long(), idx)
    else:  # CDF_BINARY
        texel = torch.searchsorted(envmap.cdf, u_sel, right=False).clamp(
            0, n_texels - 1)
    ty = torch.div(texel, w, rounding_mode="floor")
    tx = texel - ty * w
    u = (tx.to(torch.float32) + u_jit1) / w
    v = (ty.to(torch.float32) + u_jit2) / h
    wi = _rotate(world.envmap_to_world, equirect_uv_to_sphere(u, v))
    pdf = texel_pdf_to_solid_angle(envmap, texel_importance_pdf(envmap, texel), v)
    radiance = envmap.texels[ty, tx] * world.envmap_intensity
    return rng_state, wi, radiance, pdf.clamp_min(0.0)


def envmap_pdf_of_direction(world: WorldSettings, envmap, d: torch.Tensor):
    """The solid-angle pdf that ``sample_envmap`` gives direction d (N,3),
    for the MIS of BSDF samples that escape to the envmap (reference:
    Envmap.h:77-218)."""
    h, w = envmap.texels.shape[:2]
    u, v = sphere_to_equirect_uv(_rotate(world.world_to_envmap, d))
    tx = (u * w).to(torch.int64).clamp(0, w - 1)
    ty = (v * h).to(torch.int64).clamp(0, h - 1)
    texel_pdf = texel_importance_pdf(envmap, ty * w + tx)
    return texel_pdf_to_solid_angle(envmap, texel_pdf, v)
