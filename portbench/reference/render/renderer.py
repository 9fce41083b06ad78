"""The render step of the reference: ``render_step`` advances a render
state by ``n_samples`` samples, each a camera pass, the ReSTIR DI pipeline
for the camera vertex (under RESTIR_DI, with reservoirs in the state), path
tracing, accumulation and the adaptive-sampling counters; every ray goes
through the reference's own walk over its own BVH.
"""

from __future__ import annotations

import torch

from ..core import rng as rng_mod
from ..core.settings import (LightSamplingStrategy, RenderOptions,
                             RenderSettings, WorldSettings)
from ..core.state import RenderState
from ..ops.pixel_order import PixelRange
from ..ops.texture import apply_textures
from ..ops.tonemap import luminance
from ..restir import di
from . import integrator
from .integrator import camera_rays_pass, render_sample


def run_stage(_name: str, fn, *args, **kw):
    """The default ``stage`` of ``restir_reuse``: call ``fn``."""
    return fn(*args, **kw)


def _rounding_stage(stage):
    """``stage``, with the float fields of the reservoirs that each pass
    returns rounded by the control's lower precision (integrator.ROUND)."""
    def rounded(name, fn, *args, **kw):
        out = stage(name, fn, *args, **kw)
        items = out if isinstance(out, tuple) else (out,)
        items = tuple(
            x.replace(**{f: integrator.ROUND(getattr(x, f)) for f in
                         ("weight_sum", "M", "W", "radiance", "target")})
            if isinstance(x, di.Reservoir) else x for x in items)
        return items if isinstance(out, tuple) else items[0]
    return rounded


def restir_reuse(options: RenderOptions, width: int, height: int, scene, bvh,
                 state: RenderState, settings: RenderSettings,
                 world: WorldSettings, gbuf, active, sample_number: int,
                 rng_state, stage=run_stage, shard=None):
    """The ReSTIR DI pipeline for the camera vertex (reference:
    ReSTIRDIRenderPass::launch): presampled lights, initial candidates,
    visibility reuse, temporal reuse and the spatial passes (or the fused
    pass), final shading. Each pass runs as ``stage(name, fn, *args,
    **kw)``, so that a caller can time a pass or keep its inputs.
    ``shard``: the pixel range of ``gbuf`` (default: the whole image).
    Returns (the new reservoirs, the camera vertex's direct light (N,3),
    final shading's unblocked visibility rays (() int64), rng_state)."""
    shard = shard or PixelRange.whole(width, height)
    if integrator.ROUND is not None:
        stage = _rounding_stage(stage)
    active0 = active & (gbuf.prim_index >= 0)
    mats0 = scene.materials.at_indices(gbuf.material_id.clamp_min(0)).make_safe()
    if scene.textures is not None:
        # the candidates' targets and the winner's exact eval see the
        # textured surface
        mats0 = apply_textures(scene.textures, mats0, gbuf.uv)
    ior = mats0.ior.clamp_min(1.0 + 1e-3)
    eta0 = torch.where(~gbuf.backface, ior, 1.0 / ior)
    pool = (stage("light pool", di.presample_lights, scene, sample_number,
                  options)
            if options.restir_do_light_presampling else None)
    tile_id = (shard.index(gbuf.position.device) // 128).to(torch.int32)
    res, rng_state = stage(
        "initial candidates", di.initial_candidates, options, scene, bvh,
        world, settings, mats0, gbuf.position, gbuf.shading_normal,
        gbuf.geometric_normal, gbuf.view_direction, eta0, active0, rng_state,
        pool=pool, tile_id=tile_id)
    if options.restir_di_initial_visibility:
        res = stage("visibility reuse", di.visibility_reuse, options, bvh,
                    gbuf.position, gbuf.geometric_normal, res, active0)
    if options.restir_di_fused_spatiotemporal:
        res, rng_state = stage(
            "fused spatiotemporal reuse", di.fused_spatiotemporal_reuse,
            options, settings, scene, mats0, gbuf, state.prev_gbuffer,
            state.restir, res, eta0, active0, width, height,
            state.prev_view_proj, rng_state, shard=shard)
    else:
        res, rng_state = stage(
            "temporal reuse", di.temporal_reuse, options, settings, scene,
            mats0, gbuf, state.prev_gbuffer, state.restir, res, eta0, active0,
            width, height, state.prev_view_proj, rng_state, shard=shard)
        rs = settings.restir_di
        n_spatial = int(rs.num_spatial_passes) if rs.spatial_enabled else 0
        for i in range(n_spatial):
            res, rng_state = stage(
                f"spatial pass {i + 1}", di.spatial_reuse_pass, options,
                settings, scene, mats0, gbuf, res, eta0, active0, width,
                height, rng_state, bvh=bvh, is_last_pass=i == n_spatial - 1,
                shard=shard)
    direct, n_rays, rng_state = stage(
        "final shading", di.final_shading, options, scene, bvh, world, mats0,
        gbuf, res, eta0, active0, rng_state=rng_state, settings=settings,
        shard=shard)
    return res, direct, n_rays, rng_state


def render_step(options: RenderOptions, width: int, height: int, scene,
                bvh, state: RenderState, camera,
                settings: RenderSettings, world: WorldSettings,
                stage=run_stage, n_samples: int = 1,
                shard=None) -> RenderState:
    """Advance the render state by ``n_samples`` samples; returns the new
    state (the input is left as it was). Each sample is keyed by the
    state's ``sample_count``, which advances sample by sample, so one call
    of n samples is the same as n calls of one. ``stage``: how each pass of
    the ReSTIR pipeline runs (restir_reuse). ``shard``: the pixel range
    that ``state`` holds (ops/pixel_order.py:PixelRange, whole tiles of a
    tileable image; default: the whole image); its ``rays_traced`` and
    ``nb_pixels_converged`` are the image's."""
    if shard is not None and state.num_pixels != shard.size:
        raise ValueError(f"the state holds {state.num_pixels} pixels; the "
                         f"shard [{shard.start}, {shard.stop}) holds "
                         f"{shard.size}")
    for _ in range(n_samples):
        state = _sample_step(options, width, height, scene, bvh, state,
                             camera, settings, world, stage, shard)
    return state


def _sample_step(options: RenderOptions, width: int, height: int, scene,
                 bvh, state: RenderState, camera,
                 settings: RenderSettings, world: WorldSettings,
                 stage, shard) -> RenderState:
    """One sample of ``render_step``."""
    sample_number = 0 if settings.freeze_random else state.sample_count
    pixels = shard or PixelRange.whole(width, height)
    dev = state.accum.device
    # each pixel's stream is keyed by its index in the whole image
    rng_state = rng_mod.seed(pixels.index(dev), sample_number, state.seed)

    rng_state, gbuf, active = camera_rays_pass(
        scene, bvh, camera, settings, state, width, height, sample_number,
        rng_state, options, shard=pixels)
    # without reservoirs in the state every vertex runs RIS, as in the JAX
    # package
    direct0, restir, restir_rays = None, state.restir, 0
    if (options.direct_light_sampling == LightSamplingStrategy.RESTIR_DI
            and state.restir is not None):
        restir, direct0, restir_rays, rng_state = restir_reuse(
            options, width, height, scene, bvh, state, settings, world, gbuf,
            active, sample_number, rng_state, stage, shard=pixels)
    rng_state, radiance, aov_albedo, aov_normal, path_rays = render_sample(
        options, scene, bvh, world, settings, gbuf, active, rng_state,
        direct0=direct0, shard=pixels)
    # the state's count is the image's already: add the image's increment
    total_rays = state.rays_traced + pixels.sum(
        path_rays + restir_rays + active.sum())

    # --- accumulation (reference: FullPathTracer.h:296-326) ---
    act3 = active[..., None]
    if settings.accumulate:
        accum = state.accum + torch.where(act3, radiance, 0.0)
    else:
        accum = torch.where(act3, radiance, state.accum)
    lum = luminance(radiance)
    if settings.accumulate:
        accum_sq = torch.where(active, state.accum_sq_luminance + lum * lum,
                               state.accum_sq_luminance)
    else:
        accum_sq = state.accum_sq_luminance
    pix_count = state.pixel_sample_count + active.to(torch.int32)

    # --- adaptive-sampling convergence (reference: AdaptiveSampling.h,
    # 95% confidence interval) ---
    if settings.enable_adaptive_sampling or settings.stop_noise_threshold > 0.0:
        nf = pix_count.to(torch.float32).clamp_min(1.0)
        lum_acc = luminance(accum)
        mean_lum = lum_acc / nf
        var = ((accum_sq - (lum_acc ** 2) / nf) / (nf - 1.0).clamp_min(1.0)
               ).clamp_min(0.0)
        ci = 1.96 * torch.sqrt(var / nf)
        thresh = (settings.adaptive_sampling_noise_threshold * mean_lum
                  ).clamp_min(1e-6)
        converged = (pix_count >= settings.adaptive_sampling_min_samples) & (ci < thresh)
    else:
        converged = torch.zeros_like(state.pixel_converged)

    return state.replace(
        accum=accum,
        sample_count=state.sample_count + 1,
        accum_sq_luminance=accum_sq,
        pixel_sample_count=pix_count,
        pixel_converged=converged,
        nb_pixels_converged=pixels.sum(converged.sum()),
        denoiser_albedo=state.denoiser_albedo + torch.where(act3, aov_albedo, 0.0),
        denoiser_normal=state.denoiser_normal + torch.where(act3, aov_normal, 0.0),
        prev_gbuffer=state.gbuffer,
        gbuffer=gbuf,
        rays_traced=total_rays,
        prev_view_proj=camera.proj @ camera.view,
        restir=restir,
    )
