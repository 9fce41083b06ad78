"""Renderer — host-side orchestration around the render step, mirroring
``hiprt_pt_tpu.render.renderer`` (reference: GPURenderer.h:35-508).

``render_step`` advances the state by one sample: camera pass, the ReSTIR
DI pipeline for the camera vertex (under RESTIR_DI, with reservoirs in the
state), path tracing, accumulation and the adaptive-sampling counters.
``Renderer`` owns the scene, BVH, camera and settings and steps frames of
``samples_per_frame`` samples. Work is queued on the current CUDA stream
(or runs on the CPU); ``step`` does not synchronize.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..accel.build import BVHData, build_bvh
from ..core import rng as rng_mod
from ..core.settings import (LightSamplingStrategy, RenderOptions,
                             RenderSettings, WorldSettings)
from ..core.state import RenderState, init_render_state
from ..ops.pixel_order import unscramble
from ..ops.texture import apply_textures
from ..ops.tonemap import luminance, resolve_accumulation
from ..restir import di
from .integrator import camera_rays_pass, check_supported, render_sample


def run_stage(_name: str, fn, *args, **kw):
    """The default ``stage`` of ``restir_reuse``: call ``fn``."""
    return fn(*args, **kw)


def restir_reuse(options: RenderOptions, width: int, height: int, scene, bvh,
                 state: RenderState, settings: RenderSettings,
                 world: WorldSettings, gbuf, active, sample_number: int,
                 rng_state, stage=run_stage):
    """The ReSTIR DI pipeline for the camera vertex (reference:
    ReSTIRDIRenderPass::launch): presampled lights, initial candidates,
    visibility reuse, temporal reuse and the spatial passes (or the fused
    pass), final shading. Each pass runs as ``stage(name, fn, *args,
    **kw)``, so that a caller can time a pass or keep its inputs.
    Returns (the new reservoirs, the camera vertex's direct light (N,3),
    final shading's unblocked visibility rays (() int64), rng_state)."""
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
    tile_id = torch.arange(width * height, dtype=torch.int32,
                           device=gbuf.position.device) // 128
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
            state.prev_view_proj, rng_state)
    else:
        res, rng_state = stage(
            "temporal reuse", di.temporal_reuse, options, settings, scene,
            mats0, gbuf, state.prev_gbuffer, state.restir, res, eta0, active0,
            width, height, state.prev_view_proj, rng_state)
        rs = settings.restir_di
        n_spatial = int(rs.num_spatial_passes) if rs.spatial_enabled else 0
        for i in range(n_spatial):
            res, rng_state = stage(
                f"spatial pass {i + 1}", di.spatial_reuse_pass, options,
                settings, scene, mats0, gbuf, res, eta0, active0, width,
                height, rng_state, bvh=bvh, is_last_pass=i == n_spatial - 1)
    direct, n_rays, rng_state = stage(
        "final shading", di.final_shading, options, scene, bvh, world, mats0,
        gbuf, res, eta0, active0, rng_state=rng_state, settings=settings)
    return res, direct, n_rays, rng_state


def render_step(options: RenderOptions, width: int, height: int, scene,
                bvh: BVHData, state: RenderState, camera,
                settings: RenderSettings, world: WorldSettings,
                stage=run_stage) -> RenderState:
    """Advance the render state by one sample; returns the new state.
    ``stage``: how each pass of the ReSTIR pipeline runs (restir_reuse)."""
    check_supported(options, scene)
    sample_number = 0 if settings.freeze_random else state.sample_count
    n = width * height
    dev = state.accum.device
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    rng_state = rng_mod.seed(pix, sample_number, state.seed)

    rng_state, gbuf, active = camera_rays_pass(
        scene, bvh, camera, settings, state, width, height, sample_number,
        rng_state, options)
    # without reservoirs in the state every vertex runs RIS, as in the JAX
    # package
    direct0, restir, restir_rays = None, state.restir, 0
    if (options.direct_light_sampling == LightSamplingStrategy.RESTIR_DI
            and state.restir is not None):
        restir, direct0, restir_rays, rng_state = restir_reuse(
            options, width, height, scene, bvh, state, settings, world, gbuf,
            active, sample_number, rng_state, stage)
    rng_state, radiance, aov_albedo, aov_normal, path_rays = render_sample(
        options, scene, bvh, world, settings, gbuf, active, rng_state,
        direct0=direct0)
    total_rays = state.rays_traced + path_rays + restir_rays + active.sum()

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
        nb_pixels_converged=converged.sum(),
        denoiser_albedo=state.denoiser_albedo + torch.where(act3, aov_albedo, 0.0),
        denoiser_normal=state.denoiser_normal + torch.where(act3, aov_normal, 0.0),
        prev_gbuffer=state.gbuffer,
        gbuffer=gbuf,
        rays_traced=total_rays,
        prev_view_proj=camera.proj @ camera.view,
        restir=restir,
    )


class Renderer:
    """Host-side renderer: owns scene, BVH, camera and settings; device is
    the scene's."""

    def __init__(self, scene, camera, width: int, height: int,
                 options: RenderOptions = RenderOptions(),
                 settings: Optional[RenderSettings] = None,
                 world: Optional[WorldSettings] = None,
                 bvh: Optional[BVHData] = None, seed: int = 42):
        self.scene = scene
        self.camera = camera
        self.width = width
        self.height = height
        self.options = options
        self.settings = settings or RenderSettings()
        self.world = world or WorldSettings()
        self.device = scene.vertices.device
        self.bvh_build_time = 0.0
        if bvh is None:
            t0 = time.perf_counter()
            bvh = build_bvh(scene.vertices.cpu().numpy(),
                            scene.triangles.cpu().numpy(), self.device)
            self.bvh_build_time = time.perf_counter() - t0
        self.bvh = bvh
        self.seed = seed
        self.state = init_render_state(
            width, height, seed, self.device,
            with_restir=options.direct_light_sampling
            == LightSamplingStrategy.RESTIR_DI)

    def step(self) -> RenderState:
        """Queue one frame of ``samples_per_frame`` samples."""
        for _ in range(max(int(self.settings.samples_per_frame), 1)):
            self.state = render_step(
                self.options, self.width, self.height, self.scene, self.bvh,
                self.state, self.camera, self.settings, self.world)
        return self.state

    @property
    def rays_traced(self) -> int:
        """Camera + bounce + shadow rays traced so far (syncs the device)."""
        return int(self.state.rays_traced)

    def hdr_image(self) -> np.ndarray:
        """(H, W, 3) mean radiance, row 0 = top."""
        img = resolve_accumulation(self.state.accum, self.state.sample_count)
        return unscramble(img.cpu().numpy(), self.width, self.height)[::-1]
