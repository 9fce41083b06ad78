"""Renderer — host-side orchestration around the render step, mirroring
``hiprt_pt_tpu.render.renderer`` (reference: GPURenderer.h:35-508).

``render_step`` advances the state by ``n_samples`` samples, each a camera
pass, the ReSTIR DI pipeline for the camera vertex (under RESTIR_DI, with
reservoirs in the state), path tracing, accumulation and the
adaptive-sampling counters. ``Renderer`` owns the scene, BVH, camera and
settings, like the reference's GPURenderer and the headless parts of its
RenderWindow: it steps frames of ``samples_per_frame`` samples, renders to
a sample count under the stop conditions, polls the last frame, times the
passes, reports the kernels it routes to, and reads the images out. Work is
queued on the current CUDA stream (or runs on the CPU); ``step`` does not
synchronize unless asked to. The sample count is the state's host integer,
so the stop conditions read no device value but the converged-pixel count.

``render_step(..., shard=...)`` advances the state of a range of the
image's pixels (ops/pixel_order.py:PixelRange; parallel/mesh.py's pixel
shards): each pixel keyed by its index in the whole image, the counters
and the skips the image's, ReSTIR's neighbour rows gathered from every
range, so that the ranges' states put together are one device's.
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
from ..ops.pixel_order import PixelRange, unscramble
from ..ops.texture import apply_textures
from ..ops.tonemap import luminance, resolve_accumulation, tonemap_gamma
from ..restir import di
from ..utils import spans
from ..utils.perf import PerformanceMetrics
from .integrator import camera_rays_pass, render_sample


def run_stage(name: str, fn, *args, **kw):
    """The default ``stage`` of ``restir_reuse``: call ``fn`` inside the
    span ``restir/<name>``."""
    with spans.span("restir/" + name):
        return fn(*args, **kw)


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
                bvh: BVHData, state: RenderState, camera,
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
    ``nb_pixels_converged`` are the image's. The call is one step of
    utils/spans.py, each sample in the span ``step``."""
    if shard is not None and state.num_pixels != shard.size:
        raise ValueError(f"the state holds {state.num_pixels} pixels; the "
                         f"shard [{shard.start}, {shard.stop}) holds "
                         f"{shard.size}")
    with spans.step(state.accum.device):
        for _ in range(n_samples):
            with spans.span("step"):
                state = _sample_step(options, width, height, scene, bvh, state,
                                     camera, settings, world, stage, shard)
    return state


def _sample_step(options: RenderOptions, width: int, height: int, scene,
                 bvh: BVHData, state: RenderState, camera,
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

    with spans.span("accumulate"):
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
            converged = ((pix_count >= settings.adaptive_sampling_min_samples)
                         & (ci < thresh))
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


class Renderer:
    """Host-side renderer: owns scene, BVH, camera and settings; the
    device is the scene's. A frame of ``samples_per_frame`` samples is
    always one ``render_step`` call, which loops the samples (the port has
    no compiled step to fuse), so ``fuse_frame``, which selects that call
    in the JAX package, is kept for its callers and has no effect. Stop
    conditions of ``render`` and
    ``is_rendering_done``: ``max_sample_count``, ``max_render_time``
    (seconds since the first step after a reset) and, under a positive
    ``settings.stop_noise_threshold``, the share
    ``settings.stop_pixel_percentage_converged`` of converged pixels."""

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
        self.metrics = PerformanceMetrics()
        self.fuse_frame = False  # no effect: see the class docstring
        self.max_sample_count: Optional[int] = None
        self.max_render_time: Optional[float] = None
        self._render_start_time: Optional[float] = None
        # the CUDA event recorded after the last queued frame
        self._frame_event = None
        self.state = self._fresh_state()

    def _fresh_state(self) -> RenderState:
        return init_render_state(
            self.width, self.height, self.seed, self.device,
            with_restir=self.options.direct_light_sampling
            == LightSamplingStrategy.RESTIR_DI)

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step_args(self):
        return (self.options, self.width, self.height, self.scene, self.bvh)

    def recompile(self, options: RenderOptions):
        """Swap the static options (reference: GPURenderer::
        recompile_kernels, GPURenderer.cpp:726-749) and restart the render,
        whose samples came from the old options: the sample count starts
        from 0 again (the JAX package's recompile keeps its host mirror of
        the count, so its stop conditions count the old samples)."""
        self.options = options
        self.reset()

    def step(self, block: bool = False) -> RenderState:
        """Queue one frame of ``samples_per_frame`` samples. With ``block``,
        wait for it and add its ``frame_ms`` and ``samples_per_s`` (host
        clock) to ``metrics``."""
        if self._render_start_time is None:
            self._render_start_time = time.perf_counter()
        t0 = time.perf_counter()
        spf = max(int(self.settings.samples_per_frame), 1)
        self.state = render_step(*self._step_args(), self.state, self.camera,
                                 self.settings, self.world, n_samples=spf)
        if self.device.type == "cuda":
            self._frame_event = torch.cuda.Event()
            self._frame_event.record(torch.cuda.current_stream(self.device))
        if block:
            self._synchronize()
            dt = time.perf_counter() - t0
            self.metrics.add("frame_ms", dt * 1000.0)
            self.metrics.add("samples_per_s", spf / dt if dt > 0 else 0.0)
        return self.state

    def frame_render_done(self) -> bool:
        """Has the last queued frame finished? A non-blocking query of the
        event recorded after it (reference: oroStreamQuery,
        GPURenderer.cpp:497-510); before any frame, of an event recorded
        now. Always True on the CPU, where a step returns when done."""
        if self.device.type != "cuda":
            return True
        if self._frame_event is None:
            self._frame_event = torch.cuda.Event()
            self._frame_event.record(torch.cuda.current_stream(self.device))
        return self._frame_event.query()

    def render(self, total_samples: int, log_every: int = 0) -> RenderState:
        """Step frames until ``total_samples`` samples or a stop condition
        (reference: the headless render loop)."""
        while self.state.sample_count < total_samples:
            self.step(block=True)
            sc = self.state.sample_count
            if log_every and sc % log_every == 0:
                print(f"[render] {sc}/{total_samples} samples")
            if self.is_rendering_done():
                break
        self._synchronize()
        return self.state

    def is_rendering_done(self) -> bool:
        """Stop conditions (reference: RenderWindow.cpp:582-616): the
        sample count, the render time, the share of converged pixels."""
        if (self.max_sample_count is not None
                and self.state.sample_count >= self.max_sample_count):
            return True
        if (self.max_render_time is not None
                and self._render_start_time is not None
                and time.perf_counter() - self._render_start_time
                >= self.max_render_time):
            return True
        if self.settings.stop_noise_threshold > 0.0:
            frac = int(self.state.nb_pixels_converged) / (self.width * self.height)
            if frac >= self.settings.stop_pixel_percentage_converged:
                return True
        return False

    def profile(self, frames: int = 2) -> dict:
        """Per-pass times in ms (reference: per-kernel event timing,
        GPUKernel.cpp:180-189), from the spans (utils/spans.py) of
        ``frames`` one-sample steps after a warm-up step, on a private copy
        of the state, averaged: stream ms on the card, the host's clock on
        the CPU. The whole step (``step``), the camera pass (``camera``),
        the bounces (``bounce``) and what is neither (the step less its
        bounces, less the camera pass: ReSTIR, accumulation). The
        renderer's state is left as it was. The *_ms results are also added
        to ``metrics``."""
        settings = self.settings.replace(samples_per_frame=1)
        st = self.state
        was = spans.enabled()
        spans.enable(True)
        try:
            st = render_step(*self._step_args(), st, self.camera, settings,
                             self.world)
            ids = []
            for _ in range(frames):
                with spans.step(self.device) as sid:
                    st = render_step(*self._step_args(), st, self.camera,
                                     settings, self.world)
                ids.append(sid)
            spans.flush()
        finally:
            spans.enable(was)
        ms: dict = {}
        for r in spans.records():
            if r.step in ids:
                ms[r.name] = ms.get(r.name, 0.0) + (r.stream_ms or 0.0) / frames
        nb = int(self.settings.nb_bounces)
        full_ms, cam_ms = ms.get("step", 0.0), ms.get("camera", 0.0)
        loop_ms = ms.get("bounce", 0.0)
        base_ms = full_ms - loop_ms
        result = {
            "camera_pass_ms": cam_ms,
            "camera_plus_overhead_ms": base_ms,
            "direct_and_accum_ms": max(base_ms - cam_ms, 0.0),
            "per_bounce_ms": loop_ms / max(nb, 1),
            "bounce_loop_ms": loop_ms,
            "full_frame_ms": full_ms,
            "nb_bounces": nb,
        }
        for k, v in result.items():
            if k.endswith("_ms"):
                self.metrics.add(k, float(v))
        return result

    def kernel_stats(self) -> dict:
        """The kernels the live options route to, the analog of the
        reference's "Shader kernels" panel (GPUKernelCompiler.cpp:111-117):
        for each, in closest-hit and any-hit mode, its registers per
        thread, local bytes per thread, shared bytes per block and resident
        blocks per SM (from its library's *_info function, which must
        succeed); the kernels' launch counts and the device's peak memory.
        On the CPU, or with ``use_pallas_traversal`` off, the plain walks
        run and no kernel is reported."""
        out = {"options": str(self.options)}
        if self.device.type != "cuda" or not self.options.use_pallas_traversal:
            return {"kernel": "plain walks", **out}
        from ..ops import cuda_build, cuda_traverse

        kernels = cuda_traverse.routed_kernel_info(self.bvh)
        return {"kernel": "render_step", **out, "kernels": kernels,
                "launch_counts": dict(cuda_build.launch_counts),
                "peak_device_memory_bytes":
                    torch.cuda.max_memory_allocated(self.device)}

    @property
    def rays_traced(self) -> int:
        """Camera + bounce + shadow rays traced so far (syncs the device)."""
        return int(self.state.rays_traced)

    def _image(self, x: torch.Tensor) -> np.ndarray:
        """(H, W, C) of a per-pixel buffer, row 0 = top."""
        return unscramble(x.cpu().numpy(), self.width, self.height)[::-1]

    def hdr_image(self) -> np.ndarray:
        """(H, W, 3) mean radiance, row 0 = top."""
        return self._image(resolve_accumulation(self.state.accum,
                                                self.state.sample_count))

    def ldr_image(self, exposure: float = 1.0, gamma: float = 2.2) -> np.ndarray:
        """(H, W, 3) display image in [0, 1], row 0 = top."""
        hdr = resolve_accumulation(self.state.accum, self.state.sample_count)
        return self._image(tonemap_gamma(hdr, exposure, gamma))

    def aov_images(self):
        """(albedo, normal), each (H, W, 3), the denoiser's AOVs averaged
        over each pixel's samples, row 0 = top."""
        n = self.state.pixel_sample_count.to(torch.float32).clamp_min(1.0)[:, None]
        return (self._image(self.state.denoiser_albedo / n),
                self._image(self.state.denoiser_normal / n))

    def reset(self):
        """Restart accumulation from the fixed seed (reference:
        GPURenderer::reset, GPURenderer.cpp:953-973)."""
        self.state = self._fresh_state()
        self._render_start_time = None

    def set_camera(self, camera):
        self.camera = camera
        self.reset()
