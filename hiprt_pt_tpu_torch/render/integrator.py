"""Wavefront path-tracing integrator, mirroring
``hiprt_pt_tpu.render.integrator``.

- ``camera_rays_pass`` ≡ the reference's CameraRays kernel: jittered primary
  rays, first-hit trace, G-buffer write.
- ``render_sample`` ≡ the FullPathTracer megakernel: NEE with MIS per vertex,
  envmap NEE, BSDF sampling, the nested-dielectric interior stack (by
  priorities, or AUTOMATIC by parity), russian roulette, miss → ambient or
  the envmap under MIS, NaN guard; white-furnace mode; per-bounce alive
  counts on request.

The whole image is one wavefront of N rays in the tile-major pixel order.
Traversal routes in the JAX package's order (``_make_tracers``) through
``ops/routing.py``: camera rays and the first bounce's shadow rays are
coherent, every other ray incoherent, and the scene's tables pick the kernel
(trace_meganode for a kept meganode table; trace_coherent / trace_incoherent
over the BVH4; trace_stream8 / trace_lane8log over the BVH8 past the BVH4
and lane8s gates, and past every gate). On CPU tensors each runs its plain
PyTorch walk, and with ``RenderOptions.use_pallas_traversal`` off every ray
takes the routed kernel's plain walk on any device (no kernel launches).

Direct light is MIS NEE or RIS (lights/ris.py); under ReSTIR DI the camera
vertex's direct light comes from the reservoir pipeline (restir/di.py, given
to ``render_sample`` as ``direct0``) and every later vertex runs RIS. With
an envmap and envmap sampling on, every vertex also draws one envmap
direction (lights/envmap_sampling.py) and traces its any-hit shadow ray to
t_max = inf on the incoherent route, under every light strategy.
Textures modulate the materials at every vertex and normal maps the shading
normals. In a scene with alpha textures the emissive shadow rays of the NEE
and RIS take the alpha-aware march (ops/traverse.py:occluded_alpha) on the
same route. The RNG draws happen in the JAX package's order: the camera
pass draws jx, jy; each bounce draws u_lam (with ``do_dispersion``),
u_alpha, then the NEE or RIS draws (the march's draws after the light's and
the BSDF eval), the envmap sample's draws, then the BSDF sample's draws
(the override's pair, or the principled BSDF's u_sel, u1, u2, u3), then
u_rr. The host syncs once per bounce, on whether any path is alive (a
bounce with none is skipped; while spans record, on the count of live
paths), and in the march once per segment.

The frame's work is recorded as spans (utils/spans.py): ``camera``, and
for each bounce that runs ``bounce`` with ``bounce/material`` (material
fetch, textures, dispersion, the interior stack and the relative IOR),
``bounce/direct`` (NEE or RIS with its shadow rays), ``bounce/bsdf`` (the
BSDF sample, the stack update, Russian roulette), ``bounce/trace`` (the
bounce ray's traversal) and ``bounce/hit`` (hit interpolation, emission
and envmap MIS, the next vertex); the counters ``live`` (the image's
paths alive at a bounce's start) and ``lanes`` (the image's pixels) of
each bounce.

A render step may hold only a range of the image's pixels (``shard``, an
ops/pixel_order.py:PixelRange of whole tiles: parallel/mesh.py's pixel
shards): its camera rays are the range's pixels', and the bounce skip and
the march's segment skip are the image's decisions, so that every range
draws what one device draws and stays in step with the others.
"""

from __future__ import annotations

import torch

from ..core import rng as rng_mod
from ..core.camera import generate_camera_rays
from ..core.settings import (
    AmbientLightType,
    InteriorStackStrategy,
    LightSamplingStrategy,
    RenderOptions,
    RenderSettings,
    RussianRouletteMethod,
    WorldSettings,
)
from ..core.state import GBuffer
from ..lights.envmap_sampling import (envmap_pdf_of_direction,
                                      envmap_sampled, eval_envmap,
                                      sample_envmap)
from ..lights.light_sampling import (
    emissive_pdf_of_direction,
    sample_emissive_triangle,
)
from ..lights.ris import ris_direct_lighting
from ..models import nested_dielectrics as nd
from ..models.dispatcher import bsdf_eval, bsdf_sample
from ..models.dispersion import (ior_at_wavelength, sample_wavelength,
                                 wavelength_rgb_weight)
from ..ops.intersect import offset_ray_origin
from ..ops.pixel_order import PixelRange
from ..ops.routing import tracer as _tracer
from ..ops.sampling import balance_heuristic
from ..ops.texture import apply_normal_map, apply_textures
from ..ops.tonemap import luminance
from ..ops.traverse import shadow_blocked
from ..utils import spans


def _nee_enabled(options: RenderOptions) -> bool:
    return options.direct_light_sampling in (LightSamplingStrategy.UNIFORM_ONE,
                                             LightSamplingStrategy.MIS,
                                             LightSamplingStrategy.RIS_BSDF_LIGHT,
                                             LightSamplingStrategy.RESTIR_DI)


def _interpolate_hit(scene, prim, u, v, ray_d):
    """Shading attributes of a batch of hits from the packed tri_data rows:
    (shading normal, geometric normal oriented to it, uv, material id,
    tangent)."""
    row = scene.tri_data[prim.clamp_min(0).long()]  # (N, 32)
    w = 1.0 - u - v
    nx = row[:, 0] * w + row[:, 3] * u + row[:, 6] * v
    ny = row[:, 1] * w + row[:, 4] * u + row[:, 7] * v
    nz = row[:, 2] * w + row[:, 5] * u + row[:, 8] * v
    inv_len = 1.0 / torch.sqrt((nx * nx + ny * ny + nz * nz).clamp_min(1e-24))
    ns = torch.stack([nx * inv_len, ny * inv_len, nz * inv_len], dim=-1)
    gx, gy, gz = row[:, 25], row[:, 26], row[:, 27]
    flip = torch.where(gx * nx + gy * ny + gz * nz < 0.0, -1.0, 1.0)
    ng = torch.stack([gx * flip, gy * flip, gz * flip], dim=-1)
    uv = torch.stack(
        [row[:, 9] * w + row[:, 11] * u + row[:, 13] * v,
         row[:, 10] * w + row[:, 12] * u + row[:, 14] * v], dim=-1)
    mat_id = row[:, 24].contiguous().view(torch.int32)
    return ns, ng, uv, mat_id, row[:, 28:31]


def _normal_mapped(scene, mat_id, uv, ns, tangent):
    """The shading normal perturbed by the material's normal map, if any."""
    if scene.textures is None:
        return ns
    nm_idx = scene.materials.fields_at(
        mat_id.clamp_min(0), ("normal_map_texture_index",))["normal_map_texture_index"]
    return apply_normal_map(scene.textures, nm_idx, uv, ns, tangent)


def _face_forward(n, d_in):
    """Flip normal to the side the ray arrives from."""
    return torch.where((n * d_in).sum(dim=-1, keepdim=True) > 0.0, -n, n)


def _clamp_contribution(contrib, clamp_val: float):
    """Per-category firefly clamp; 0 = disabled."""
    if clamp_val <= 0.0:
        return contrib
    m = contrib.amax(dim=-1, keepdim=True)
    scale = torch.where(m > clamp_val, clamp_val / m.clamp_min(1e-12), 1.0)
    return contrib * scale


def camera_rays_pass(scene, bvh, camera, settings: RenderSettings, state,
                     width: int, height: int, sample_number: int, rng_state,
                     options: RenderOptions = RenderOptions(), shard=None):
    """Primary-ray pass filling the G-buffer, for the pixels of ``shard``
    (default: the whole image).
    Returns (rng_state, GBuffer, pixel_active)."""
    with spans.span("camera"):
        dev = rng_state.device
        shard = shard or PixelRange.whole(width, height)
        rng_state, jx = rng_mod.next_float(rng_state)
        rng_state, jy = rng_mod.next_float(rng_state)
        jitter = torch.stack([jx, jy], dim=-1)
        # tile-major order → each 128-ray packet is one 16x8 tile
        px, py = shard.coords(dev)
        o, d = generate_camera_rays(camera, width, height, jitter, px, py)

        active = torch.ones((shard.size,), dtype=torch.bool, device=dev)
        if settings.render_low_resolution:
            sc = settings.low_resolution_scale
            active = ((px % sc) == 0) & ((py % sc) == 0)
        if settings.enable_adaptive_sampling:
            active = active & ~state.pixel_converged

        rec = _tracer(bvh, True, options.use_pallas_traversal)(
            bvh, o, d, t_min=0.0, active=active)
        hit = rec.prim >= 0
        ns, ng, uv, mat_id, tangent = _interpolate_hit(scene, rec.prim, rec.u, rec.v, d)
        ns = _normal_mapped(scene, mat_id, uv, ns, tangent)
        pos = o + d * torch.where(torch.isfinite(rec.t), rec.t, 0.0)[..., None]
        backface = (ns * d).sum(dim=-1) > 0.0
        gbuf = GBuffer(
            position=pos,
            shading_normal=torch.where(hit[..., None], _face_forward(ns, d), 0.0),
            geometric_normal=torch.where(hit[..., None], _face_forward(ng, d), 0.0),
            view_direction=-d,
            material_id=torch.where(hit, mat_id, -1),
            prim_index=rec.prim,
            uv=uv,
            t=rec.t,
            ray_dir=d,
            backface=backface,
        )
    return rng_state, gbuf, active


def _direct_lighting(options: RenderOptions, scene, bvh, world: WorldSettings,
                     settings: RenderSettings, mats, p, ns, ng, wo,
                     rng_state, active, eta_rel=None,
                     shadow_coherent: bool = False, shard=None):
    """Direct light at one path vertex: emissive triangles,
    ``number_of_light_samples`` times averaged, by RIS over light and BSDF
    candidates (lights/ris.py) or by NEE of power-sampled emissive
    triangles MIS-weighted against the BSDF; then one envmap sample
    (``_envmap_nee``). ``shadow_coherent``: the emissive shadow rays are
    screen-tile coherent (the camera vertex). ``shard``: the pixel range
    the vertices belong to. Returns (rng_state, radiance (N,3), shadow-ray
    count (() int64 tensor))."""
    contrib = torch.zeros_like(p)
    n_shadow = torch.zeros((), dtype=torch.int64, device=p.device)
    n_ls = max(int(settings.number_of_light_samples), 1)
    inv_ls = 1.0 / n_ls
    # ReSTIR DI's vertices past the camera vertex run RIS (reference:
    # Lights.h)
    if options.direct_light_sampling in (LightSamplingStrategy.RIS_BSDF_LIGHT,
                                         LightSamplingStrategy.RESTIR_DI):
        for _ in range(n_ls):
            rng_state, c, rays = ris_direct_lighting(
                options, scene, bvh, settings, mats, p, ns, ng, wo, rng_state,
                active, eta_rel, shadow_coherent=shadow_coherent, shard=shard)
            c = _clamp_contribution(c, settings.direct_contribution_clamp)
            contrib = contrib + c * inv_ls
            n_shadow = n_shadow + rays
    elif _nee_enabled(options):
        rng_state, contrib, n_shadow = _emissive_nee(
            options, scene, bvh, settings, mats, p, ns, ng, wo, rng_state,
            active, eta_rel, shadow_coherent, shard)
    if envmap_sampled(options, scene):
        rng_state, c, rays = _envmap_nee(options, scene, bvh, world, settings,
                                         mats, p, ns, ng, wo, rng_state,
                                         active, eta_rel)
        contrib = contrib + c
        n_shadow = n_shadow + rays
    return rng_state, contrib, n_shadow


def _emissive_nee(options: RenderOptions, scene, bvh, settings, mats, p, ns,
                  ng, wo, rng_state, active, eta_rel, shadow_coherent, shard):
    """NEE of power-sampled emissive triangles, ``number_of_light_samples``
    times averaged. Returns (rng_state, radiance (N,3), shadow rays)."""
    contrib = torch.zeros_like(p)
    n_shadow = torch.zeros((), dtype=torch.int64, device=p.device)
    n_ls = max(int(settings.number_of_light_samples), 1)
    inv_ls = 1.0 / n_ls
    occluded = _tracer(bvh, shadow_coherent, options.use_pallas_traversal)
    for _ in range(n_ls):
        rng_state, ls = sample_emissive_triangle(scene, p, rng_state)
        wi = ls["wi"]
        cos_i = (ns * wi).sum(dim=-1)
        f, bsdf_pdf = bsdf_eval(options, mats, ns, wo, wi,
                                {"eta_rel": eta_rel})
        cand = active & ls["valid"] & (cos_i > 0.0) & (ls["pdf"] > 0.0)
        so = offset_ray_origin(p, ng, wi)
        t_max = ls["dist"] * (1.0 - 1e-3)
        rng_state, blocked = shadow_blocked(bvh, scene, so, wi, rng_state,
                                            t_max, cand, occluded, shard)
        n_shadow = n_shadow + cand.sum()
        vis = cand & ~blocked
        c = f * ls["radiance"] * (cos_i / ls["pdf"].clamp_min(1e-12))[..., None]
        if options.direct_light_sampling == LightSamplingStrategy.MIS:
            c = c * balance_heuristic(ls["pdf"], bsdf_pdf)[..., None]
        if settings.minimum_light_contribution > 0.0:
            strong = luminance(c) >= settings.minimum_light_contribution
            vis = vis & strong
        c = _clamp_contribution(c, settings.direct_contribution_clamp)
        contrib = contrib + torch.where(vis[..., None], c * inv_ls, 0.0)
    return rng_state, contrib, n_shadow


def _envmap_nee(options: RenderOptions, scene, bvh, world: WorldSettings,
                settings, mats, p, ns, ng, wo, rng_state, active, eta_rel):
    """One importance-sampled envmap direction, its any-hit shadow ray to
    t_max = inf on the incoherent route, MIS-weighted against the BSDF
    under ``envmap_bsdf_mis`` (reference: Envmap.h
    sample_environment_map). Returns (rng_state, radiance (N,3), shadow
    rays)."""
    rng_state, wi, rad, pdf = sample_envmap(options, world, scene.envmap,
                                            rng_state)
    cos_e = (ns * wi).sum(dim=-1)
    f, bsdf_pdf = bsdf_eval(options, mats, ns, wo, wi, {"eta_rel": eta_rel})
    cand = active & (cos_e > 0.0) & (pdf > 0.0)
    if world.ambient_light_type != int(AmbientLightType.ENVMAP):
        cand = torch.zeros_like(cand)
    so = offset_ray_origin(p, ng, wi)
    blocked = _tracer(bvh, False, options.use_pallas_traversal)(
        bvh, so, wi, t_min=1e-4, t_max=float("inf"), active=cand,
        any_hit=True).prim >= 0
    c = f * rad * (cos_e / pdf.clamp_min(1e-12))[..., None]
    if options.envmap_bsdf_mis:
        c = c * balance_heuristic(pdf, bsdf_pdf)[..., None]
    c = _clamp_contribution(c, settings.envmap_contribution_clamp)
    return (rng_state, torch.where((cand & ~blocked)[..., None], c, 0.0),
            cand.sum())


def render_sample(options: RenderOptions, scene, bvh, world: WorldSettings,
                  settings: RenderSettings, gbuffer: GBuffer, pixel_active,
                  rng_state, direct0=None, collect_bounce_stats: bool = False,
                  shard=None):
    """Trace one full path per pixel from the G-buffer's first hit.
    ``direct0``: the camera vertex's direct light (ReSTIR DI), which
    replaces that vertex's NEE; the NEE there still runs with every ray
    masked, so that the RNG stream stays the JAX package's. Under
    ``options.white_furnace_mode`` the world is a uniform white and
    emission and NEE are off: any pixel away from 1 is the BSDF's energy
    gain or loss (reference: white furnace mode). ``shard``: the pixel
    range of the G-buffer (default: the whole image); a bounce is skipped
    when no path of the image is alive, so that every range runs the same
    bounces and marches (the collectives of a range held by a rank of a
    process group are made by all of them), though a range with no live
    path of its own would draw nothing a pixel keeps.

    Returns (rng_state, radiance (N,3), aov_albedo (N,3), aov_normal (N,3),
    rays traced by this sample excluding the camera pass (() int64)); with
    ``collect_bounce_stats`` also the live rays of each bounce
    ((max(max_bounces_static, 1),) int64; reference: RenderData.h:102-113
    still_one_ray_active, per depth)."""
    n_rays = gbuffer.position.shape[0]
    dev = gbuffer.position.device
    shard = shard or PixelRange.batch(n_rays)
    mats_all = scene.materials
    d0 = gbuffer.ray_dir
    hit0 = gbuffer.prim_index >= 0
    if options.white_furnace_mode:
        world = world.replace(ambient_light_type=int(AmbientLightType.UNIFORM),
                              uniform_light_color=(1.0, 1.0, 1.0))
    em_scale = 0.0 if options.white_furnace_mode else 1.0
    env_mis = envmap_sampled(options, scene) and options.envmap_bsdf_mis
    alive = torch.zeros((max(options.max_bounces_static, 1),),
                        dtype=torch.int64, device=dev)

    radiance = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((n_rays, 3), dtype=torch.float32, device=dev)
    # miss at the primary ray → ambient, weight 1
    env0 = eval_envmap(world, scene.envmap, d0)
    radiance = radiance + torch.where((~hit0 & pixel_active)[..., None], env0, 0.0)
    # emission at the primary hit, weight 1
    mats0 = mats_all.at_indices(gbuffer.material_id.clamp_min(0)).make_safe()
    em0 = mats0.effective_emission() * em_scale
    radiance = radiance + torch.where((hit0 & pixel_active)[..., None], em0, 0.0)
    aov_albedo = torch.where(hit0[..., None], mats0.base_color, env0.clamp(0.0, 1.0))
    aov_normal = torch.where(hit0[..., None], gbuffer.shading_normal, 0.0)

    rays = torch.zeros((), dtype=torch.int64, device=dev)
    active = hit0 & pixel_active
    p = gbuffer.position
    ns = gbuffer.shading_normal
    ng = gbuffer.geometric_normal
    wo = gbuffer.view_direction
    mat_id = gbuffer.material_id.clamp_min(0)
    uv = gbuffer.uv
    stack_mat, stack_pri = nd.empty_stack(
        n_rays, options.nested_dielectrics_stack_size, dev)
    entering = ~gbuffer.backface
    wavelength = torch.zeros((n_rays,), dtype=torch.float32, device=dev)  # 0: none

    n_bounces = min(options.max_bounces_static, int(settings.nb_bounces))
    for bounce in range(n_bounces):
        # the one host sync of a bounce: a bounce with no live ray is skipped
        # and leaves the RNG stream untouched, as in the JAX package; while
        # spans record, the sync reads the live paths' count for the counter
        if spans.enabled():
            live = shard.count(active)
            if not live:
                break
            spans.count("live", live)
            spans.count("lanes", shard.num_pixels)
        elif not shard.any(active):
            break
        if collect_bounce_stats:
            alive[bounce] = active.sum()
        with spans.span("bounce"):
            with spans.span("bounce/material"):
                mats = mats_all.at_indices(mat_id).make_safe()
                if scene.textures is not None:
                    mats = apply_textures(scene.textures, mats, uv)

                # --- dispersion: a hero wavelength is drawn on first contact
                # with a dispersive dielectric; its RGB weight enters the
                # throughput once and its IOR replaces the material's from
                # then on ---
                if options.do_dispersion:
                    dispersive = ((mats.dispersion_scale > 0.0)
                                  & (mats.specular_transmission > 0.0))
                    rng_state, u_lam = rng_mod.next_float(rng_state)
                    need_sample = dispersive & (wavelength <= 0.0) & active
                    wavelength = torch.where(need_sample, sample_wavelength(u_lam),
                                             wavelength)
                    throughput = torch.where(
                        need_sample[..., None],
                        throughput * wavelength_rgb_weight(wavelength), throughput)
                    eta_mat = torch.where(
                        dispersive & (wavelength > 0.0),
                        ior_at_wavelength(mats.ior, mats.dispersion_abbe_number,
                                          mats.dispersion_scale, wavelength),
                        mats.ior)
                else:
                    eta_mat = mats.ior

                rng_state, u_alpha = rng_mod.next_float(rng_state)
                alpha_skip = active & (u_alpha >= mats.alpha_opacity)
                if not settings.do_alpha_testing:
                    alpha_skip = torch.zeros_like(active)

                # --- nested dielectrics: true vs false interfaces, relative
                # IOR (reference: NestedDielectrics.h). WITH_PRIORITIES:
                # Schmidt 2002 priorities; AUTOMATIC (RT Gems 2019,
                # InteriorStackImpl<ISS_AUTOMATIC>): every dielectric ranks 0
                # and parity decides, so entering a material already on the
                # stack is a false interface ---
                is_trans = mats.specular_transmission > 0.0
                top_pri = nd.top_priority(stack_pri)
                top_mat = nd.top_material(stack_mat, stack_pri)
                if options.interior_stack_strategy == InteriorStackStrategy.AUTOMATIC:
                    m_pri = torch.zeros_like(mats.dielectric_priority,
                                             dtype=torch.int32)
                    false_enter = (is_trans & entering
                                   & nd.contains(stack_mat, stack_pri, mat_id))
                else:
                    m_pri = mats.dielectric_priority.to(torch.int32)
                    false_enter = is_trans & entering & (m_pri < top_pri)
                false_exit = (is_trans & ~entering & (top_mat != mat_id)
                              & (top_pri >= 0))
                false_interface = (false_enter | false_exit) & active
                alpha_skip = alpha_skip | false_interface

                def ior_of(ids):
                    return torch.where(ids >= 0,
                                       mats_all.ior[ids.clamp_min(0).long()], 1.0)

                n_outside_enter = ior_of(top_mat)
                excl_mat, excl_pri = nd.top_excluding(stack_mat, stack_pri, mat_id)
                n_outside_exit = torch.where(excl_pri >= 0, ior_of(excl_mat), 1.0)
                eta_c = eta_mat.clamp_min(1.0 + 1e-3)
                eta_rel = torch.where(entering, eta_c / n_outside_enter,
                                      n_outside_exit / eta_c).clamp_min(1e-3)
                nee_active = active & ~alpha_skip
                if ((direct0 is not None and bounce == 0)
                        or options.white_furnace_mode):
                    nee_active = torch.zeros_like(nee_active)
            # --- NEE ---
            with spans.span("bounce/direct"):
                rng_state, direct, n_shadow = _direct_lighting(
                    options, scene, bvh, world, settings, mats, p, ns, ng, wo,
                    rng_state, nee_active, eta_rel, shadow_coherent=(bounce == 0),
                    shard=shard)
                if direct0 is not None and bounce == 0:
                    direct = direct0
                radiance = radiance + torch.where(active[..., None],
                                                  throughput * direct, 0.0)

            # --- BSDF sample + bounce ray ---
            with spans.span("bounce/bsdf"):
                rng_state, wi, f, bsdf_pdf, s_aux = bsdf_sample(
                    options, mats, ns, wo, rng_state, {"eta_rel": eta_rel})
                wi = torch.where(alpha_skip[..., None], -wo, wi)
                cos_i = (ns * wi).sum(dim=-1)
                valid_sample = active & ((bsdf_pdf > 1e-9) | alpha_skip)
                factor = torch.where(alpha_skip, 1.0,
                                     cos_i.abs() / bsdf_pdf.clamp_min(1e-12))
                new_throughput = throughput * torch.where(
                    valid_sample[..., None],
                    torch.where(alpha_skip[..., None], 1.0, f) * factor[..., None],
                    0.0)

                # --- interior stack update + Beer-Lambert medium from the new
                # top ---
                refracted = s_aux["refracted"] & ~alpha_skip
                not_thin = mats.thin_walled < 0.5
                crossed = (valid_sample & is_trans & not_thin
                           & (refracted | false_interface))
                stack_mat, stack_pri = nd.push(stack_mat, stack_pri, mat_id, m_pri,
                                               crossed & entering)
                stack_mat, stack_pri = nd.remove(stack_mat, stack_pri, mat_id,
                                                 crossed & ~entering)
                new_top = nd.top_material(stack_mat, stack_pri)
                med = mats_all.fields_at(
                    new_top.clamp_min(0),
                    ("absorption_color", "absorption_at_distance"))
                absorb = med["absorption_color"].clamp(1.0 / 512.0, 1.0)
                sigma_top = (-torch.log(absorb)
                             / med["absorption_at_distance"].clamp_min(1e-4)[..., None])
                medium_sigma = torch.where((new_top >= 0)[..., None], sigma_top,
                                           0.0)

                # --- russian roulette (survive probability from the
                # pre-attenuation throughput, or the Arnold-2014 attenuation
                # ratio) ---
                rng_state, u_rr = rng_mod.next_float(rng_state)
                if settings.do_russian_roulette and bounce >= settings.rr_min_depth:
                    tp_max = throughput.amax(dim=-1)
                    if settings.rr_method == int(RussianRouletteMethod.ARNOLD):
                        survive_p = torch.sqrt(new_throughput.amax(dim=-1)
                                               / tp_max.clamp_min(1e-12))
                    else:
                        survive_p = tp_max
                    survive_p = survive_p.clamp_max(1.0)
                    killed = u_rr >= survive_p
                    increase = 1.0 / survive_p.clamp_min(1e-12)
                    if settings.rr_throughput_clamp > 0.0:
                        increase = increase.clamp_max(
                            settings.rr_throughput_clamp)
                    new_throughput = torch.where(
                        (~killed)[..., None], new_throughput * increase[..., None],
                        new_throughput)
                    valid_sample = valid_sample & ~killed

            # --- trace the bounce ray ---
            with spans.span("bounce/trace"):
                o_next = offset_ray_origin(p, ng, wi)
                rec = _tracer(bvh, False, options.use_pallas_traversal)(
                    bvh, o_next, wi, t_min=0.0, active=valid_sample)
            with spans.span("bounce/hit"):
                hit = rec.prim >= 0
                ns2, ng2, uv2, mat_id2, tan2 = _interpolate_hit(
                    scene, rec.prim, rec.u, rec.v, wi)
                t_b = rec.t

                # Beer-Lambert absorption along the segment inside a medium
                seg_t = torch.where(hit, t_b, 0.0)
                new_throughput = new_throughput * torch.exp(
                    -medium_sigma * seg_t[..., None])

                # BSDF ray hits an emitter → MIS-weighted emission
                light_pdf, is_em = emissive_pdf_of_direction(
                    scene, o_next, rec.prim, t_b, wi)
                if options.direct_light_sampling == LightSamplingStrategy.MIS:
                    w_em = balance_heuristic(bsdf_pdf, light_pdf)
                elif _nee_enabled(options):
                    # pure NEE, RIS and ReSTIR: emitter hits are already
                    # counted by the light samples or the candidate pools
                    w_em = torch.zeros_like(bsdf_pdf)
                else:
                    w_em = torch.ones_like(bsdf_pdf)
                # a pass-through ray skipped NEE at its vertex → full emitter
                # weight
                w_em = torch.where(alpha_skip, 1.0, w_em)
                em = mats_all.fields_at(
                    scene.material_ids[rec.prim.clamp_min(0).long()],
                    ("emission", "emission_strength"))
                em_c = (em["emission"] * em["emission_strength"][..., None]
                        * em_scale * w_em[..., None] * new_throughput)
                em_c = _clamp_contribution(em_c,
                                           settings.indirect_contribution_clamp)
                radiance = radiance + torch.where(
                    (valid_sample & hit & is_em)[..., None], em_c, 0.0)

                # miss → ambient, or the envmap MIS-weighted against its own
                # sampling
                env_c = eval_envmap(world, scene.envmap, wi)
                if (env_mis and world.ambient_light_type
                        == int(AmbientLightType.ENVMAP)):
                    w_env = balance_heuristic(
                        bsdf_pdf, envmap_pdf_of_direction(world, scene.envmap, wi))
                    env_c = env_c * w_env[..., None]
                env_c = env_c * new_throughput
                env_c = _clamp_contribution(env_c,
                                            settings.envmap_contribution_clamp)
                radiance = radiance + torch.where((valid_sample & ~hit)[..., None],
                                                  env_c, 0.0)

                # --- next vertex ---
                ns2 = _normal_mapped(scene, mat_id2, uv2, ns2, tan2)
                p2 = o_next + wi * torch.where(torch.isfinite(t_b), t_b,
                                               0.0)[..., None]
                next_active = valid_sample & hit
                na = next_active[..., None]
                entering2 = (ns2 * wi).sum(dim=-1) < 0.0
                rays = rays + n_shadow + valid_sample.sum()
                throughput = torch.where(na, new_throughput, throughput)
                p = torch.where(na, p2, p)
                ns = torch.where(na, _face_forward(ns2, wi), ns)
                ng = torch.where(na, _face_forward(ng2, wi), ng)
                wo = torch.where(na, -wi, wo)
                mat_id = torch.where(next_active, mat_id2, mat_id)
                uv = torch.where(na, uv2, uv)
                entering = torch.where(next_active, entering2, entering)
                active = next_active

    # NaN / negative scrub: a bad sample contributes black
    bad = (~torch.isfinite(radiance) | (radiance < 0.0)).any(dim=-1)
    radiance = torch.where(bad[..., None], 0.0, radiance)
    if collect_bounce_stats:
        return rng_state, radiance, aov_albedo, aov_normal, rays, alive
    return rng_state, radiance, aov_albedo, aov_normal, rays
