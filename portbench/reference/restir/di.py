"""ReSTIR DI — spatiotemporal reservoir reuse for direct lighting at the
camera vertex, mirroring ``hiprt_pt_tpu.restir.di`` (reference:
ReSTIRDIRenderPass.cpp and kernels/ReSTIR/DI/*).

Light presampling, per-pixel initial candidates (RIS over presampled lights
and BSDF samples), temporal reuse with back-projection and similarity
heuristics, spatial reuse passes with six bias-correction schemes, the fused
spatiotemporal pass, and final shading with visibility. Every pass is a
function Reservoir -> Reservoir over the flat pixel wavefront in the
tile-major order (ops/pixel_order.py); a neighbour tap reads one row of a
packed table.

Area-light samples are stored and weighted in area measure (no reuse
Jacobians); the target p_hat is the unshadowed luminance of f·Le·G.

Candidate and tap loops are Python loops over the settings' counts; every
draw comes in the JAX package's order, so winners match it. With an
importance-sampled envmap, a light candidate is an envmap direction with
probability ``ReSTIRDISettings.envmap_candidate_probability`` and a BSDF
candidate that reaches no emitter becomes an envmap candidate (solid-angle
measure; reference: InitialCandidates.h:377-405). Visibility rays
(visibility reuse after the initial candidates, the last spatial pass,
final shading) are any-hit traces on the incoherent route: after reuse a
pixel's winner comes from a neighbour's reservoir. In a scene with alpha
textures final shading's visibility ray takes the alpha-aware march
(ops/traverse.py:occluded_alpha), which draws from the RNG stream; the
other two stay alpha-blind, as in the JAX package. The last spatial
pass's visibility is traced only in that pass (the JAX package traces it in
every pass with all rays masked but the last pass's, which gives the same
result).

The passes may run on a range of the image's pixels (``shard``, an
ops/pixel_order.py:PixelRange; parallel/mesh.py's pixel shards): each pass
computes the range's own pixels, and the packed table a neighbour tap reads
is gathered from every range first, so that tap indices are the image's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.settings import (AmbientLightType, ReSTIRBiasCorrection,
                             RenderOptions)
from ..lights.envmap_sampling import (envmap_pdf_of_direction,
                                      envmap_sampled, eval_envmap,
                                      sample_envmap)
from ..lights.light_sampling import (closest_emissive_hit,
                                     emissive_pdf_of_direction,
                                     sample_emissive_triangle)
from ..lights.ris import DENSE_EMISSIVE_MAX
from ..models.dispatcher import (bsdf_eval, bsdf_proxy_ctx, bsdf_proxy_eval,
                                 bsdf_proxy_eval_ctx, bsdf_proxy_sample_ctx,
                                 bsdf_sample)
from ..ops.intersect import offset_ray_origin
from ..ops.pixel_order import PixelRange, linear_index
from ..ops.routing import tracer
from ..ops.sampling import sample_triangle
from ..ops.tonemap import luminance
from ..ops.traverse import shadow_blocked
from .reservoir import Reservoir

# (width, height, device) -> row-major pixel index -> canonical index
_LIN2CANON: dict = {}


def _lin2canon(width: int, height: int, device) -> torch.Tensor:
    key = (width, height, str(device))
    if key not in _LIN2CANON:
        order = np.argsort(linear_index(width, height), kind="stable")
        _LIN2CANON[key] = torch.from_numpy(order).to(device)
    return _LIN2CANON[key]


def _occluded(options: RenderOptions, bvh, o, d, t_max, active):
    """Any-hit visibility of a wavefront on the incoherent route."""
    trace = tracer(bvh, False, options.use_pallas_traversal)
    return trace(bvh, o, d, t_min=1e-4, t_max=t_max, active=active,
                 any_hit=True).prim >= 0


# ----------------------------------------------------------------- target fn


def eval_target_full(options: RenderOptions, mats, p, ns, wo, eta_rel,
                     sample, pctx=None) -> dict:
    """p_hat of a (light_point, light_normal, radiance, is_envmap) sample at
    surface (p, ns, wo), plus the terms MIS needs. ``pctx``: the hoisted
    proxy context of this surface batch (models/dispatcher.bsdf_proxy_ctx).
    Returns dict(ph, wi, dist, bsdf_pdf [solid angle], cos_l, d2)."""
    lp = sample["light_point"]
    ln = sample["light_normal"]
    rad = sample["radiance"]
    is_env = sample["is_envmap"]

    to_l = lp - p
    d2 = (to_l * to_l).sum(dim=-1)
    dist_area = torch.sqrt(d2.clamp_min(1e-12))
    wi = torch.where(is_env[:, None], lp, to_l / dist_area[:, None])
    dist = torch.where(is_env, float("inf"), dist_area)

    cos_i = (ns * wi).sum(dim=-1).clamp_min(0.0)
    cos_l = (ln * (-wi)).sum(dim=-1).abs()
    aux = {"eta_rel": eta_rel}
    if not options.ris_proxy_target:
        f, bsdf_pdf = bsdf_eval(options, mats, ns, wo, wi, aux)
    elif pctx is not None:
        f, bsdf_pdf = bsdf_proxy_eval_ctx(options, pctx, mats, ns, wo, wi, aux)
    else:
        f, bsdf_pdf = bsdf_proxy_eval(options, mats, ns, wo, wi, aux)
    base = luminance(f * rad) * cos_i
    ph_area = base * cos_l / d2.clamp_min(1e-12)
    ph = torch.where(is_env, base, ph_area)
    return {"ph": torch.where(torch.isfinite(ph) & (ph >= 0.0), ph, 0.0),
            "wi": wi, "dist": dist, "bsdf_pdf": bsdf_pdf, "cos_l": cos_l,
            "d2": d2}


def eval_target(options: RenderOptions, mats, p, ns, wo, eta_rel, sample,
                pctx=None):
    """(p_hat (N,), wi (N,3), dist (N,)) of a sample at surface (p, ns, wo)."""
    tf = eval_target_full(options, mats, p, ns, wo, eta_rel, sample, pctx)
    return tf["ph"], tf["wi"], tf["dist"]


def _power_heuristic_counts(pdf_a, count_a: float, pdf_b, count_b: float):
    """n_a·p_a² / ((n_a·p_a)² + (n_b·p_b)²) (reference: Sampling.h:75-87)."""
    a = count_a * pdf_a
    b = count_b * pdf_b
    return torch.where(a > 0.0,
                       count_a * pdf_a * pdf_a / (a * a + b * b).clamp_min(1e-24),
                       0.0)


def _sample_of(res: Reservoir) -> dict:
    return {"light_point": res.light_point, "light_normal": res.light_normal,
            "radiance": res.radiance, "is_envmap": res.is_envmap}


# ------------------------------------------------------------- presampling


def presample_lights(scene, sample_number: int,
                     options: RenderOptions = RenderOptions()) -> dict:
    """The presampled light pool of S x K samples (reference:
    LightsPresampling.h; S, K: RenderOptions.restir_presample_subset_*),
    drawn from the power alias table with area-measure pdfs. The pool's
    streams are seeded with (pool index, sample_number, 977)."""
    S = options.restir_presample_subset_count
    K = options.restir_presample_subset_size
    n = S * K
    dev = scene.vertices.device
    pool_rng = rng_mod.seed(torch.arange(n, device=dev), sample_number, 977)
    pool_rng, u0 = rng_mod.next_float(pool_rng)
    pool_rng, u1, u2 = rng_mod.next_float2(pool_rng)
    pool_rng, u_acc = rng_mod.next_float(pool_rng)

    e = scene.emissive_alias_prob.shape[0]
    j = (u0 * e).to(torch.int64).clamp_max(e - 1)
    slot = torch.where(u_acc < scene.emissive_alias_prob[j], j,
                       scene.emissive_alias[j].long())
    tri_idx = scene.emissive_tri_indices[slot]
    safe_tri = tri_idx.clamp_min(0).long()
    tri = scene.triangles[safe_tri].long()
    v0 = scene.vertices[tri[:, 0]]
    e1 = scene.vertices[tri[:, 1]] - v0
    e2 = scene.vertices[tri[:, 2]] - v0
    lp, ng = sample_triangle(v0, e1, e2, u1, u2)
    ng_len = torch.linalg.norm(ng, dim=-1)
    area = 0.5 * ng_len
    ln = ng / ng_len.clamp_min(1e-12)[:, None]
    pdf_area = scene.emissive_pmf[slot] / area.clamp_min(1e-12)
    rad = scene.materials.at_indices(
        scene.material_ids[safe_tri]).effective_emission()
    valid = tri_idx >= 0
    return {"light_point": lp, "light_normal": ln, "radiance": rad,
            "pdf": torch.where(valid, pdf_area, 0.0),
            "is_envmap": torch.zeros((n,), dtype=torch.bool, device=dev),
            "valid": valid, "S": S, "K": K}


# ------------------------------------------------------- initial candidates


def initial_candidates(options: RenderOptions, scene, bvh, world, settings,
                       mats, p, ns, ng, wo, eta_rel, active, rng_state,
                       pool=None, tile_id=None):
    """Per-pixel RIS over light (and envmap) and BSDF candidates into a
    reservoir (reference: InitialCandidates.h:449), light candidates from
    the tile-coherent presampled subsets when ``pool`` and ``tile_id`` are
    given. Visibility reuse is the next pass (``visibility_reuse``).
    Returns (reservoir, rng_state)."""
    n = p.shape[0]
    dev = p.device
    rs = settings.restir_di
    res = Reservoir.empty(n, dev)
    pctx = bsdf_proxy_ctx(options, mats, ns, wo) if options.ris_proxy_target else None
    M_l = int(rs.num_light_candidates)
    M_b = int(rs.num_bsdf_candidates)
    no_env = torch.zeros((n,), dtype=torch.bool, device=dev)
    aux = {"eta_rel": eta_rel}
    has_env = envmap_sampled(options, scene)
    p_env = float(rs.envmap_candidate_probability)

    for i in range(M_l):
        # the envmap choice's draw is made with or without an envmap
        rng_state, u_env = rng_mod.next_float(rng_state)
        if pool is not None and tile_id is not None:
            # tile-coherent subset pick from the presampled pool
            rng_state, u_pick = rng_mod.next_float(rng_state)
            subset = (tile_id + i) % pool["S"]
            k = (u_pick * pool["K"]).to(torch.int64).clamp(0, pool["K"] - 1)
            idx = subset.long() * pool["K"] + k
            lp = pool["light_point"][idx]
            ln = pool["light_normal"][idx]
            rad = pool["radiance"][idx]
            pdf_area = pool["pdf"][idx]
            lvalid = pool["valid"][idx]
        else:
            rng_state, ls = sample_emissive_triangle(scene, p, rng_state)
            lp, ln, rad = ls["light_point"], ls["light_normal"], ls["radiance"]
            # the solid-angle pdf back to area measure
            cos_l = (ln * (-ls["wi"])).sum(dim=-1).abs()
            pdf_area = ls["pdf"] * cos_l / (ls["dist"] ** 2).clamp_min(1e-12)
            lvalid = ls["valid"]
        is_env = no_env
        if has_env:
            use_env = u_env < p_env
            rng_state, wi_e, rad_e, pdf_e = sample_envmap(options, world,
                                                          scene.envmap, rng_state)
            lp = torch.where(use_env[:, None], wi_e, lp)
            ln = torch.where(use_env[:, None], -wi_e, ln)
            rad = torch.where(use_env[:, None], rad_e, rad)
            pdf_area = torch.where(use_env, pdf_e * p_env, pdf_area * (1.0 - p_env))
            lvalid = torch.where(use_env, pdf_e > 0.0, lvalid)
            is_env = use_env
        sample = {"light_point": lp, "light_normal": ln, "radiance": rad,
                  "is_envmap": is_env}
        tf = eval_target_full(options, mats, p, ns, wo, eta_rel, sample, pctx)
        ph = tf["ph"]
        valid = active & lvalid & (pdf_area > 0.0)
        # MIS against the BSDF candidate stream, in the candidate's measure:
        # area for emissive triangles, solid angle for the envmap
        # (reference: InitialCandidates.h:241)
        pdf_b_meas = tf["bsdf_pdf"] * tf["cos_l"] / tf["d2"].clamp_min(1e-12)
        if has_env:
            pdf_b_meas = torch.where(is_env, tf["bsdf_pdf"], pdf_b_meas)
        mis_w = _power_heuristic_counts(pdf_area, float(M_l), pdf_b_meas,
                                        float(M_b))
        w = mis_w * ph / pdf_area.clamp_min(1e-12)
        res, rng_state = res.update(rng_state, w, lp, ln, rad, ph, is_env, valid)

    # BSDF candidates: find the emitter each direction reaches
    rows = scene.emissive_rows
    for _ in range(M_b):
        if options.ris_proxy_target:
            # drawn by the proxy sampler, so pdf_b is the draw's density and
            # matches eval_target_full's bsdf_pdf in the MIS weights
            rng_state, wi, _f, pdf_b = bsdf_proxy_sample_ctx(
                options, pctx, mats, ns, wo, rng_state, aux)
        else:
            rng_state, wi, _f, pdf_b, _aux = bsdf_sample(
                options, mats, ns, wo, rng_state, aux)
        cos_i = (ns * wi).sum(dim=-1)
        cand = active & (pdf_b > 0.0) & (cos_i > 0.0)
        o = offset_ray_origin(p, ng, wi)
        if 0 < rows.shape[0] <= DENSE_EMISSIVE_MAX:
            # the dense emissive sweep: occlusion is settled by the
            # visibility passes, not here
            t_e, slot = closest_emissive_hit(scene, o, wi, active=cand)
            is_em = slot >= 0
            row = rows[slot.clamp_min(0)]
            rad = row[:, 14:17]
            ng_l = row[:, 9:12]
            lp = o + wi * torch.where(is_em, t_e, 0.0)[:, None]
            cos_l = (ng_l * (-wi)).sum(dim=-1).abs()
            d2 = (t_e * t_e).clamp_min(1e-12)
            pdf_l_area = row[:, 13] / row[:, 12].clamp_min(1e-12)
            miss_for_env = ~is_em
        else:
            from ..render.integrator import _interpolate_hit

            rec = tracer(bvh, False, options.use_pallas_traversal)(
                bvh, o, wi, t_min=0.0, active=cand)
            hit = rec.prim >= 0
            em = scene.materials.fields_at(
                scene.material_ids[rec.prim.clamp_min(0).long()],
                ("emission", "emission_strength"))
            rad = em["emission"] * em["emission_strength"][..., None]
            is_em = (rad > 0.0).any(dim=-1) & hit
            lp = o + wi * torch.where(torch.isfinite(rec.t), rec.t, 0.0)[:, None]
            _ns_l, ng_l, _uv, _mid, _tan = _interpolate_hit(
                scene, rec.prim, rec.u, rec.v, wi)
            cos_l = (ng_l * (-wi)).sum(dim=-1).abs()
            d2 = (rec.t * rec.t).clamp_min(1e-12)
            # the light-domain pdf of this point, in area measure
            # (reference: InitialCandidates.h:350)
            pdf_l_solid, _ = emissive_pdf_of_direction(scene, o, rec.prim,
                                                       rec.t, wi)
            pdf_l_area = pdf_l_solid * cos_l / d2
            miss_for_env = ~hit
        pdf_area = pdf_b * cos_l / d2  # solid angle -> area
        sample = {"light_point": lp, "light_normal": ng_l, "radiance": rad,
                  "is_envmap": no_env}
        ph, _, _ = eval_target(options, mats, p, ns, wo, eta_rel, sample, pctx)
        valid = cand & is_em & (pdf_area > 0.0)
        if has_env:
            pdf_l_area = pdf_l_area * (1.0 - p_env)
        mis_w = _power_heuristic_counts(pdf_area, float(M_b), pdf_l_area,
                                        float(M_l))
        w = mis_w * ph / pdf_area.clamp_min(1e-12)
        res, rng_state = res.update(rng_state, w, lp, ng_l, rad, ph, no_env,
                                    valid)
        if has_env:
            # a direction that reaches no emitter is an envmap candidate,
            # in solid angle (reference: InitialCandidates.h:377-405); its
            # update draws even where the world shows no envmap
            env_rad = eval_envmap(world, scene.envmap, wi)
            all_env = torch.ones_like(no_env)
            ph_e, _, _ = eval_target(
                options, mats, p, ns, wo, eta_rel,
                {"light_point": wi, "light_normal": -wi, "radiance": env_rad,
                 "is_envmap": all_env}, pctx)
            pdf_e_l = envmap_pdf_of_direction(world, scene.envmap, wi) * p_env
            mis_e = _power_heuristic_counts(pdf_b, float(M_b), pdf_e_l,
                                            float(M_l))
            w_e = mis_e * ph_e / pdf_b.clamp_min(1e-12)
            env_on = world.ambient_light_type == int(AmbientLightType.ENVMAP)
            res, rng_state = res.update(rng_state, w_e, wi, -wi, env_rad, ph_e,
                                        all_env, cand & miss_for_env & env_on)

    # the MIS weights sum to 1 across the streams: W = w_sum / p_hat(y),
    # confidence 1 (reference: Reservoir.h end())
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    res = res.finalize(normalization=ones)
    res = res.replace(M=torch.where(res.M > 0, 1.0, 0.0))
    return res, rng_state


def visibility_reuse(options: RenderOptions, bvh, p, ng, res: Reservoir,
                     active) -> Reservoir:
    """Drop the initial candidates' occluded winners before any reuse: one
    any-hit trace (reference: ReSTIR_DI_DoVisibilityReuse; the JAX package
    runs it at the end of initial_candidates under
    ``restir_di_initial_visibility``)."""
    blocked = _occluded(options, bvh, *visibility_rays(p, ng, res, active))
    return res.replace(W=torch.where(blocked, 0.0, res.W))


# ------------------------------------------------------------ temporal reuse


def _similarity_ok(rs, ns, p, rough_here, nb_n, nb_p, nb_rough):
    """Neighbour similarity heuristics: normal cone, plane distance,
    roughness (reference: ReSTIR/DI/Utils.h
    check_neighbor_similarity_heuristics)."""
    normal_ok = (ns * nb_n).sum(dim=-1) > rs.normal_similarity_threshold
    plane_ok = ((nb_p - p) * ns).sum(dim=-1).abs() < rs.plane_distance_threshold
    rough_ok = (nb_rough - rough_here).abs() <= rs.roughness_similarity_threshold
    return normal_ok & plane_ok & rough_ok


def _packed_table(scene, res: Reservoir, gbuf) -> torch.Tensor:
    """(N, 26) f32: reservoir (0:14), shading normal (14:17), position
    (17:20), view direction (20:23), prim index (23), material id (24) and
    roughness (25) of every pixel: a neighbour tap is one row gather."""
    rough = scene.materials.roughness[gbuf.material_id.clamp_min(0).long()]
    return torch.cat([
        res.pack_columns(), gbuf.shading_normal, gbuf.position,
        gbuf.view_direction, gbuf.prim_index.to(torch.float32)[:, None],
        gbuf.material_id.to(torch.float32)[:, None], rough[:, None]], dim=1)


def _row_surface(scene, row):
    """(materials, position, shading normal, view direction) of packed
    rows."""
    mats = scene.materials.at_indices(
        row[:, 24].to(torch.int32).clamp_min(0)).make_safe()
    return mats, row[:, 17:20], row[:, 14:17], row[:, 20:23]


def _back_project(p, prev_view_proj):
    """(ndc x, ndc y, clip w) of points p in the previous frame's view; the
    product is summed term by term in one order on every device."""
    vp = prev_view_proj
    clip = (p[:, 0:1] * vp[:, 0] + p[:, 1:2] * vp[:, 1] + p[:, 2:3] * vp[:, 2]
            + vp[:, 3])
    w = clip[:, 3:4]
    ndc = clip[:, :2] / w.abs().clamp_min(1e-12) * torch.sign(w)
    return ndc[:, 0], ndc[:, 1], clip[:, 3]


def _in_screen(nx, ny, cw):
    return (nx > -1.0) & (nx < 1.0) & (ny > -1.0) & (ny < 1.0) & (cw > 0.0)


def temporal_reuse(options: RenderOptions, settings, scene, mats, gbuf,
                   prev_gbuf, prev_res: Reservoir, cur_res: Reservoir,
                   eta_rel, active, width: int, height: int, prev_view_proj,
                   rng_state, shard=None):
    """Combine each pixel's reservoir with a back-projected previous-frame
    reservoir (reference: TemporalReuse.h:48): the exact reprojected tap
    (optionally permutation-sampled), then up to
    ``temporal_max_neighbor_search`` random taps in a disk until one passes
    the similarity heuristics; an M-capped combine under the configured
    bias correction. ``shard``: the pixels of the current arrays (default:
    the whole image); the previous frame's arrays are the range's too.
    Returns (reservoir, rng_state)."""
    rs = settings.restir_di
    p = gbuf.position
    ns = gbuf.shading_normal
    wo = gbuf.view_direction
    n = p.shape[0]
    dev = p.device
    rough_here = mats.roughness
    pctx = bsdf_proxy_ctx(options, mats, ns, wo) if options.ris_proxy_target else None

    nx, ny, cw = _back_project(p, prev_view_proj)
    fx = (nx * 0.5 + 0.5) * width
    fy = (ny * 0.5 + 0.5) * height
    in_screen = _in_screen(nx, ny, cw)
    lin2canon = _lin2canon(width, height, dev)
    shard = shard or PixelRange.whole(width, height)
    packed_prev = shard.gather_rows(_packed_table(scene, prev_res, prev_gbuf))

    # neighbour search: tap 0 is the exact reprojection, taps 1..max random
    # disk offsets; the first valid tap wins (reference:
    # find_temporal_neighbor_index + apply_permutation_sampling)
    radius = float(rs.temporal_neighbor_search_radius)
    if rs.temporal_use_permutation_sampling:
        # frame-constant permutation bits from pixel 0's stream (no host
        # sync)
        perm_bits = (shard.from_first(rng_state[0:1])[0] >> 8) & 15
    found_idx = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for i in range(max(int(rs.temporal_max_neighbor_search), 0) + 1):
        rng_state, u1, u2 = rng_mod.next_float2(rng_state)
        if i > 0:
            tx = torch.round(fx - 0.5 + (u1 - 0.5) * radius).to(torch.int32)
            ty = torch.round(fy - 0.5 + (u2 - 0.5) * radius).to(torch.int32)
        else:
            tx = torch.round(fx - 0.5).to(torch.int32)
            ty = torch.round(fy - 0.5).to(torch.int32)
            if rs.temporal_use_permutation_sampling:
                ox_p, oy_p = perm_bits & 3, (perm_bits >> 2) & 3
                tx = (((tx + ox_p) ^ 3) - ox_p).to(torch.int32)
                ty = (((ty + oy_p) ^ 3) - oy_p).to(torch.int32)
        inside = (tx >= 0) & (tx < width) & (ty >= 0) & (ty < height)
        idx = lin2canon[(ty.clamp(0, height - 1) * width
                         + tx.clamp(0, width - 1)).long()]
        row = packed_prev[idx]
        ok = (inside
              & _similarity_ok(rs, ns, p, rough_here, row[:, 14:17],
                               row[:, 17:20], row[:, 25])
              & (row[:, 23] >= 0.0) & (row[:, 1] > 0.0))
        found_idx = torch.where((found_idx < 0) & ok, idx, found_idx)

    valid = active & in_screen & (found_idx >= 0)
    if not rs.temporal_enabled:
        valid = torch.zeros_like(valid)
    prev_row = packed_prev[found_idx.clamp_min(0)]
    prev_r = Reservoir.from_columns(prev_row[:, 0:14]).m_capped(rs.m_cap)

    ph_here, _, _ = eval_target(options, mats, p, ns, wo, eta_rel,
                                _sample_of(prev_r), pctx)
    scheme = options.restir_di_bias_correction
    use_conf = options.restir_di_confidence_weights
    M_t = torch.where(valid, prev_r.M, 0.0)
    M_c = cur_res.M.clamp_min(0.0)
    c_t = M_t if use_conf else torch.where(valid, 1.0, 0.0)
    c_c = M_c if use_conf else torch.where(M_c > 0, 1.0, 0.0)
    prev_surface = _row_surface(scene, prev_row)

    if scheme in (ReSTIRBiasCorrection.M_WEIGHT_1_OVER_M,
                  ReSTIRBiasCorrection.M_WEIGHT_1_OVER_Z):
        combined, rng_state = cur_res.combine(rng_state, prev_r, ph_here, M_t,
                                              valid)
        if scheme == ReSTIRBiasCorrection.M_WEIGHT_1_OVER_Z:
            # Z: confidence of the participants whose surface can produce the
            # final winner (reference: TemporalNormalizationWeight 1/Z)
            ph_win_at_prev, _, _ = eval_target(options, *prev_surface, eta_rel,
                                               _sample_of(combined))
            z = (torch.where(combined.target > 0.0, M_c, 0.0)
                 + torch.where(valid & (ph_win_at_prev > 0.0), M_t, 0.0))
            combined = combined.finalize(normalization=z.clamp_min(1e-6))
            combined = combined.replace(M=M_c + M_t)
        else:
            combined = combined.finalize()
        return combined, rng_state

    # two-candidate MIS: MIS-like, GBH and pairwise (defensive or not) all
    # reduce to the confidence-weighted balance heuristic at two
    # participants (reference: TemporalMISWeight.h)
    ph_t_at_prev = prev_r.target
    m_t = c_t * ph_t_at_prev / (c_t * ph_t_at_prev + c_c * ph_here).clamp_min(1e-12)
    # the canonical sample at the temporal surface
    ph_c_at_prev, _, _ = eval_target(options, *prev_surface, eta_rel,
                                     _sample_of(cur_res))
    m_c = c_c * cur_res.target / (
        c_c * cur_res.target + c_t * torch.where(valid, ph_c_at_prev, 0.0)
    ).clamp_min(1e-12)

    out = Reservoir.empty(n, dev)
    out, rng_state = out.combine(rng_state, prev_r, ph_here, m_t, valid)
    canon_w = m_c * cur_res.target * cur_res.W
    out, rng_state = out.update(
        rng_state, canon_w, cur_res.light_point, cur_res.light_normal,
        cur_res.radiance, cur_res.target, cur_res.is_envmap,
        active & (cur_res.M > 0.0))
    out = out.finalize(normalization=torch.ones((n,), dtype=torch.float32,
                                                device=dev))
    return out.replace(M=M_c + M_t), rng_state


# ------------------------------------------------------------- spatial reuse


def spatial_reuse_pass(options: RenderOptions, settings, scene, mats, gbuf,
                       res: Reservoir, eta_rel, active, width: int,
                       height: int, rng_state, bvh=None,
                       is_last_pass: bool = False, shard=None):
    """One spatial pass: resample from disk neighbours that pass the
    similarity heuristics, under the configured bias correction (reference:
    SpatialReuse.h:64, SpatialMISWeight.h, SpatialNormalizationWeight.h):

      M_WEIGHT_1_OVER_M      confidence weights, biased
      M_WEIGHT_1_OVER_Z      unbiased Z-counting normalization
      MIS_LIKE               confidence resampling, normalized by the
                             winner's target over participant surfaces
      MIS_GBH                generalized balance heuristic ((K+1)² evals)
      PAIRWISE_MIS           pairwise MIS against the canonical sample
      PAIRWISE_MIS_DEFENSIVE the same with the defensive canonical term

    Pixels whose reservoir has M ≤ 1 reuse ``disocclusion_boost_candidates``
    neighbours instead of ``num_spatial_neighbors`` (reference:
    SpatialReuse.h:112-114). Every scheme replays one tap stream. With
    ``restir_di_spatial_visibility_last_pass`` and a ``bvh``, the last
    pass's winner is visibility-tested and its W zeroed if occluded.
    ``shard``: the pixels of the arrays (default: the whole image).
    Returns (reservoir, rng_state)."""
    rs = settings.restir_di
    p = gbuf.position
    ns = gbuf.shading_normal
    wo = gbuf.view_direction
    n = p.shape[0]
    dev = p.device
    pctx = bsdf_proxy_ctx(options, mats, ns, wo) if options.ris_proxy_target else None
    shard = shard or PixelRange.whole(width, height)
    px, py = shard.coords(dev)
    lin2canon = _lin2canon(width, height, dev)
    rough_here = mats.roughness
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    self_idx = shard.index(dev)

    base_nb = int(rs.num_spatial_neighbors)
    boost = int(rs.disocclusion_boost_candidates)
    if boost > 0:
        px_nb = torch.where(res.M <= 1.0, float(max(boost, base_nb)),
                            float(base_nb))
    else:
        px_nb = torch.full((n,), float(base_nb), device=dev)
    loop_nb = max(base_nb, boost if boost > 0 else base_nb)

    radius = float(rs.spatial_radius)
    scheme = options.restir_di_bias_correction
    use_conf = options.restir_di_confidence_weights
    packed_nb = shard.gather_rows(_packed_table(scene, res, gbuf))

    def read_tap(j, tap_rng):
        """Draw one neighbour of the replayed tap stream and read its row.
        Returns (tap_rng, tap dict)."""
        tap_rng, u1 = rng_mod.next_float(tap_rng)
        tap_rng, u2 = rng_mod.next_float(tap_rng)
        r = radius * torch.sqrt(u1)
        theta = 2.0 * math.pi * u2
        ox = (r * torch.cos(theta)).to(torch.int32)
        oy = (r * torch.sin(theta)).to(torch.int32)
        nb_x = (px + ox).clamp(0, width - 1)
        nb_y = (py + oy).clamp(0, height - 1)
        nb_idx = lin2canon[(nb_y * width + nb_x).long()]
        row = packed_nb[nb_idx]
        nb_r = Reservoir.from_columns(row[:, 0:14])
        valid = (active
                 & _similarity_ok(rs, ns, p, rough_here, row[:, 14:17],
                                  row[:, 17:20], row[:, 25])
                 & (row[:, 23] >= 0.0) & (nb_r.M > 0.0)
                 & (nb_idx != self_idx) & (j < px_nb))
        return tap_rng, {"r": nb_r, "row": row, "valid": valid}

    # the replayable tap stream: every loop below sees the same neighbours
    tap_rng0 = rng_mod.pcg_hash(rng_state ^ 0x5F3759DF)

    def taps():
        tap_rng = tap_rng0
        for j in range(loop_nb):
            tap_rng, tap = read_tap(j, tap_rng)
            yield j, tap

    def at_center(sample):
        return eval_target(options, mats, p, ns, wo, eta_rel, sample, pctx)[0]

    def at_neighbour(tap, sample):
        return eval_target(options, *_row_surface(scene, tap["row"]), eta_rel,
                           sample)[0]

    # pre-pass: valid-neighbour count and confidence sum (reference:
    # count_valid_spatial_neighbors)
    valid_cnt, M_sum = zeros, zeros
    for _j, tap in taps():
        valid_cnt = valid_cnt + torch.where(tap["valid"], 1.0, 0.0)
        M_sum = M_sum + torch.where(tap["valid"], tap["r"].M, 0.0)
    M_c = res.M

    if scheme in (ReSTIRBiasCorrection.PAIRWISE_MIS,
                  ReSTIRBiasCorrection.PAIRWISE_MIS_DEFENSIVE):
        # pairwise MIS with confidence weights inside the m-terms (reference:
        # SpatialMISWeight.h PAIRWISE(±DEFENSIVE); "A Gentle Introduction to
        # ReSTIR" Eq. 7.6/7.7)
        defensive = scheme == ReSTIRBiasCorrection.PAIRWISE_MIS_DEFENSIVE
        conf_nb_sum = M_sum if use_conf else ones
        conf_c = M_c if use_conf else ones
        div = ones if use_conf else valid_cnt.clamp_min(1.0)
        out = Reservoir.empty(n, dev)
        m_c_acc = zeros
        m_total = res.M
        for _j, tap in taps():
            valid, nb_r = tap["valid"], tap["r"]
            ph_here = at_center(_sample_of(nb_r))
            conf_i = nb_r.M if use_conf else ones
            t_nb = nb_r.target  # the neighbour's sample at its own surface
            # balance-heuristic denominator for x_i: the neighbour-domain
            # term (lumped through the confidence sum) + the canonical one
            denom = t_nb * conf_nb_sum + (ph_here / div) * conf_c
            m_i = torch.where(denom > 0.0,
                              t_nb * conf_i / denom.clamp_min(1e-12), 0.0)
            if not defensive:
                m_i = m_i / div
            elif use_conf:
                m_i = m_i * conf_nb_sum / (conf_nb_sum + conf_c).clamp_min(1e-12)
            else:
                m_i = m_i / (valid_cnt + 1.0).clamp_min(1.0)
            out, rng_state = out.combine(rng_state, nb_r, ph_here, m_i, valid)
            # the canonical sample at the neighbour's surface
            ph_c_at_nb = at_neighbour(tap, _sample_of(res))
            t_cc = res.target
            nume_mc = (t_cc / div) * conf_c
            denom_mc = ph_c_at_nb * conf_nb_sum + (t_cc / div) * conf_c
            if defensive:
                conf_mult = (conf_i / (conf_c + conf_nb_sum).clamp_min(1e-12)
                             if use_conf else ones)
                term = torch.where(
                    denom_mc > 0.0,
                    nume_mc / denom_mc.clamp_min(1e-12) * conf_mult, 0.0)
            else:
                conf_mult = (conf_i / conf_nb_sum.clamp_min(1e-12)
                             if use_conf else ones)
                term = torch.where(
                    denom_mc > 0.0,
                    nume_mc / denom_mc.clamp_min(1e-12) / div * conf_mult, 0.0)
            m_c_acc = m_c_acc + torch.where(valid, term, 0.0)
            m_total = m_total + torch.where(valid, nb_r.M, 0.0)
        # the canonical MIS weight (reference: resampling_canonical)
        if not defensive:
            m_canon = m_c_acc
        elif use_conf:
            m_canon = m_c_acc + M_c / (M_c + M_sum).clamp_min(1e-12)
        else:
            m_canon = (1.0 + m_c_acc) / (valid_cnt + 1.0).clamp_min(1.0)
        m_canon = torch.where(valid_cnt <= 0.0, 1.0, m_canon)
        out, rng_state = out.update(
            rng_state, m_canon * res.target * res.W, res.light_point,
            res.light_normal, res.radiance, res.target, res.is_envmap,
            active & (res.M > 0.0))
        out = out.finalize(normalization=ones).replace(M=m_total)

    elif scheme == ReSTIRBiasCorrection.MIS_GBH:
        # generalized balance heuristic over the neighbours (the replayed
        # stream) and the canonical sample: m_j = t_j(x_j)·c_j / Σ_k
        # t_k(x_j)·c_k, t_k the target at participant k's surface
        # (reference: SpatialMISWeight.h MIS_GBH)
        conf_c = M_c if use_conf else torch.where(M_c > 0, 1.0, 0.0)

        def denom_for(sample):
            dn = at_center(sample) * conf_c
            for _k, tap in taps():
                conf_k = tap["r"].M if use_conf else 1.0
                dn = dn + torch.where(tap["valid"],
                                      at_neighbour(tap, sample) * conf_k, 0.0)
            return dn

        out = Reservoir.empty(n, dev)
        m_total = res.M
        for _j, tap in taps():
            valid, nb_r = tap["valid"], tap["r"]
            ph_here = at_center(_sample_of(nb_r))
            conf_j = nb_r.M if use_conf else ones
            dn = denom_for(_sample_of(nb_r))
            m_j = torch.where(dn > 0.0,
                              nb_r.target * conf_j / dn.clamp_min(1e-12), 0.0)
            out, rng_state = out.combine(rng_state, nb_r, ph_here, m_j, valid)
            m_total = m_total + torch.where(valid, nb_r.M, 0.0)
        dn_c = denom_for(_sample_of(res))
        m_canon = torch.where(dn_c > 0.0,
                              res.target * conf_c / dn_c.clamp_min(1e-12), 0.0)
        out, rng_state = out.update(
            rng_state, m_canon * res.target * res.W, res.light_point,
            res.light_normal, res.radiance, res.target, res.is_envmap,
            active & (res.M > 0.0))
        out = out.finalize(normalization=ones).replace(M=m_total)

    elif scheme == ReSTIRBiasCorrection.MIS_LIKE:
        # confidence resampling, then normalization by the winner's target
        # over every participant's surface (reference: SpatialMISWeight.h
        # MIS_LIKE + SpatialNormalizationWeight.h:109); the center streams
        # first with its own confidence weight
        conf_c = M_c if use_conf else torch.where(M_c > 0, 1.0, 0.0)
        out = Reservoir.empty(n, dev)
        out, rng_state = out.update(
            rng_state, conf_c * res.target * res.W, res.light_point,
            res.light_normal, res.radiance, res.target, res.is_envmap,
            active & (res.M > 0.0))
        m_total = res.M
        # the selected participant: -1 = the center
        sel = torch.full((n,), -1, dtype=torch.int32, device=dev)
        for j, tap in taps():
            valid, nb_r = tap["valid"], tap["r"]
            ph_here = at_center(_sample_of(nb_r))
            m_w = nb_r.M if use_conf else ones
            out, rng_state, take = out.combine_tracked(rng_state, nb_r, ph_here,
                                                       m_w, valid)
            sel = torch.where(take, j, sel)
            m_total = m_total + torch.where(valid, nb_r.M, 0.0)
        # nume = t_sel(y) (confidence is already in the resampling weight),
        # denom = Σ_j t_j(y)·c_j
        center_ok = (res.M > 0.0) & (out.target > 0.0)
        denom = torch.where(center_ok, out.target * conf_c, 0.0)
        nume = torch.where((sel < 0) & center_ok, out.target, 0.0)
        for j, tap in taps():
            ph_j = at_neighbour(tap, _sample_of(out))
            conf_j = tap["r"].M if use_conf else 1.0
            ok = tap["valid"] & (ph_j > 0.0)
            denom = denom + torch.where(ok, ph_j * conf_j, 0.0)
            nume = nume + torch.where(ok & (sel == j), ph_j, 0.0)
        norm = torch.where(nume > 0.0, denom / nume.clamp_min(1e-12), 1e12)
        out = out.finalize(normalization=norm).replace(M=m_total)

    else:
        # confidence weights: 1/M (biased) or 1/Z (unbiased)
        out = res
        m_total = res.M
        for _j, tap in taps():
            valid, nb_r = tap["valid"], tap["r"]
            ph_here = at_center(_sample_of(nb_r))
            out, rng_state = out.combine(rng_state, nb_r, ph_here, nb_r.M, valid)
            m_total = m_total + torch.where(valid, nb_r.M, 0.0)
        if scheme == ReSTIRBiasCorrection.M_WEIGHT_1_OVER_Z:
            # count the confidence of every participant whose surface could
            # produce the final winner
            z = torch.where(res.target > 0.0, res.M, 0.0)
            for _j, tap in taps():
                ok = tap["valid"] & (at_neighbour(tap, _sample_of(out)) > 0.0)
                z = z + torch.where(ok, tap["r"].M, 0.0)
            out = out.finalize(normalization=z.clamp_min(1e-6)).replace(M=m_total)
        else:
            out = out.replace(M=m_total).finalize()

    # visibility reuse after the last pass (reference: visibility reuse
    # after the final spatial pass)
    if (options.restir_di_spatial_visibility_last_pass and bvh is not None
            and is_last_pass):
        blocked = _occluded(options, bvh, *visibility_rays(
            p, gbuf.geometric_normal, out, active))
        out = out.replace(W=torch.where(blocked, 0.0, out.W))
    return out, rng_state


def fused_spatiotemporal_reuse(options: RenderOptions, settings, scene, mats,
                               gbuf, prev_gbuf, prev_res: Reservoir,
                               cur_res: Reservoir, eta_rel, active,
                               width: int, height: int, prev_view_proj,
                               rng_state, shard=None):
    """One pass that streams the back-projected temporal reservoir and
    spatial neighbours of the previous frame into the initial-candidate
    reservoir, with pairwise-MIS-defensive weights against the canonical
    sample (reference: FusedSpatiotemporalReuse.h:135). Traces nothing.
    ``shard``: the pixels of the current and previous arrays (default: the
    whole image). Returns (reservoir, rng_state)."""
    rs = settings.restir_di
    p = gbuf.position
    ns = gbuf.shading_normal
    wo = gbuf.view_direction
    n = p.shape[0]
    dev = p.device
    pctx = bsdf_proxy_ctx(options, mats, ns, wo) if options.ris_proxy_target else None
    lin2canon = _lin2canon(width, height, dev)

    nx, ny, cw = _back_project(p, prev_view_proj)
    prev_px = ((nx * 0.5 + 0.5) * width).to(torch.int32).clamp(0, width - 1)
    prev_py = ((ny * 0.5 + 0.5) * height).to(torch.int32).clamp(0, height - 1)
    in_screen = _in_screen(nx, ny, cw)
    Kf = float(rs.num_spatial_neighbors) + 1.0
    shard = shard or PixelRange.whole(width, height)
    packed_prev = shard.gather_rows(_packed_table(scene, prev_res, prev_gbuf))

    def tap(rng_state, tap_px, tap_py, tap_valid, out, m_c, m_total):
        idx = lin2canon[(tap_py.clamp(0, height - 1) * width
                         + tap_px.clamp(0, width - 1)).long()]
        row = packed_prev[idx]
        r_n = Reservoir.from_columns(row[:, 0:14]).m_capped(rs.m_cap)
        valid = (tap_valid & active
                 & _similarity_ok(rs, ns, p, mats.roughness, row[:, 14:17],
                                  row[:, 17:20], row[:, 25])
                 & (row[:, 23] >= 0.0) & (r_n.M > 0.0))
        # pairwise MIS; the tap's own-domain target is r_n.target
        ph_here = eval_target(options, mats, p, ns, wo, eta_rel,
                              _sample_of(r_n), pctx)[0]
        m_i = r_n.target / (ph_here + Kf * r_n.target).clamp_min(1e-12)
        m_i = m_i * (Kf / (Kf + 1.0))  # defensive
        out, rng_state = out.combine(rng_state, r_n, ph_here, m_i, valid)
        # the canonical pairing term: our sample at the tap's surface
        ph_at_nb = eval_target(options, *_row_surface(scene, row), eta_rel,
                               _sample_of(cur_res))[0]
        term = cur_res.target / (cur_res.target + Kf * ph_at_nb).clamp_min(1e-12)
        m_c = m_c + torch.where(valid, term, 1.0)
        m_total = m_total + torch.where(valid, r_n.M, 0.0)
        return rng_state, out, m_c, m_total

    out = Reservoir.empty(n, dev)
    m_c = torch.zeros((n,), dtype=torch.float32, device=dev)
    m_total = cur_res.M
    # the temporal center tap
    temporal_ok = in_screen if rs.temporal_enabled else torch.zeros_like(in_screen)
    rng_state, out, m_c, m_total = tap(rng_state, prev_px, prev_py,
                                       temporal_ok, out, m_c, m_total)
    # spatial taps around the reprojected position
    for _ in range(int(rs.num_spatial_neighbors)):
        rng_state, u1, u2 = rng_mod.next_float2(rng_state)
        r = float(rs.spatial_radius) * torch.sqrt(u1)
        theta = 2.0 * math.pi * u2
        ox = (r * torch.cos(theta)).to(torch.int32)
        oy = (r * torch.sin(theta)).to(torch.int32)
        rng_state, out, m_c, m_total = tap(rng_state, prev_px + ox,
                                           prev_py + oy, in_screen, out, m_c,
                                           m_total)
    m_c = m_c / Kf
    m_c = m_c * (Kf / (Kf + 1.0)) + 1.0 / (Kf + 1.0)  # defensive floor
    out, rng_state = out.update(
        rng_state, m_c * cur_res.target * cur_res.W, cur_res.light_point,
        cur_res.light_normal, cur_res.radiance, cur_res.target,
        cur_res.is_envmap, active & (cur_res.M > 0.0))
    out = out.finalize(normalization=torch.ones((n,), dtype=torch.float32,
                                                device=dev))
    return out.replace(M=m_total), rng_state


# ------------------------------------------------------------- final shading


def _toward_winner(p, res: Reservoir):
    """(wi, squared distance, distance: inf for an envmap direction) from
    the points p to each reservoir's sample."""
    to_l = res.light_point - p
    d2 = (to_l * to_l).sum(dim=-1)
    dist = torch.sqrt(d2.clamp_min(1e-12))
    wi = torch.where(res.is_envmap[:, None], res.light_point, to_l / dist[:, None])
    return wi, d2, torch.where(res.is_envmap, float("inf"), dist)


def visibility_rays(p, ng, res: Reservoir, active):
    """(o, d, t_max, active) of the visibility rays from the points p
    (geometric normals ng) toward each reservoir's winner, stopping short of
    the light, active where the winner has weight: the rays of visibility
    reuse and of the last spatial pass."""
    wi, _d2, dist = _toward_winner(p, res)
    t_max = torch.where(torch.isfinite(dist), dist * (1.0 - 1e-3), 1e30)
    return offset_ray_origin(p, ng, wi), wi, t_max, active & (res.W > 0.0)


def final_visibility_rays(gbuf, res: Reservoir, active):
    """visibility_rays from the G-buffer's surfaces, active only where the
    winner also has a target: final shading's rays."""
    o, wi, t_max, has = visibility_rays(gbuf.position, gbuf.geometric_normal,
                                        res, active)
    return o, wi, t_max, has & (res.target > 0.0)


def final_shading(options: RenderOptions, scene, bvh, world, mats, gbuf,
                  res: Reservoir, eta_rel, active, rng_state=None,
                  settings=None, shard=None):
    """Shade each pixel's winning sample with the full BSDF and, with
    ``restir_di_final_visibility``, one visibility ray (reference:
    FinalShading.h:117); ``shard``: the pixel range of the arrays (the
    alpha march's segment skip is its image's). Returns (radiance (N,3),
    the visibility rays that found the light unblocked (() int64),
    rng_state)."""
    p = gbuf.position
    ns = gbuf.shading_normal
    wi, d2, _dist = _toward_winner(p, res)
    cos_i = (ns * wi).sum(dim=-1).clamp_min(0.0)
    cos_l = (res.light_normal * (-wi)).sum(dim=-1).abs()
    f, _ = bsdf_eval(options, mats, ns, gbuf.view_direction, wi,
                     {"eta_rel": eta_rel})
    geom = torch.where(res.is_envmap, 1.0, cos_l / d2.clamp_min(1e-12))
    contrib = f * res.radiance * (cos_i * geom * res.W)[:, None]

    o, _wi, t_max, has = final_visibility_rays(gbuf, res, active)
    n_rays = torch.zeros((), dtype=torch.int64, device=p.device)
    if options.restir_di_final_visibility:
        # alpha-aware with alpha textures and a PCG stream (reference:
        # FilterFunction.h alpha testing applies to ReSTIR's shadow rays
        # too); visibility reuse and the last spatial pass stay alpha-blind,
        # as in the JAX package
        rng_state, blocked = shadow_blocked(
            bvh, scene, o, wi, rng_state, t_max, has,
            tracer(bvh, False, options.use_pallas_traversal), shard)
        has = has & ~blocked
        # as in the JAX package: only the rays that found the light count
        n_rays = has.sum()
    ok = res.sanity_mask()
    return torch.where((has & ok)[:, None], contrib, 0.0), n_rays, rng_state
