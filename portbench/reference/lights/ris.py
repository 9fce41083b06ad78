"""RIS — resampled importance sampling with weighted reservoir sampling,
mirroring ``hiprt_pt_tpu.lights.ris`` (reference: RIS/RIS.h,
RIS_Reservoir.h).

Every candidate x, drawn from the lights or from the BSDF, gets the
Talbot-MIS weight

    w = p_hat(x) / (M_l·p_light(x) + M_b·p_bsdf(x))

where p_hat is the unshadowed (or, with ``ris_use_visibility_target``,
shadowed) target luminance. One winner is kept per vertex by weighted
reservoir sampling, re-evaluated with the full BSDF and shaded with one
visibility ray (in a scene with alpha textures the alpha-aware march of
ops/traverse.py:occluded_alpha, on the same route, its draws after the
candidates'). With ``ris_proxy_target`` the candidates are weighted and
the BSDF candidates drawn by the proxy BSDF (models/proxy.py). The RNG draws
come in the JAX package's order: per light candidate the light draw
(u_sel, u1, u2, u_acc) then the reservoir's u; per BSDF candidate the
sampler's draws then the reservoir's u.
"""

from __future__ import annotations

import torch

from ..core import rng as rng_mod
from ..core.settings import RenderOptions
from ..models.dispatcher import (bsdf_eval, bsdf_proxy_ctx, bsdf_proxy_eval_ctx,
                                 bsdf_proxy_sample_ctx, bsdf_sample)
from ..ops.intersect import offset_ray_origin
from ..ops.pixel_order import PixelRange
from ..ops.routing import tracer
from ..ops.tonemap import luminance
from ..ops.traverse import shadow_blocked
from .light_sampling import (closest_emissive_hit, emissive_pdf_of_direction,
                             sample_emissive_triangle)

# BSDF candidates find their emitter by the dense emissive sweep up to this
# many emissive triangles, else by a closest-hit trace of the whole scene
DENSE_EMISSIVE_MAX = 1024


def ris_direct_lighting(options: RenderOptions, scene, bvh, settings, mats,
                        p, ns, ng, wo, rng_state, active, eta_rel,
                        shadow_coherent: bool = False, shard=None):
    """RIS+WRS direct lighting at a batch of vertices.

    Returns (rng_state, contribution (N,3), rays traced (() int64)).
    ``shadow_coherent``: this wavefront's shadow rays are screen-tile
    coherent (the camera vertex with tile-shared light candidates), so they
    take the coherent route. ``shard``: the pixel range (whole tiles) the
    vertices belong to (ops/pixel_order.py:PixelRange; default: the whole
    wavefront)."""
    trace = tracer(bvh, shadow_coherent, options.use_pallas_traversal)
    n = p.shape[0]
    dev = p.device
    shard = shard or PixelRange.batch(n)
    M_l = int(settings.ris.number_of_light_candidates)
    M_b = int(settings.ris.number_of_bsdf_candidates)
    aux = {"eta_rel": eta_rel}
    pctx = bsdf_proxy_ctx(options, mats, ns, wo) if options.ris_proxy_target else None

    def target_eval(wi):
        if options.ris_proxy_target:
            return bsdf_proxy_eval_ctx(options, pctx, mats, ns, wo, wi, aux)
        return bsdf_eval(options, mats, ns, wo, wi, aux)

    res = dict(
        w_sum=torch.zeros((n,), dtype=torch.float32, device=dev),
        radiance=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        p_hat=torch.zeros((n,), dtype=torch.float32, device=dev),
        wi=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        dist=torch.full((n,), float("inf"), dtype=torch.float32, device=dev),
    )
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)

    def wrs_update(res, rng_state, w, radiance, p_hat, wi, dist, valid):
        w = torch.where(valid & (p_hat > 0.0), w, 0.0)
        new_sum = res["w_sum"] + w
        rng_state, u = rng_mod.next_float(rng_state)
        take = (u * new_sum < w) & (w > 0.0)
        return dict(
            w_sum=new_sum,
            radiance=torch.where(take[..., None], radiance, res["radiance"]),
            p_hat=torch.where(take, p_hat, res["p_hat"]),
            wi=torch.where(take[..., None], wi, res["wi"]),
            dist=torch.where(take, dist, res["dist"]),
        ), rng_state

    # --- light candidates ---
    tile = options.ris_tile_light_candidates or None
    for _ in range(M_l):
        rng_state, ls = sample_emissive_triangle(
            scene, p, rng_state, tile_size=tile,
            wavefront_size=shard.num_pixels)
        wi = ls["wi"]
        cos_i = (ns * wi).sum(dim=-1)
        f, pdf_b = target_eval(wi)
        p_hat = luminance(f * ls["radiance"]) * cos_i.clamp_min(0.0)
        valid = active & ls["valid"] & (cos_i > 0.0) & (ls["pdf"] > 0.0)
        if options.ris_use_visibility_target:
            so = offset_ray_origin(p, ng, wi)
            cand = valid & (p_hat > 0.0)
            blocked = trace(bvh, so, wi, t_min=1e-4,
                            t_max=ls["dist"] * (1.0 - 1e-3), active=cand,
                            any_hit=True).prim >= 0
            p_hat = torch.where(blocked, 0.0, p_hat)
            n_rays = n_rays + (valid & (p_hat >= 0.0)).sum()
        w = p_hat / (M_l * ls["pdf"] + M_b * pdf_b).clamp_min(1e-12)
        res, rng_state = wrs_update(res, rng_state, w, ls["radiance"], p_hat,
                                    wi, ls["dist"], valid)

    # --- BSDF candidates: find the emitter each direction reaches ---
    rows = scene.emissive_rows
    for _ in range(M_b):
        if options.ris_proxy_target:
            rng_state, wi, f, pdf_b = bsdf_proxy_sample_ctx(
                options, pctx, mats, ns, wo, rng_state, aux)
        else:
            rng_state, wi, f, pdf_b, _s_aux = bsdf_sample(
                options, mats, ns, wo, rng_state, aux)
        cos_i = (ns * wi).sum(dim=-1)
        cand = active & (pdf_b > 0.0) & (cos_i > 0.0)
        o = offset_ray_origin(p, ng, wi)
        if 0 < rows.shape[0] <= DENSE_EMISSIVE_MAX:
            # occluders are ignored here; the winner's visibility ray
            # settles occlusion
            t_e, slot = closest_emissive_hit(scene, o, wi, active=cand)
            valid = cand & (slot >= 0)
            row = rows[slot.clamp_min(0)]
            radiance = row[:, 14:17]
            cos_l = (row[:, 9:12] * (-wi)).sum(dim=-1).abs()
            pdf_l = (row[:, 13] / row[:, 12].clamp_min(1e-12)
                     * (t_e * t_e) / cos_l.clamp_min(1e-8))
            pdf_l = torch.where(valid & torch.isfinite(pdf_l), pdf_l, 0.0)
            dist = t_e
        else:
            rec = trace(bvh, o, wi, t_min=0.0, active=cand)
            pdf_l, is_em = emissive_pdf_of_direction(scene, o, rec.prim, rec.t, wi)
            em = scene.materials.fields_at(
                scene.material_ids[rec.prim.clamp_min(0).long()],
                ("emission", "emission_strength"))
            radiance = em["emission"] * em["emission_strength"][..., None]
            valid = cand & (rec.prim >= 0) & is_em
            dist = rec.t
        p_hat = luminance(f * radiance) * cos_i.clamp_min(0.0)
        w = p_hat / (M_l * pdf_l + M_b * pdf_b).clamp_min(1e-12)
        res, rng_state = wrs_update(res, rng_state, w, radiance, p_hat, wi,
                                    dist, valid)
        n_rays = n_rays + cand.sum()

    # --- final shading: one exact BSDF eval of the winner, one visibility ray
    W = res["w_sum"] / res["p_hat"].clamp_min(1e-12)
    has_winner = active & (res["p_hat"] > 0.0) & (res["w_sum"] > 0.0)
    f_true, _pdf = bsdf_eval(options, mats, ns, wo, res["wi"], aux)
    cos_w = (ns * res["wi"]).sum(dim=-1).clamp_min(0.0)
    integrand = f_true * res["radiance"] * cos_w[..., None]
    so = offset_ray_origin(p, ng, res["wi"])
    t_max_w = torch.where(torch.isfinite(res["dist"]),
                          res["dist"] * (1.0 - 1e-3), 1e30)
    # alpha-aware with alpha textures, on the same route (reference:
    # FilterFunction.h applies the stochastic alpha test to every shadow ray)
    rng_state, blocked = shadow_blocked(bvh, scene, so, res["wi"], rng_state,
                                        t_max_w, has_winner, trace, shard)
    n_rays = n_rays + has_winner.sum()
    contrib = torch.where((has_winner & ~blocked)[..., None],
                          integrand * W[..., None], 0.0)
    # minimum-contribution culling (reference: RIS.h:292-304)
    if settings.minimum_light_contribution > 0.0:
        strong = luminance(contrib) >= settings.minimum_light_contribution
        contrib = torch.where(strong[..., None], contrib, 0.0)
    return rng_state, contrib, n_rays
