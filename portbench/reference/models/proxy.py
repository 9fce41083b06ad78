"""Cheap proxy BSDF for RIS candidate weighting and sampling, mirroring
``hiprt_pt_tpu.models.proxy``.

RIS weights its candidates with this three-lobe proxy and re-evaluates only
the winner with the full principled BSDF; the estimator stays unbiased for
any target that is positive wherever the true BSDF is, which the support
floors guarantee. Lobes, in the local frame (+z = shading normal):
  * diffuse reflection   w_d · base_color/π         (upper hemisphere)
  * GGX specular         w_s · D·G2/(4 cos_o cos_i)  (upper hemisphere)
  * diffuse transmission w_t · base_color/π         (lower hemisphere, for
    transmissive materials)
plus a small floor on each side. The sampler draws the same three lobes
(cosine / VNDF / flipped cosine) and its mixture pdf is exact.
"""

from __future__ import annotations

import math

import torch

from ..core import rng as rng_mod
from ..core.material import get_alphas
from ..ops.sampling import INV_PI, build_onb
from . import microfacet as mf
from .fresnel import fresnel_dielectric

_FLOOR = 1e-4  # support floor (relative to a unit-albedo diffuse lobe)


def _lum(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def _ctx_from_weights(mats, cos_o) -> dict:
    """Candidate-invariant proxy state of a batch of vertices: the lobe
    weights (two Fresnel chains), computed once for all candidates."""
    trans = mats.specular_transmission
    w_metal = mats.metallic
    w_glass = (1.0 - mats.metallic) * trans
    w_base = (1.0 - mats.metallic) * (1.0 - trans)
    F_spec = fresnel_dielectric(cos_o, mats.ior.clamp_min(1.0 + 1e-3))
    Fc = fresnel_dielectric(cos_o, mats.coat_ior.clamp_min(1.0 + 1e-3))
    alb = _lum(mats.base_color).clamp_min(0.05)
    w_diff = w_base * (1.0 - F_spec * mats.specular) * alb
    # one GGX lobe stands in for metal + specular + coat + glass reflection
    spec_rgb = (w_metal[..., None] * mats.base_color
                + (w_base * mats.specular * F_spec + mats.coat * Fc
                   + w_glass * F_spec)[..., None])
    w_trans = w_glass * (1.0 - F_spec) * alb
    ax, ay = get_alphas(mats.roughness.clamp_min(0.04), mats.anisotropy)
    p_s = _lum(spec_rgb)
    tot = (w_diff + p_s + w_trans).clamp_min(1e-8)
    return dict(w_diff=w_diff, spec_rgb=spec_rgb, w_trans=w_trans, ax=ax, ay=ay,
                p_s=p_s, tot=tot)


def make_ctx(mats, n, wo) -> dict:
    """World-frame proxy context; cos_o = |wo·n| is the canonical local
    frame's wo.z."""
    cos_o = (wo * n).sum(dim=-1).abs().clamp_min(1e-6)
    ctx = _ctx_from_weights(mats, cos_o)
    ctx["mats"] = mats
    return ctx


def _eval_core(ctx, wo, wi):
    """Proxy eval of canonical local-frame (wo, wi). Returns (f, pdf)."""
    cos_o = wo[..., 2].clamp_min(1e-6)
    ax, ay = ctx["ax"], ctx["ay"]
    mats = ctx["mats"]
    cos_i = wi[..., 2]
    upper = cos_i > 1e-6
    lower = cos_i < -1e-6

    h = wo + wi
    h = h / torch.linalg.norm(h, dim=-1, keepdim=True).clamp_min(1e-12)
    h = torch.where(h[..., 2:3] < 0.0, -h, h)
    d = mf.ggx_ndf(h, ax, ay)
    g2 = mf.smith_g2_height_correlated(wo, wi, ax, ay)
    spec = torch.where(upper, d * g2 / (4.0 * (cos_o * cos_i).clamp_min(1e-9)), 0.0)
    doth = (wo * h).sum(dim=-1).clamp_min(1e-9)
    pdf_spec = torch.where(upper, mf.vndf_pdf(wo, h, ax, ay) / (4.0 * doth), 0.0)

    base = mats.base_color.clamp_min(0.05)
    transmissive = (mats.specular_transmission > 0.0).to(torch.float32)
    f_up = ((ctx["w_diff"] * INV_PI + _FLOOR)[..., None] * base
            + spec[..., None] * ctx["spec_rgb"])
    f_dn = (ctx["w_trans"] * INV_PI + _FLOOR * transmissive)[..., None] * base
    f = torch.where(upper[..., None], f_up, torch.where(lower[..., None], f_dn, 0.0))

    tot = ctx["tot"]
    pdf = (ctx["w_diff"] / tot * torch.where(upper, cos_i * INV_PI, 0.0)
           + ctx["p_s"] / tot * pdf_spec
           + ctx["w_trans"] / tot * torch.where(lower, -cos_i * INV_PI, 0.0))
    return f, pdf


def _to_local(w, t, b, n):
    return torch.stack([(w * t).sum(dim=-1), (w * b).sum(dim=-1),
                        (w * n).sum(dim=-1)], dim=-1)


def eval_pdf_ctx(ctx, n, wo, wi_world):
    """Per-candidate proxy eval against a context (the frame and the
    below-frame flip are recomputed here)."""
    t, b = build_onb(n)
    wo_l = _to_local(wo, t, b, n)
    wi_l = _to_local(wi_world, t, b, n)
    flip = wo_l[..., 2:3] < 0.0
    return _eval_core(ctx, torch.where(flip, -wo_l, wo_l),
                      torch.where(flip, -wi_l, wi_l))


def _sample_core(ctx, wo, rng_state):
    """Sample the proxy mixture in the canonical local frame. Draws u_sel,
    then (u1, u2). Returns (rng, wi canonical-local, f, pdf)."""
    rng_state, u_sel = rng_mod.next_float(rng_state)
    rng_state, u1, u2 = rng_mod.next_float2(rng_state)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    wi_cos = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                          torch.sqrt((1.0 - u1).clamp_min(0.0))], dim=-1)
    h = mf.sample_vndf(wo, ctx["ax"], ctx["ay"], u1, u2)
    wi_spec = mf.reflect_local(wo, h)
    c_d = ctx["w_diff"] / ctx["tot"]
    c_s = c_d + ctx["p_s"] / ctx["tot"]
    pick_d = u_sel < c_d
    pick_s = ~pick_d & (u_sel < c_s)
    flip_z = torch.tensor([1.0, 1.0, -1.0], dtype=wi_cos.dtype, device=wi_cos.device)
    wi = torch.where(pick_d[..., None], wi_cos,
                     torch.where(pick_s[..., None], wi_spec, wi_cos * flip_z))
    f, pdf = _eval_core(ctx, wo, wi)
    return rng_state, wi, f, pdf


def sample_ctx(ctx, n, wo, rng_state):
    """Per-candidate proxy sample against a context.
    Returns (rng, wi_world (N,3), f (N,3), pdf (N,))."""
    t, b = build_onb(n)
    wo_l = _to_local(wo, t, b, n)
    flip = wo_l[..., 2:3] < 0.0
    rng_state, wi, f, pdf = _sample_core(ctx, torch.where(flip, -wo_l, wo_l),
                                         rng_state)
    wi_l = torch.where(flip, -wi, wi)
    wi_world = wi_l[..., 0:1] * t + wi_l[..., 1:2] * b + wi_l[..., 2:3] * n
    return rng_state, wi_world, f, pdf


def eval_pdf(mats, n, wo, wi):
    """World-frame proxy eval."""
    return eval_pdf_ctx(make_ctx(mats, n, wo), n, wo, wi)


def sample(mats, n, wo, rng_state):
    """World-frame proxy sample. Returns (rng, wi_world, f, pdf)."""
    return sample_ctx(make_ctx(mats, n, wo), n, wo, rng_state)
