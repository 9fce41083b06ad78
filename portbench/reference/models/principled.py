"""Layered principled BSDF — eval, pdf and sample for a batch of hits,
mirroring ``hiprt_pt_tpu.models.principled`` (reference: Principled.h).

Lobe model:
  f = coat·f_coat
    + coat_att · [ sheen·f_sheen
                 + metallic·f_metal(F82 tint, thin film)
                 + (1-metallic)·trans·f_glass(Walter07 reflect+refract)
                 + (1-metallic)·(1-trans)·(f_specular + (1-F)·f_diffuse(ON)) ]
with multiple-scattering energy compensation from the baked tables in
``bake/`` (or their fitted polynomials, the default). Every lobe is
evaluated for the whole batch and blended by weights; ``sample`` picks one
lobe per ray from the lobe-probability CDF and returns the full eval and
the probability-weighted pdf of all lobes (one-sample MIS), so sample and
eval agree exactly.

The polynomial fits of the tables run in numpy at import with the JAX
package's code, so their coefficients are identical.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.material import get_alphas, oren_nayar_AB, thin_walled_roughness
from ..core.settings import GGXSamplingVariant, RenderOptions
from ..ops.sampling import INV_PI, build_onb
from . import microfacet as mf
from .fresnel import f82_tint, fresnel_dielectric

_BAKE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "bake")


def _load(name):
    return np.load(os.path.join(_BAKE, name)).astype(np.float32)


# GGX single-scattering directional albedo Ess(roughness, cos) (32 x 32)
_GGX_ESS = _load("data_ggx_conductor_ess_32.npy")
# fitted sheen LTC (Ai, Bi, R) as 8x8 Chebyshev polynomials over
# (cos_theta_o, alpha)
_SHEEN_LTC_POLY = _load("data_sheen_ltc_poly.npy")
# glass Ess tables over (ior, roughness, cos), on this IOR grid
_GLASS_IORS = np.asarray([1.1, 1.2, 1.3, 1.4, 1.5, 1.7, 2.0, 2.5], np.float32)
_GLASS_ESS = _load("data_ggx_glass_ess_16.npy")
_GLASS_INV_ESS = _load("data_ggx_glass_inv_ess_16.npy")
_THIN_GLASS_ESS = _load("data_ggx_thin_glass_ess_16.npy")
_GLOSSY_BASE_ESS = _load("data_glossy_base_ess_16.npy")
# (selector, ior, rough, cos): 0 entering, 1 exiting, 2 thin, 3 glossy base
_GLASS_ALL = np.stack([_GLASS_ESS, _GLASS_INV_ESS, _THIN_GLASS_ESS,
                       _GLOSSY_BASE_ESS], 0)


def _fit_glass_poly():
    """(5,5,3)-degree tensor-polynomial least-squares fit of each glass
    table over (roughness, cos, ior) — the JAX package's fit."""
    res = _GLASS_ESS.shape[1]
    cos = (np.arange(res) + 0.5) / res
    rough = (np.arange(res) + 0.5) / res
    iorp = (_GLASS_IORS - 1.0) / 1.5
    DR, DC, DI = 5, 5, 3
    II, RR, CC = np.meshgrid(iorp, rough, cos, indexing="ij")

    def design(r_, c_, i_):
        cols = []
        for a in range(DR):
            for b in range(DC):
                for g in range(DI):
                    cols.append((r_ ** a) * (c_ ** b) * (i_ ** g))
        return np.stack(cols, -1)

    A = design(RR.ravel(), CC.ravel(), II.ravel())
    coefs = []
    for t in (_GLASS_ESS, _GLASS_INV_ESS, _THIN_GLASS_ESS, _GLOSSY_BASE_ESS):
        y = np.clip(t, 0.2, 1.0).ravel()
        c, *_ = np.linalg.lstsq(A, y, rcond=None)
        coefs.append(c.astype(np.float32))
    return np.stack(coefs, 0), (DR, DC, DI)


_GLASS_POLY, _GLASS_POLY_DEG = _fit_glass_poly()


def _glass_ess_poly(rough, cos_o, ior, sel):
    """The fitted glass polynomial; sel is a Python int or an (N,) int
    tensor picking the table per ray."""
    DR, DC, DI = _GLASS_POLY_DEG
    ip = torch.clamp((ior - 1.0) / 1.5, 0.0, 1.0)
    out = torch.zeros_like(rough)
    k = 0
    ra = torch.ones_like(rough)
    for _a in range(DR):
        cb = torch.ones_like(cos_o)
        for _b in range(DC):
            ig = torch.ones_like(ip)
            for _g in range(DI):
                if isinstance(sel, int):
                    ck = float(_GLASS_POLY[sel, k])
                else:
                    c = [float(_GLASS_POLY[j, k]) for j in range(4)]
                    ck = torch.where(sel == 0, c[0], torch.where(
                        sel == 1, c[1], torch.where(sel == 2, c[2], c[3])))
                out = out + ck * ra * cb * ig
                k += 1
                ig = ig * ip
            cb = cb * cos_o
        ra = ra * rough
    return torch.clamp(out, 0.2, 1.0)


def _fit_conductor_poly():
    """(7,7)-degree least-squares fit of the conductor table — the JAX
    package's fit."""
    res_r, res_c = _GGX_ESS.shape
    rough = (np.arange(res_r) + 0.5) / res_r
    cos = (np.arange(res_c) + 0.5) / res_c
    DR, DC = 7, 7
    RR, CC = np.meshgrid(rough, cos, indexing="ij")
    A = np.stack([(RR.ravel() ** a) * (CC.ravel() ** b)
                  for a in range(DR) for b in range(DC)], -1)
    y = np.clip(_GGX_ESS, 0.05, 1.0).ravel()
    c, *_ = np.linalg.lstsq(A, y, rcond=None)
    return c.astype(np.float32), (DR, DC)


_CONDUCTOR_POLY, _CONDUCTOR_POLY_DEG = _fit_conductor_poly()


def _ess_poly(rough, cos_o):
    """Fitted-polynomial conductor Ess(roughness, cos)."""
    DR, DC = _CONDUCTOR_POLY_DEG
    out = torch.zeros_like(rough)
    k = 0
    ra = torch.ones_like(rough)
    for _a in range(DR):
        cb = torch.ones_like(cos_o)
        for _b in range(DC):
            out = out + float(_CONDUCTOR_POLY[k]) * ra * cb
            k += 1
            cb = cb * cos_o
        ra = ra * rough
    return torch.clamp(out, 0.05, 1.0)


def _table(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(x).to(like.device)


def _ess_lookup(rough, cos_o):
    """Bilinear lookup of the conductor Ess(roughness, cos); args in [0,1]."""
    res_r, res_c = _GGX_ESS.shape
    table = _table(_GGX_ESS.reshape(-1), rough)
    r = torch.clamp(rough * res_r - 0.5, 0.0, res_r - 1.0)
    c = torch.clamp(cos_o * res_c - 0.5, 0.0, res_c - 1.0)
    r0 = torch.floor(r).to(torch.int64)
    c0 = torch.floor(c).to(torch.int64)
    r1 = torch.clamp_max(r0 + 1, res_r - 1)
    c1 = torch.clamp_max(c0 + 1, res_c - 1)
    fr = r - r0
    fc = c - c0
    return (table[r0 * res_c + c0] * (1 - fr) * (1 - fc)
            + table[r0 * res_c + c1] * (1 - fr) * fc
            + table[r1 * res_c + c0] * fr * (1 - fc)
            + table[r1 * res_c + c1] * fr * fc)


def _glass_ess_lookup(rough, cos_o, ior, sel):
    """Trilinear lookup of the (selector, ior, rough, cos) glass stack; sel
    (N,) int picks the table per ray; ior = max(eta, 1/eta) >= 1."""
    n_sel, n_ior, res_r, res_c = _GLASS_ALL.shape
    flat = _table(_GLASS_ALL.reshape(-1), rough)
    iors = _table(_GLASS_IORS, rough)
    sel_off = sel.to(torch.int64) * n_ior
    k = torch.clamp((ior[..., None] >= iors).to(torch.int64).sum(-1) - 1,
                    0, n_ior - 2)
    i0 = iors[k]
    i1 = iors[k + 1]
    fi = torch.clamp((ior - i0) / torch.clamp_min(i1 - i0, 1e-6), 0.0, 1.0)
    r = torch.clamp(rough * res_r - 0.5, 0.0, res_r - 1.0)
    c = torch.clamp(cos_o * res_c - 0.5, 0.0, res_c - 1.0)
    r0 = torch.floor(r).to(torch.int64)
    c0 = torch.floor(c).to(torch.int64)
    r1 = torch.clamp_max(r0 + 1, res_r - 1)
    c1 = torch.clamp_max(c0 + 1, res_c - 1)
    fr = r - r0
    fc = c - c0

    def at(kk, rr, cc):
        return flat[((sel_off + kk) * res_r + rr) * res_c + cc]

    def bil(kk):
        return (at(kk, r0, c0) * (1 - fr) * (1 - fc)
                + at(kk, r0, c1) * (1 - fr) * fc
                + at(kk, r1, c0) * fr * (1 - fc)
                + at(kk, r1, c1) * fr * fc)

    return bil(k) * (1 - fi) + bil(k + 1) * fi


def _to_local(n, w):
    t, b = build_onb(n)
    return torch.stack([(w * t).sum(dim=-1), (w * b).sum(dim=-1),
                        (w * n).sum(dim=-1)], dim=-1)


def _to_world(n, w):
    t, b = build_onb(n)
    return w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n


def _lum(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def _normalize(v):
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-12)


# ---------------------------------------------------------------- lobes


def _ggx_reflection_lobe(wo, wi, ax, ay):
    """GGX reflection D·G2/(4 cos_o cos_i) without Fresnel, and its VNDF
    pdf; zero unless wo.z > 0 and wi.z > 0."""
    valid = (wo[..., 2] > 1e-6) & (wi[..., 2] > 1e-6)
    h = _normalize(wo + wi)
    h = torch.where(h[..., 2:3] < 0.0, -h, h)
    d = mf.ggx_ndf(h, ax, ay)
    g2 = mf.smith_g2_height_correlated(wo, wi, ax, ay)
    denom = 4.0 * torch.clamp_min(wo[..., 2] * wi[..., 2], 1e-9)
    spec = torch.where(valid, d * g2 / denom, 0.0)
    doth = torch.clamp_min((wo * h).sum(dim=-1), 1e-9)
    pdf = torch.where(valid, mf.vndf_pdf(wo, h, ax, ay) / (4.0 * doth), 0.0)
    cos_h = (wo * h).sum(dim=-1)
    return spec, pdf, cos_h, valid


def _sheen_ltc_params(cos_o, sheen_roughness):
    """(Ai, Bi, R) of the fitted sheen LTC at (cos_theta_o, alpha)."""
    deg = _SHEEN_LTC_POLY.shape[1]

    def cheb(x):
        t = 2.0 * torch.clamp(x, 0.0, 1.0) - 1.0
        Ts = [torch.ones_like(t), t]
        for _ in range(2, deg):
            Ts.append(2.0 * t * Ts[-1] - Ts[-2])
        return Ts[:deg]

    Tc = cheb(cos_o)
    Ta = cheb(sheen_roughness)
    out = []
    for ch in range(3):
        co = _SHEEN_LTC_POLY[ch]
        acc = 0.0
        for i in range(deg):
            row = 0.0
            for j in range(deg):
                row = row + float(co[i, j]) * Ta[j]
            acc = acc + row * Tc[i]
        out.append(acc)
    Ai = torch.clamp_min(out[0], 1e-3)
    Bi = out[1]
    R = torch.clamp(out[2], 0.0, 1.0)
    return Ai, Bi, R


def _sheen_view_frame(wo):
    """cos/sin of the view azimuth (the LTC is fitted with the view at
    phi = 0)."""
    rho = torch.sqrt(wo[..., 0] ** 2 + wo[..., 1] ** 2)
    safe = rho > 1e-8
    c = torch.where(safe, wo[..., 0] / torch.clamp_min(rho, 1e-8), 1.0)
    s = torch.where(safe, wo[..., 1] / torch.clamp_min(rho, 1e-8), 0.0)
    return c, s


def _sheen_lobe(wo, wi, sheen_roughness):
    """Fitted-LTC sheen (reference: SheenLTC.h eval): f = R·D(wi)/cos_i,
    pdf = D."""
    valid = (wo[..., 2] > 1e-6) & (wi[..., 2] > 1e-6)
    Ai, Bi, R = _sheen_ltc_params(wo[..., 2], sheen_roughness)
    c, s = _sheen_view_frame(wo)
    x = c * wi[..., 0] + s * wi[..., 1]
    y = -s * wi[..., 0] + c * wi[..., 1]
    z = wi[..., 2]
    xp = x * Ai + z * Bi
    yp = y * Ai
    l2 = torch.clamp_min(xp * xp + yp * yp + z * z, 1e-12)
    Do = z * Ai * Ai / (math.pi * l2 * l2)
    Do = torch.where(valid & (Do > 0.0) & torch.isfinite(Do), Do, 0.0)
    f = R * Do / torch.clamp_min(wi[..., 2], 1e-8)
    return torch.where(valid, f, 0.0), Do


def _sheen_sample(wo, sheen_roughness, u1, u2):
    """Sample the sheen LTC: cosine-sample, map through M, rotate back to
    the view azimuth (reference: SheenLTC.h sample)."""
    Ai, Bi, R = _sheen_ltc_params(wo[..., 2], sheen_roughness)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    cx = r * torch.cos(phi)
    cy = r * torch.sin(phi)
    cz = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    inv_Ai = 1.0 / Ai
    v = _normalize(torch.stack([(cx - cz * Bi) * inv_Ai, cy * inv_Ai, cz], dim=-1))
    c, s = _sheen_view_frame(wo)
    return torch.stack([c * v[..., 0] - s * v[..., 1],
                        s * v[..., 0] + c * v[..., 1], v[..., 2]], dim=-1)


def _diffuse_lobe(base_color, sigma, wo, wi):
    """Oren-Nayar diffuse in the local frame."""
    cos_o = wo[..., 2]
    cos_i = wi[..., 2]
    valid = (cos_i > 1e-6) & (cos_o > 1e-6)
    A, B = oren_nayar_AB(sigma)
    sin_o = torch.sqrt(torch.clamp_min(1.0 - cos_o * cos_o, 0.0))
    sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
    denom = torch.clamp_min(sin_i * sin_o, 1e-7)
    cos_dphi = torch.clamp(
        (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) / denom, -1.0, 1.0)
    sin_alpha = torch.maximum(sin_i, sin_o)
    tan_beta = torch.minimum(sin_i, sin_o) / torch.clamp_min(
        torch.minimum(cos_i, cos_o), 1e-7)
    fr = INV_PI * (A + B * torch.clamp_min(cos_dphi, 0.0) * sin_alpha * tan_beta)
    f = torch.where(valid[..., None], base_color * fr[..., None], 0.0)
    pdf = torch.where(valid, cos_i * INV_PI, 0.0)
    return f, pdf


def _glass_lobe(base_color, wo, wi, ax, ay, eta_rel):
    """Rough dielectric (Walter et al. 2007), reflection + refraction;
    eta_rel = n_transmitted / n_incident. Returns (f (N,3), pdf (N,))."""
    cos_o = wo[..., 2]
    cos_i = wi[..., 2]
    is_reflect = cos_i > 0.0
    h_r = _normalize(wo + wi)
    h_r = torch.where(h_r[..., 2:3] < 0.0, -h_r, h_r)
    h_t = _normalize(-(wo + eta_rel[..., None] * wi))
    h_t = torch.where(h_t[..., 2:3] < 0.0, -h_t, h_t)
    h = torch.where(is_reflect[..., None], h_r, h_t)
    doth_o = (wo * h).sum(dim=-1)
    doth_i = (wi * h).sum(dim=-1)

    F = fresnel_dielectric(doth_o.abs(), eta_rel)
    d = mf.ggx_ndf(h, ax, ay)
    g2 = mf.smith_g2_height_correlated(
        wo, torch.where(is_reflect[..., None], wi, -wi), ax, ay)
    vpdf = mf.vndf_pdf(wo, h, ax, ay)

    denom_r = 4.0 * torch.clamp_min((cos_o * cos_i).abs(), 1e-9)
    f_r = F * d * g2 / denom_r
    pdf_r = F * vpdf / (4.0 * torch.clamp_min(doth_o.abs(), 1e-9))

    # transmission (Walter eq. 21), radiance transport from the camera
    jac_denom = torch.square(doth_o + eta_rel * doth_i)
    common = ((doth_o * doth_i).abs()
              / torch.clamp_min((cos_o * cos_i).abs(), 1e-9)
              * d * g2 / torch.clamp_min(jac_denom, 1e-12))
    f_t = (1.0 - F) * common
    jac_t = eta_rel * eta_rel * doth_i.abs() / torch.clamp_min(jac_denom, 1e-12)
    pdf_t = (1.0 - F) * vpdf * jac_t

    valid_o = cos_o > 1e-6
    f_scalar = torch.where(valid_o, torch.where(is_reflect, f_r, f_t), 0.0)
    pdf = torch.where(valid_o, torch.where(is_reflect, pdf_r, pdf_t), 0.0)
    # refraction is tinted by the base colour
    tint = torch.where(is_reflect[..., None], torch.ones_like(base_color), base_color)
    return f_scalar[..., None] * tint, pdf


# ------------------------------------------------- lobe weights/probabilities


def _lobe_setup(options: RenderOptions, mats, wo):
    """Per-ray lobe sampling probabilities (normalized) and weights."""
    cos_o = wo[..., 2].abs()
    trans = mats.specular_transmission
    w_coat = mats.coat
    w_metal = mats.metallic
    w_glass = (1.0 - mats.metallic) * trans
    w_base = (1.0 - mats.metallic) * (1.0 - trans)
    w_sheen = mats.sheen

    eta_spec = torch.clamp_min(mats.ior, 1.0 + 1e-3)
    F_spec = fresnel_dielectric(cos_o, eta_spec) * mats.specular
    Fc = fresnel_dielectric(cos_o, torch.clamp_min(mats.coat_ior, 1.0 + 1e-3))
    f_metal_approx = _lum(f82_tint(mats.base_color, mats.metallic_F82,
                                   mats.metallic_F90,
                                   mats.metallic_F90_falloff_exponent, cos_o))

    p_coat = w_coat * Fc
    p_sheen = w_sheen * 0.08
    p_metal = w_metal * torch.clamp_min(f_metal_approx, 0.05)
    p_glass = w_glass
    p_spec = w_base * F_spec
    p_diff = w_base * (1.0 - F_spec) * torch.clamp_min(_lum(mats.base_color), 0.05)

    total = torch.clamp_min(p_coat + p_sheen + p_metal + p_glass + p_spec + p_diff,
                            1e-8)
    probs = [p_coat / total, p_sheen / total, p_metal / total, p_glass / total,
             p_spec / total, p_diff / total]
    weights = dict(coat=w_coat, sheen=w_sheen, metal=w_metal, glass=w_glass,
                   base=w_base)
    return probs, weights


def _eval_lobes(options: RenderOptions, mats, wo, wi, eta_rel):
    """Every lobe. Returns (f_total (N,3), [pdf per lobe (N,)] x 6) in the
    order coat, sheen, metal, glass, specular, diffuse."""
    # anisotropy rotation spins the tangent frame
    rot = mats.anisotropy_rotation * math.pi
    wo = mf.anisotropy_rotate(wo, rot)
    wi = mf.anisotropy_rotate(wi, rot)
    ax, ay = get_alphas(mats.roughness, mats.anisotropy)
    cax, cay = get_alphas(mats.coat_roughness, mats.coat_anisotropy)
    cos_o = wo[..., 2].abs()
    cos_i_signed = wi[..., 2]
    coat_eta = torch.clamp_min(mats.coat_ior, 1.0 + 1e-3)

    # coat: white dielectric GGX reflection
    spec_c, pdf_c, cosh_c, _ = _ggx_reflection_lobe(wo, wi, cax, cay)
    Fc_h = fresnel_dielectric(torch.clamp_min(cosh_c, 0.0), coat_eta)
    f_coat = (spec_c * Fc_h)[..., None] * torch.ones_like(mats.base_color)

    # coat attenuation of everything below: two crossings, darkening, and
    # Beer-Lambert absorption over the in-coat path
    Fc_o = fresnel_dielectric(cos_o, coat_eta)
    Fc_i = fresnel_dielectric(cos_i_signed.abs(), coat_eta)
    coat_att = 1.0 - mats.coat * (0.5 * (Fc_o + Fc_i) * mats.coat_darkening)
    coat_path = mats.coat_medium_thickness * 0.01 * (
        1.0 / torch.clamp_min(cos_o, 0.1)
        + 1.0 / torch.clamp_min(cos_i_signed.abs(), 0.1))
    coat_tint = torch.exp(
        torch.log(torch.clamp(mats.coat_medium_absorption, 1e-3, 1.0))
        * coat_path[..., None])
    coat_att_rgb = coat_att[..., None] * (
        (1.0 - mats.coat[..., None]) + mats.coat[..., None] * coat_tint)

    # sheen
    f_sh_s, pdf_sh = _sheen_lobe(wo, wi, mats.sheen_roughness)
    f_sheen = f_sh_s[..., None] * mats.sheen_color

    # metal: two GGX lobes (second roughness) sharing the Fresnel
    spec_m1, pdf_m1, cosh_m, _ = _ggx_reflection_lobe(wo, wi, ax, ay)
    ax2, ay2 = get_alphas(mats.second_roughness, mats.anisotropy)
    spec_m2, pdf_m2, _, _ = _ggx_reflection_lobe(wo, wi, ax2, ay2)
    w2 = mats.second_roughness_weight
    spec_m = (1.0 - w2) * spec_m1 + w2 * spec_m2
    pdf_m = (1.0 - w2) * pdf_m1 + w2 * pdf_m2
    F_metal = f82_tint(mats.base_color, mats.metallic_F82, mats.metallic_F90,
                       mats.metallic_F90_falloff_exponent,
                       torch.clamp_min(cosh_m, 0.0))
    if options.do_thin_film:
        from .thin_film import thin_film_reflectance

        tf_base_ior = torch.where(mats.thin_film_do_ior_override > 0.5,
                                  mats.thin_film_base_ior_override,
                                  torch.clamp_min(mats.ior, 1.0 + 1e-3))
        F_tf = thin_film_reflectance(
            torch.clamp_min(cosh_m, 0.0), mats.thin_film_ior,
            mats.thin_film_thickness, tf_base_ior,
            mats.thin_film_hue_shift_degrees)
        F_metal = ((1.0 - mats.thin_film[..., None]) * F_metal
                   + mats.thin_film[..., None] * F_tf)
    f_metal = spec_m[..., None] * F_metal
    if options.do_energy_compensation:
        # Turquin 2019, symmetric in (wo, wi): boost by (1-E)/E with
        # E = sqrt(Ess(mu_o) Ess(mu_i))
        if options.glass_compensation_exact:
            E_o = _ess_lookup(mats.roughness, wo[..., 2].abs())
            E_i = _ess_lookup(mats.roughness, wi[..., 2].abs())
        else:
            E_o = _ess_poly(mats.roughness, wo[..., 2].abs())
            E_i = _ess_poly(mats.roughness, wi[..., 2].abs())
        E = torch.sqrt(torch.clamp(E_o * E_i, 1e-3, 1.0))
        ms_boost = 1.0 + mats.base_color * ((1.0 - E) / E)[..., None]
        f_metal = f_metal * ms_boost

    # glass: a thin-walled surface transmits straight through (eta ~ 1) with
    # the remapped roughness of a double interface
    r_thin = thin_walled_roughness(mats.thin_walled, mats.roughness,
                                   torch.clamp_min(eta_rel, 1.0 + 1e-3))
    axt, ayt = get_alphas(r_thin, mats.anisotropy)
    thin = mats.thin_walled > 0.5
    ax_g = torch.where(thin, axt, ax)
    ay_g = torch.where(thin, ayt, ay)
    eta_g = torch.where(thin, 1.0 + 1e-3, eta_rel)
    f_glass, pdf_g = _glass_lobe(mats.base_color, wo, wi, ax_g, ay_g, eta_g)
    if options.do_energy_compensation:
        ior_key = torch.clamp_min(
            torch.maximum(eta_rel, 1.0 / torch.clamp_min(eta_rel, 1e-3)), 1.0 + 1e-3)
        entering = eta_rel >= 1.0
        r_key = torch.where(thin, r_thin, mats.roughness)
        sel = torch.where(thin, 2, torch.where(entering, 0, 1)).to(torch.int32)
        # keyed on wo only (wi lies on the other side of the interface)
        if options.glass_compensation_exact:
            Eg = _glass_ess_lookup(r_key, wo[..., 2].abs(), ior_key, sel)
        else:
            Eg = _glass_ess_poly(r_key, wo[..., 2].abs(), ior_key, sel)
        Eg = torch.clamp(Eg, 1e-2, 1.0)
        f_glass = f_glass * (1.0 / Eg)[..., None]

    # specular dielectric reflection on the base
    ior_b = torch.clamp_min(mats.ior, 1.0 + 1e-3)
    F_s_h = fresnel_dielectric(torch.clamp_min(cosh_m, 0.0), ior_b)
    f_spec = (spec_m * F_s_h * mats.specular)[..., None] * (
        mats.specular_color * mats.specular_tint[..., None]
        + (1.0 - mats.specular_tint[..., None]))
    pdf_s = pdf_m

    # diffuse under the specular layer, with (1-F) on both sides
    Fo = fresnel_dielectric(cos_o, ior_b)
    Fi = fresnel_dielectric(cos_i_signed.abs(), ior_b)
    f_diff, pdf_d = _diffuse_lobe(mats.base_color, mats.oren_nayar_sigma, wo, wi)
    f_diff = f_diff * ((1.0 - Fo * mats.specular) * (1.0 - Fi * mats.specular))[..., None]

    if options.do_energy_compensation:
        # glossy-base layer: boost specular + diffuse by the reciprocal of
        # the layer's albedo, lerped by `specular`, faded by thin film
        if options.glass_compensation_exact:
            E_gb = _glass_ess_lookup(mats.roughness, cos_o, ior_b,
                                     torch.full_like(cos_o, 3, dtype=torch.int32))
        else:
            E_gb = _glass_ess_poly(mats.roughness, cos_o, ior_b, 3)
        E_gb = torch.clamp(E_gb, 0.2, 1.0)
        boost_gb = 1.0 / (1.0 + mats.specular * (E_gb - 1.0))
        boost_gb = boost_gb + mats.thin_film * (1.0 - boost_gb)
        f_spec = f_spec * boost_gb[..., None]
        f_diff = f_diff * boost_gb[..., None]

    trans = mats.specular_transmission
    w_metal = mats.metallic
    w_glass = (1.0 - mats.metallic) * trans
    w_base = (1.0 - mats.metallic) * (1.0 - trans)
    f_total = mats.coat[..., None] * f_coat + coat_att_rgb * (
        mats.sheen[..., None] * f_sheen
        + w_metal[..., None] * f_metal
        + w_glass[..., None] * f_glass
        + w_base[..., None] * (f_spec + f_diff))
    if options.do_energy_compensation:
        # clearcoat layer: boost the whole stack by the reciprocal of the
        # coat-over-base albedo, lerped by coat·(1-transmission)
        ior_c = coat_eta
        if options.glass_compensation_exact:
            E_c = _glass_ess_lookup(mats.coat_roughness, cos_o, ior_c,
                                    torch.full_like(cos_o, 3, dtype=torch.int32))
        else:
            E_c = _glass_ess_poly(mats.coat_roughness, cos_o, ior_c, 3)
        E_c = torch.clamp(E_c, 0.2, 1.0)
        w_cc = mats.coat * (1.0 - mats.specular_transmission)
        boost_c = 1.0 / (1.0 + w_cc * (E_c - 1.0))
        boost_c = boost_c + mats.thin_film * (1.0 - boost_c)
        f_total = f_total * boost_c[..., None]
    return f_total, [pdf_c, pdf_sh, pdf_m, pdf_g, pdf_s, pdf_d]


def _eta_rel(mats, aux):
    if aux and "eta_rel" in aux:
        return aux["eta_rel"]
    return torch.clamp_min(mats.ior, 1.0 + 1e-3)


def eval_pdf(options: RenderOptions, mats, n, wo, wi, aux=None):
    """World-frame eval. aux['eta_rel'] is the optional (N,) relative IOR
    of the glass lobe (default: entering, ior). Returns (f (N,3), pdf (N,))."""
    wo_l = _to_local(n, wo)
    wi_l = _to_local(n, wi)
    f, pdfs = _eval_lobes(options, mats, wo_l, wi_l, _eta_rel(mats, aux))
    probs, _ = _lobe_setup(options, mats, wo_l)
    pdf = sum(p * l for p, l in zip(probs, pdfs))
    good = torch.isfinite(pdf) & torch.isfinite(f).all(dim=-1)
    return torch.where(good[..., None], f, 0.0), torch.where(good, pdf, 0.0)


def sample(options: RenderOptions, mats, n, wo, rng_state, aux=None):
    """Pick a lobe by probability, sample it, and return the full eval and
    the combined pdf. Draws u_sel, then (u1, u2), then u3.

    Returns (rng_state, wi (N,3) world, f (N,3), pdf (N,), {'refracted'})."""
    wo_l = _to_local(n, wo)
    eta_rel = _eta_rel(mats, aux)
    probs, _ = _lobe_setup(options, mats, wo_l)
    rng_state, u_sel = rng_mod.next_float(rng_state)
    rng_state, u1, u2 = rng_mod.next_float2(rng_state)
    rng_state, u3 = rng_mod.next_float(rng_state)

    ax, ay = get_alphas(mats.roughness, mats.anisotropy)
    cax, cay = get_alphas(mats.coat_roughness, mats.coat_anisotropy)
    sampler = (mf.sample_vndf if options.ggx_sampling == GGXSamplingVariant.VNDF
               else mf.sample_vndf_spherical_caps)

    wo_up = torch.where(wo_l[..., 2:3] < 0.0, -wo_l, wo_l)
    # sample in the rotated tangent frame, rotate the result back
    rot = mats.anisotropy_rotation * math.pi
    wo_rot = mf.anisotropy_rotate(wo_up, rot)

    h_coat = sampler(wo_rot, cax, cay, u1, u2)
    wi_coat = mf.anisotropy_rotate(mf.reflect_local(wo_rot, h_coat), -rot)
    h_base = sampler(wo_rot, ax, ay, u1, u2)
    wi_specm = mf.anisotropy_rotate(mf.reflect_local(wo_rot, h_base), -rot)

    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    wi_cos = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                          torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))], dim=-1)
    wi_sheen = _sheen_sample(wo_up, mats.sheen_roughness, u1, u2)

    # glass: reflect or refract through h_base by Fresnel; thin-walled
    # surfaces use eta ~ 1 (straight through)
    eta_g = torch.where(mats.thin_walled > 0.5, 1.0 + 1e-3, eta_rel)
    doth = torch.clamp_min((wo_rot * h_base).sum(dim=-1), 1e-9)
    Fg = fresnel_dielectric(doth, eta_g)
    wt, tir = mf.refract_local(wo_rot, h_base, 1.0 / eta_g)
    wt = mf.anisotropy_rotate(wt, -rot)
    choose_reflect = (u3 < Fg) | tir
    wi_glass = torch.where(choose_reflect[..., None], wi_specm, wt)

    # lobe CDF
    c0 = probs[0]
    c1 = c0 + probs[1]
    c2 = c1 + probs[2]
    c3 = c2 + probs[3]
    c4 = c3 + probs[4]
    sel_coat = u_sel < c0
    sel_sheen = ~sel_coat & (u_sel < c1)
    sel_metal = ~sel_coat & ~sel_sheen & (u_sel < c2)
    sel_glass = ~sel_coat & ~sel_sheen & ~sel_metal & (u_sel < c3)
    sel_spec = ~sel_coat & ~sel_sheen & ~sel_metal & ~sel_glass & (u_sel < c4)
    wi_l = torch.where(sel_coat[..., None], wi_coat,
           torch.where(sel_sheen[..., None], wi_sheen,
           torch.where(sel_metal[..., None], wi_specm,
           torch.where(sel_glass[..., None], wi_glass,
           torch.where(sel_spec[..., None], wi_specm, wi_cos)))))

    f, pdfs = _eval_lobes(options, mats, wo_up, wi_l, eta_rel)
    pdf = sum(p * l for p, l in zip(probs, pdfs))
    good = torch.isfinite(pdf) & (pdf > 0.0) & torch.isfinite(f).all(dim=-1)
    f = torch.where(good[..., None], f, 0.0)
    pdf = torch.where(good, pdf, 0.0)
    refracted = sel_glass & (wi_l[..., 2] < 0.0)
    return rng_state, _to_world(n, wi_l), f, pdf, {"refracted": refracted}
