"""Fresnel models, mirroring ``hiprt_pt_tpu.models.fresnel`` (reference:
Fresnel.h): exact dielectric Fresnel, Schlick, and the Adobe F82-tint
conductor model."""

from __future__ import annotations

import torch


def fresnel_dielectric(cos_i, eta_rel):
    """Exact unpolarized dielectric Fresnel reflectance.
    cos_i >= 0 is the incident cosine; eta_rel = n_transmitted / n_incident."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / torch.clamp_min(eta_rel * eta_rel, 1e-12)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, 0.0, 1.0))
    r_par = (eta_rel * cos_i - cos_t) / torch.clamp_min(eta_rel * cos_i + cos_t, 1e-12)
    r_perp = (cos_i - eta_rel * cos_t) / torch.clamp_min(cos_i + eta_rel * cos_t, 1e-12)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, f)


def schlick(f0, cos_i):
    """f0 (...,3) or (...,); cos_i (...,)."""
    m = torch.clamp(1.0 - cos_i, 0.0, 1.0)
    m5 = m * m * m * m * m
    if f0.ndim == cos_i.ndim + 1:
        return f0 + (1.0 - f0) * m5[..., None]
    return f0 + (1.0 - f0) * m5


_COS_82 = 0.139173  # cos(~82 deg), the F82 control angle


def f82_tint(F0, F82, F90, falloff_exponent, cos_i):
    """Adobe F82-tint conductor Fresnel: generalized Schlick with a term
    that tints the reflectance near grazing (~82 deg) by F82.
    F0/F82/F90: (...,3); falloff_exponent, cos_i: (...,)."""
    m = torch.clamp(1.0 - cos_i, 0.0, 1.0)
    mN = (m ** falloff_exponent)[..., None]
    schlick_term = F0 + (F90 - F0) * mN
    mbar = 1.0 - _COS_82
    schlick_82 = F0 + (F90 - F0) * (mbar ** 5)
    denom = _COS_82 * (mbar ** 6)
    correction = schlick_82 * (1.0 - F82) * ((cos_i * (m ** 6)) / denom)[..., None]
    return torch.clamp_min(schlick_term - correction, 0.0)
