"""Thin-film interference, mirroring ``hiprt_pt_tpu.models.thin_film``
(reference: ThinFilm.h): two-interface Airy interference of a film of IOR
n1 and thickness d over a base, at three representative RGB wavelengths,

    R(λ) = (r12² + r23² + 2 r12 r23 cos φ) / (1 + r12²r23² + 2 r12 r23 cos φ)

with amplitude coefficients r = ±sqrt(F); a hue shift rotates the
wavelengths."""

from __future__ import annotations

import math

import torch

from .fresnel import fresnel_dielectric

_LAMBDA_RGB = (650.0, 550.0, 440.0)  # nm


def _amp_reflectance(cos_i, n_from, n_to):
    """Signed amplitude reflection coefficient: magnitude sqrt(F), negative
    when entering a denser medium."""
    F = fresnel_dielectric(cos_i, n_to / n_from)
    sign = torch.where(n_to > n_from, -1.0, 1.0)
    return sign * torch.sqrt(torch.clamp(F, 0.0, 1.0))


def thin_film_reflectance(cos_theta0, film_ior, thickness_nm, base_ior,
                          hue_shift_deg, outside_ior=1.0):
    """RGB reflectance of a thin film over a base. All args (N,); (N,3)."""
    n0 = torch.full_like(cos_theta0, outside_ior)
    n1 = torch.clamp_min(film_ior, 1.0 + 1e-3)
    n2 = torch.clamp_min(base_ior, 1.0 + 1e-3)
    cos0 = torch.clamp(cos_theta0, 1e-4, 1.0)
    sin0 = torch.sqrt(torch.clamp_min(1.0 - cos0 * cos0, 0.0))
    sin1 = torch.clamp(n0 / n1 * sin0, 0.0, 1.0)
    cos1 = torch.sqrt(torch.clamp_min(1.0 - sin1 * sin1, 0.0))

    r12 = _amp_reflectance(cos0, n0, n1)
    r23 = _amp_reflectance(cos1, n1, n2)

    opd = 2.0 * n1 * thickness_nm * cos1  # optical path difference (nm)
    chans = []
    for lam in _LAMBDA_RGB:
        lam_eff = lam * (1.0 + hue_shift_deg / 360.0)
        phi = 2.0 * math.pi * opd / torch.clamp_min(lam_eff, 1.0)
        c = torch.cos(phi)
        num = r12 * r12 + r23 * r23 + 2.0 * r12 * r23 * c
        den = 1.0 + (r12 * r23) ** 2 + 2.0 * r12 * r23 * c
        chans.append(torch.clamp(num / torch.clamp_min(den, 1e-6), 0.0, 1.0))
    return torch.stack(chans, dim=-1)
