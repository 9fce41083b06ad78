"""Lambertian diffuse BRDF, mirroring ``hiprt_pt_tpu.models.lambert``
(reference: BSDFs/Lambertian.h)."""

from __future__ import annotations

import torch

from ..ops.sampling import INV_PI, sample_cosine_hemisphere


def eval_pdf(base_color, n, wo, wi):
    """f = albedo/pi, pdf = cos/pi; wo/wi point away from the surface.
    Returns (f (N,3), pdf (N,))."""
    cos_i = (n * wi).sum(dim=-1)
    cos_o = (n * wo).sum(dim=-1)
    valid = (cos_i > 0.0) & (cos_o > 0.0)
    f = torch.where(valid[..., None], base_color * INV_PI, 0.0)
    pdf = torch.where(valid, cos_i * INV_PI, 0.0)
    return f, pdf


def sample(base_color, n, wo, u1, u2):
    wi, pdf = sample_cosine_hemisphere(n, u1, u2)
    f, _ = eval_pdf(base_color, n, wo, wi)
    return wi, f, pdf
