"""Oren-Nayar rough diffuse BRDF, mirroring ``hiprt_pt_tpu.models.oren_nayar``
(reference: BSDFs/OrenNayar.h)."""

from __future__ import annotations

import torch

from ..core.material import oren_nayar_AB
from ..ops.sampling import INV_PI, sample_cosine_hemisphere, to_local


def eval_pdf(base_color, sigma, n, wo, wi):
    """Qualitative Oren-Nayar model. Returns (f (N,3), pdf (N,))."""
    lo = to_local(wo, n)
    li = to_local(wi, n)
    cos_o = lo[..., 2]
    cos_i = li[..., 2]
    valid = (cos_i > 1e-6) & (cos_o > 1e-6)
    A, B = oren_nayar_AB(sigma)
    sin_o = torch.sqrt((1.0 - cos_o * cos_o).clamp_min(0.0))
    sin_i = torch.sqrt((1.0 - cos_i * cos_i).clamp_min(0.0))
    denom = (sin_i * sin_o).clamp_min(1e-7)
    cos_dphi = ((li[..., 0] * lo[..., 0] + li[..., 1] * lo[..., 1]) / denom
                ).clamp(-1.0, 1.0)
    sin_alpha = torch.maximum(sin_i, sin_o)
    tan_beta = torch.minimum(sin_i, sin_o) / torch.minimum(cos_i, cos_o).clamp_min(1e-7)
    fr = INV_PI * (A + B * cos_dphi.clamp_min(0.0) * sin_alpha * tan_beta)
    f = torch.where(valid[..., None], base_color * fr[..., None], 0.0)
    pdf = torch.where(valid, cos_i * INV_PI, 0.0)
    return f, pdf


def sample(base_color, sigma, n, wo, u1, u2):
    wi, pdf = sample_cosine_hemisphere(n, u1, u2)
    f, _ = eval_pdf(base_color, sigma, n, wo, wi)
    return wi, f, pdf
