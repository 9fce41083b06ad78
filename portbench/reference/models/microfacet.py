"""GGX microfacet building blocks in the local shading frame (z = normal),
mirroring ``hiprt_pt_tpu.models.microfacet`` (reference: Microfacet.h):
the GGX NDF, Smith height-correlated masking-shadowing, VNDF sampling and
its spherical-caps variant (Dupuy & Benyoub 2023). Directions are (..., 3)."""

from __future__ import annotations

import math

import torch


def _normalize(v):
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-12)


def ggx_ndf(h, ax, ay):
    """Anisotropic GGX normal distribution D(h)."""
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]
    d = (hx / ax) ** 2 + (hy / ay) ** 2 + hz * hz
    return torch.where(
        hz > 0.0, 1.0 / (math.pi * ax * ay * torch.clamp_min(d * d, 1e-12)), 0.0)


def smith_lambda(w, ax, ay):
    """Smith Λ for GGX."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    az2 = (wx * ax) ** 2 + (wy * ay) ** 2
    wz2 = wz * wz
    return 0.5 * (torch.sqrt(1.0 + az2 / torch.clamp_min(wz2, 1e-12)) - 1.0)


def smith_g1(w, ax, ay):
    return 1.0 / (1.0 + smith_lambda(w, ax, ay))


def smith_g2_height_correlated(wo, wi, ax, ay):
    """Height-correlated masking-shadowing G2."""
    return 1.0 / (1.0 + smith_lambda(wo, ax, ay) + smith_lambda(wi, ax, ay))


def sample_vndf(wo, ax, ay, u1, u2):
    """Classic VNDF sampling (Heitz 2018)."""
    vh = _normalize(torch.stack([ax * wo[..., 0], ay * wo[..., 1], wo[..., 2]], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = torch.where(
        (lensq > 1e-9)[..., None],
        torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)], dim=-1)
        / torch.sqrt(torch.clamp_min(lensq, 1e-12))[..., None],
        torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device).expand(vh.shape))
    t2 = torch.linalg.cross(vh, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    h = torch.stack([ax * nh[..., 0], ay * nh[..., 1],
                     torch.clamp_min(nh[..., 2], 1e-9)], dim=-1)
    return _normalize(h)


def sample_vndf_spherical_caps(wo, ax, ay, u1, u2):
    """Visible normal by the spherical-caps method (Dupuy & Benyoub 2023);
    wo must be in the upper hemisphere."""
    vh = _normalize(torch.stack([ax * wo[..., 0], ay * wo[..., 1], wo[..., 2]], dim=-1))
    phi = 2.0 * math.pi * u1
    z = (1.0 - u2) * (1.0 + vh[..., 2]) - vh[..., 2]
    sin_t = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    x = sin_t * torch.cos(phi)
    y = sin_t * torch.sin(phi)
    c = torch.stack([x, y, z], dim=-1) + vh
    h = torch.stack([ax * c[..., 0], ay * c[..., 1],
                     torch.clamp_min(c[..., 2], 1e-9)], dim=-1)
    return _normalize(h)


def vndf_pdf(wo, h, ax, ay):
    """pdf of a visible normal h given wo: G1(wo) D(h) <wo,h> / wo.z."""
    d = ggx_ndf(h, ax, ay)
    g1 = smith_g1(wo, ax, ay)
    doth = torch.clamp_min((wo * h).sum(dim=-1), 0.0)
    return g1 * d * doth / torch.clamp_min(wo[..., 2].abs(), 1e-9)


def reflect_local(wo, h):
    return 2.0 * (wo * h).sum(dim=-1, keepdim=True) * h - wo


def refract_local(wo, h, eta_rel):
    """Refract wo about h with eta_rel = n_incident / n_transmitted.
    Returns (wt, total-internal-reflection mask)."""
    cos_i = (wo * h).sum(dim=-1)
    sin2_t = eta_rel * eta_rel * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, 0.0, 1.0))
    wt = (-wo) * eta_rel[..., None] + h * (eta_rel * cos_i - cos_t)[..., None]
    return _normalize(wt), tir


def anisotropy_rotate(w, rotation):
    """Rotate the tangent-plane components by the anisotropy rotation."""
    c = torch.cos(rotation)
    s = torch.sin(rotation)
    x = c * w[..., 0] + s * w[..., 1]
    y = -s * w[..., 0] + c * w[..., 1]
    return torch.stack([x, y, w[..., 2]], dim=-1)
