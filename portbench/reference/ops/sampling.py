"""Sampling primitives and MIS heuristics, mirroring
``hiprt_pt_tpu.ops.sampling`` (reference: Sampling.h, ONB.h, LightUtils.h)."""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi


def build_onb(n):
    """Branchless ONB from a unit normal (Duff et al. 2017).
    n: (..., 3) → (tangent, bitangent)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], dim=-1
    )
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def to_world(local_dir, n):
    """Local (z-up) direction → world around normal n."""
    t, b = build_onb(n)
    return (local_dir[..., 0:1] * t + local_dir[..., 1:2] * b
            + local_dir[..., 2:3] * n)


def to_local(world_dir, n):
    t, b = build_onb(n)
    return torch.stack(
        [(world_dir * t).sum(dim=-1), (world_dir * b).sum(dim=-1),
         (world_dir * n).sum(dim=-1)],
        dim=-1,
    )


def sample_cosine_hemisphere(n, u1, u2):
    """Cosine-weighted hemisphere around n. Returns (dir, pdf)."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt((1.0 - u1).clamp_min(0.0))
    local = torch.stack([x, y, z], dim=-1)
    d = to_world(local, n)
    pdf = z.clamp_min(1e-8) * INV_PI
    return d, pdf


def sample_disk(u1, u2):
    """Uniform point on the unit disk (polar warp). Returns (x, y)."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return r * torch.cos(phi), r * torch.sin(phi)


def sample_uniform_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt((1.0 - z * z).clamp_min(0.0))
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def sample_triangle(v0, e1, e2, u1, u2):
    """Uniform point on a triangle (sqrt warp). Returns (point, unnormalized
    geometric normal)."""
    su1 = torch.sqrt(u1)
    b0 = 1.0 - su1
    b1 = u2 * su1
    p = v0 + e1 * b0[..., None] + e2 * b1[..., None]
    return p, torch.linalg.cross(e1, e2)


_MASK = 0xFFFFFFFF


def radical_inverse_base2(bits):
    """Van der Corput radical inverse for Hammersley points: the 32 bits of
    ``bits`` reversed, as a float in [0, 1). torch has no uint32 shifts on
    every device, so the word is held in int64 and masked to 32 bits."""
    b = bits.to(torch.int64) & _MASK
    b = ((b << 16) | (b >> 16)) & _MASK
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                        (8, 0x00FF00FF)):
        b = ((b & mask) << shift) | ((b >> shift) & mask)
    return b.to(torch.float32) * 2.3283064365386963e-10


def hammersley_2d(i, n):
    return i.to(torch.float32) / n, radical_inverse_base2(i)


def balance_heuristic(pdf_a, pdf_b):
    return pdf_a / (pdf_a + pdf_b).clamp_min(1e-12)


def power_heuristic(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    return a2 / (a2 + pdf_b * pdf_b).clamp_min(1e-12)


def reflect(d, n):
    """Mirror reflect direction d (pointing away from the surface) about n."""
    return 2.0 * (d * n).sum(dim=-1, keepdim=True) * n - d


def sphere_to_equirect_uv(d):
    """Unit direction → equirectangular (u, v) in [0,1)^2; v = 0 is the +Y
    pole (the reference's envmap parameterization, Envmap.h)."""
    theta = torch.arccos(d[..., 1].clamp(-1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0])
    u = torch.remainder(phi / TWO_PI, 1.0)
    v = theta / math.pi
    return u, v


def equirect_uv_to_sphere(u, v):
    theta = v * math.pi
    phi = u * TWO_PI
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), torch.cos(theta),
                        st * torch.sin(phi)], dim=-1)
