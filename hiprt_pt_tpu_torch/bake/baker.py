"""BRDF LUT baker — Monte-Carlo directional-albedo tables, mirroring
``hiprt_pt_tpu.bake.baker`` (reference: GPUBaker, src/Renderer/Baker/
GPUBaker.h:22-57, and its baking kernels in src/Device/kernels/Baking/).

Bakes the GGX energy-compensation tables the principled BSDF reads: the
single-scattering directional albedo ``Ess(roughness, cos_theta)`` of
conductors, its Fresnel-weighted glossy-dielectric variant, the glossy base
layer and the glass tables (entering, exiting, thin-walled) over
``GLASS_IORS``.

Each integrand takes one value per table cell and averages ``n_samples``
draws per cell. The cells' draws run as one flat batch of lanes (cell-major,
then sample) on ``device`` (the GPU unless the caller asks for the CPU), in
place of the JAX package's ``vmap(vmap(...))``. Every cell draws from the
same PCG streams the JAX package's does: lane (cell, k) is seeded with
sample index k, not with its flat index, so the two packages draw the same
numbers. The glass tables keep the JAX package's loop over the IORs, so one
call holds one IOR's lanes.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.device import resolve_device
from ..models import microfacet as mf
from ..models.fresnel import fresnel_dielectric

# IOR grid of the 3D glass tables (ior x roughness x cos); reference:
# GPUBakerConstants GGX_GLASS_ESS_TEXTURE_SIZE_IOR
GLASS_IORS = (1.1, 1.2, 1.3, 1.4, 1.5, 1.7, 2.0, 2.5)


def _lanes(cos_o, rough, n_samples: int, stream: int, seed: int):
    """Per-lane (cos_o, alpha, wo, rng state) of the cells (C,) with
    ``n_samples`` lanes each, cell-major; lane (cell, k) is seeded with
    (k, stream, seed), as the JAX package seeds every cell."""
    cos_l = cos_o.repeat_interleave(n_samples)
    a = torch.clamp_min(rough * rough, 1e-4).repeat_interleave(n_samples)
    sin_l = torch.sqrt(torch.clamp_min(1.0 - cos_l * cos_l, 0.0))
    wo = torch.stack([sin_l, torch.zeros_like(sin_l), cos_l], dim=-1)
    k = torch.arange(n_samples, device=cos_o.device).repeat(cos_o.shape[0])
    return cos_l, a, wo, rng_mod.seed(k, stream, seed)


def _cell_mean(est, n_samples: int):
    """(C,) mean of each cell's lanes (and channels, where est has them)."""
    return est.reshape(-1, n_samples * (est[0].numel())).mean(dim=-1)


def _directional_albedo_ggx(cos_o, rough, n_samples, seed, eta=None):
    """E[f·cos/pdf] for VNDF-sampled GGX at each cell (cos_o, rough) (C,):
    the estimator reduces to G2/G1 (times Fresnel when eta is given)."""
    _cos, a, wo, s = _lanes(cos_o, rough, n_samples, 0, seed)
    s, u1 = rng_mod.next_float(s)
    s, u2 = rng_mod.next_float(s)
    h = mf.sample_vndf_spherical_caps(wo, a, a, u1, u2)
    wi = mf.reflect_local(wo, h)
    valid = wi[:, 2] > 0.0
    g2 = mf.smith_g2_height_correlated(wo, wi, a, a)
    g1 = mf.smith_g1(wo, a, a)
    est = torch.where(valid, g2 / torch.clamp_min(g1, 1e-9), 0.0)
    if eta is not None:
        doth = torch.clamp_min((wo * h).sum(dim=-1), 0.0)
        est = est * fresnel_dielectric(doth, torch.full_like(doth, eta))
    return _cell_mean(est, n_samples)


def _grid(res: int, device):
    """(cos_o, rough) (res*res,) of every cell, rows = roughness, columns =
    cos_theta, both at texel centres in (0, 1)."""
    g = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    return g.repeat(res), g.repeat_interleave(res)


def _bake2d(integrand, res, device, *args):
    cos_o, rough = _grid(res, resolve_device(device))
    return integrand(cos_o, rough, *args).reshape(res, res).cpu().numpy()


def bake_ggx_conductor_ess(res: int = 32, n_samples: int = 8192, seed: int = 3,
                           device=None):
    """(res, res) table: rows = roughness in (0,1], cols = cos_theta in
    (0,1]. reference artifact: GGX_Conductor_128x128.hdr
    (GPUBakerConstants)."""
    return _bake2d(_directional_albedo_ggx, res, device, n_samples, seed)


def bake_ggx_glossy_dielectric_ess(eta: float = 1.5, res: int = 32,
                                   n_samples: int = 8192, seed: int = 7,
                                   device=None):
    """Fresnel-weighted GGX directional albedo (glossy dielectric
    reflection; reference artifact: GlossyDielectrics tables), a 2D slice
    at a fixed eta; bake_glossy_base_ess is the 3D table the renderer
    reads."""
    return _bake2d(_directional_albedo_ggx, res, device, n_samples, seed,
                   float(np.float32(eta)))


def _glossy_base_albedo(cos_o, rough, eta, n_samples, seed):
    """Directional albedo of the production glossy base layer: dielectric
    GGX specular (specular=1) + white Lambert diffuse darkened by the same
    (1 - F(cos_o))·(1 - F(cos_i)) factors the principled BSDF applies,
    mixture-sampled 50/50 VNDF reflection / cosine (reference:
    src/Device/kernels/Baking/GlossyDielectricDirectionalAlbedo.h:71-120),
    at each cell (cos_o, rough) (C,)."""
    cos_l, a, wo, s = _lanes(cos_o, rough, n_samples, 1, seed)
    s, u1 = rng_mod.next_float(s)
    s, u2 = rng_mod.next_float(s)
    s, u3 = rng_mod.next_float(s)
    s, u4 = rng_mod.next_float(s)
    s, u5 = rng_mod.next_float(s)
    eta_l = torch.full_like(cos_l, eta)
    h = mf.sample_vndf_spherical_caps(wo, a, a, u1, u2)
    wi_spec = mf.reflect_local(wo, h)
    ci = torch.sqrt(torch.clamp(u4, 1e-7, 1.0))
    si = torch.sqrt(torch.clamp_min(1.0 - u4, 0.0))
    phi = 2.0 * np.pi * u5
    wi_cos = torch.stack([si * torch.cos(phi), si * torch.sin(phi), ci], dim=-1)
    wi = torch.where((u3 < 0.5)[..., None], wi_spec, wi_cos)
    cos_i = wi[..., 2]
    valid = cos_i > 1e-6

    hf = wo + wi
    hf = hf / torch.clamp_min(torch.linalg.norm(hf, dim=-1, keepdim=True), 1e-12)
    doth = torch.clamp_min((wo * hf).sum(dim=-1), 1e-9)
    d = mf.ggx_ndf(hf, a, a)
    g2 = mf.smith_g2_height_correlated(wo, wi, a, a)
    # f_spec * cos_i = D F G2 / (4 cos_o)
    fspec_cos = (d * fresnel_dielectric(doth, eta_l) * g2
                 / (4.0 * torch.clamp_min(cos_l, 1e-6)))
    fo = fresnel_dielectric(torch.clamp_min(cos_l, 0.0), eta_l)
    fi = fresnel_dielectric(torch.clamp_min(cos_i, 0.0), eta_l)
    fdiff_cos = (1.0 - fo) * (1.0 - fi) * cos_i / np.pi

    pdf_spec = mf.vndf_pdf(wo, hf, a, a) / (4.0 * doth)
    pdf_cos = torch.clamp_min(cos_i, 0.0) / np.pi
    pdf = 0.5 * pdf_spec + 0.5 * pdf_cos
    est = torch.where(valid & (pdf > 1e-9), (fspec_cos + fdiff_cos) / pdf, 0.0)
    return torch.clamp(_cell_mean(est, n_samples), 0.0, 1.5)


def _bake_ior_grid(integrand, res, device, etas, *args):
    """(len(GLASS_IORS), res, res): ``integrand(cos_o, rough, eta, *args)``
    over the cells, one call for each eta of ``etas``."""
    cos_o, rough = _grid(res, resolve_device(device))
    out = np.zeros((len(GLASS_IORS), res, res), np.float32)
    for k, eta in enumerate(etas):
        out[k] = integrand(cos_o, rough, float(np.float32(eta)),
                           *args).reshape(res, res).cpu().numpy()
    return out


def bake_glossy_base_ess(res: int = 16, n_samples: int = 4096,
                         seed: int = 19, device=None):
    """3D (ior, roughness, cos) glossy-base layer albedo over GLASS_IORS —
    the table the principled BSDF samples for both the glossy-base and the
    clearcoat compensation (reference: bsdfs_data.glossy_dielectric_Ess,
    BSDFsData.h:41)."""
    return _bake_ior_grid(_glossy_base_albedo, res, device, GLASS_IORS,
                          n_samples, seed)


def bake_ggx_fresnel_ess(res: int = 16, n_samples: int = 4096,
                         seed: int = 23, device=None):
    """3D (ior, roughness, cos) directional albedo of the bare
    Fresnel-weighted GGX lobe (reference:
    src/Device/kernels/Baking/GGXFresnelDirectionalAlbedo.h; an offline
    artifact that no renderer binds)."""

    def integrand(cos_o, rough, eta, n, sd):
        return _directional_albedo_ggx(cos_o, rough, n, sd, eta=eta)
    return _bake_ior_grid(integrand, res, device, GLASS_IORS, n_samples, seed)


def _glass_albedo(cos_o, rough, eta, n_samples, seed, thin=False):
    """Directional albedo of the port's own glass lobe (compensation off)
    at each cell (cos_o, rough) (C,), normalized by its smooth-surface
    value at the same (cos, eta), so that 1/E inverts the lobe's
    single-scatter roughness loss. Baked through the lobe itself
    (models/principled.py:sample), as the reference's baking kernels run
    the production BSDF."""
    from ..core.material import MaterialBank
    from ..core.settings import RenderOptions
    from ..models import principled

    opts = RenderOptions(do_energy_compensation=False)
    dev = cos_o.device
    n = cos_o.shape[0] * n_samples
    # the material row's roughness is replaced per lane below; the JAX
    # package's row and make_safe run first, as here
    bank = MaterialBank.from_rows([dict(
        base_color=[1.0, 1.0, 1.0], specular_transmission=1.0, roughness=0.0,
        ior=1.5, specular=0.0)], device=dev)
    base = bank.at_indices(torch.zeros((n,), dtype=torch.int32,
                                       device=dev)).make_safe()
    thin_walled = torch.full((n,), 1.0 if thin else 0.0, device=dev)
    nrm = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3)
    aux = {"eta_rel": torch.full((n,), eta, device=dev)}

    def albedo_at(r):
        _cos, _a, wo, s = _lanes(cos_o, r, n_samples, 2, seed)
        mats = dataclasses.replace(base, roughness=r.repeat_interleave(n_samples),
                                   thin_walled=thin_walled)
        _s, wi, f, pdf, _ = principled.sample(opts, mats, nrm, wo, s, aux)
        cos_i = wi[..., 2].abs()
        est = torch.where((pdf > 1e-8)[..., None],
                          f * (cos_i / torch.clamp_min(pdf, 1e-9))[..., None],
                          0.0)
        return _cell_mean(est, n_samples)

    smooth = albedo_at(torch.full_like(rough, 0.02))
    val = albedo_at(rough)
    return torch.clamp(val / torch.clamp_min(smooth, 1e-6), 0.05, 1.5)


def _bake_glass_grid(res, n_samples, seed, eta_of, thin=False, device=None):
    return _bake_ior_grid(
        lambda c, r, e: _glass_albedo(c, r, e, n_samples, seed, thin=thin),
        res, device, [eta_of(ior) for ior in GLASS_IORS])


def bake_ggx_glass_ess(res: int = 16, n_samples: int = 4096, seed: int = 11,
                       device=None):
    """Entering tables Ess(ior; roughness, cos) (reference artifact:
    GGX_Ess_glass.hdr 3D stack)."""
    return _bake_glass_grid(res, n_samples, seed, lambda i: i, device=device)


def bake_ggx_glass_inv_ess(res: int = 16, n_samples: int = 4096,
                           seed: int = 13, device=None):
    """Exiting (inside -> outside) tables: relative IOR 1/ior (reference:
    GGX_Ess_glass_inverse.hdr)."""
    return _bake_glass_grid(res, n_samples, seed, lambda i: 1.0 / i,
                            device=device)


def bake_ggx_thin_glass_ess(res: int = 16, n_samples: int = 4096,
                            seed: int = 17, device=None):
    """Thin-walled glass tables (reference: GGX_Ess_thin_glass.hdr)."""
    return _bake_glass_grid(res, n_samples, seed, lambda i: i, thin=True,
                            device=device)


def save_lut(table: np.ndarray, path: str):
    """Write ``path``.npy (exact) and ``path``.hdr (the reference
    artifact's shape; a 3D table's IOR slices stacked top to bottom)."""
    from ..assets.image_io import write_hdr

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.save(path + ".npy", table.astype(np.float32))
    flat = table.reshape(-1, table.shape[-1])
    write_hdr(path + ".hdr", np.repeat(flat[..., None], 3, axis=-1))


def bake_all(out_dir: str = "data/BRDFsData", res: int = 32, device=None):
    """Bake the default LUT set into ``out_dir`` (reference: the GPUBaker
    bake_ggx_* suite); returns the tables by name."""
    ess = bake_ggx_conductor_ess(res=res, device=device)
    save_lut(ess, os.path.join(out_dir, f"GGX_Conductor_Ess_{res}x{res}"))
    gd = bake_ggx_glossy_dielectric_ess(res=res, device=device)
    save_lut(gd, os.path.join(out_dir, f"GGX_GlossyDielectric_Ess_{res}x{res}"))
    gres = max(res // 2, 8)
    glass = bake_ggx_glass_ess(res=gres, device=device)
    glass_inv = bake_ggx_glass_inv_ess(res=gres, device=device)
    thin = bake_ggx_thin_glass_ess(res=gres, device=device)
    glossy_base = bake_glossy_base_ess(res=gres, device=device)
    fresnel = bake_ggx_fresnel_ess(res=gres, device=device)
    for name, tab in (("Glass", glass), ("GlassInv", glass_inv),
                      ("ThinGlass", thin), ("GlossyBase", glossy_base),
                      ("Fresnel", fresnel)):
        np.save(os.path.join(out_dir, f"GGX_{name}_Ess_{gres}.npy"),
                tab.astype(np.float32))
    return {"conductor": ess, "glossy_dielectric": gd, "glass": glass,
            "glass_inv": glass_inv, "thin_glass": thin,
            "glossy_base": glossy_base, "fresnel": fresnel}
