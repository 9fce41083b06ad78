"""Denoiser — edge-avoiding à-trous wavelet filter with AOV guidance,
mirroring ``hiprt_pt_tpu.render.denoise`` (reference: the Intel OIDN
wrapper, src/Renderer/OpenImageDenoiser.{h,cpp}, "RT" filter with albedo
and normal AOVs).

The filter is the JAX package's (Dammertz, Sewtz, Hanika & Lensch,
"Edge-Avoiding À-Trous Wavelet Transform for fast Global Illumination
Filtering", HPG 2010; with the SVGF variance rule of Schied et al. 2017):
plain tensor operations on the image's device, in the JAX package's
arithmetic and order. Each iteration doubles the tap stride of the 5x5
B3-spline kernel; ``torch.roll`` wraps at the border as ``jnp.roll`` does.
At 1920x1080 one call is a few thousand elementwise launches; no kernel of
the port fuses it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.pixel_order import unscramble
from ..ops.tonemap import luminance

# 5-tap B3-spline kernel (outer product applied separably via offsets)
_KERNEL_1D = np.asarray([1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16])


def _roll(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(x, (dy, dx), dims=(0, 1))


def suppress_fireflies(color: torch.Tensor, k: float = 3.0) -> torch.Tensor:
    """Clamp isolated HDR outliers to k x the 3x3 neighbor mean (excluding the
    center). Russian-roulette boosts + grazing NEE produce rare huge samples;
    the reference exposes per-category clamps for the same problem
    (RenderSettings.h contribution clamps)."""
    acc = torch.zeros_like(color)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            acc = acc + _roll(color, dy, dx)
    nb_mean = acc / 8.0
    limit = torch.clamp_min(k * nb_mean, 0.25)
    return torch.minimum(color, limit)


def _edge_weight(c_center, c_tap, sigma: float) -> torch.Tensor:
    d2 = ((c_center - c_tap) ** 2).sum(dim=-1)
    return torch.exp(-d2 / max(sigma * sigma, 1e-8))


def atrous_denoise(
    color: torch.Tensor,
    albedo: Optional[torch.Tensor] = None,
    normal: Optional[torch.Tensor] = None,
    iterations: int = 5,
    sigma_color: float = 0.5,
    sigma_albedo: float = 0.25,
    sigma_normal: float = 0.3,
    prefilter: bool = True,
    variance: Optional[torch.Tensor] = None,
    spp_map: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Denoise an (H, W, 3) HDR image. albedo/normal: optional (H, W, 3) AOVs
    (reference: OIDN albedo/normal auxiliary images).

    variance: optional (H, W) per-pixel variance of the MEAN luminance
    estimate (from the adaptive-sampling squared-luminance accumulator).
    When given, the color edge weight blends (per pixel, in log space)
    the SVGF-style exp(-|l_p - l_q| / (sigma_l * sqrt(var_3x3) + eps))
    with the fixed-sigma weight, by how converged the pixel is (spp_map /
    32 clamped to [0,1]; where spp_map < 2 the sample variance is
    degenerate and the fixed-sigma rule takes over fully)."""
    img = suppress_fireflies(color) if prefilter else color

    if variance is not None:
        # 3x3 gaussian-prefiltered std of the luminance mean (SVGF g3x3)
        vacc = torch.zeros_like(variance)
        wtot = 0.0
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                kk = (2.0 if dy == 0 else 1.0) * (2.0 if dx == 0 else 1.0)
                vacc = vacc + kk * _roll(variance, dy, dx)
                wtot += kk
        std_f = torch.sqrt(torch.clamp_min(vacc / wtot, 0.0))
        if spp_map is not None:
            conv_t = torch.where(spp_map < 2.0, 1.0,
                                 torch.clamp(spp_map / 32.0, 0.0, 1.0))
        else:
            conv_t = torch.zeros_like(variance)

    for it in range(iterations):
        stride = 1 << it
        sig = sigma_color * (2.0 ** -it)
        lum_img = luminance(img) if variance is not None else None
        accum = torch.zeros_like(img)
        wsum = torch.zeros(img.shape[:2], dtype=img.dtype, device=img.device)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                k = float(_KERNEL_1D[dy + 2] * _KERNEL_1D[dx + 2])
                sy, sx = dy * stride, dx * stride
                tap = _roll(img, sy, sx)
                if variance is not None:
                    # log-space per-pixel blend of the variance rule and
                    # the fixed-sigma rule by convergence t
                    dl = torch.abs(lum_img - luminance(tap))
                    e_var = dl / (4.0 * std_f + 1e-3)
                    d2c = ((img - tap) ** 2).sum(dim=-1)
                    e_fix = d2c / max(sig * sig, 1e-8)
                    w = k * torch.exp(-((1.0 - conv_t) * e_var + conv_t * e_fix))
                else:
                    w = k * _edge_weight(img, tap, sig)
                if albedo is not None:
                    w = w * _edge_weight(albedo, _roll(albedo, sy, sx),
                                         sigma_albedo)
                if normal is not None:
                    w = w * _edge_weight(normal, _roll(normal, sy, sx),
                                         sigma_normal)
                accum = accum + tap * w[..., None]
                wsum = wsum + w
        img = accum / torch.clamp_min(wsum, 1e-8)[..., None]
    return img


def _display(renderer, x: torch.Tensor) -> torch.Tensor:
    """A per-pixel buffer in display order (row-major, row 0 = top), the
    route of Renderer.hdr_image, on the buffer's device."""
    img = unscramble(x.cpu().numpy(), renderer.width, renderer.height)[::-1]
    return torch.from_numpy(img.copy()).to(x.device)


def collect_aovs(renderer, use_variance: bool = True):
    """Gather the denoiser inputs from a Renderer in display pixel order:
    (hdr (H,W,3) tensor, albedo (H,W,3) numpy, normal (H,W,3) numpy,
    variance-of-mean (H,W) tensor | None, spp_map (H,W) tensor | None);
    the tensors on the renderer's device."""
    dev = renderer.state.accum.device
    hdr = torch.from_numpy(renderer.hdr_image().copy()).to(dev)
    alb, nrm = renderer.aov_images()
    var = None
    spp_map = None
    if use_variance:
        st = renderer.state
        n = st.pixel_sample_count.to(torch.float32).clamp_min(1.0)
        # variance of the mean: (E[l^2] - E[l]^2) / n
        ml = luminance(st.accum) / n
        v = torch.clamp_min(st.accum_sq_luminance / n - ml * ml, 0.0) / n
        var = _display(renderer, v)
        spp_map = _display(renderer, n)
    return hdr, alb, nrm, var, spp_map


def denoise(renderer, blend: float = 1.0, use_variance: bool = True,
            method: str = "auto") -> np.ndarray:
    """Denoise a Renderer's current image using its accumulated AOVs
    (reference: RenderWindow::denoise + denoiser blend setting).
    Returns (H, W, 3) numpy, blended denoised/raw by `blend`.

    method: "atrous" = the wavelet filter; "nn" = the learned denoiser
    (render/denoise_nn.py) refining the wavelet output, FileNotFoundError
    when its weights are absent; "auto" = the wavelet filter (the JAX
    package's held-out measurement found the network regresses on unseen
    transport)."""
    hdr, alb, nrm, var, spp_map = collect_aovs(
        renderer, use_variance=use_variance)
    dev = hdr.device
    alb_t = torch.from_numpy(alb.copy()).to(dev)
    nrm_t = torch.from_numpy(nrm.copy()).to(dev)
    out = atrous_denoise(hdr, alb_t, nrm_t, variance=var, spp_map=spp_map)
    if method == "nn":
        from . import denoise_nn

        params = denoise_nn.load_params(device=dev)
        if params is None:
            raise FileNotFoundError(
                f"learned-denoiser weights missing: {denoise_nn.WEIGHTS_PATH}")
        out = denoise_nn.apply(params, hdr, out, alb_t, nrm_t, var, spp_map)
    out = blend * out + (1.0 - blend) * hdr
    return out.cpu().numpy()
