"""Chromatic dispersion, mirroring ``hiprt_pt_tpu.models.dispersion``
(reference: Dispersion.h): a Cauchy-equation IOR from the d-line IOR and
Abbe number, and the hero-wavelength RGB throughput from analytic CIE fits
(Wyman, Sloan & Shirley, JCGT 2013)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import row_products

LAMBDA_MIN = 380.0
LAMBDA_MAX = 730.0
# Fraunhofer lines of the Abbe number
_L_D = 589.3
_L_F = 486.1
_L_C = 656.3


def cauchy_coefficients(ior_d, abbe):
    """Cauchy A + B/λ² from n_d and V = (n_d - 1)/(n_F - n_C)."""
    B = (ior_d - 1.0) / (
        torch.clamp_min(abbe, 1e-3)
        * (1.0 / (_L_F * 1e-3) ** 2 - 1.0 / (_L_C * 1e-3) ** 2))
    A = ior_d - B / (_L_D * 1e-3) ** 2
    return A, B


def ior_at_wavelength(ior_d, abbe, dispersion_scale, lam_nm):
    """n(λ); dispersion_scale scales the dispersive term (0 gives n_d)."""
    A, B = cauchy_coefficients(ior_d, abbe)
    lam_um = lam_nm * 1e-3
    n = A + dispersion_scale * B / torch.clamp_min(lam_um * lam_um, 1e-6) + (
        1.0 - dispersion_scale) * (ior_d - A)
    return torch.clamp_min(n, 1.0 + 1e-4)


def _gauss(x, alpha, mu, s1, s2):
    s = torch.where(x < mu, s1, s2)
    t = (x - mu) / s
    return alpha * torch.exp(-0.5 * t * t)


def xyz_of_wavelength(lam_nm):
    """CIE 1931 XYZ colour-matching fits (Wyman et al. 2013)."""
    x = (_gauss(lam_nm, 1.056, 599.8, 37.9, 31.0)
         + _gauss(lam_nm, 0.362, 442.0, 16.0, 26.7)
         + _gauss(lam_nm, -0.065, 501.1, 20.4, 26.2))
    y = (_gauss(lam_nm, 0.821, 568.8, 46.9, 40.5)
         + _gauss(lam_nm, 0.286, 530.9, 16.3, 31.1))
    z = (_gauss(lam_nm, 1.217, 437.0, 11.8, 36.0)
         + _gauss(lam_nm, 0.681, 459.0, 26.0, 13.8))
    return x, y, z


_XYZ_TO_RGB = np.asarray(
    [[3.2406, -1.5372, -0.4986],
     [-0.9689, 1.8758, 0.0415],
     [0.0557, -0.2040, 1.0570]], dtype=np.float32)


# Per-channel normalization so that the (negative-lobe-clipped) weights of
# uniform wavelengths average to exact RGB white; computed in numpy with the
# JAX package's formula, so the constants are identical.
def _np_xyz(lam):
    def g(x, alpha, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return alpha * np.exp(-0.5 * ((x - mu) / s) ** 2)

    x = g(lam, 1.056, 599.8, 37.9, 31.0) + g(lam, 0.362, 442.0, 16.0, 26.7) + g(
        lam, -0.065, 501.1, 20.4, 26.2)
    y = g(lam, 0.821, 568.8, 46.9, 40.5) + g(lam, 0.286, 530.9, 16.3, 31.1)
    z = g(lam, 1.217, 437.0, 11.8, 36.0) + g(lam, 0.681, 459.0, 26.0, 13.8)
    return np.stack([x, y, z], axis=-1)


_lams = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 4096)
_rgb_clipped = np.clip(_np_xyz(_lams) @ _XYZ_TO_RGB.T, 0.0, None)
_RGB_NORM = np.maximum(_rgb_clipped.mean(axis=0), 1e-6).astype(np.float32)


def wavelength_rgb_weight(lam_nm):
    """RGB throughput weight of a hero wavelength drawn uniformly on
    [LAMBDA_MIN, LAMBDA_MAX]; E[weight] = (1, 1, 1)."""
    x, y, z = xyz_of_wavelength(lam_nm)
    xyz = torch.stack([x, y, z], dim=-1)
    m = torch.from_numpy(_XYZ_TO_RGB.copy()).to(xyz.device)
    rgb = torch.clamp_min(row_products(xyz, m), 0.0)
    return rgb / torch.from_numpy(_RGB_NORM).to(xyz.device)


def sample_wavelength(u):
    """Uniform hero wavelength in nm."""
    return LAMBDA_MIN + u * (LAMBDA_MAX - LAMBDA_MIN)
