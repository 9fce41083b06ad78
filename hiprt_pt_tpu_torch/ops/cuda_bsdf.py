"""The principled BSDF on the card (csrc/principled.cu) and its wrapper.

``eval_pdf`` and ``sample`` are ``models/principled.py``'s of the same
names for CUDA tensors: one launch of ``principled_eval_kernel`` or
``principled_sample_kernel`` each (the design, the bound and what the
kernels keep of the plain version's arithmetic are in the source). They
take CUDA tensors only; the caller runs the plain version on the CPU.
Their launches count in ``cuda_build.launch_counts["principled_eval"]``
and ``["principled_sample"]``.

The kernels read the material fields of ``SCALAR_FIELDS`` and
``COLOR_FIELDS`` (the enums of the source, in the same order) through
pointers passed by value, and the coefficient table the caller passes
(``models/principled.py:device_coefficients``: the plain version's fits
and baked tables, laid out as the source reads them).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.settings import GGXSamplingVariant, RenderOptions
from . import cuda_build
from .cuda_build import check_tensor

SCALAR_FIELDS = (
    "roughness", "oren_nayar_sigma", "metallic", "metallic_F90_falloff_exponent",
    "anisotropy", "anisotropy_rotation", "second_roughness_weight",
    "second_roughness", "specular", "specular_tint", "coat",
    "coat_medium_thickness", "coat_roughness", "coat_darkening",
    "coat_anisotropy", "coat_ior", "sheen", "sheen_roughness", "ior",
    "specular_transmission", "thin_walled", "thin_film", "thin_film_ior",
    "thin_film_thickness", "thin_film_hue_shift_degrees",
    "thin_film_base_ior_override", "thin_film_do_ior_override")
COLOR_FIELDS = ("base_color", "metallic_F82", "metallic_F90", "specular_color",
                "coat_medium_absorption", "sheen_color")

# the source's option flags
THIN_FILM, ENERGY_COMPENSATION, COMPENSATION_EXACT, SPHERICAL_CAPS = 1, 2, 4, 8


def option_flags(options: RenderOptions) -> int:
    """The kernels' flags of the options the principled BSDF reads."""
    return ((THIN_FILM if options.do_thin_film else 0)
            | (ENERGY_COMPENSATION if options.do_energy_compensation else 0)
            | (COMPENSATION_EXACT if options.glass_compensation_exact else 0)
            | (SPHERICAL_CAPS if options.ggx_sampling
               == GGXSamplingVariant.VNDF_SPHERICAL_CAPS else 0))


def _vec(name, t, n, dev):
    t = t.contiguous()
    check_tensor(name, t, torch.float32, (n, 3), dev)
    return t


def _fields(mats, n, dev):
    """The material fields' pointers (a ctypes array) and the tensors
    behind them, which the caller keeps alive through the launch."""
    held = []
    for name in SCALAR_FIELDS + COLOR_FIELDS:
        t = getattr(mats, name).contiguous()
        shape = (n,) if name in SCALAR_FIELDS else (n, 3)
        check_tensor(f"mats.{name}", t, torch.float32, shape, dev)
        held.append(t)
    ptrs = (ctypes.c_void_p * len(held))(*(t.data_ptr() for t in held))
    return ptrs, held


def _checked(table, mats, n_t, wo, eta_rel, wi=None, rng_state=None):
    """The inputs, contiguous, after checking their types and shapes and
    then that they lie on the card; wi for eval,
    rng_state for sample. The caller binds ``held`` until its launch is
    queued: a field's contiguous copy freed earlier could become an
    output's memory."""
    dev = n_t.device
    n = n_t.shape[0]
    n_t = _vec("n", n_t, n, dev)
    wo = _vec("wo", wo, n, dev)
    if wi is not None:
        wi = _vec("wi", wi, n, dev)
    if rng_state is not None:
        rng_state = rng_state.contiguous()
        check_tensor("rng_state", rng_state, torch.int64, (n,), dev)
    if eta_rel is not None:
        eta_rel = eta_rel.contiguous()
        check_tensor("eta_rel", eta_rel, torch.float32, (n,), dev)
    ptrs, held = _fields(mats, n, dev)
    if dev.type != "cuda":
        raise ValueError(f"the principled kernels run on CUDA tensors, got {dev}")
    lib = cuda_build.load_libraries()["principled"]
    check_tensor("table", table, torch.float32,
                 (lib.hpt_principled_table_floats(),), dev)
    return dev, n, n_t, wo, wi, rng_state, eta_rel, ptrs, held


def eval_pdf(options: RenderOptions, table, mats, n_t, wo, wi,
             eta_rel=None) -> tuple:
    """f (N, 3) and pdf (N,) of the principled BSDF at world-frame (n, wo,
    wi) (N, 3) f32; ``eta_rel`` (N,) f32 or None (the material's ior,
    clamped); ``table`` the coefficient table on the same card. Raises on
    anything but f32 CUDA tensors of those shapes (the materials' fields
    (N,) and (N, 3)), or if the launch fails."""
    dev, n, n_t, wo, wi, _, eta_rel, ptrs, held = _checked(
        table, mats, n_t, wo, eta_rel, wi=wi)
    f = torch.empty((n, 3), dtype=torch.float32, device=dev)
    pdf = torch.empty((n,), dtype=torch.float32, device=dev)
    cuda_build.launch("principled_eval", dev, ptrs, n_t.data_ptr(),
                      wo.data_ptr(), wi.data_ptr(),
                      None if eta_rel is None else eta_rel.data_ptr(),
                      table.data_ptr(), option_flags(options), n,
                      f.data_ptr(), pdf.data_ptr())
    return f, pdf


def sample(options: RenderOptions, table, mats, n_t, wo, rng_state,
           eta_rel=None, with_lobe: bool = False) -> tuple:
    """Draw a direction from the principled BSDF at (n, wo) (N, 3) f32 with
    the RNG states ``rng_state`` (N,) int64. Returns (the advanced states,
    wi (N, 3) world, f (N, 3), pdf (N,), refracted (N,) bool). Raises as
    ``eval_pdf``. ``with_lobe`` is a hook for the checks against the plain
    version (the card tests, chip_smoke.py): it appends the drawn lobe (N,)
    int8 (0 coat, 1 sheen, 2 metal, 3 glass, 4 specular, 5 diffuse), which
    wi and refracted do not tell (metal, specular and glass's reflection
    draw the same wi); the render path leaves it off."""
    dev, n, n_t, wo, _, rng_state, eta_rel, ptrs, held = _checked(
        table, mats, n_t, wo, eta_rel, rng_state=rng_state)
    rng_out = torch.empty((n,), dtype=torch.int64, device=dev)
    wi = torch.empty((n, 3), dtype=torch.float32, device=dev)
    f = torch.empty((n, 3), dtype=torch.float32, device=dev)
    pdf = torch.empty((n,), dtype=torch.float32, device=dev)
    refracted = torch.empty((n,), dtype=torch.bool, device=dev)
    lobe = torch.empty((n,), dtype=torch.int8, device=dev) if with_lobe else None
    cuda_build.launch("principled_sample", dev, ptrs, n_t.data_ptr(),
                      wo.data_ptr(), rng_state.data_ptr(),
                      None if eta_rel is None else eta_rel.data_ptr(),
                      table.data_ptr(), option_flags(options), n,
                      rng_out.data_ptr(), wi.data_ptr(), f.data_ptr(),
                      pdf.data_ptr(), refracted.data_ptr(),
                      None if lobe is None else lobe.data_ptr())
    out = (rng_out, wi, f, pdf, refracted)
    return out + (lobe,) if with_lobe else out
