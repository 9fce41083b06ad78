"""Material data model — structure-of-arrays bank of principled-BSDF
parameters, mirroring ``hiprt_pt_tpu.core.material``.

One row per material; looking up the materials at a batch of hits is a plain
index gather per field (the JAX package's one-hot matmul path exists only for
the TPU's matrix unit).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NO_TEXTURE = -1

ROUGHNESS_CLAMP = 1.0e-4

# (field, default) — the JAX package's field order and reference defaults
_SCALAR_FIELDS = [
    ("emission_strength", 1.0),
    ("roughness", 0.3),
    ("oren_nayar_sigma", 0.34906585),
    ("metallic", 0.0),
    ("metallic_F90_falloff_exponent", 5.0),
    ("anisotropy", 0.0),
    ("anisotropy_rotation", 0.0),
    ("second_roughness_weight", 0.0),
    ("second_roughness", 0.5),
    ("specular", 1.0),
    ("specular_tint", 1.0),
    ("specular_darkening", 0.0),
    ("coat", 0.0),
    ("coat_medium_thickness", 5.0),
    ("coat_roughness", 0.0),
    ("coat_roughening", 1.0),
    ("coat_darkening", 1.0),
    ("coat_anisotropy", 0.0),
    ("coat_anisotropy_rotation", 0.0),
    ("coat_ior", 1.5),
    ("sheen", 0.0),
    ("sheen_roughness", 0.5),
    ("ior", 1.4),
    ("specular_transmission", 0.0),
    ("absorption_at_distance", 1.0),
    ("dispersion_scale", 0.0),
    ("dispersion_abbe_number", 20.0),
    ("thin_walled", 0.0),
    ("thin_film", 0.0),
    ("thin_film_ior", 1.3),
    ("thin_film_thickness", 500.0),
    ("thin_film_kappa_3", 0.0),
    ("thin_film_hue_shift_degrees", 0.0),
    ("thin_film_base_ior_override", 1.0),
    ("thin_film_do_ior_override", 0.0),
    ("alpha_opacity", 1.0),
    ("dielectric_priority", 0.0),
]

_COLOR_FIELDS = [
    ("base_color", (1.0, 1.0, 1.0)),
    ("emission", (0.0, 0.0, 0.0)),
    ("metallic_F82", (1.0, 1.0, 1.0)),
    ("metallic_F90", (1.0, 1.0, 1.0)),
    ("specular_color", (1.0, 1.0, 1.0)),
    ("coat_medium_absorption", (1.0, 1.0, 1.0)),
    ("sheen_color", (1.0, 1.0, 1.0)),
    ("absorption_color", (1.0, 1.0, 1.0)),
]

_TEXTURE_FIELDS = [
    "normal_map_texture_index",
    "emission_texture_index",
    "base_color_texture_index",
    "roughness_metallic_texture_index",
    "roughness_texture_index",
    "metallic_texture_index",
    "specular_texture_index",
    "coat_texture_index",
    "sheen_texture_index",
    "specular_transmission_texture_index",
]

FIELD_NAMES = (
    [name for name, _ in _SCALAR_FIELDS]
    + [name for name, _ in _COLOR_FIELDS]
    + _TEXTURE_FIELDS
)


def _from_rows(cls, rows: list, device="cpu"):
    """Bank from per-material dicts (missing keys → reference defaults)."""
    n = max(len(rows), 1)
    kw = {}
    for name, default in _SCALAR_FIELDS:
        arr = np.full((n,), float(default), dtype=np.float32)
        for i, r in enumerate(rows):
            if name in r:
                arr[i] = float(r[name])
        kw[name] = arr
    for name, default in _COLOR_FIELDS:
        arr = np.tile(np.asarray(default, dtype=np.float32), (n, 1))
        for i, r in enumerate(rows):
            if name in r:
                arr[i] = np.asarray(r[name], dtype=np.float32)[:3]
        kw[name] = arr
    for name in _TEXTURE_FIELDS:
        arr = np.full((n,), NO_TEXTURE, dtype=np.int32)
        for i, r in enumerate(rows):
            if name in r:
                arr[i] = int(r[name])
        kw[name] = arr
    return cls(**{k: torch.from_numpy(v).to(device) for k, v in kw.items()})


def _num_materials(self) -> int:
    return self.roughness.shape[0]


def _to(self, device):
    return dataclasses.replace(
        self, **{k: getattr(self, k).to(device) for k in FIELD_NAMES})


def _at_indices(self, mat_ids: torch.Tensor):
    """Per-hit materials: every field gathered at mat_ids (N,)."""
    idx = mat_ids.clamp(0, self.num_materials - 1).long()
    return type(self)(**{k: getattr(self, k)[idx] for k in FIELD_NAMES})


def _fields_at(self, mat_ids: torch.Tensor, names: tuple) -> dict:
    """Only the named fields at mat_ids: {name: (N,) or (N,3)}."""
    idx = mat_ids.clamp(0, self.num_materials - 1).long()
    out = {}
    for name in names:
        if name not in FIELD_NAMES:
            raise KeyError(name)
        out[name] = getattr(self, name)[idx]
    return out


def _make_safe(self):
    """Clamp degenerate parameter values (reference: Material.h make_safe)."""
    return dataclasses.replace(
        self,
        roughness=self.roughness.clamp_min(ROUGHNESS_CLAMP),
        coat_roughness=self.coat_roughness.clamp_min(ROUGHNESS_CLAMP),
        second_roughness=self.second_roughness.clamp_min(ROUGHNESS_CLAMP),
        sheen_roughness=self.sheen_roughness.clamp_min(ROUGHNESS_CLAMP),
        absorption_color=self.absorption_color.clamp_min(1.0 / 512.0),
    )


def _effective_emission(self) -> torch.Tensor:
    return self.emission * self.emission_strength[..., None]


MaterialBank = dataclasses.make_dataclass(
    "MaterialBank",
    [(name, torch.Tensor) for name in FIELD_NAMES],
    namespace={
        "__doc__": "SoA bank of N materials. Scalar fields: (N,) f32; "
                   "colors: (N,3) f32; texture indices: (N,) i32.",
        "__module__": __name__,
        "from_rows": classmethod(_from_rows),
        "num_materials": property(_num_materials),
        "to": _to,
        "at_indices": _at_indices,
        "fields_at": _fields_at,
        "make_safe": _make_safe,
        "effective_emission": _effective_emission,
    },
)


def oren_nayar_AB(sigma: torch.Tensor):
    """Oren-Nayar A/B coefficients (reference Material.h:73-78)."""
    s2 = sigma * sigma
    A = 1.0 - 0.5 * s2 / (s2 + 0.33)
    B = 0.45 * s2 / (s2 + 0.09)
    return A, B


def get_alphas(roughness: torch.Tensor, anisotropy: torch.Tensor):
    """GGX alpha_x, alpha_y from roughness and anisotropy (reference
    Material.h:80-85)."""
    aspect = torch.sqrt(1.0 - 0.9 * anisotropy)
    r2 = roughness * roughness
    alpha_x = torch.clamp_min(r2 / aspect, ROUGHNESS_CLAMP)
    alpha_y = torch.clamp_min(r2 * aspect, ROUGHNESS_CLAMP)
    return alpha_x, alpha_y


def thin_walled_roughness(thin_walled: torch.Tensor, base_roughness: torch.Tensor,
                          relative_eta: torch.Tensor) -> torch.Tensor:
    """Roughness remap so a thin-walled single interface matches a
    double-interface slab (reference Material.h:87-111)."""
    eta = torch.where((relative_eta - 1.0).abs() < 1.0e-3, 1.001, relative_eta)
    remapped = base_roughness * torch.sqrt(torch.clamp_min(
        3.7 * (eta - 1.0) * torch.square(eta - 0.5) / (eta ** 3), 0.0))
    r = torch.where(thin_walled > 0.5, remapped, base_roughness)
    return torch.clamp(r, ROUGHNESS_CLAMP, 1.0)
