"""The LUT baker and the baked lookup tables of the principled BSDF,
mirroring ``hiprt_pt_tpu.bake``. The ``data_*.npy`` files are
byte-identical copies of the JAX package's (read by models/principled.py);
``baker.py`` bakes them afresh and ``sheen_ltc_fit.py`` fits the sheen
LTC table and its polynomial."""
from .baker import (
    bake_all,
    bake_ggx_conductor_ess,
    bake_ggx_fresnel_ess,
    bake_ggx_glossy_dielectric_ess,
    bake_glossy_base_ess,
    save_lut,
)

__all__ = [
    "bake_all",
    "bake_ggx_conductor_ess",
    "bake_ggx_fresnel_ess",
    "bake_ggx_glossy_dielectric_ess",
    "bake_glossy_base_ess",
    "save_lut",
]
