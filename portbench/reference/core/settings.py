"""Render configuration, mirroring ``hiprt_pt_tpu.core.settings``.

``RenderOptions`` holds the static feature switches (same field names and
enums as the JAX package). ``RenderSettings`` and ``WorldSettings`` hold the
runtime knobs the render path reads, as plain Python values: the host reads
them to drive the bounce loop, so keeping them off the device costs no sync.
"""

from __future__ import annotations

import dataclasses
import enum


class LightSamplingStrategy(enum.IntEnum):
    NO_NEE = 0
    UNIFORM_ONE = 1
    BSDF_ONLY = 2
    MIS = 3
    RIS_BSDF_LIGHT = 4
    RESTIR_DI = 5


class EnvmapSamplingStrategy(enum.IntEnum):
    NO_SAMPLING = 0
    CDF_BINARY = 1
    ALIAS_TABLE = 2


class BSDFOverride(enum.IntEnum):
    NONE = 0
    LAMBERTIAN = 1
    OREN_NAYAR = 2
    PRINCIPLED = 3


class InteriorStackStrategy(enum.IntEnum):
    AUTOMATIC = 0
    WITH_PRIORITIES = 1


class GGXSamplingVariant(enum.IntEnum):
    VNDF = 0
    VNDF_SPHERICAL_CAPS = 1


class ReSTIRBiasCorrection(enum.IntEnum):
    M_WEIGHT_1_OVER_M = 0
    M_WEIGHT_1_OVER_Z = 1
    MIS_LIKE = 2
    MIS_GBH = 3
    PAIRWISE_MIS = 4
    PAIRWISE_MIS_DEFENSIVE = 5


class AmbientLightType(enum.IntEnum):
    NONE = 0
    UNIFORM = 1
    ENVMAP = 2


class RussianRouletteMethod(enum.IntEnum):
    MAX_THROUGHPUT = 0
    ARNOLD = 1


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Static feature matrix; field names and defaults follow the JAX
    package's ``RenderOptions``."""

    direct_light_sampling: LightSamplingStrategy = LightSamplingStrategy.MIS
    envmap_sampling: EnvmapSamplingStrategy = EnvmapSamplingStrategy.ALIAS_TABLE
    envmap_bsdf_mis: bool = True
    ris_use_visibility_target: bool = False
    ris_proxy_target: bool = True
    ris_tile_light_candidates: int = 128
    bsdf_override: BSDFOverride = BSDFOverride.NONE
    interior_stack_strategy: InteriorStackStrategy = (
        InteriorStackStrategy.WITH_PRIORITIES
    )
    nested_dielectrics_stack_size: int = 3
    ggx_sampling: GGXSamplingVariant = GGXSamplingVariant.VNDF_SPHERICAL_CAPS
    restir_di_initial_visibility: bool = True
    restir_di_temporal_visibility: bool = False
    restir_di_spatial_visibility_last_pass: bool = True
    restir_di_final_visibility: bool = True
    restir_di_bias_correction: ReSTIRBiasCorrection = (
        ReSTIRBiasCorrection.PAIRWISE_MIS_DEFENSIVE
    )
    restir_di_confidence_weights: bool = True
    restir_di_fused_spatiotemporal: bool = False
    restir_presample_subset_count: int = 128
    restir_presample_subset_size: int = 1024
    restir_do_light_presampling: bool = True
    do_energy_compensation: bool = True
    do_dispersion: bool = True
    do_thin_film: bool = True
    glass_compensation_exact: bool = False
    max_bounces_static: int = 8
    use_pallas_traversal: bool = True
    white_furnace_mode: bool = False

    def replace(self, **kw) -> "RenderOptions":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class RISSettings:
    """Candidate counts of RIS direct lighting (lights/ris.py; reference:
    RenderSettings.h RISSettings)."""

    number_of_light_candidates: int = 4
    number_of_bsdf_candidates: int = 1


@dataclasses.dataclass
class ReSTIRDISettings:
    """Runtime knobs of ReSTIR DI (restir/di.py; reference:
    ReSTIRDISettings.h:12-195)."""

    # initial candidates
    num_light_candidates: int = 4
    num_bsdf_candidates: int = 1
    # the share of light candidates drawn from the envmap, when the scene
    # has one and envmap sampling is on
    envmap_candidate_probability: float = 0.25
    # temporal pass
    temporal_enabled: bool = True
    temporal_max_neighbor_search: int = 8
    temporal_neighbor_search_radius: float = 4.0
    # permutation sampling of the exact reprojected tap
    temporal_use_permutation_sampling: bool = False
    m_cap: int = 25
    # spatial passes
    spatial_enabled: bool = True
    num_spatial_passes: int = 2
    spatial_radius: float = 16.0
    num_spatial_neighbors: int = 3
    disocclusion_boost_candidates: int = 6
    # neighbour similarity heuristics
    normal_similarity_threshold: float = 0.906  # cos(25deg)
    plane_distance_threshold: float = 0.1
    roughness_similarity_threshold: float = 0.25

    def replace(self, **kw) -> "ReSTIRDISettings":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class RenderSettings:
    """Runtime knobs of the render step (the fields the port reads)."""

    accumulate: bool = True
    samples_per_frame: int = 1
    nb_bounces: int = 8
    rr_min_depth: int = 3
    rr_throughput_clamp: float = 10.0
    do_russian_roulette: bool = True
    direct_contribution_clamp: float = 0.0
    envmap_contribution_clamp: float = 0.0
    indirect_contribution_clamp: float = 0.0
    minimum_light_contribution: float = 0.0
    enable_adaptive_sampling: bool = False
    adaptive_sampling_min_samples: int = 64
    adaptive_sampling_noise_threshold: float = 0.1
    # stop conditions (Renderer.is_rendering_done): with a positive noise
    # threshold, stop once this share of the pixels has converged
    stop_noise_threshold: float = 0.0
    stop_pixel_percentage_converged: float = 0.9
    render_low_resolution: bool = False
    low_resolution_scale: int = 4
    do_alpha_testing: bool = True
    rr_method: int = int(RussianRouletteMethod.MAX_THROUGHPUT)
    number_of_light_samples: int = 1
    freeze_random: bool = False
    ris: RISSettings = dataclasses.field(default_factory=RISSettings)
    restir_di: ReSTIRDISettings = dataclasses.field(
        default_factory=ReSTIRDISettings)

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)


_IDENTITY3 = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


@dataclasses.dataclass
class WorldSettings:
    """Ambient lighting controls (reference: WorldSettings.h:17-53). The
    envmap texture and its sampling tables live in ``SceneData.envmap``;
    the rotations are 3x3 row tuples."""

    ambient_light_type: int = int(AmbientLightType.UNIFORM)
    uniform_light_color: tuple = (0.5, 0.5, 0.5)
    envmap_intensity: float = 1.0
    envmap_to_world: tuple = _IDENTITY3
    world_to_envmap: tuple = _IDENTITY3

    def replace(self, **kw) -> "WorldSettings":
        return dataclasses.replace(self, **kw)
