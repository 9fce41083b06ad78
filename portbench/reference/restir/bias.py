"""ReSTIR DI bias-status explainer, mirroring ``hiprt_pt_tpu.restir.bias``
(reference: ImGuiSettingsWindow.cpp:1639 display_ReSTIR_DI_bias_status).

Given the static options and the runtime settings, report whether the
configuration estimates direct lighting without bias and, if not, each
active source of bias with its explanation. The reuse passes' m-terms never
test visibility, so the reference's conditions on
BIAS_CORRECTION_USE_VISIBILITY simplify.
"""

from __future__ import annotations

from ..core.settings import (LightSamplingStrategy, RenderOptions,
                             ReSTIRBiasCorrection)

_REASONS = {
    "1/M": (
        "1/M biased weights",
        "1/M weights do not take into account how many neighbors could have "
        "produced the resampled sample; samples are under-weighted as if all "
        "M neighbors could have produced them, which darkens the image."),
    "visibility_reuse": (
        "Visibility reuse without visibility in bias correction",
        "The initial-candidate visibility-reuse pass discards occluded "
        "winners, so reuse passes only ever resample unoccluded samples. The "
        "m-term neighbor counting does not test visibility (this "
        "implementation has no bias-correction-visibility mode), so neighbors "
        "whose view of the sample is occluded are still counted as able to "
        "produce it — overestimating valid neighbors and darkening the "
        "result."),
    "visibility_target": (
        "Target-function visibility without visibility in bias correction",
        "With visibility inside the candidate target function, surviving "
        "samples are unoccluded; counting neighbors without a visibility test "
        "then overestimates how many could have produced the winner "
        "(darkening), exactly as with visibility reuse."),
    "adaptive": (
        "Adaptive sampling + spatial reuse of converged neighbors",
        "Adaptive sampling stops updating converged pixels; the spatial pass "
        "(which has no converged-neighbor exclusion here) keeps resampling "
        "from their frozen reservoirs, which shows up as bias exactly where "
        "adaptive sampling works hardest."),
    "no_final_visibility": (
        "Not using final shading visibility",
        "Skipping the final visibility ray shades samples as if unoccluded — "
        "shadows go missing and the scene brightens."),
}


def bias_status(options: RenderOptions, settings) -> dict:
    """{"active", "biased", "reasons": [{"title", "explanation"}]};
    ``active`` is False unless the light sampling strategy is ReSTIR DI."""
    if options.direct_light_sampling != LightSamplingStrategy.RESTIR_DI:
        return {"active": False, "biased": False, "reasons": []}
    rs = settings.restir_di
    active = (
        ("1/M", options.restir_di_bias_correction
         == ReSTIRBiasCorrection.M_WEIGHT_1_OVER_M),
        ("visibility_reuse", options.restir_di_initial_visibility),
        ("visibility_target", options.ris_use_visibility_target),
        ("adaptive", bool(settings.enable_adaptive_sampling)
         and bool(rs.spatial_enabled) and int(rs.num_spatial_passes) > 0),
        ("no_final_visibility", not options.restir_di_final_visibility),
    )
    reasons = [{"title": _REASONS[k][0], "explanation": _REASONS[k][1]}
               for k, on in active if on]
    return {"active": True, "biased": bool(reasons), "reasons": reasons}
