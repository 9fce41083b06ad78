"""The benchmark's one call into the port's span registry
(hiprt_pt_tpu_torch/utils/spans.py): ``flush()``, then medians over the
steps the registry holds (its last 64 render_step calls: in a run, the
warm-up frames, the window's frames and the traced frames after it, so the
window decides the median). A port without the registry gives None, and
the metrics that read it are left out of the line.
"""

from __future__ import annotations

import statistics


def _registry():
    try:
        from hiprt_pt_tpu_torch.utils import spans
    except ImportError:
        return None
    spans.flush()
    return spans


def stream_ms(names) -> float | None:
    """Median over the render steps held of the stream ms a step spent in
    the spans named ``names`` (each span's own stream ms, its children's
    included), summed over the step; None where no step holds one."""
    spans = _registry()
    if spans is None:
        return None
    names = set(names)
    per_step: dict = {}
    for r in spans.records():
        if r.name in names and r.stream_ms is not None:
            per_step[r.step] = per_step.get(r.step, 0.0) + r.stream_ms
    return statistics.median(per_step.values()) if per_step else None


def share(num: str, den: str) -> float | None:
    """Median over the render steps held of 100 x the step's counter
    ``num`` over its counter ``den``; None where no step counted ``den``."""
    spans = _registry()
    if spans is None:
        return None
    shares = [100.0 * st.counters.get(num, 0) / st.counters[den]
              for st in spans.steps() if st.counters.get(den)]
    return statistics.median(shares) if shares else None
