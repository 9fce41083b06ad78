"""Display transforms, mirroring ``hiprt_pt_tpu.ops.tonemap``."""

from __future__ import annotations

import torch


def resolve_accumulation(accum: torch.Tensor, sample_count: int) -> torch.Tensor:
    """Accumulated radiance sum → mean radiance."""
    return accum / max(float(sample_count), 1.0)


def tonemap_gamma(hdr: torch.Tensor, exposure=1.0, gamma=2.2) -> torch.Tensor:
    x = (hdr * exposure).clamp_min(0.0) ** (1.0 / gamma)
    return x.clamp(0.0, 1.0)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
