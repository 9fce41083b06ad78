"""The device the port's entry points run on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` when given, else the current CUDA device. The CPU runs only
    when the caller asks for it (``device="cpu"``); there every traversal
    kernel's plain PyTorch version runs in its place."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to "
            "run its plain PyTorch version on the host")
    return torch.device("cuda", torch.cuda.current_device())
