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


def cuda_ms(fn, reps: int = 3):
    """(mean ms of ``reps`` back-to-back calls of ``fn`` between CUDA events,
    after a warm-up call; the warm-up call's result)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out

