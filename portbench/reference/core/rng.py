"""Deterministic counter-based per-ray RNG (PCG), bit-exact with
``hiprt_pt_tpu.core.rng``.

Every (pixel, sample, frame-seed) triple yields an independent, reproducible
stream, so the port draws the same random numbers as the JAX package and
renders can be compared pixel by pixel.

PyTorch has no uint32 arithmetic on every device, so the state is an int64
tensor holding a uint32 value; every product of a uint32 with a 32-bit
constant fits in int64 and is masked back with ``& 0xFFFFFFFF``.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PCG_MULT = 747796405
_PCG_INC = 2891336453


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG output permutation of a uint32 word (held in int64)."""
    state = (x * _PCG_MULT + _PCG_INC) & _MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _MASK
    return (word >> 22) ^ word


def seed(pixel_index: torch.Tensor, sample_number: int, global_seed: int) -> torch.Tensor:
    """Per-ray RNG state from (pixel, sample, seed)."""
    s = pcg_hash((pixel_index.to(torch.int64) + 1) & _MASK)
    s = pcg_hash(s ^ ((int(sample_number) * 0x9E3779B9) & _MASK))
    return pcg_hash(s ^ (int(global_seed) & _MASK))


def next_uint(state: torch.Tensor):
    """Advance: LCG step + PCG permutation. Returns (new_state, uint32 draw)."""
    new_state = (state * _PCG_MULT + _PCG_INC) & _MASK
    return new_state, pcg_hash(new_state)


def next_float(state: torch.Tensor):
    """Uniform float32 in [0, 1). Returns (new_state, floats)."""
    new_state, bits = next_uint(state)
    return new_state, (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def next_float2(state: torch.Tensor):
    state, a = next_float(state)
    state, b = next_float(state)
    return state, a, b
