"""The dense emissive sweep on the card (csrc/emissive_sweep.cu) and its
wrapper.

``emissive_sweep`` finds, for each ray (o, d), the nearest emissive
triangle of the table ``rows`` it hits, occluders ignored: one launch of
``emissive_sweep_kernel``, bit for bit
``lights/light_sampling.py:_closest_emissive_hit_plain`` (its design and
bound are in the source). It takes CUDA tensors only; the caller
(``closest_emissive_hit``) runs the plain version on the CPU. Its
launches count in ``cuda_build.launch_counts["emissive_sweep"]``.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .cuda_build import check_tensor


def emissive_sweep(rows: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                   active: torch.Tensor | None = None,
                   t_min: float = 1e-5) -> tuple:
    """Nearest hit of each ray (o, d) (N,3) f32 among the triangles v0, e1,
    e2 in columns 0:9 of ``rows`` (E, W) f32, at t > t_min. Returns (t (N,)
    f32, inf on a miss; slot (N,) i64 into rows, -1 on a miss or where
    ``active`` (N,) bool is False). Raises on anything but contiguous f32
    CUDA tensors of those shapes, or if the launch fails."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"emissive_sweep runs on CUDA tensors, got {dev}")
    n = o.shape[0]
    check_tensor("o", o, torch.float32, (n, 3), dev)
    check_tensor("d", d, torch.float32, (n, 3), dev)
    if rows.dim() != 2 or rows.shape[1] < 9:
        raise ValueError(f"rows has shape {tuple(rows.shape)}, expected (E, >= 9)")
    check_tensor("rows", rows, torch.float32, tuple(rows.shape), dev)
    if active is not None:
        check_tensor("active", active, torch.bool, (n,), dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    slot = torch.empty((n,), dtype=torch.int64, device=dev)
    cuda_build.launch("emissive_sweep", dev, rows.data_ptr(), rows.shape[0],
                      rows.shape[1], o.data_ptr(), d.data_ptr(),
                      None if active is None else active.data_ptr(), n, t_min,
                      t.data_ptr(), slot.data_ptr())
    return t, slot
