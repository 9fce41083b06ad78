"""The yardstick: the card's published peaks, the least time of a
traversal launch, and the window's arithmetic. Nothing here reads the
program's own counts: a traversal's work is counted by the reference's own
walk over the reference's own BVH (reference/ops/traverse.py:walk), so a
kernel or BVH-builder change in the program cannot change it.
"""

from __future__ import annotations

import statistics

# one NVIDIA H100 SXM (the data sheet's dense rates at 700 W): float32
# outside the tensor cores, and HBM3 bandwidth
F32_OPS_PER_S = 67e12
BYTES_PER_S = 3.35e12
# f32 operations of one slab test (two boxes' 6 subtractions and 6
# products, 12 min/max, the entry/exit compare) and of one Moller-Trumbore
# triangle test (two cross products, four 3-term dots, the edge vector, u,
# v and t scaled, the reciprocal, 7 compares and the u + v sum)
SLAB_OPS, TRI_OPS = 25, 53
# bytes a launch must move: every ray's active flag, t_max and hit record
# (t, prim, u, v); an active ray's o, d and t_min
RAY_BYTES, ACTIVE_RAY_BYTES = 1 + 4 + 16, 28


def least_seconds(box_tests: int, tri_tests: int, n_rays: int,
                  n_active: int, table_bytes: int) -> float:
    """The least time the card could take for one traversal launch: the
    larger of its operations at the f32 peak and its bytes (the rays, and
    the scene's triangles and tree once if any ray is active) at the
    memory peak."""
    ops = box_tests * SLAB_OPS + tri_tests * TRI_OPS
    nbytes = n_rays * RAY_BYTES + n_active * ACTIVE_RAY_BYTES
    if n_active:
        nbytes += table_bytes
    return max(ops / F32_OPS_PER_S, nbytes / BYTES_PER_S)


def p95(values) -> float:
    """The 95th percentile of every value (linear between order
    statistics, statistics.quantiles' inclusive method)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=20, method="inclusive")[18])


def window_metrics(frames: int, samples_per_frame: int, seconds: float,
                   intervals_ms) -> dict:
    """spp_per_s: every sample per pixel that the window completed over the
    window's whole time; frame_ms_p95: the 95th percentile of the intervals
    between consecutive frame ends, over every frame of the window."""
    return {"spp_per_s": frames * samples_per_frame / seconds,
            "frame_ms_p95": p95(intervals_ms)}
