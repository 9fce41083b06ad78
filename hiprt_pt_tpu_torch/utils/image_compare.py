"""Image comparison metrics, a copy of ``hiprt_pt_tpu.utils.image_compare``
(numpy only): RMSE, MAE and relative MSE for parity checks ("RMSE vs
reference at equal spp") and golden regression gates."""

from __future__ import annotations

import numpy as np


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def mae(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def rel_mse(a: np.ndarray, ref: np.ndarray, eps: float = 1e-2) -> float:
    """Relative MSE (standard MC-render metric: error weighted by reference
    brightness so dark regions don't vanish from the score)."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((a - ref) ** 2 / (ref ** 2 + eps)))


def tonemapped_rmse(a: np.ndarray, b: np.ndarray, gamma: float = 2.2) -> float:
    """RMSE in display space (closer to perceptual relevance)."""
    ta = np.clip(np.asarray(a, np.float64), 0, None) ** (1.0 / gamma)
    tb = np.clip(np.asarray(b, np.float64), 0, None) ** (1.0 / gamma)
    return rmse(np.clip(ta, 0, 1), np.clip(tb, 0, 1))


def compare_report(a: np.ndarray, ref: np.ndarray) -> dict:
    return {
        "rmse": rmse(a, ref),
        "mae": mae(a, ref),
        "rel_mse": rel_mse(a, ref),
        "tonemapped_rmse": tonemapped_rmse(a, ref),
    }
