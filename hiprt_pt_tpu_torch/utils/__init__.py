from .logger import get_logger
from .perf import PerformanceMetrics
from .precompile import Precompiler, common_permutations

__all__ = [
    "get_logger",
    "PerformanceMetrics",
    "Precompiler",
    "common_permutations",
]
