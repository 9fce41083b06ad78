"""Windowed streaming performance metrics, mirroring
``hiprt_pt_tpu.utils.perf`` (reference: PerformanceMetricsComputer,
src/UI/PerformanceMetricsComputer.h:14-60): per named metric, the average,
variance, standard deviation, median, minimum and maximum over a sliding
window."""

from __future__ import annotations

import math
import statistics
from collections import deque


class PerformanceMetrics:
    def __init__(self, window: int = 64):
        self.window = window
        self._series: dict[str, deque] = {}

    def add(self, name: str, value: float):
        s = self._series.setdefault(name, deque(maxlen=self.window))
        s.append(float(value))

    def values(self, name: str):
        return list(self._series.get(name, []))

    def get_average(self, name: str) -> float:
        s = self._series.get(name)
        return sum(s) / len(s) if s else 0.0

    def get_variance(self, name: str) -> float:
        s = self._series.get(name)
        if not s or len(s) < 2:
            return 0.0
        m = sum(s) / len(s)
        return sum((x - m) ** 2 for x in s) / (len(s) - 1)

    def get_stddev(self, name: str) -> float:
        return math.sqrt(self.get_variance(name))

    def get_median(self, name: str) -> float:
        s = self._series.get(name)
        return statistics.median(s) if s else 0.0

    def get_min(self, name: str) -> float:
        s = self._series.get(name)
        return min(s) if s else 0.0

    def get_max(self, name: str) -> float:
        s = self._series.get(name)
        return max(s) if s else 0.0

    def names(self):
        return list(self._series.keys())
