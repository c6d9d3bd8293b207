"""Fixed-bucket latency histograms — a copy of ``Histogram`` and
``latency_summary`` from ``repro/serving/telemetry.py`` (the rest of that
module, the metrics registry and span tracer, is not ported yet)."""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Tuple


def _geometric_bounds(lo: float = 1e-6, hi: float = 64.0,
                      ratio: float = 2 ** 0.5) -> Tuple[float, ...]:
    bounds: List[float] = []
    v = lo
    while v < hi * (1.0 + 1e-9):
        bounds.append(v)
        v *= ratio
    return tuple(bounds)


# 1 µs .. 64 s at a sqrt(2) ratio
DEFAULT_BOUNDS = _geometric_bounds()


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles, clamped to the
    observed min/max (a single-valued histogram reports that value)."""
    __slots__ = ('bounds', 'counts', 'count', 'total', '_min', '_max')

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_BOUNDS):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.total = 0.0
        self._min = float('inf')
        self._max = float('-inf')

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        self._min = min(self._min, v)
        self._max = max(self._max, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> Optional[float]:
        """Interpolated q-th percentile (q in [0, 100]); None when empty."""
        if not self.count:
            return None
        target = (q / 100.0) * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c:
                lo = self.bounds[i - 1] if i > 0 else self._min
                hi = self.bounds[i] if i < len(self.bounds) else self._max
                lo = max(min(lo, hi), self._min)
                hi = min(hi, self._max)
                est = lo + (hi - lo) * max(0.0, min(1.0, (target - cum) / c))
                return float(min(max(est, self._min), self._max))
            cum += c
        return float(self._max)

    @classmethod
    def of(cls, values) -> 'Histogram':
        h = cls()
        for v in values:
            h.observe(v)
        return h


def latency_summary(suffix: str, values) -> Dict[str, float]:
    """``mean_/p50_/p99_<suffix>`` keys for a sample list, and no keys at
    all when it is empty (a missing key is "no samples", never 0.0)."""
    if not len(values):
        return {}
    h = Histogram.of(values)
    return {f'mean_{suffix}': h.mean, f'p50_{suffix}': h.percentile(50),
            f'p99_{suffix}': h.percentile(99)}
