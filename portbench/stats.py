"""Statistics over a window: percentiles over every sample, failures as
missing every limit."""

from __future__ import annotations

import math

import numpy as np

__all__ = ["percentile", "spread"]


def percentile(values, q: float) -> float | None:
    """The q-th percentile (linear between order statistics) over every value;
    ``inf`` (a failure) sorts last. ``None`` when there is no value."""
    v = np.asarray(list(values), dtype=np.float64)
    if v.size == 0:
        return None
    v = np.sort(v)
    pos = (v.size - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(v[hi]):
        return math.inf
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def spread(values) -> float:
    """Interquartile distance over the median (``statistics.quantiles``)."""
    import statistics
    q = statistics.quantiles(list(values), n=4)
    return (q[2] - q[0]) / statistics.median(values)
