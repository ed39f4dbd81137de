"""Counters / gauges / streaming histograms + a named registry.

The registry is the single sink the launchers and examples report through
(instead of ad-hoc prints), so rendered output, traces, and audit logs are all
views of the same recorded numbers. Everything is deterministic: histograms
are log-bucketed (no sampling), rendering sorts by metric name, and nothing
reads a clock.
"""

from __future__ import annotations

import math

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotone event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value: float | None = None

    def set(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            raise ValueError(f"gauge value must be finite, got {v!r}")
        self.value = v


class Histogram:
    """Streaming log-bucketed histogram with quantile estimates.

    Buckets grow geometrically (``GROWTH`` per bucket, ~7.7% relative width),
    so ``percentile`` is exact to within one bucket's relative width at any
    stream length in O(1) memory. Non-positive values land in a dedicated
    zero bucket (they are valid latencies for instants/zero-byte legs).
    """

    GROWTH = 1.08

    __slots__ = ("count", "sum", "_min", "_max", "_zero", "_buckets", "_log_g")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._zero = 0
        self._buckets: dict[int, int] = {}
        self._log_g = math.log(self.GROWTH)

    def record(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            raise ValueError(f"histogram observation must be finite, got {v!r}")
        self.count += 1
        self.sum += v
        self._min = min(self._min, v)
        self._max = max(self._max, v)
        if v <= 0.0:
            self._zero += 1
            return
        idx = math.floor(math.log(v) / self._log_g)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def min(self) -> float:
        return self._min if self.count else 0.0

    @property
    def max(self) -> float:
        return self._max if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in (0, 1); returns the geometric midpoint of the bucket holding
        the q-th observation (0.0 for the zero bucket)."""
        if not 0.0 < q < 1.0:
            raise ValueError(f"q must be in (0, 1), got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = float(self._zero)
        if rank <= seen:
            return 0.0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if rank <= seen:
                return self.GROWTH ** (idx + 0.5)
        return self._max

    @property
    def p50(self) -> float:
        return self.percentile(0.50)

    @property
    def p99(self) -> float:
        return self.percentile(0.99)


class MetricsRegistry:
    """Get-or-create named metrics; snapshot/render deterministically."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram())

    def snapshot(self) -> dict:
        """Plain-dict view (JSON-ready), sorted by metric name."""
        out: dict[str, dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._counters):
            out["counters"][name] = self._counters[name].value
        for name in sorted(self._gauges):
            out["gauges"][name] = self._gauges[name].value
        for name in sorted(self._histograms):
            h = self._histograms[name]
            out["histograms"][name] = {
                "count": h.count, "mean": h.mean, "min": h.min, "max": h.max,
                "p50": h.p50, "p99": h.p99,
            }
        return out

    def render(self, prefix: str = "") -> str:
        """Terminal-friendly rendering, one metric per line."""
        lines: list[str] = []
        snap = self.snapshot()
        for name, v in snap["counters"].items():
            lines.append(f"{prefix}{name} = {v}")
        for name, v in snap["gauges"].items():
            lines.append(f"{prefix}{name} = {v:g}" if v is not None
                         else f"{prefix}{name} = (unset)")
        for name, h in snap["histograms"].items():
            lines.append(
                f"{prefix}{name}: n={h['count']} mean={h['mean']:.6g} "
                f"p50={h['p50']:.6g} p99={h['p99']:.6g} max={h['max']:.6g}")
        return "\n".join(lines)
