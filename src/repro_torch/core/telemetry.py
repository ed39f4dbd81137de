"""Runtime metric estimation (paper §4.2, §5.1).

The resource manager "periodically collects runtime metrics including network
bandwidth, edge server load, and request arrival rate". These estimators are
what it collects them with:

  * arrival rate lambda — sliding window over request timestamps (§4.2)
  * bandwidth B         — EWMA over iperf-style measurements (§4.2)
  * service rate mu / utilisation rho — completions per interval (§4.2)
  * service mean/variance — windowed moments (feeds the M/G/1 terms)
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "SlidingRateEstimator",
    "EwmaEstimator",
    "WindowedMoments",
    "UtilisationEstimator",
    "TelemetrySnapshot",
]


class SlidingRateEstimator:
    """lambda-hat = (#events in window) / window (paper: 'sliding window over
    incoming request timestamps')."""

    def __init__(self, window_s: float = 10.0):
        if window_s <= 0:
            raise ValueError("window must be positive")
        self.window_s = window_s
        self._times: deque[float] = deque()

    def record(self, t: float) -> None:
        t = float(t)
        if not np.isfinite(t):
            # a NaN/inf timestamp would poison every eviction comparison from
            # here on (NaN compares false, so nothing ever evicts) — reject
            # at the boundary instead of propagating a silently-wrong rate
            raise ValueError(f"timestamp must be finite, got {t!r}")
        if self._times and t < self._times[-1]:
            raise ValueError("timestamps must be non-decreasing")
        self._times.append(t)
        self._evict(t)

    def _evict(self, now: float) -> None:
        # strict <: an event exactly window_s old is still IN the window
        while self._times and self._times[0] < now - self.window_s:
            self._times.popleft()

    def rate(self, now: float | None = None) -> float:
        if not self._times:
            return 0.0
        now = self._times[-1] if now is None else float(now)
        if not np.isfinite(now):
            raise ValueError(f"now must be finite, got {now!r}")
        self._evict(now)
        if not self._times:
            return 0.0
        return len(self._times) / self.window_s


class EwmaEstimator:
    """Exponentially-weighted moving average (bandwidth, edge load reports)."""

    def __init__(self, alpha: float = 0.3, initial: float | None = None):
        if not 0 < alpha <= 1:
            raise ValueError("alpha in (0, 1]")
        if initial is not None and not np.isfinite(initial):
            raise ValueError(f"initial must be finite, got {initial!r}")
        self.alpha = alpha
        self._value = initial

    def update(self, x: float) -> float:
        x = float(x)
        if not np.isfinite(x):
            # one NaN observation would stick in the average forever (every
            # later blend stays NaN); an inf decays but lingers for many
            # epochs — a corrupted probe reading must fail at ingest
            raise ValueError(f"observation must be finite, got {x!r}")
        self._value = x if self._value is None else self.alpha * x + (1 - self.alpha) * self._value
        return self._value

    @property
    def value(self) -> float:
        if self._value is None:
            raise RuntimeError("no observations yet")
        return self._value

    @property
    def initialized(self) -> bool:
        return self._value is not None


class WindowedMoments:
    """Rolling mean/variance of the last n observations (service times)."""

    def __init__(self, maxlen: int = 512):
        self._buf: deque[float] = deque(maxlen=maxlen)

    def record(self, x: float) -> None:
        x = float(x)
        if not np.isfinite(x):
            # a single NaN/inf makes mean AND var non-finite for the next
            # maxlen observations — reject loudly at the boundary
            raise ValueError(f"observation must be finite, got {x!r}")
        self._buf.append(x)

    @property
    def count(self) -> int:
        return len(self._buf)

    @property
    def mean(self) -> float:
        if not self._buf:
            raise RuntimeError(
                "WindowedMoments.mean on an empty window — record() at least "
                "one observation (or check .count) before reading the mean")
        return float(np.mean(self._buf))

    @property
    def var(self) -> float:
        # one sample has no spread information: report 0.0 (a deterministic
        # M/G/1 prior) rather than the NaN ddof=1 would produce
        if len(self._buf) < 2:
            return 0.0
        return float(np.var(self._buf, ddof=1))


class UtilisationEstimator:
    """rho-hat = lambda-hat / mu-hat, mu-hat from completions per interval."""

    def __init__(self, window_s: float = 10.0):
        self.arrivals = SlidingRateEstimator(window_s)
        self.completions = SlidingRateEstimator(window_s)
        self.service = WindowedMoments()

    def on_arrival(self, t: float) -> None:
        self.arrivals.record(t)

    def on_completion(self, t: float, service_s: float) -> None:
        self.completions.record(t)
        self.service.record(service_s)

    def utilisation(self, now: float | None = None) -> float:
        lam = self.arrivals.rate(now)
        if self.service.count == 0:
            return 0.0
        return lam * self.service.mean


@dataclass(frozen=True)
class TelemetrySnapshot:
    """One epoch's inputs to Algorithm 1."""

    time_s: float
    lam_dev: float  # device arrival rate
    bandwidth_Bps: float  # measured B
    edge_arrival_rates: tuple[float, ...] = ()  # lambda_edge,E per server
    edge_service_means: tuple[float, ...] = ()  # aggregate s_edge,E
    edge_service_vars: tuple[float, ...] = ()  # Var[s_edge,E]
    extras: dict = field(default_factory=dict, compare=False)
