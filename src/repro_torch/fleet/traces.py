"""Time-varying condition traces for the §5 adaptive-manager experiments.

A :class:`Trace` is the epoch-sampled environment the paper's resource
manager reacts to: measured network bandwidth, request arrival rate, and
per-edge aggregate background load ("dynamic multi-tenant edge settings").
Generators cover the three shapes the evaluation uses:

  * :func:`step_signal` — piecewise-constant schedules (the Fig. 6
    20 -> 10 -> 2 -> 20 Mbps bandwidth walk, Fig. 7 load phases);
  * :func:`drift_signal` — linear drift with an optional seeded random walk
    (slow diurnal-style change);
  * :func:`mmpp_signal` — a 2-state Markov-modulated level (bursty
    conditions: the process alternates between a low and a high level with
    geometric sojourn times, the discrete-epoch cousin of an MMPP).

All generators are plain numpy and seeded — a trace is data, not a process,
so replays are exactly reproducible and trivially serialisable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = [
    "Trace",
    "TraceBatch",
    "epoch_times",
    "step_signal",
    "drift_signal",
    "mmpp_signal",
    "make_trace",
]


@dataclass(frozen=True)
class Trace:
    """Epoch-sampled environment conditions for a trace-driven replay."""

    times: np.ndarray  # (T,) epoch start times, uniformly spaced
    bandwidth_Bps: np.ndarray  # (T,) measured shared-path bandwidth
    arrival_rate: np.ndarray  # (T,) device request rate lambda
    edge_bg_rate: np.ndarray  # (T, E) aggregate background rate per edge

    def __post_init__(self):
        t = np.asarray(self.times, dtype=np.float64)
        object.__setattr__(self, "times", t)
        object.__setattr__(self, "bandwidth_Bps",
                           np.asarray(self.bandwidth_Bps, dtype=np.float64))
        object.__setattr__(self, "arrival_rate",
                           np.asarray(self.arrival_rate, dtype=np.float64))
        bg = np.asarray(self.edge_bg_rate, dtype=np.float64)
        if bg.ndim == 1:
            bg = bg[:, None]
        object.__setattr__(self, "edge_bg_rate", bg)
        if t.ndim != 1 or len(t) < 2:
            raise ValueError("trace needs at least two epochs")
        dts = np.diff(t)
        if not np.allclose(dts, dts[0]) or dts[0] <= 0:
            raise ValueError("trace epochs must be uniformly spaced and increasing")
        for name in ("bandwidth_Bps", "arrival_rate"):
            arr = getattr(self, name)
            if arr.shape != t.shape:
                raise ValueError(f"{name} must be shape {t.shape}, got {arr.shape}")
        if self.edge_bg_rate.shape[0] != len(t):
            raise ValueError("edge_bg_rate must have one row per epoch")
        if np.any(self.bandwidth_Bps <= 0):
            raise ValueError("bandwidth must be positive everywhere")
        if np.any(self.arrival_rate <= 0):
            raise ValueError("arrival rate must be positive everywhere")
        if np.any(self.edge_bg_rate < 0):
            raise ValueError("background rates must be non-negative")

    @property
    def n_epochs(self) -> int:
        return int(len(self.times))

    @property
    def n_edges(self) -> int:
        return int(self.edge_bg_rate.shape[1])

    @property
    def epoch_s(self) -> float:
        return float(self.times[1] - self.times[0])


@dataclass(frozen=True)
class TraceBatch:
    """Per-client condition traces for a closed-loop cluster replay.

    The N-client generalisation of :class:`Trace`: every client sees its own
    measured bandwidth and arrival rate, while ``edge_bg_rate`` is the
    *exogenous* (non-cluster) background load per shared edge — the
    endogenous part, what the other N-1 clients offload, is produced by the
    closed loop itself (:mod:`repro_torch.fleet.cluster`), never by a trace.
    """

    times: np.ndarray  # (T,) epoch start times, uniformly spaced
    bandwidth_Bps: np.ndarray  # (T, N) per-client measured bandwidth
    arrival_rate: np.ndarray  # (T, N) per-client request rate lambda
    edge_bg_rate: np.ndarray  # (T, E) exogenous background rate per edge

    def __post_init__(self):
        t = np.asarray(self.times, dtype=np.float64)
        object.__setattr__(self, "times", t)
        for name in ("bandwidth_Bps", "arrival_rate", "edge_bg_rate"):
            object.__setattr__(self, name,
                               np.asarray(getattr(self, name), dtype=np.float64))
        if t.ndim != 1 or len(t) < 2:
            raise ValueError("trace batch needs at least two epochs")
        dts = np.diff(t)
        if not np.allclose(dts, dts[0]) or dts[0] <= 0:
            raise ValueError("trace epochs must be uniformly spaced and increasing")
        for name in ("bandwidth_Bps", "arrival_rate", "edge_bg_rate"):
            arr = getattr(self, name)
            if arr.ndim != 2 or arr.shape[0] != len(t):
                raise ValueError(f"{name} must be (n_epochs, ...) 2-D with "
                                 f"{len(t)} rows, got shape {arr.shape}")
        if self.bandwidth_Bps.shape != self.arrival_rate.shape:
            raise ValueError("bandwidth_Bps and arrival_rate must agree on "
                             "(n_epochs, n_clients)")
        if self.n_clients < 1:
            raise ValueError("trace batch needs at least one client column")
        if np.any(self.bandwidth_Bps <= 0):
            raise ValueError("bandwidth must be positive everywhere")
        if np.any(self.arrival_rate <= 0):
            raise ValueError("arrival rate must be positive everywhere")
        if np.any(self.edge_bg_rate < 0):
            raise ValueError("background rates must be non-negative")

    @property
    def n_epochs(self) -> int:
        return int(len(self.times))

    @property
    def n_clients(self) -> int:
        return int(self.bandwidth_Bps.shape[1])

    @property
    def n_edges(self) -> int:
        return int(self.edge_bg_rate.shape[1])

    @property
    def epoch_s(self) -> float:
        return float(self.times[1] - self.times[0])

    @classmethod
    def from_trace(cls, trace: Trace, n_clients: int) -> "TraceBatch":
        """Broadcast one single-client trace over ``n_clients`` identical
        columns (every client measures the same conditions)."""
        if n_clients < 1:
            raise ValueError("n_clients must be positive")
        tile = np.repeat(trace.bandwidth_Bps[:, None], n_clients, axis=1)
        lam = np.repeat(trace.arrival_rate[:, None], n_clients, axis=1)
        return cls(times=trace.times, bandwidth_Bps=tile, arrival_rate=lam,
                   edge_bg_rate=trace.edge_bg_rate)

    @classmethod
    def from_traces(cls, traces: Sequence[Trace]) -> "TraceBatch":
        """Stack N per-client traces column-wise.

        All traces must share the same epoch grid, and — because the
        exogenous edge background is a property of the shared pool, not of
        any one client — identical ``edge_bg_rate`` columns."""
        if not traces:
            raise ValueError("need at least one trace")
        first = traces[0]
        for k, tr in enumerate(traces[1:], start=1):
            if not np.array_equal(tr.times, first.times):
                raise ValueError(f"trace {k} has a different epoch grid")
            if not np.array_equal(tr.edge_bg_rate, first.edge_bg_rate):
                raise ValueError(
                    f"trace {k} disagrees on the exogenous edge background; "
                    "the shared pool has ONE background, per-client bg traces "
                    "are not meaningful")
        return cls(
            times=first.times,
            bandwidth_Bps=np.stack([tr.bandwidth_Bps for tr in traces], axis=1),
            arrival_rate=np.stack([tr.arrival_rate for tr in traces], axis=1),
            edge_bg_rate=first.edge_bg_rate,
        )


def epoch_times(duration_s: float, epoch_s: float) -> np.ndarray:
    """Uniform epoch starts covering [0, duration)."""
    if epoch_s <= 0 or duration_s < 2 * epoch_s:
        raise ValueError("need duration >= 2 epochs of positive length")
    return np.arange(0.0, duration_s, epoch_s)


def step_signal(times: np.ndarray, points: Sequence[tuple[float, float]]) -> np.ndarray:
    """Piecewise-constant schedule from (time, value) breakpoints.

    The value before the first breakpoint is the first value; breakpoints
    must be time-sorted. ``step_signal(t, [(0, 20), (40, 2), (60, 20)])`` is
    the Fig. 6-style walk.
    """
    if not points:
        raise ValueError("need at least one (time, value) breakpoint")
    ts = np.asarray([p[0] for p in points], dtype=np.float64)
    vs = np.asarray([p[1] for p in points], dtype=np.float64)
    if np.any(np.diff(ts) < 0):
        raise ValueError("breakpoints must be sorted by time")
    idx = np.clip(np.searchsorted(ts, times, side="right") - 1, 0, len(vs) - 1)
    return vs[idx]


def drift_signal(
    times: np.ndarray,
    start: float,
    end: float,
    *,
    jitter: float = 0.0,
    seed: int = 0,
    floor: float = 1e-9,
) -> np.ndarray:
    """Linear drift start -> end plus an optional seeded random walk.

    ``jitter`` is the per-epoch random-walk step as a fraction of the mean
    level; the result is floored to keep rates/bandwidths positive.
    """
    base = np.linspace(start, end, len(times))
    if jitter > 0.0:
        rng = np.random.default_rng(seed)
        scale = jitter * 0.5 * (start + end)
        base = base + np.cumsum(rng.normal(0.0, scale, size=len(times)))
    return np.maximum(base, floor)


def mmpp_signal(
    times: np.ndarray,
    low: float,
    high: float,
    *,
    p_up: float = 0.1,
    p_down: float = 0.3,
    seed: int = 0,
) -> np.ndarray:
    """Bursty 2-state Markov-modulated level (epoch-discretised MMPP).

    Each epoch the process jumps low->high w.p. ``p_up`` and high->low w.p.
    ``p_down`` — geometric burst/idle sojourns, mean burst length 1/p_down
    epochs. Used for flash-crowd arrival bursts and fading-link bandwidth.
    """
    if not (0 <= p_up <= 1 and 0 <= p_down <= 1):
        raise ValueError("transition probabilities must be in [0, 1]")
    rng = np.random.default_rng(seed)
    state = np.zeros(len(times), dtype=bool)
    cur = False
    u = rng.random(len(times))
    for i in range(len(times)):
        cur = (not cur and u[i] < p_up) or (cur and u[i] >= p_down)
        state[i] = cur
    return np.where(state, high, low)


def _resolve(spec, times: np.ndarray) -> np.ndarray:
    if callable(spec):
        return np.asarray(spec(times), dtype=np.float64)
    arr = np.asarray(spec, dtype=np.float64)
    if arr.ndim == 0:
        return np.full(len(times), float(arr))
    return arr


def make_trace(
    duration_s: float,
    epoch_s: float,
    *,
    bandwidth_Bps,
    arrival_rate,
    edge_bg_rate: Sequence = (),
) -> Trace:
    """Assemble a Trace from per-field specs (constant, array, or callable).

    ``edge_bg_rate`` is one spec per edge; edges beyond the sequence get a
    constant zero background. Example::

        trace = make_trace(
            120.0, 1.0,
            bandwidth_Bps=lambda t: step_signal(t, [(0, 2.5e6), (40, 2.5e5)]),
            arrival_rate=10.0,
            edge_bg_rate=[lambda t: mmpp_signal(t, 0.0, 30.0, seed=7)],
        )
    """
    times = epoch_times(duration_s, epoch_s)
    bg = [_resolve(spec, times) for spec in edge_bg_rate]
    bg_arr = np.stack(bg, axis=1) if bg else np.zeros((len(times), 0))
    return Trace(
        times=times,
        bandwidth_Bps=_resolve(bandwidth_Bps, times),
        arrival_rate=_resolve(arrival_rate, times),
        edge_bg_rate=bg_arr,
    )
