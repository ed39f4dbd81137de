"""Error metrics for scoring analytic predictions against simulated truth.

The paper's §4.3 fidelity claim is stated in exactly these statistics: mean
absolute percentage error over a scenario set (2.2%), plus the fraction of
scenarios whose prediction lands within ±5% / ±10% of the observation. This
module computes them, groups them into per-regime tables, and quantifies the
*statistical* uncertainty of a simulated mean with a moving-block bootstrap —
queue-latency samples are strongly autocorrelated near saturation, so an
i.i.d. bootstrap would report confidence intervals several times too narrow.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence

import numpy as np

__all__ = [
    "mape",
    "ErrorStats",
    "error_stats",
    "error_table",
    "BootstrapCI",
    "bootstrap_mean_ci",
]


def mape(pred, obs):
    """Absolute percentage error |pred - obs| / |obs| * 100, broadcasting.

    Returns a float for scalar inputs, an ndarray otherwise. ``obs`` must be
    nonzero (latencies are strictly positive); infinities propagate to inf so
    an unstable prediction scored against a finite observation is loud.
    """
    pred = np.asarray(pred, dtype=np.float64)
    obs = np.asarray(obs, dtype=np.float64)
    out = np.abs(pred - obs) / np.abs(obs) * 100.0
    return float(out) if out.ndim == 0 else out


@dataclass(frozen=True)
class ErrorStats:
    """Summary of one group of absolute-percentage errors (paper §4.3 style)."""

    n: int
    mean_pct: float
    median_pct: float
    max_pct: float
    within_5_frac: float
    within_10_frac: float

    def to_dict(self) -> dict:
        return {
            "n": self.n,
            "mean_pct": self.mean_pct,
            "median_pct": self.median_pct,
            "max_pct": self.max_pct,
            "within_5_frac": self.within_5_frac,
            "within_10_frac": self.within_10_frac,
        }


def error_stats(errors_pct: Iterable[float]) -> ErrorStats:
    """Aggregate a list of percentage errors into the paper's summary stats."""
    e = np.asarray(list(errors_pct), dtype=np.float64)
    if e.size == 0:
        return ErrorStats(0, float("nan"), float("nan"), float("nan"),
                          float("nan"), float("nan"))
    return ErrorStats(
        n=int(e.size),
        mean_pct=float(np.mean(e)),
        median_pct=float(np.median(e)),
        max_pct=float(np.max(e)),
        within_5_frac=float(np.mean(e <= 5.0)),
        within_10_frac=float(np.mean(e <= 10.0)),
    )


def error_table(
    keyed_errors: Iterable[tuple[str, float]],
    *,
    order: Sequence[str] | None = None,
) -> Mapping[str, ErrorStats]:
    """Group ``(key, error_pct)`` pairs into per-key :class:`ErrorStats`.

    ``order`` fixes the key order of the returned mapping (unknown keys keep
    insertion order after the ordered ones) — handy for utilization bands,
    which have a natural low->stress reading order.
    """
    groups: dict[str, list[float]] = {}
    for key, err in keyed_errors:
        groups.setdefault(key, []).append(err)
    keys = list(groups)
    if order:
        keys = [k for k in order if k in groups] + [k for k in keys if k not in order]
    return {k: error_stats(groups[k]) for k in keys}


@dataclass(frozen=True)
class BootstrapCI:
    """A bootstrap confidence interval for a simulated steady-state mean."""

    mean: float
    lo: float
    hi: float
    level: float
    n_boot: int
    block_len: int

    @property
    def half_width_pct(self) -> float:
        """CI half-width as a percentage of the mean — the resolution floor
        below which an analytic-vs-simulated MAPE is statistically moot."""
        return float(0.5 * (self.hi - self.lo) / abs(self.mean) * 100.0)

    def to_dict(self) -> dict:
        return {
            "mean": self.mean,
            "lo": self.lo,
            "hi": self.hi,
            "level": self.level,
            "half_width_pct": self.half_width_pct,
        }


def bootstrap_mean_ci(
    samples: np.ndarray,
    *,
    n_boot: int = 200,
    level: float = 0.95,
    block_len: int | None = None,
    seed: int = 0,
) -> BootstrapCI:
    """Moving-block bootstrap CI for the mean of an autocorrelated series.

    Resamples whole contiguous blocks (default length ~sqrt(n), a standard
    rate-optimal choice) so the latency process's serial correlation survives
    into the replicates. Percentile interval at ``level``.
    """
    x = np.asarray(samples, dtype=np.float64).ravel()
    n = x.size
    if n < 2:
        m = float(x.mean()) if n else float("nan")
        return BootstrapCI(m, m, m, level, 0, 1)
    if block_len is None:
        block_len = max(1, int(np.sqrt(n)))
    block_len = min(block_len, n)
    n_blocks = int(np.ceil(n / block_len))
    rng = np.random.default_rng(seed)
    # start indices of sampled blocks, (n_boot, n_blocks)
    starts = rng.integers(0, n - block_len + 1, size=(n_boot, n_blocks))
    idx = starts[:, :, None] + np.arange(block_len)[None, None, :]
    reps = x[idx.reshape(n_boot, -1)[:, :n]].mean(axis=1)
    alpha = 0.5 * (1.0 - level)
    lo, hi = np.quantile(reps, [alpha, 1.0 - alpha])
    return BootstrapCI(
        mean=float(x.mean()),
        lo=float(lo),
        hi=float(hi),
        level=level,
        n_boot=n_boot,
        block_len=block_len,
    )
