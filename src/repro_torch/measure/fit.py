"""Fit measured service-time distributions into the paper's taxonomy.

The port's copy of ``repro.measure.fit`` (numpy only), with the same
thresholds.

Each (phase, batch occupancy) group of a trace becomes one :class:`DistFit`:
sample mean, variance, SCV (squared coefficient of variation), empirical
percentiles, a moving-block bootstrap CI on the mean (reusing
``validate.metrics`` — latency samples are serially correlated through the
queue), and a :class:`~repro_torch.core.latency.ServiceModel` classification:

  SCV <= DET_SCV_MAX        -> DETERMINISTIC (M/D/1, Lemma 3.1)
  |SCV - 1| <= EXP_SCV_BAND -> EXPONENTIAL   (M/M/1, Lemma 3.3)
  otherwise                 -> GENERAL       (two-moment M/G/1, Lemma 3.2)

The GENERAL branch carries the sample variance, so downstream
Pollaczek-Khinchine forms see an exact two-moment match of the measurement.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.latency import ServiceModel
from repro_torch.validate.metrics import bootstrap_mean_ci

__all__ = [
    "DET_SCV_MAX",
    "EXP_SCV_BAND",
    "PERCENTILES",
    "classify_service_model",
    "DistFit",
    "fit_samples",
    "fit_trace",
]

DET_SCV_MAX = 0.02
EXP_SCV_BAND = 0.35
PERCENTILES = (50.0, 90.0, 95.0, 99.0)

PHASES = ("prefill", "decode", "request")


def classify_service_model(mean_s: float, var_s: float) -> ServiceModel:
    """Two-moment classification into the paper's queueing taxonomy."""
    if not mean_s > 0:
        raise ValueError(f"mean service must be > 0, got {mean_s}")
    if var_s < 0:
        raise ValueError(f"service variance must be >= 0, got {var_s}")
    scv = var_s / mean_s**2
    if scv <= DET_SCV_MAX:
        return ServiceModel.DETERMINISTIC
    if abs(scv - 1.0) <= EXP_SCV_BAND:
        return ServiceModel.EXPONENTIAL
    return ServiceModel.GENERAL


@dataclass(frozen=True)
class DistFit:
    """A fitted service-time distribution for one (phase, occupancy) group."""

    phase: str  # "prefill" | "decode" | "request"
    occupancy: int
    n: int
    mean_s: float
    var_s: float
    model: ServiceModel
    percentiles: tuple[tuple[str, float], ...]  # (("p50", ...), ...)
    ci_lo_s: float
    ci_hi_s: float
    ci_level: float

    @property
    def scv(self) -> float:
        return self.var_s / self.mean_s**2

    @property
    def ci_half_width_pct(self) -> float:
        """Mean-CI half width as % of the mean — the statistical resolution
        floor for any MAPE computed against this fit."""
        return 0.5 * (self.ci_hi_s - self.ci_lo_s) / abs(self.mean_s) * 100.0

    def percentile(self, p: float) -> float:
        key = _pkey(p)
        for k, v in self.percentiles:
            if k == key:
                return v
        raise KeyError(f"percentile {key} not fitted "
                       f"(have {[k for k, _ in self.percentiles]})")

    def moments(self) -> tuple[float, float, ServiceModel]:
        return self.mean_s, self.var_s, self.model

    def to_dict(self) -> dict:
        return {
            "phase": self.phase,
            "occupancy": self.occupancy,
            "n": self.n,
            "mean_s": self.mean_s,
            "var_s": self.var_s,
            "scv": self.scv,
            "model": self.model.value,
            "percentiles": {k: v for k, v in self.percentiles},
            "ci": {"lo_s": self.ci_lo_s, "hi_s": self.ci_hi_s,
                   "level": self.ci_level},
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "DistFit":
        ci = d.get("ci", {})
        return cls(
            phase=d["phase"],
            occupancy=int(d["occupancy"]),
            n=int(d["n"]),
            mean_s=float(d["mean_s"]),
            var_s=float(d["var_s"]),
            model=ServiceModel(d["model"]),
            percentiles=tuple(sorted(
                (str(k), float(v)) for k, v in d.get("percentiles", {}).items())),
            ci_lo_s=float(ci.get("lo_s", d["mean_s"])),
            ci_hi_s=float(ci.get("hi_s", d["mean_s"])),
            ci_level=float(ci.get("level", 0.95)),
        )


def _pkey(p: float) -> str:
    return f"p{p:g}"


def fit_samples(samples: Iterable[float], *, phase: str, occupancy: int,
                percentiles: Sequence[float] = PERCENTILES,
                seed: int = 0) -> DistFit:
    """Fit one sample group. Samples must be positive durations in seconds."""
    x = np.asarray(list(samples), dtype=np.float64)
    if x.size == 0:
        raise ValueError(f"no samples for ({phase}, occupancy={occupancy})")
    if not np.all(x > 0):
        raise ValueError(f"service samples must be positive ({phase}, "
                         f"occupancy={occupancy})")
    mean = float(x.mean())
    var = float(x.var())
    ci = bootstrap_mean_ci(x, seed=seed)
    pcts = tuple(sorted(
        (_pkey(p), float(np.percentile(x, p))) for p in percentiles))
    return DistFit(
        phase=phase,
        occupancy=int(occupancy),
        n=int(x.size),
        mean_s=mean,
        var_s=var,
        model=classify_service_model(mean, var),
        percentiles=pcts,
        ci_lo_s=float(ci.lo),
        ci_hi_s=float(ci.hi),
        ci_level=float(ci.level),
    )


def fit_trace(trace, *, seed: int = 0, min_group: int = 8) -> list[DistFit]:
    """All fits of a :class:`~repro_torch.measure.harness.MeasuredTrace`.

    Groups: prefill events (occupancy 1, batch-1 compute), decode events per
    observed batch occupancy, and request-level in-service times per rounded
    mean occupancy (the group :meth:`Tier.from_measured` consumes). Groups
    smaller than ``min_group`` are dropped — a 3-sample variance classifies
    noise, not a distribution.
    """
    from repro_torch.serving.engine import ServiceEvent

    events = [ServiceEvent(*e) for e in trace.events]
    groups: dict[tuple[str, int], list[float]] = {}
    for ev in events:
        if ev.phase == "prefill":
            groups.setdefault(("prefill", 1), []).append(ev.duration_s)
        elif ev.phase == "decode":
            groups.setdefault(("decode", int(ev.occupancy)), []).append(ev.duration_s)
    for r in trace.requests:
        groups.setdefault(("request", r.occupancy), []).append(r.service_s)

    fits = []
    for (phase, occ) in sorted(groups, key=lambda k: (PHASES.index(k[0]), k[1])):
        samples = groups[(phase, occ)]
        if len(samples) < min_group:
            continue
        fits.append(fit_samples(samples, phase=phase, occupancy=occ, seed=seed))
    if not fits:
        raise ValueError(
            f"trace produced no fit group with >= {min_group} samples")
    return fits
