"""Versioned MeasuredProfile artifact: the bridge from measurement to model.

The port's copy of ``repro.measure.profile``: the same fields, JSON and
``PROFILE_VERSION``, so a profile written by either package loads in the
other.

A profile bundles everything the analytic layer needs from one profiling
run: the fitted per-(phase, occupancy) distributions, the resolved arrival
rate, and the *observed* end-to-end latency statistics the validation gate
scores against. Serialization is canonical JSON (sorted keys, fixed indent,
trailing newline) so a profile round-trips byte-for-byte — profiles are
meant to be committed next to benchmark baselines.

``Tier.from_measured(profile, occupancy)`` consumes the duck-typed
:meth:`MeasuredProfile.service_moments`; nothing in ``repro_torch.core`` imports
this package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Mapping

import numpy as np

from repro_torch.core.latency import ServiceModel
from repro_torch.validate.metrics import bootstrap_mean_ci

from .fit import DistFit, fit_trace
from .harness import MeasuredTrace

__all__ = ["PROFILE_VERSION", "MeasuredProfile", "build_profile", "load_profile"]

PROFILE_VERSION = 1


@dataclass(frozen=True)
class MeasuredProfile:
    """Fitted service-time profile of one (model config, engine setup) pair."""

    arch: str
    clock: str  # "simulated" | "wall"
    seed: int
    slots: int
    arrival_rate: float
    n_requests: int
    fits: tuple[DistFit, ...]
    observed: tuple[tuple[str, float], ...]  # end-to-end latency stats (sorted keys)
    workload: tuple[tuple[str, float], ...]  # workload shape summary (sorted keys)
    manifest: Mapping | None = None  # run provenance (repro_torch.obs.run_manifest)
    version: int = PROFILE_VERSION

    # -- lookups -------------------------------------------------------------
    def fit_for(self, phase: str, occupancy: int) -> DistFit:
        for f in self.fits:
            if f.phase == phase and f.occupancy == occupancy:
                return f
        have = [(f.phase, f.occupancy) for f in self.fits]
        raise KeyError(f"no fit for ({phase!r}, occupancy={occupancy}); "
                       f"profiled groups: {have}")

    def occupancies(self, phase: str = "request") -> list[int]:
        return sorted(f.occupancy for f in self.fits if f.phase == phase)

    def dominant_occupancy(self, phase: str = "request") -> int:
        """The occupancy with the most samples — the default gate target."""
        cands = [f for f in self.fits if f.phase == phase]
        if not cands:
            raise KeyError(f"profile has no {phase!r} fits")
        return max(cands, key=lambda f: (f.n, -f.occupancy)).occupancy

    def service_moments(self, occupancy: int) -> tuple[float, float, ServiceModel]:
        """(mean_s, var_s, model) of the request-level service at the given
        batch occupancy — the ``Tier.from_measured`` protocol."""
        return self.fit_for("request", int(occupancy)).moments()

    def observed_stat(self, key: str) -> float:
        for k, v in self.observed:
            if k == key:
                return v
        raise KeyError(f"no observed stat {key!r} "
                       f"(have {[k for k, _ in self.observed]})")

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        d = {
            "version": self.version,
            "arch": self.arch,
            "clock": self.clock,
            "seed": self.seed,
            "slots": self.slots,
            "arrival_rate": self.arrival_rate,
            "n_requests": self.n_requests,
            "workload": {k: v for k, v in self.workload},
            "observed": {k: v for k, v in self.observed},
            "fits": [f.to_dict() for f in self.fits],
        }
        if self.manifest is not None:
            d["manifest"] = dict(self.manifest)
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "MeasuredProfile":
        version = int(d.get("version", 0))
        if version != PROFILE_VERSION:
            raise ValueError(
                f"unsupported MeasuredProfile version {version} "
                f"(this build reads version {PROFILE_VERSION})")
        return cls(
            arch=d["arch"],
            clock=d["clock"],
            seed=int(d["seed"]),
            slots=int(d["slots"]),
            arrival_rate=float(d["arrival_rate"]),
            n_requests=int(d["n_requests"]),
            fits=tuple(DistFit.from_dict(f) for f in d["fits"]),
            observed=tuple(sorted(
                (str(k), float(v)) for k, v in d.get("observed", {}).items())),
            workload=tuple(sorted(
                (str(k), float(v)) for k, v in d.get("workload", {}).items())),
            manifest=d.get("manifest"),
            version=version,
        )

    def dumps(self) -> str:
        """Canonical serialization — byte-stable across round-trips."""
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.dumps())
        return path


def load_profile(path: str | Path) -> MeasuredProfile:
    return MeasuredProfile.from_dict(json.loads(Path(path).read_text()))


def build_profile(trace: MeasuredTrace, *, seed: int = 0,
                  min_group: int = 8, manifest: Mapping | None = None) -> MeasuredProfile:
    """Fit a trace and package it as a :class:`MeasuredProfile`.

    The observed block records what the engine actually delivered end to
    end (mean/percentile latency, queue wait, a block-bootstrap CI on the
    mean) — the ground truth the measured validation gate compares the
    closed forms against. ``manifest`` (``repro_torch.obs.run_manifest``) stamps
    the run's provenance into the artifact; it is timestamp-free, so the
    profile stays byte-stable per seed.
    """
    hc = trace.harness
    lat = trace.latencies()
    waits = np.array([r.queue_wait_s for r in trace.requests])
    service = np.array([r.service_s for r in trace.requests])
    ci = bootstrap_mean_ci(lat, seed=seed)
    observed = {
        "latency_mean_s": float(lat.mean()),
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p90_s": float(np.percentile(lat, 90)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "latency_mean_ci_lo_s": float(ci.lo),
        "latency_mean_ci_hi_s": float(ci.hi),
        "queue_wait_mean_s": float(waits.mean()),
        "service_mean_s": float(service.mean()),
        "rho_hat": float(trace.arrival_rate * service.mean() / hc.slots),
        "n": float(lat.size),
    }
    workload = {
        "prompt_len": float(hc.prompt_len),
        "prompt_len_jitter": float(hc.prompt_len_jitter),
        "max_new_tokens": float(hc.max_new_tokens),
        "new_tokens_geometric_p": float(hc.new_tokens_geometric_p),
        "target_rho": float(hc.target_rho),
    }
    return MeasuredProfile(
        arch=hc.arch,
        clock=hc.clock,
        seed=hc.seed,
        slots=hc.slots,
        arrival_rate=float(trace.arrival_rate),
        n_requests=len(trace.requests),
        fits=tuple(fit_trace(trace, seed=seed, min_group=min_group)),
        observed=tuple(sorted(observed.items())),
        workload=tuple(sorted(workload.items())),
        manifest=manifest,
    )
