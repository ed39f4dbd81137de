"""Measured regime: gate the closed forms against OBSERVED engine latencies.

The port's counterpart of ``repro.validate.measured``, with the same budgets
and report. A :class:`~repro_torch.measure.MeasuredProfile` — fitted from a
run of the port's ``Engine`` — becomes an ordinary analytic tier via
``Tier.from_measured``, the same ``analytic()`` / ``analytic_tail()`` entry
points every other regime uses predict its mean and tail latency, and the
gate scores those predictions against the latencies the engine actually
delivered (paper §5: closed forms within 2.2% MAPE of latencies observed on
real accelerators).

Budgets are looser than the simulator gates on purpose: a profiling run is a
finite sample of a stochastic system (the report carries the bootstrap CI
half-width as the statistical resolution floor), and the tail gate scores an
empirical p99 of a few hundred requests.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.latency import NetworkPath, Tier, Workload
from repro_torch.core.scenario import Scenario, analytic, analytic_tail

from .metrics import mape

__all__ = [
    "DEFAULT_MEASURED_BUDGET_PCT",
    "DEFAULT_MEASURED_TAIL_BUDGET_PCT",
    "MEASURED_VEC_TOL",
    "MeasuredGateReport",
    "measured_scenario",
    "run_measured_gate",
]

DEFAULT_MEASURED_BUDGET_PCT = 15.0  # mean-latency MAPE budget
DEFAULT_MEASURED_TAIL_BUDGET_PCT = 35.0  # p99 vs an empirical tail is noisier
MEASURED_VEC_TOL = 1e-6  # measured tier through fleet.analytic_vec must agree


def measured_scenario(profile, occupancy: int | None = None, *,
                      name: str | None = None) -> Scenario:
    """An on-device :class:`Scenario` whose device tier is the measured one.

    The workload is the profiling run's own stream (resolved arrival rate,
    payload bytes from the token counts at 4 bytes/token — irrelevant to the
    on-device path but kept honest for anyone adding edges). The returned
    scenario flows through ``analytic``/``analytic_tail``/``fleet`` exactly
    like a hand-specified one; ``allow_unstable=True`` so a saturated
    profiling run yields an inf prediction (and a failed gate) rather than a
    constructor error.
    """
    occ = profile.dominant_occupancy() if occupancy is None else int(occupancy)
    tier = Tier.from_measured(profile, occ)
    wl_meta = dict(profile.workload)
    prompt = wl_meta.get("prompt_len", 64.0)
    newtok = wl_meta.get("max_new_tokens", 16.0)
    return Scenario(
        workload=Workload(
            arrival_rate=profile.arrival_rate,
            req_bytes=4.0 * prompt,
            res_bytes=4.0 * newtok,
            name=f"measured:{profile.arch}",
        ),
        device=tier,
        network=NetworkPath(bandwidth_Bps=1e9),  # no edges: path is unused
        edges=(),
        allow_unstable=True,
        name=name or f"measured:{profile.arch}@occ{occ}",
    )


@dataclass(frozen=True)
class MeasuredGateReport:
    """Analytic-vs-observed scorecard for one measured profile."""

    arch: str
    clock: str
    seed: int
    slots: int
    occupancy: int
    n_requests: int
    rho: float
    observed_mean_s: float
    analytic_mean_s: float
    mean_mape_pct: float
    observed_p99_s: float
    analytic_p99_s: float
    p99_mape_pct: float
    ci_half_width_pct: float  # bootstrap resolution floor on the observed mean
    vec_rel_err: float  # scalar analytic vs fleet.analytic_vec on the same spec
    budget_pct: float
    tail_budget_pct: float
    tail_pct: float

    @property
    def mean_passed(self) -> bool:
        return np.isfinite(self.mean_mape_pct) and self.mean_mape_pct <= self.budget_pct

    @property
    def tail_passed(self) -> bool:
        return (np.isfinite(self.p99_mape_pct)
                and self.p99_mape_pct <= self.tail_budget_pct)

    @property
    def vec_passed(self) -> bool:
        return np.isfinite(self.vec_rel_err) and self.vec_rel_err <= MEASURED_VEC_TOL

    @property
    def passed(self) -> bool:
        return self.mean_passed and self.tail_passed and self.vec_passed

    def to_dict(self) -> dict:
        return {
            "regime": "measured",
            "profile": {
                "arch": self.arch, "clock": self.clock, "seed": self.seed,
                "slots": self.slots, "occupancy": self.occupancy,
                "n_requests": self.n_requests, "rho": self.rho,
            },
            "mean": {
                "observed_s": self.observed_mean_s,
                "analytic_s": self.analytic_mean_s,
                "mape_pct": self.mean_mape_pct,
                "budget_pct": self.budget_pct,
                "ci_half_width_pct": self.ci_half_width_pct,
                "passed": self.mean_passed,
            },
            "tail": {
                "pct": self.tail_pct,
                "observed_s": self.observed_p99_s,
                "analytic_s": self.analytic_p99_s,
                "mape_pct": self.p99_mape_pct,
                "budget_pct": self.tail_budget_pct,
                "passed": self.tail_passed,
            },
            "vec": {"rel_err": self.vec_rel_err, "tol": MEASURED_VEC_TOL,
                    "passed": self.vec_passed},
            "passed": self.passed,
        }


def run_measured_gate(
    profile,
    *,
    occupancy: int | None = None,
    budget_pct: float = DEFAULT_MEASURED_BUDGET_PCT,
    tail_budget_pct: float = DEFAULT_MEASURED_TAIL_BUDGET_PCT,
    tail_pct: float = 99.0,
    device=None,
) -> MeasuredGateReport:
    """Score the closed forms against the profile's observed latencies.

    Three checks: (1) analytic mean latency (Eq. 2 with the measured tier's
    service model) within ``budget_pct`` MAPE of the observed mean; (2)
    analytic ``tail_pct`` sojourn quantile within ``tail_budget_pct`` of the
    empirical one; (3) the measured tier predicts identically through the
    vectorized fleet path — no special-casing anywhere downstream. That
    path runs on ``device`` (default: the card).
    """
    scn = measured_scenario(profile, occupancy)
    occ = int(scn.device.parallelism_k)

    pred = analytic(scn)
    analytic_mean = float(np.asarray(pred["on_device"].total))
    q = tail_pct / 100.0
    analytic_q = float(analytic_tail(scn, q)["on_device"])

    observed_mean = profile.observed_stat("latency_mean_s")
    pkey = f"latency_p{tail_pct:g}_s"
    observed_q = profile.observed_stat(pkey)

    # cross-path consistency: the same spec through fleet.analytic_vec
    from repro_torch.fleet import ScenarioBatch, fleet_analytic

    fp = fleet_analytic(ScenarioBatch.from_scenarios([scn]), device=device)
    vec_mean = float(fp.t_dev[0])
    vec_rel = abs(vec_mean - analytic_mean) / max(abs(analytic_mean), 1e-300)

    ci_lo = profile.observed_stat("latency_mean_ci_lo_s")
    ci_hi = profile.observed_stat("latency_mean_ci_hi_s")
    tier = scn.device
    rho = profile.arrival_rate * tier.service_time_s / tier.parallelism_k

    return MeasuredGateReport(
        arch=profile.arch,
        clock=profile.clock,
        seed=profile.seed,
        slots=profile.slots,
        occupancy=occ,
        n_requests=profile.n_requests,
        rho=float(rho),
        observed_mean_s=observed_mean,
        analytic_mean_s=analytic_mean,
        mean_mape_pct=mape(analytic_mean, observed_mean),
        observed_p99_s=observed_q,
        analytic_p99_s=analytic_q,
        p99_mape_pct=mape(analytic_q, observed_q),
        ci_half_width_pct=float(0.5 * (ci_hi - ci_lo) / observed_mean * 100.0),
        vec_rel_err=float(vec_rel),
        budget_pct=float(budget_pct),
        tail_budget_pct=float(tail_budget_pct),
        tail_pct=float(tail_pct),
    )
