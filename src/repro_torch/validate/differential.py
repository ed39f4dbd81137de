"""Differential validation: every corpus scenario through all four paths,
and the five gates of the fidelity report.

The repo evaluates one operating point four independent ways:

  1. ``scenario.analytic()``        — scalar closed forms (numpy),
  2. ``fleet.fleet_analytic``       — batched float64 closed forms (torch),
  3. ``scenario.simulate()``        — scalar discrete-event simulator,
  4. ``fleet.simulate_fleet``       — batched Lindley-scan simulator (card).

This module pushes the golden corpus through all of them and scores the
path pairs the paper's fidelity claim rests on:

  * gate 1: scalar vs batched analytic must agree to ``vec_tol`` (default
    1e-6 relative — it actually holds to ~1e-15; any excess is a
    transcription bug, not statistics);
  * gate 2: recomputed scalar analytic must match the fixture's golden totals
    (``golden_tol``) — drift in the closed forms shows up as a diff here;
  * gate 3: analytic vs long-run simulation must land within a MAPE budget
    over the gated entries (rho <= 0.9, exact-model regimes), reported per
    utilization band and per regime with block-bootstrap CIs on every
    simulated mean — the repo's analogue of the paper's Table of
    observed-vs-predicted latencies (2.2% mean, 91.5% within ±5%);
  * the two simulators, where both apply, must agree statistically
    (independent random streams estimating the same queue);
  * gate 4, tails: every entry's strategy is scored at the ``tail_pct``
    percentile — scalar ``analytic_tail`` vs batched ``fleet_tail`` (to
    ``vec_tol``), the batched exact Euler inversion vs the scalar one (to
    ``euler_vec_tol`` at rho <= 0.95), and, where simulated, the analytic
    quantile vs the observed ``percentile(tail_pct)`` of the same runs as
    gate 3 (``tail_budget_pct`` over :func:`tail_gated` entries);
  * gate 5, mean field: the class-aggregated Wardrop solver vs the exact
    per-client equilibrium on the fixed :func:`meanfield_gate_specs` fleets
    (``meanfield_budget_pct``), analytic on both sides, so it runs even with
    ``simulate=False``.

``run_differential`` is pure given its inputs and seeded throughout, so a
failing report reproduces exactly on the same device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.latency import NetworkPath, ServiceModel, Tier, Workload
from repro_torch.core.scenario import (
    ClientClass,
    EdgeSpec,
    MeanFieldSpec,
    Scenario,
    analytic_tail,
    parse_strategy,
)
from repro_torch.core.scenario import simulate as scalar_simulate
from repro_torch.core.simulation import steady_slice
from repro_torch.fleet import (
    ScenarioBatch,
    cross_check_meanfield,
    fleet_analytic,
    fleet_tail,
    simulate_fleet,
)

from .corpus import BAND_ORDER, CorpusEntry
from .metrics import BootstrapCI, ErrorStats, bootstrap_mean_ci, error_stats, error_table, mape

__all__ = [
    "EntryReport",
    "ValidationReport",
    "run_differential",
    "run_meanfield_gate",
    "meanfield_gate_specs",
    "smoke_subset",
    "tail_gated",
    "DEFAULT_MAPE_BUDGET_PCT",
    "DEFAULT_MEANFIELD_BUDGET_PCT",
    "DEFAULT_VEC_TOL",
    "DEFAULT_GOLDEN_TOL",
    "DEFAULT_TAIL_BUDGET_PCT",
    "DEFAULT_TAIL_PCT",
    "DEFAULT_EULER_VEC_TOL",
    "EULER_VEC_RHO_MAX",
]

DEFAULT_MAPE_BUDGET_PCT = 5.0
DEFAULT_VEC_TOL = 1e-6
DEFAULT_GOLDEN_TOL = 1e-9
# tail-percentile gate: analytic p99 vs simulated percentile(99). Looser than
# the mean gate: a p99 comparison stacks the tandem independence
# approximation, the Euler inversion (~1e-8, negligible) and the much noisier
# simulated percentile estimator.
DEFAULT_TAIL_BUDGET_PCT = 10.0
DEFAULT_TAIL_PCT = 99.0
# tail-euler-vec gate: the batched exact Euler inversion vs the scalar one per
# corpus entry. Both sides run the identical search trajectory, so what is
# left is float noise flipping a bisection decision at a razor edge; 1e-8 is
# the contract. Restricted to rho <= EULER_VEC_RHO_MAX: deeper into
# saturation the transform's conditioning degrades faster than any
# scalar/batched comparison can resolve.
DEFAULT_EULER_VEC_TOL = 1e-8
EULER_VEC_RHO_MAX = 0.95
# mean-field gate: the class-aggregated Wardrop fixed point vs the exact
# per-client equilibrium on fixed small fleets, the same 5% contract as the
# analytic-vs-simulated mean gate over the <= rho_gate per-class latencies and
# busy-edge utilizations cross_check_meanfield reports.
DEFAULT_MEANFIELD_BUDGET_PCT = 5.0


def tail_gated(e: CorpusEntry) -> bool:
    """Does this entry count toward the tail-percentile gate?

    Mean-gated (rho <= 0.9, exact mean regimes) AND every station on the
    strategy path has an exact service transform (deterministic/exponential).
    GENERAL tiers and multi-tenant mixtures simulate lognormal draws that the
    tail layer's two-moment gamma match only approximates — those are
    reported, never gated.
    """
    if not e.sim_gate:
        return False
    scn = e.scenario
    j = parse_strategy(e.strategy, len(scn.edges))
    if j < 0:
        return scn.device.service_model is not ServiceModel.GENERAL
    edge = scn.edges[j]
    if edge.background:
        return False
    return edge.tier.service_model is not ServiceModel.GENERAL


def smoke_subset(entries: Sequence[CorpusEntry]) -> list[CorpusEntry]:
    """The fast tier-1 slice of the corpus (entries flagged ``smoke``)."""
    return [e for e in entries if e.smoke]


def meanfield_gate_specs() -> tuple[MeanFieldSpec, ...]:
    """The fixed small fleets the mean-field-vs-exact gate solves.

    Constant (no seed, no jitter): the gate compares two *solvers* on the
    same spec. Two shapes: a mixed-rate fleet with a deterministic and an
    exponential edge, and a heavier two-class fleet whose busy edge sits in
    the high band where the continuum approximation is most stressed below
    the gate's rho ceiling."""
    base = Scenario(
        workload=Workload(2.0, 30_000, 1_000, name="meanfield-gate"),
        device=Tier("orin", 0.045),
        network=NetworkPath(20e6 / 8),
        edges=(
            EdgeSpec(Tier("a2", 0.028)),
            EdgeSpec(Tier("t4", 0.020, service_model=ServiceModel.EXPONENTIAL)),
        ),
        name="mf-gate-base",
    )
    mixed = MeanFieldSpec(
        base=base,
        classes=(
            ClientClass(n_clients=16, arrival_scale=1.0, name="steady"),
            ClientClass(n_clients=16, arrival_scale=0.5, name="light"),
            ClientClass(n_clients=8, arrival_scale=2.0, bandwidth_scale=0.5, name="heavy"),
        ),
        name="mf-gate-mixed",
    )
    heavy = MeanFieldSpec(
        base=Scenario(
            workload=Workload(2.5, 40_000, 2_000, name="meanfield-gate"),
            device=Tier("tx2", 0.150),
            network=NetworkPath(20e6 / 8),
            edges=(EdgeSpec(Tier("a2", 0.014)), EdgeSpec(Tier("a2-far", 0.028))),
            name="mf-gate-heavy-base",
        ),
        classes=(
            ClientClass(n_clients=24, arrival_scale=1.0, name="steady"),
            ClientClass(n_clients=8, arrival_scale=1.5, name="heavy"),
        ),
        name="mf-gate-heavy",
    )
    return (mixed, heavy)


def run_meanfield_gate(
    specs: Sequence[MeanFieldSpec] | None = None,
    *,
    budget_pct: float = DEFAULT_MEANFIELD_BUDGET_PCT,
    device=None,
) -> dict:
    """Cross-check the mean-field solver against the exact one per spec, on
    ``device`` (default: the card); the exact solves launch the decision
    scan once per synchronous step.

    Runs :func:`repro_torch.fleet.cross_check_meanfield` on every spec and
    folds the per-spec gated maxima into one pass/fail block shaped like the
    other gates. Both solvers are deterministic and analytic."""
    specs = meanfield_gate_specs() if specs is None else list(specs)
    checks = []
    for spec in specs:
        r = cross_check_meanfield(spec, device=device)
        checks.append({"spec": spec.name, "n_total": spec.n_total, **r})
    gated_max = [c["gated_max_mape_pct"] for c in checks
                 if c["gated_max_mape_pct"] is not None]
    gated_mean = [c["gated_mean_mape_pct"] for c in checks
                  if c["gated_mean_mape_pct"] is not None]
    converged = all(c["meanfield_converged"] and c["exact_converged"] for c in checks)
    max_pct = float(max(gated_max)) if gated_max else None
    return {
        "budget_pct": float(budget_pct),
        "n_specs": len(checks),
        "converged": converged,
        "gated_max_mape_pct": max_pct,
        "gated_mean_mape_pct": float(np.mean(gated_mean)) if gated_mean else None,
        # a gate nobody exercised stays "pass, n=0" like the other gates, but
        # a non-converged solver is always a loud failure
        "passed": converged and (max_pct is None or max_pct <= budget_pct),
        "specs": checks,
    }


def _rel_err(a: float, b: float) -> float:
    """Symmetric-denominator relative error. Two same-sign infinities agree
    exactly; a one-sided inf or any NaN is an INFINITE error, never a NaN —
    ``max()`` silently drops NaNs, which would let exactly the
    inf-vs-finite transcription bug this check exists to catch slip through."""
    if np.isnan(a) or np.isnan(b):
        return float("inf")
    if np.isinf(a) or np.isinf(b):
        return 0.0 if (np.isinf(a) and np.isinf(b) and (a > 0) == (b > 0)) \
            else float("inf")
    denom = max(abs(a), abs(b), 1e-300)
    return abs(a - b) / denom


@dataclass(frozen=True)
class EntryReport:
    """One corpus scenario's cross-path scores."""

    name: str
    regime: str
    band: str
    rho: float
    strategy: str
    sim_gate: bool
    analytic_scalar_s: float  # scalar closed-form total on the strategy path
    analytic_vec_s: float  # batched closed-form total, same path
    vec_rel_err: float  # max over ALL strategies of this scenario
    golden_rel_err: float | None  # vs fixture totals (None without a fixture)
    sim_backend: str | None  # "fleet" | "scalar" | None (not simulated)
    sim_n: int
    sim_mean_s: float | None
    sim_ci: BootstrapCI | None
    sim_mape_pct: float | None
    tail_gate: bool = False  # counts toward the tail-percentile gate
    analytic_tail_s: float | None = None  # scalar q-quantile, strategy path
    sim_tail_s: float | None = None  # simulated percentile(tail_pct)
    tail_mape_pct: float | None = None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "regime": self.regime,
            "rho_band": self.band,
            "rho": self.rho,
            "strategy": self.strategy,
            "sim_gate": self.sim_gate,
            "analytic_scalar_s": self.analytic_scalar_s,
            "analytic_vec_s": self.analytic_vec_s,
            "vec_rel_err": self.vec_rel_err,
            "golden_rel_err": self.golden_rel_err,
            "sim_backend": self.sim_backend,
            "sim_n": self.sim_n,
            "sim_mean_s": self.sim_mean_s,
            "sim_ci": None if self.sim_ci is None else self.sim_ci.to_dict(),
            "sim_mape_pct": self.sim_mape_pct,
            "tail_gate": self.tail_gate,
            "analytic_tail_s": self.analytic_tail_s,
            "sim_tail_s": self.sim_tail_s,
            "tail_mape_pct": self.tail_mape_pct,
        }


@dataclass(frozen=True)
class ValidationReport:
    """The full fidelity report ``launch/validate.py`` serialises."""

    entries: tuple[EntryReport, ...]
    vec_max_rel_err: float
    vec_tol: float
    golden_max_rel_err: float | None
    golden_tol: float
    gate: ErrorStats  # over sim-gated entries only
    mape_budget_pct: float
    bands: Mapping[str, ErrorStats]  # ALL simulated entries, by rho band
    regimes: Mapping[str, ErrorStats]
    sim_cross: Mapping[str, float]  # scalar-vs-fleet simulator agreement
    config: Mapping[str, object]
    tail: ErrorStats = error_stats(())  # tail-gated entries only
    tail_budget_pct: float = DEFAULT_TAIL_BUDGET_PCT
    tail_pct: float = DEFAULT_TAIL_PCT
    tail_vec_max_rel_err: float | None = None  # scalar tail vs fleet_tail
    euler_vec_max_rel_err: float | None = None  # batched exact euler vs scalar
    euler_vec_tol: float = DEFAULT_EULER_VEC_TOL
    euler_vec_n: int = 0  # corpus entries inside the rho <= 0.95 gate
    meanfield: Mapping[str, object] | None = None  # run_meanfield_gate block

    @property
    def vec_passed(self) -> bool:
        return self.vec_max_rel_err <= self.vec_tol

    @property
    def golden_passed(self) -> bool:
        return self.golden_max_rel_err is None or \
            self.golden_max_rel_err <= self.golden_tol

    @property
    def gate_passed(self) -> bool:
        # a gate nobody exercised (analytic-only run, or an entry set with no
        # sim-gated members) is consistently "pass, n=0"
        if self.gate.n == 0:
            return True
        return self.gate.mean_pct <= self.mape_budget_pct

    @property
    def tail_vec_passed(self) -> bool:
        return self.tail_vec_max_rel_err is None or \
            self.tail_vec_max_rel_err <= self.vec_tol

    @property
    def euler_vec_passed(self) -> bool:
        return self.euler_vec_max_rel_err is None or \
            self.euler_vec_max_rel_err <= self.euler_vec_tol

    @property
    def tail_passed(self) -> bool:
        if self.tail.n == 0:
            return True
        return self.tail.mean_pct <= self.tail_budget_pct

    @property
    def meanfield_passed(self) -> bool:
        return self.meanfield is None or bool(self.meanfield["passed"])

    @property
    def passed(self) -> bool:
        return (self.vec_passed and self.golden_passed and self.gate_passed
                and self.tail_vec_passed and self.euler_vec_passed
                and self.tail_passed and self.meanfield_passed)

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "passed": self.passed,
            "config": dict(self.config),
            "scalar_vs_vec": {
                "max_rel_err": self.vec_max_rel_err,
                "tol": self.vec_tol,
                "passed": self.vec_passed,
            },
            "golden": {
                "max_rel_err": self.golden_max_rel_err,
                "tol": self.golden_tol,
                "passed": self.golden_passed,
            },
            "mape_gate": {
                "budget_pct": self.mape_budget_pct,
                "passed": self.gate_passed,
                **self.gate.to_dict(),
            },
            "tail_gate": {
                "tail_pct": self.tail_pct,
                "budget_pct": self.tail_budget_pct,
                "passed": self.tail_passed,
                **self.tail.to_dict(),
            },
            "scalar_vs_vec_tail": {
                "max_rel_err": self.tail_vec_max_rel_err,
                "tol": self.vec_tol,
                "passed": self.tail_vec_passed,
            },
            "tail_euler_vec": {
                "max_rel_err": self.euler_vec_max_rel_err,
                "tol": self.euler_vec_tol,
                "rho_max": EULER_VEC_RHO_MAX,
                "n_entries": self.euler_vec_n,
                "passed": self.euler_vec_passed,
            },
            "meanfield_gate": None if self.meanfield is None else dict(self.meanfield),
            "bands": {k: v.to_dict() for k, v in self.bands.items()},
            "regimes": {k: v.to_dict() for k, v in self.regimes.items()},
            "sim_cross": dict(self.sim_cross),
            "entries": [e.to_dict() for e in self.entries],
        }


def _sim_n_for(rho: float, base_n: int, max_factor: float) -> int:
    """Longer runs near saturation (autocorrelation grows sharply as rho -> 1,
    so the mean needs more samples to resolve a 5% comparison at all). The
    factor is quantized to a small tier ladder so batched groups can share a
    launch without low-rho rows inheriting a stress entry's run length."""
    factor = min(max_factor, max(1.0, 0.5 / max(1e-6, 1.0 - rho)))
    for tier in (1.0, 2.0, 4.0):
        if factor <= tier <= max_factor:
            return int(base_n * tier)
    return int(base_n * max_factor)


def _simulate_entries(
    entries: Sequence[CorpusEntry],
    idxs: Sequence[int],
    *,
    base_n: int,
    max_factor: float,
    seed: int,
    bootstrap: int,
    device,
    tail_pct: float = DEFAULT_TAIL_PCT,
) -> dict[int, tuple[str, int, float, BootstrapCI, float]]:
    """Simulate every entry, batching where the batched simulator applies.

    Returns ``{corpus index: (backend, n, mean, ci, tail_percentile)}``. Dedicated-edge and
    on-device entries run through ``simulate_fleet`` grouped by their exact
    strategy string (one launch per station per group); entries whose target
    edge hosts background tenants need the shared-station scalar simulator.
    """
    out: dict[int, tuple[str, int, float, BootstrapCI, float]] = {}
    # one launch per (strategy, run-length tier): batching is preserved
    # within a tier, and a stress entry's long run never inflates the
    # low-utilization rows that share its strategy
    groups: dict[tuple[str, int], list[int]] = {}
    scalar_idxs: list[int] = []
    for i in idxs:
        e = entries[i]
        j = parse_strategy(e.strategy, len(e.scenario.edges))
        if j >= 0 and e.scenario.edges[j].background:
            scalar_idxs.append(i)
        else:
            n = _sim_n_for(e.rho, base_n, max_factor)
            groups.setdefault((e.strategy, n), []).append(i)

    for (strategy, n), members in groups.items():
        batch = ScenarioBatch.from_scenarios([entries[i].scenario for i in members])
        res = simulate_fleet(batch, strategy, n=n, seed=seed, device=device)
        steady = res.latencies[:, steady_slice(n)]
        for row, i in enumerate(members):
            ci = bootstrap_mean_ci(steady[row], n_boot=bootstrap, seed=seed + i)
            out[i] = ("fleet", n, float(steady[row].mean()), ci,
                      float(np.percentile(steady[row], tail_pct)))

    for i in scalar_idxs:
        e = entries[i]
        n = _sim_n_for(e.rho, base_n, max_factor)
        res = scalar_simulate(e.scenario, e.strategy, n=n, seed=seed + i)
        # observed = the scenario's own stream, trimmed with the one shared
        # steady-state window (cf. SimResult.stream_mean)
        sl = steady_slice(len(res.latencies), res.warmup_frac)
        mask = res.stream_ids[sl] == 0
        own = res.latencies[sl][mask]
        ci = bootstrap_mean_ci(own, n_boot=bootstrap, seed=seed + i)
        out[i] = ("scalar", n, float(own.mean()), ci, float(np.percentile(own, tail_pct)))
    return out


def run_differential(
    entries: Sequence[CorpusEntry],
    *,
    expected_totals: Mapping[str, Mapping[str, float]] | None = None,
    base_n: int = 120_000,
    max_n_factor: float = 6.0,
    seed: int = 0,
    mape_budget_pct: float = DEFAULT_MAPE_BUDGET_PCT,
    vec_tol: float = DEFAULT_VEC_TOL,
    golden_tol: float = DEFAULT_GOLDEN_TOL,
    euler_vec_tol: float = DEFAULT_EULER_VEC_TOL,
    bootstrap: int = 200,
    simulate: bool = True,
    sim_cross_count: int = 3,
    tail_pct: float = DEFAULT_TAIL_PCT,
    tail_budget_pct: float = DEFAULT_TAIL_BUDGET_PCT,
    meanfield: bool = True,
    meanfield_budget_pct: float = DEFAULT_MEANFIELD_BUDGET_PCT,
    device=None,
) -> ValidationReport:
    """Cross-check all four evaluation paths over ``entries`` (gates 1–5);
    the batched paths run on ``device`` (default: the card).

    ``expected_totals`` (scenario name -> strategy -> golden total) comes from
    the fixture via :func:`repro_torch.validate.corpus.load_corpus`; omit it
    to skip the golden pin. Gate 4 scores every entry's strategy at the
    ``tail_pct`` percentile, its simulated side from the same runs as gate
    3; ``meanfield`` runs gate 5 (:func:`run_meanfield_gate`), analytic, so
    also with ``simulate=False``.
    """
    entries = list(entries)
    if not entries:
        raise ValueError("need at least one corpus entry")
    q = tail_pct / 100.0

    # -- paths 1+2: scalar and batched closed forms ---------------------------
    scalar_totals = [e.scenario.analytic().totals() for e in entries]
    batch = ScenarioBatch.from_scenarios([e.scenario for e in entries])
    pred = fleet_analytic(batch, device=device)
    scalar_tails = [analytic_tail(e.scenario, q) for e in entries]
    pred_tail = fleet_tail(batch, q, device=device)

    vec_errs: list[float] = []
    tail_vec_errs: list[float] = []
    golden_errs: list[float | None] = []
    for i, (e, tot) in enumerate(zip(entries, scalar_totals)):
        vtot = pred.totals(i)
        vec_errs.append(max(_rel_err(v, vtot[k]) for k, v in tot.items()))
        vtail = pred_tail.totals(i)
        tail_vec_errs.append(max(_rel_err(v, vtail[k]) for k, v in scalar_tails[i].items()))
        if expected_totals is not None and e.name in expected_totals:
            exp = expected_totals[e.name]
            golden_errs.append(max(_rel_err(v, float(exp[k]))
                                   for k, v in tot.items()))
        else:
            golden_errs.append(None)

    # -- tail-euler-vec: batched exact inversion vs scalar Euler --------------
    # method="euler" on both sides (immune to default-method drift)
    euler_idx = [i for i, e in enumerate(entries) if e.rho <= EULER_VEC_RHO_MAX]
    euler_vec_max = None
    if euler_idx:
        pred_euler = fleet_tail(batch, q, method="euler", device=device)
        euler_errs = []
        for i in euler_idx:
            sc = analytic_tail(entries[i].scenario, q, method="euler")
            vtail = pred_euler.totals(i)
            euler_errs.append(max(_rel_err(v, vtail[k]) for k, v in sc.items()))
        euler_vec_max = float(max(euler_errs))

    # -- paths 3+4: discrete-event simulation ---------------------------------
    sim_results: dict[int, tuple[str, int, float, BootstrapCI, float]] = {}
    if simulate:
        sim_results = _simulate_entries(
            entries, range(len(entries)), base_n=base_n, max_factor=max_n_factor,
            seed=seed, bootstrap=bootstrap, device=device, tail_pct=tail_pct,
        )

    reports: list[EntryReport] = []
    for i, e in enumerate(entries):
        pred_s = float(scalar_totals[i][e.strategy])
        pred_q = float(scalar_tails[i][e.strategy])
        backend = n_used = sim_mean = ci = err = None
        sim_q = tail_err = None
        if i in sim_results:
            backend, n_used, sim_mean, ci, sim_q = sim_results[i]
            err = mape(pred_s, sim_mean)
            tail_err = mape(pred_q, sim_q)
        reports.append(EntryReport(
            name=e.name,
            regime=e.regime,
            band=e.band,
            rho=e.rho,
            strategy=e.strategy,
            sim_gate=e.sim_gate,
            analytic_scalar_s=pred_s,
            analytic_vec_s=float(pred.totals(i)[e.strategy]),
            vec_rel_err=vec_errs[i],
            golden_rel_err=golden_errs[i],
            sim_backend=backend,
            sim_n=n_used or 0,
            sim_mean_s=sim_mean,
            sim_ci=ci,
            sim_mape_pct=err,
            tail_gate=tail_gated(e),
            analytic_tail_s=pred_q,
            sim_tail_s=sim_q,
            tail_mape_pct=tail_err,
        ))

    # -- simulator-vs-simulator cross-check (independent random streams) -----
    sim_cross: dict[str, float] = {}
    if simulate and sim_cross_count > 0:
        crossed = []
        for i, e in enumerate(entries):
            if len(crossed) >= sim_cross_count:
                break
            if not e.sim_gate or e.strategy != "on_device":
                continue
            n = _sim_n_for(e.rho, base_n, max_n_factor)
            res = scalar_simulate(e.scenario, "on_device", n=n, seed=seed + 7919)
            fleet_mean = sim_results[i][2]
            crossed.append(mape(res.mean, fleet_mean))
        if crossed:
            sim_cross = {
                "n_entries": float(len(crossed)),
                "mean_mape_pct": float(np.mean(crossed)),
                "max_mape_pct": float(np.max(crossed)),
            }

    gated = [r.sim_mape_pct for r in reports if r.sim_gate and r.sim_mape_pct is not None]
    simulated = [(r.band, r.sim_mape_pct) for r in reports if r.sim_mape_pct is not None]
    by_regime = [(r.regime, r.sim_mape_pct) for r in reports if r.sim_mape_pct is not None]
    tail_gated_errs = [r.tail_mape_pct for r in reports
                       if r.tail_gate and r.tail_mape_pct is not None]

    mf_report = run_meanfield_gate(budget_pct=meanfield_budget_pct, device=device) \
        if meanfield else None

    golden_vals = [g for g in golden_errs if g is not None]
    return ValidationReport(
        entries=tuple(reports),
        vec_max_rel_err=float(max(vec_errs)),
        vec_tol=vec_tol,
        golden_max_rel_err=float(max(golden_vals)) if golden_vals else None,
        golden_tol=golden_tol,
        gate=error_stats(gated),
        mape_budget_pct=mape_budget_pct,
        bands=error_table(simulated, order=BAND_ORDER),
        regimes=error_table(by_regime),
        sim_cross=sim_cross,
        config={
            "n_entries": len(entries),
            "base_n": base_n,
            "max_n_factor": max_n_factor,
            "seed": seed,
            "bootstrap": bootstrap,
            "simulate": simulate,
            "tail_pct": tail_pct,
            "device": str(device) if device is not None else "cuda",
        },
        tail=error_stats(tail_gated_errs),
        tail_budget_pct=tail_budget_pct,
        tail_pct=tail_pct,
        tail_vec_max_rel_err=float(max(tail_vec_errs)),
        euler_vec_max_rel_err=euler_vec_max,
        euler_vec_tol=euler_vec_tol,
        euler_vec_n=len(euler_idx),
        meanfield=mf_report,
    )
