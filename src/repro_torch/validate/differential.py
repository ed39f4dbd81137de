"""Differential validation, gates 1–3: the corpus through four paths.

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
    (independent random streams estimating the same queue).

The reference harness also scores tail percentiles, the batched Euler tail
inversion and the mean-field fleet. Those blocks need modules the port does
not have yet (ROADMAP A3); the report names them with ``"ported": false``,
and its ``passed`` covers gates 1–3 only.

``run_differential`` is pure given its inputs and seeded throughout, so a
failing report reproduces exactly on the same device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.scenario import parse_strategy
from repro_torch.core.scenario import simulate as scalar_simulate
from repro_torch.core.simulation import steady_slice
from repro_torch.fleet import ScenarioBatch, fleet_analytic, simulate_fleet

from .corpus import BAND_ORDER, CorpusEntry
from .metrics import BootstrapCI, ErrorStats, bootstrap_mean_ci, error_stats, error_table, mape

__all__ = [
    "EntryReport",
    "ValidationReport",
    "run_differential",
    "smoke_subset",
    "DEFAULT_MAPE_BUDGET_PCT",
    "DEFAULT_VEC_TOL",
    "DEFAULT_GOLDEN_TOL",
    "GATES",
    "NOT_PORTED",
]

DEFAULT_MAPE_BUDGET_PCT = 5.0
DEFAULT_VEC_TOL = 1e-6
DEFAULT_GOLDEN_TOL = 1e-9
GATES = ("scalar_vs_vec", "golden", "mape_gate")
# the reference report's blocks that need modules still to port (ROADMAP A3)
NOT_PORTED = ("tail_gate", "scalar_vs_vec_tail", "tail_euler_vec", "meanfield_gate")


def smoke_subset(entries: Sequence[CorpusEntry]) -> list[CorpusEntry]:
    """The fast tier-1 slice of the corpus (entries flagged ``smoke``)."""
    return [e for e in entries if e.smoke]


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
        }


@dataclass(frozen=True)
class ValidationReport:
    """Gates 1–3 of the reference's fidelity report."""

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
    def passed(self) -> bool:
        """Gates 1–3 passed (the only gates this report covers)."""
        return self.vec_passed and self.golden_passed and self.gate_passed

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "passed": self.passed,
            "covers": list(GATES),
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
            **{name: {"ported": False} for name in NOT_PORTED},
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
) -> dict[int, tuple[str, int, float, BootstrapCI]]:
    """Simulate every entry, batching where the batched simulator applies.

    Returns ``{corpus index: (backend, n, mean, ci)}``. Dedicated-edge and
    on-device entries run through ``simulate_fleet`` grouped by their exact
    strategy string (one launch per station per group); entries whose target
    edge hosts background tenants need the shared-station scalar simulator.
    """
    out: dict[int, tuple[str, int, float, BootstrapCI]] = {}
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
            out[i] = ("fleet", n, float(steady[row].mean()), ci)

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
        out[i] = ("scalar", n, float(own.mean()), ci)
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
    bootstrap: int = 200,
    simulate: bool = True,
    sim_cross_count: int = 3,
    device=None,
) -> ValidationReport:
    """Cross-check the four evaluation paths over ``entries`` (gates 1–3);
    the batched paths run on ``device`` (default: the card).

    ``expected_totals`` (scenario name -> strategy -> golden total) comes from
    the fixture via :func:`repro_torch.validate.corpus.load_corpus`; omit it
    to skip the golden pin.
    """
    entries = list(entries)
    if not entries:
        raise ValueError("need at least one corpus entry")

    # -- paths 1+2: scalar and batched closed forms ---------------------------
    scalar_totals = [e.scenario.analytic().totals() for e in entries]
    batch = ScenarioBatch.from_scenarios([e.scenario for e in entries])
    pred = fleet_analytic(batch, device=device)

    vec_errs: list[float] = []
    golden_errs: list[float | None] = []
    for i, (e, tot) in enumerate(zip(entries, scalar_totals)):
        vtot = pred.totals(i)
        vec_errs.append(max(_rel_err(v, vtot[k]) for k, v in tot.items()))
        if expected_totals is not None and e.name in expected_totals:
            exp = expected_totals[e.name]
            golden_errs.append(max(_rel_err(v, float(exp[k]))
                                   for k, v in tot.items()))
        else:
            golden_errs.append(None)

    # -- paths 3+4: discrete-event simulation ---------------------------------
    sim_results: dict[int, tuple[str, int, float, BootstrapCI]] = {}
    if simulate:
        sim_results = _simulate_entries(
            entries, range(len(entries)), base_n=base_n, max_factor=max_n_factor,
            seed=seed, bootstrap=bootstrap, device=device,
        )

    reports: list[EntryReport] = []
    for i, e in enumerate(entries):
        pred_s = float(scalar_totals[i][e.strategy])
        backend = n_used = sim_mean = ci = err = None
        if i in sim_results:
            backend, n_used, sim_mean, ci = sim_results[i]
            err = mape(pred_s, sim_mean)
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
            "device": str(device) if device is not None else "cuda",
        },
    )
