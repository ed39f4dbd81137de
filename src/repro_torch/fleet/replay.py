"""Trace-driven replay of the adaptive manager against static policies (§5).

Reproduces the shape of the paper's evaluation "under variable network
conditions and dynamic multi-tenant edge settings": a :class:`Trace` drives
the true environment epoch by epoch; the adaptive policy sees it only through
the §4.2 telemetry estimators (EWMA bandwidth and edge-load reports, a
sliding-window arrival-rate estimate over sampled request timestamps — never
raw instantaneous values), decides via the *same*
``AdaptiveOffloadManager.step()`` hook the serving gateway uses, and every
policy's chosen strategy is then scored with the closed forms under the TRUE
conditions. Static-device and static-edge baselines bracket it, so

    replay(scn, trace).policies["adaptive"].mean_latency_s

directly answers the paper's §5 question: does model-driven adaptation beat
committing to either side?

Epochs whose chosen strategy is unstable under the true conditions score
``saturation_penalty_s`` instead of ``inf`` — one epoch of saturation accrues
a bounded backlog, and bounded penalties keep policy means comparable.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence

import numpy as np

from repro_torch.core.manager import AdaptiveOffloadManager, Decision
from repro_torch.core.multitenant import TenantStream
from repro_torch.core.scenario import Scenario, ScenarioError
from repro_torch.core.telemetry import EwmaEstimator, SlidingRateEstimator

from .policy import bg_template, clamp_saturation, parse_policy, true_latency
from .traces import Trace

__all__ = ["PolicyResult", "ReplayResult", "replay"]


@dataclass(frozen=True)
class PolicyResult:
    """One policy's scored trajectory through the trace."""

    name: str
    latencies_s: np.ndarray  # (T,) true-condition latency of the chosen target
    targets: tuple[int, ...]  # per-epoch edge index (ON_DEVICE for local)
    saturated_epochs: int  # epochs that hit the saturation penalty

    @property
    def mean_latency_s(self) -> float:
        return float(np.mean(self.latencies_s))

    @property
    def switches(self) -> int:
        return sum(1 for a, b in zip(self.targets, self.targets[1:]) if a != b)


@dataclass(frozen=True)
class ReplayResult:
    """Replay outcome: per-policy scores plus the estimator trajectories."""

    trace: Trace
    policies: dict[str, PolicyResult]
    est_bandwidth_Bps: np.ndarray  # (T,) EWMA view the manager acted on
    est_arrival_rate: np.ndarray  # (T,) sliding-window view
    est_edge_bg_rate: np.ndarray  # (T, E) EWMA edge-load reports
    decisions: tuple[Decision, ...]  # the adaptive manager's full history

    @property
    def adaptive_wins(self) -> bool:
        """Paper §5 criterion: adaptive mean <= every static policy's mean."""
        a = self.policies["adaptive"].mean_latency_s
        return all(
            a <= p.mean_latency_s for n, p in self.policies.items() if n != "adaptive"
        )


def replay(
    scn: Scenario,
    trace: Trace,
    *,
    policies: Sequence[str] = ("adaptive", "on_device", "edge[0]"),
    seed: int = 0,
    bw_alpha: float = 0.5,
    bg_alpha: float = 0.5,
    rate_window_epochs: int = 5,
    saturation_penalty_s: float = 30.0,
    manager: AdaptiveOffloadManager | None = None,
    slo_quantile: float | None = None,
    tail_method: str = "euler",
) -> ReplayResult:
    """Drive ``scn`` through ``trace``, scoring adaptive vs static policies.

    The adaptive policy's inputs go through the telemetry layer: bandwidth
    and per-edge load via :class:`EwmaEstimator`, arrival rate via a
    :class:`SlidingRateEstimator` fed seeded Poisson request timestamps —
    so the manager reacts with realistic estimator lag, exactly as the
    gateway would. ``manager`` defaults to ``scn.manager()`` (pass one with
    hysteresis etc. to study the beyond-paper extensions).

    ``slo_quantile`` switches the whole replay to the SLO view: the default
    manager decides on q-quantiles (``scn.manager(slo_quantile=...)``) and
    every policy is scored by the q-quantile of its chosen path under the
    true conditions, so ``adaptive_wins`` answers the §5 question for tail
    latency instead of the mean.

    The reference's ``auditor``/``tracer`` hooks come back with the port's
    ``obs`` slice (ROADMAP A2).
    """
    if trace.n_edges not in (0, len(scn.edges)):
        raise ScenarioError(
            "trace", f"trace has {trace.n_edges} edge columns but the scenario "
            f"has {len(scn.edges)} edges")
    static_targets = {
        name: parse_policy(name, len(scn.edges))
        for name in policies if name != "adaptive"
    }
    run_adaptive = "adaptive" in policies
    templates = [bg_template(scn, j) for j in range(len(scn.edges))]
    # a trace without edge columns means "no churn", not "no tenants": the
    # spec's declared background rates hold for every epoch
    spec_bg = np.array([t[0] for t in templates])

    rng = np.random.default_rng(seed)
    if manager is not None:
        mgr = manager
    elif slo_quantile is not None:
        mgr = scn.manager(slo_quantile=slo_quantile, tail_method=tail_method)
    else:
        mgr = scn.manager()
    dt = trace.epoch_s
    bw_est = EwmaEstimator(alpha=bw_alpha)
    lam_est = SlidingRateEstimator(window_s=rate_window_epochs * dt)
    bg_ests = [EwmaEstimator(alpha=bg_alpha) for _ in scn.edges]

    t_n = trace.n_epochs
    est_bw = np.empty(t_n)
    est_lam = np.empty(t_n)
    est_bg = np.zeros((t_n, len(scn.edges)))
    chosen: dict[str, list[int]] = {n: [] for n in (*static_targets, *(
        ("adaptive",) if run_adaptive else ()))}
    decisions: list[Decision] = []

    for i in range(t_n):
        t = float(trace.times[i])
        bw_true = float(trace.bandwidth_Bps[i])
        lam_true = float(trace.arrival_rate[i])
        bg_true = trace.edge_bg_rate[i] if trace.n_edges else spec_bg

        # -- telemetry collection (§4.2): estimators, not raw values --------
        est_bw[i] = bw_est.update(bw_true)
        n_req = int(rng.poisson(lam_true * dt))
        for ts in np.sort(rng.uniform(t, t + dt, size=n_req)):
            lam_est.record(float(ts))
        measured = lam_est.rate(t + dt)
        lam_hat = measured if measured > 0 else scn.workload.arrival_rate
        est_lam[i] = lam_hat
        for j, est in enumerate(bg_ests):
            est_bg[i, j] = est.update(float(bg_true[j]))

        if run_adaptive:
            # estimated edge states: spec edges with the churned background
            # re-aggregated at the EWMA-estimated rate
            wl_hat = replace(scn.workload, arrival_rate=lam_hat)
            states = []
            for j, e in enumerate(scn.edges):
                rate, mean, var = templates[j]
                bg = ((TenantStream(est_bg[i, j], mean, var),)
                      if est_bg[i, j] > 0 else ())
                states.append(replace(e, background=bg).to_state(wl_hat))
            d = mgr.step(t, {
                "workload": scn.workload,
                "lam_dev": lam_hat,
                "bandwidth_Bps": est_bw[i],
                "edges": states,
            })
            decisions.append(d)
            chosen["adaptive"].append(d.edge_index)
        for name, tgt in static_targets.items():
            chosen[name].append(tgt)

    # -- score every policy under the TRUE conditions -------------------------
    results: dict[str, PolicyResult] = {}
    for name, targets in chosen.items():
        lats = np.empty(t_n)
        for i, tgt in enumerate(targets):
            bg_true = trace.edge_bg_rate[i] if trace.n_edges else spec_bg
            lats[i] = true_latency(scn, tgt, float(trace.bandwidth_Bps[i]),
                                   float(trace.arrival_rate[i]), bg_true, templates,
                                   slo_quantile=slo_quantile,
                                   tail_method=tail_method)
        lats, saturated = clamp_saturation(lats, saturation_penalty_s)
        results[name] = PolicyResult(
            name=name, latencies_s=lats, targets=tuple(targets),
            saturated_epochs=saturated,
        )

    return ReplayResult(
        trace=trace,
        policies=results,
        est_bandwidth_Bps=est_bw,
        est_arrival_rate=est_lam,
        est_edge_bg_rate=est_bg,
        decisions=tuple(decisions),
    )
