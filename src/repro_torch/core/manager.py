"""Model-driven adaptive offloading manager — paper Algorithm 1 (§5.1).

Runs on the device. Each epoch it takes a telemetry snapshot (lambda, B,
per-edge load), evaluates the closed-form latency of every strategy —
on-device (Eq. 2, M/D/1) and offload-to-E for each edge server E (Eq. 1 with
M/G/1 edge processing) — and executes with the argmin. Line numbers in
comments refer to Algorithm 1 in the paper.

Beyond-paper (flag-gated, default off, recorded in EXPERIMENTS.md):
  * hysteresis — require a relative improvement before switching strategy, to
    damp flapping around a crossover;
  * SLO-quantile decisions — when ``slo_quantile`` is set, every strategy is
    scored by the q-quantile of its closed-form sojourn *distribution*
    (:mod:`repro_torch.core.tail`) instead of its mean, so the argmin optimises the
    latency SLO directly (p95/p99) rather than a mean proxy;
  * ``tail_z`` — the DEPRECATED predecessor of the quantile mode: inflate
    both waits by ``(1 + z)`` as a crude variability penalty. Kept as a
    fallback; prefer ``slo_quantile``.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

from .latency import (
    NetworkPath,
    ServiceModel,
    Tier,
    Workload,
    mg1_wait,
    mm1_wait,
    proc_wait,
)
from .tail import (
    KIND_DET,
    KIND_EXP,
    KIND_GAMMA,
    Station,
    offload_stations,
    proc_station,
    sojourn_quantile,
)
from .telemetry import TelemetrySnapshot

__all__ = ["EdgeServerState", "Decision", "AdaptiveOffloadManager", "apply_decision_rule"]

ON_DEVICE = -1  # sentinel edge index for local execution


def apply_decision_rule(
    t_dev: float,
    t_edges: Sequence[float],
    *,
    last_index: int | None = None,
    hysteresis: float = 0.0,
) -> tuple[int, float]:
    """Algorithm 1 lines 7-11 (+ the hysteresis extension) as a pure function.

    Given the per-strategy latency predictions, returns ``(choice,
    predicted)`` where ``choice`` is ``ON_DEVICE`` or an edge index.
    On-device wins exact ties (line 7's ``<=``), matching
    ``FleetPrediction.best_edge``'s first-argmin convention. This is THE
    selection rule: ``AdaptiveOffloadManager.decide`` calls it per epoch and
    ``repro_torch.fleet.cluster`` is its (N,)-array transcription — a coherence
    test pins the two together so the scalar and vectorized decision paths
    cannot drift apart.
    """
    if t_edges and np.isfinite(min(t_edges)):
        best_edge = int(np.argmin(t_edges))
        best_edge_t = float(t_edges[best_edge])
    else:
        best_edge, best_edge_t = ON_DEVICE, np.inf

    if t_dev <= best_edge_t:  # line 7
        choice, predicted = ON_DEVICE, t_dev  # line 8
    else:
        choice, predicted = best_edge, best_edge_t  # lines 10-11

    # beyond-paper hysteresis: keep the previous target unless the new one
    # improves by more than `hysteresis` relative.
    if hysteresis > 0.0 and last_index is not None and choice != last_index:
        prev_t = (
            t_dev
            if last_index == ON_DEVICE
            else (t_edges[last_index] if last_index < len(t_edges) else np.inf)
        )
        if np.isfinite(prev_t) and predicted > (1.0 - hysteresis) * prev_t:
            choice, predicted = last_index, float(prev_t)
    return choice, float(predicted)


@dataclass(frozen=True)
class EdgeServerState:
    """One edge server E as the manager sees it this epoch."""

    name: str
    service_rate: float  # mu_edge,E^proc — aggregated service rate (Alg. 1 input)
    arrival_rate: float  # lambda_edge,E — aggregate load (Alg. 1 input)
    service_time_s: float  # s_edge^proc for THIS workload on E
    service_var: float = 0.0  # Var[s] of E's aggregate mixture (M/G/1 term)
    parallelism_k: float = 1.0
    bandwidth_Bps: float | None = None  # per-edge path override (else device B)


@dataclass(frozen=True)
class Decision:
    strategy: str  # "on_device" | "offload"
    edge_index: int  # ON_DEVICE or index into the edges list
    predicted_latency_s: float
    t_dev: float
    t_edges: tuple[float, ...]
    epoch: int

    @property
    def target_name(self) -> str:
        return "on_device" if self.edge_index == ON_DEVICE else f"edge[{self.edge_index}]"


class AdaptiveOffloadManager:
    """Algorithm 1, plus optional hysteresis / tail-awareness extensions."""

    _MODEL_KINDS = {
        ServiceModel.DETERMINISTIC: KIND_DET,
        ServiceModel.EXPONENTIAL: KIND_EXP,
        ServiceModel.GENERAL: KIND_GAMMA,
    }

    def __init__(
        self,
        device: Tier,
        *,
        hysteresis: float = 0.0,
        tail_z: float = 0.0,
        slo_quantile: float | None = None,
        tail_method: str = "euler",
        return_results: bool = True,
        auditor=None,
        tracer=None,
        audit_source: str = "manager",
    ):
        if hysteresis < 0:
            raise ValueError("hysteresis must be >= 0")
        if slo_quantile is not None and not 0.0 < slo_quantile < 1.0:
            raise ValueError(f"slo_quantile must be in (0, 1), got {slo_quantile}")
        if tail_method not in ("euler", "asymptote"):
            raise ValueError(f"unknown tail_method {tail_method!r}")
        if tail_z > 0.0:
            if slo_quantile is not None:
                raise ValueError("tail_z and slo_quantile are mutually exclusive; "
                                 "use slo_quantile")
            warnings.warn(
                "tail_z is deprecated: it inflates the mean by a fixed factor "
                "instead of optimising a quantile; use slo_quantile=0.99 (the "
                "principled SLO mode backed by repro_torch.core.tail)",
                DeprecationWarning, stacklevel=2,
            )
        self.device = device
        self.hysteresis = hysteresis
        self.tail_z = tail_z
        self.slo_quantile = slo_quantile
        self.tail_method = tail_method
        # paper §3.3: results consumed at the edge omit the return network
        # delay — must match the Scenario/analytic() setting or the argmin
        # disagrees with the closed forms on the same spec
        self.return_results = return_results
        # observability (repro_torch.obs) — both duck-typed so core never imports
        # obs: `auditor` needs .record(**row), `tracer` needs .instant(...).
        # None keeps the decision path allocation-free.
        self.auditor = auditor
        self.tracer = tracer
        self.audit_source = audit_source
        self._epoch = 0
        self._last: Decision | None = None
        self.history: list[Decision] = []

    # -- Algorithm 1 lines 1-2 ------------------------------------------------
    def _device_station(self, lam_dev: float) -> Station:
        d = self.device
        return proc_station(lam_dev, self._MODEL_KINDS[d.service_model],
                            d.service_time_s, d.service_var, d.parallelism_k)

    def _device_terms(self, lam_dev: float) -> dict[str, float]:
        """The mean on-device decomposition, keyed and ordered exactly like
        ``on_device_latency(..., breakdown=True)`` — the audit layer's term
        re-sum invariant holds by construction because ``_predict_device``
        derives its mean prediction from this very dict."""
        # proc_wait dispatches on the device's service model (M/D/1, M/M/1,
        # or M/G/1 with its variance) exactly as the paper's lines 1-2 do —
        # duplicating that dispatch here is how GENERAL was once mis-modeled
        w = float(proc_wait(self.device, lam_dev))
        if self.tail_z > 0.0:
            # deprecated fallback — the SAME variability inflation the edge
            # path gets, so equal-variability specs are treated symmetrically
            w = w * (1.0 + self.tail_z)
        return {"w_proc_dev": w, "s_dev": self.device.service_time_s}

    def _predict_device(self, lam_dev: float) -> float:
        if self.slo_quantile is not None:
            return float(sojourn_quantile((self._device_station(lam_dev),),
                                          self.slo_quantile, method=self.tail_method))
        t = self._device_terms(lam_dev)
        return t["w_proc_dev"] + t["s_dev"]

    # -- Algorithm 1 lines 3-6 ------------------------------------------------
    @staticmethod
    def _edge_bandwidth(edge: EdgeServerState, bandwidth_Bps: float) -> float | None:
        """Resolve the path bandwidth for this edge (per-edge override wins);
        None means the link is dead/saturated this epoch."""
        if edge.bandwidth_Bps is not None and edge.bandwidth_Bps <= 0:
            # an explicit per-edge override of 0.0 is a config error, not "unset"
            raise ValueError(
                f"edge {edge.name!r}: bandwidth override must be positive, "
                f"got {edge.bandwidth_Bps!r}"
            )
        b = bandwidth_Bps if edge.bandwidth_Bps is None else edge.bandwidth_Bps
        if b is None or b <= 0:
            # measured bandwidth can hit 0 during an outage: the link is
            # saturated/dead, so offloading is never preferable this epoch
            return None
        return b

    def _edge_terms(
        self, edge: EdgeServerState, wl: Workload, lam_dev: float, bandwidth_Bps: float
    ) -> dict[str, float]:
        """The mean offload decomposition — the same six terms, keys, and
        order as ``edge_offload_latency(..., breakdown=True)`` (Eq. 1 /
        Alg. 1 lines 3-6). ``_predict_edge`` sums this dict in mean mode."""
        b = self._edge_bandwidth(edge, bandwidth_Bps)
        if b is None:
            return {"w_net_dev": float(np.inf), "n_req": 0.0,
                    "w_proc_edge": 0.0, "s_edge": edge.service_time_s,
                    "w_net_edge": 0.0, "n_res": 0.0}
        # zero-byte payloads mean "no transfer on this leg" (e.g. results
        # consumed at the edge) — the NIC queue degenerates to zero delay
        if wl.req_bytes > 0:
            # line 3: T_net_req <- M/M/1(lambda_dev, B/D_req) + D_req/B
            w_net_dev = float(mm1_wait(lam_dev, b / wl.req_bytes))
            n_req = wl.req_bytes / b
        else:
            w_net_dev = n_req = 0.0
        if self.return_results and wl.res_bytes > 0:
            # line 4: T_net_res <- M/M/1(lambda_edge,E, B/D_res) + D_res/B
            w_net_edge = float(mm1_wait(edge.arrival_rate, b / wl.res_bytes))
            n_res = wl.res_bytes / b
        else:
            w_net_edge = n_res = 0.0
        # line 6: M/G/1 wait on the edge's aggregate mixture
        w_proc = float(
            mg1_wait(edge.arrival_rate, edge.service_rate, edge.service_var, edge.parallelism_k)
        )
        if self.tail_z > 0.0:
            # beyond-paper: penalise variability when an SLO is set.
            # sigma_w proxy: for M/G/1 the wait is roughly exponential-tailed
            # with scale E[w]; mean + z*E[w] is a cheap upper quantile proxy.
            w_proc = w_proc * (1.0 + self.tail_z)
        return {"w_net_dev": w_net_dev, "n_req": n_req,
                "w_proc_edge": w_proc, "s_edge": edge.service_time_s,
                "w_net_edge": w_net_edge, "n_res": n_res}

    def _predict_edge(
        self, edge: EdgeServerState, wl: Workload, lam_dev: float, bandwidth_Bps: float
    ) -> float:
        b = self._edge_bandwidth(edge, bandwidth_Bps)
        if b is None:
            return float(np.inf)
        if self.slo_quantile is not None:
            # SLO mode: score the q-quantile of the composed sojourn
            # distribution over the same three stations lines 3-6 price by
            # their means. The edge wait is the aggregate-mixture M/G/1
            # (gamma-matched), line 6's own service time rides on top.
            k_mu = edge.parallelism_k * edge.service_rate
            proc = Station(edge.arrival_rate, KIND_GAMMA, 1.0 / k_mu,
                           edge.service_var, KIND_GAMMA, edge.service_time_s,
                           edge.service_var)
            stations = offload_stations(lam_dev, wl.req_bytes, wl.res_bytes, b,
                                        proc, return_results=self.return_results)
            return float(sojourn_quantile(stations, self.slo_quantile,
                                          method=self.tail_method))
        # line 6: T_edge,E <- T_req + M/G/1(lambda_E, mu_E) + s_edge + T_res —
        # summed in LatencyBreakdown's key order so the prediction IS the sum
        # of its own audit terms (bit-exact, not just within tolerance)
        t = self._edge_terms(edge, wl, lam_dev, bandwidth_Bps)
        return (t["w_net_dev"] + t["n_req"] + t["w_proc_edge"]
                + t["s_edge"] + t["w_net_edge"] + t["n_res"])

    # -- Algorithm 1 lines 7-11 -----------------------------------------------
    def decide(
        self,
        wl: Workload,
        snapshot: TelemetrySnapshot,
        edges: Sequence[EdgeServerState],
    ) -> Decision:
        lam_dev = snapshot.lam_dev
        last_index = None if self._last is None else self._last.edge_index
        t_dev = self._predict_device(lam_dev)
        t_edges = tuple(
            self._predict_edge(e, wl, lam_dev, snapshot.bandwidth_Bps) for e in edges
        )
        choice, predicted = apply_decision_rule(
            t_dev,
            t_edges,
            last_index=last_index,
            hysteresis=self.hysteresis,
        )

        decision = Decision(
            strategy="on_device" if choice == ON_DEVICE else "offload",
            edge_index=choice,
            predicted_latency_s=float(predicted),
            t_dev=t_dev,
            t_edges=t_edges,
            epoch=self._epoch,
        )
        if self.auditor is not None:
            self._audit(decision, wl, snapshot, edges, last_index)
        if self.tracer is not None:
            self.tracer.instant(
                t=snapshot.time_s, name="decide", cat="decide",
                track=self.audit_source, epoch=decision.epoch,
                target=decision.target_name,
                predicted_latency_s=decision.predicted_latency_s,
            )
        self._epoch += 1
        self._last = decision
        self.history.append(decision)
        return decision

    def _audit(self, decision, wl, snapshot, edges, last_index) -> None:
        """Record the full closed-form story behind ``decision`` (repro_torch.obs).

        In mean mode the audited totals ARE the ordered sums of the audited
        terms (the predictions are computed that way); in SLO-quantile mode
        the totals are q-quantiles, so the mean decomposition is logged
        alongside under ``term_totals`` and ``decision_metric`` says which
        metric the argmin ranked.
        """
        terms: dict[str, dict[str, float]] = {
            "on_device": self._device_terms(snapshot.lam_dev)}
        for i, e in enumerate(edges):
            terms[f"edge[{i}]"] = self._edge_terms(
                e, wl, snapshot.lam_dev, snapshot.bandwidth_Bps)
        term_totals = {
            "on_device": terms["on_device"]["w_proc_dev"] + terms["on_device"]["s_dev"]}
        for i in range(len(edges)):
            t = terms[f"edge[{i}]"]
            term_totals[f"edge[{i}]"] = (
                t["w_net_dev"] + t["n_req"] + t["w_proc_edge"]
                + t["s_edge"] + t["w_net_edge"] + t["n_res"])
        totals = {"on_device": decision.t_dev}
        for i, v in enumerate(decision.t_edges):
            totals[f"edge[{i}]"] = v
        alts = [v for k, v in totals.items() if k != decision.target_name]
        chosen_total = totals[decision.target_name]
        margin = min(alts) - chosen_total if alts else float(np.inf)
        if np.isnan(margin):  # inf - inf: everything saturated, no margin story
            margin = 0.0
        # hysteresis engaged <=> the no-hysteresis rule picks differently
        raw_choice, _ = apply_decision_rule(decision.t_dev, decision.t_edges)
        self.auditor.record(
            epoch=decision.epoch,
            time_s=snapshot.time_s,
            source=self.audit_source,
            chosen=decision.target_name,
            edge_index=decision.edge_index,
            predicted_latency_s=decision.predicted_latency_s,
            decision_metric=("mean" if self.slo_quantile is None
                             else f"p{self.slo_quantile * 100:g}"),
            totals=totals,
            terms=terms,
            term_totals=term_totals,
            snapshot={
                "time_s": snapshot.time_s,
                "lam_dev": snapshot.lam_dev,
                "bandwidth_Bps": snapshot.bandwidth_Bps,
                "edge_arrival_rates": [e.arrival_rate for e in edges],
                "edge_service_rates": [e.service_rate for e in edges],
                "edge_service_vars": [e.service_var for e in edges],
            },
            margin_s=float(margin),
            hysteresis={
                "hysteresis": self.hysteresis,
                "last_index": last_index,
                "engaged": raw_choice != decision.edge_index,
            },
            slo_quantile=self.slo_quantile,
        )

    # -- shared epoch entry point ----------------------------------------------
    def step(self, t: float, metrics: Mapping) -> Decision:
        """One epoch from measured metrics — the single decision path shared
        by the serving gateway and the fleet trace replay.

        ``metrics`` keys: ``workload`` (:class:`Workload`), ``lam_dev`` and
        ``bandwidth_Bps`` (estimator outputs, *not* raw instantaneous values),
        and optionally ``edges`` (a sequence of :class:`EdgeServerState`).
        Builds the :class:`TelemetrySnapshot` and runs Algorithm 1 lines 1-11;
        keeping snapshot assembly here means no consumer re-implements the
        dispatch and the two paths can never disagree on the same metrics.
        """
        for key in ("workload", "lam_dev", "bandwidth_Bps"):
            if key not in metrics:
                raise KeyError(f"metrics missing required key {key!r}")
        snap = TelemetrySnapshot(
            time_s=t,
            lam_dev=float(metrics["lam_dev"]),
            bandwidth_Bps=float(metrics["bandwidth_Bps"]),
        )
        return self.decide(metrics["workload"], snap, tuple(metrics.get("edges", ())))

    @property
    def switches(self) -> int:
        """Number of strategy changes so far (flapping metric)."""
        return sum(
            1
            for a, b in zip(self.history, self.history[1:])
            if a.edge_index != b.edge_index
        )
