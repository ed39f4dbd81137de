"""Offload gateway: the paper's Algorithm 1 embedded in the serving stack.

The gateway fronts one *device-tier* engine and E *edge-tier* engines
separated by a modelled network path. Per epoch it snapshots telemetry
(sliding-window arrival rate, EWMA bandwidth, per-edge aggregate load +
service moments), asks ``AdaptiveOffloadManager`` for the argmin strategy,
and routes the epoch's requests accordingly. Service-time estimates come from
the engines' own profiled ticks (paper §4.2), as ``launch/serve.py`` feeds it.

This is the deployable form of the paper's resource manager, a copy of
``repro.serving.gateway`` over the port's numpy ``core``. It is host code:
it holds no tensor, touches no device and launches no kernel, so the same
object routes for an engine on the card or on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.latency import Tier, Workload
from repro_torch.core.manager import ON_DEVICE, AdaptiveOffloadManager, Decision, EdgeServerState
from repro_torch.core.telemetry import EwmaEstimator, SlidingRateEstimator, WindowedMoments

__all__ = ["EdgeHandle", "OffloadGateway"]


@dataclass
class EdgeHandle:
    """One edge server as the gateway tracks it."""

    name: str
    service_mean_s: float  # current estimate for THIS workload on the edge
    parallelism_k: float = 1.0
    service_var_s: float = 0.0  # Var[s] of THIS workload's service on the edge
    background_rate: float = 0.0  # other tenants' aggregate lambda (obs.)
    background_service_s: float = 0.0
    background_service_var: float = 0.0
    bandwidth_Bps: float | None = None  # per-edge path override (else device B)
    arrivals: SlidingRateEstimator = field(default_factory=lambda: SlidingRateEstimator(30.0))
    service: WindowedMoments = field(default_factory=WindowedMoments)
    load_reports: EwmaEstimator = field(default_factory=lambda: EwmaEstimator(alpha=0.5))

    @classmethod
    def from_spec(cls, spec) -> "EdgeHandle":
        """Build a handle from a declarative ``repro_torch.core.EdgeSpec`` — the
        spec's background tenants seed the handle's load/mixture estimates,
        which live telemetry then updates, and the own-stream variance is the
        one the tier's service model implies (matching ``analytic()``).

        Note the arrival-rate semantics differ from ``EdgeSpec.to_state()``
        by design: the gateway models the edge's *observed* load, so the own
        stream only enters the aggregate once requests are actually routed
        there (``arrivals`` estimator), whereas ``to_state()`` answers the
        declarative what-if with the own stream always included."""
        from repro_torch.core.multitenant import aggregate_streams
        from repro_torch.core.scenario import implied_service_var

        if spec.background:
            agg = aggregate_streams(spec.background)
            bg_rate, bg_mean, bg_var = agg.arrival_rate, agg.service_mean_s, agg.service_var
        else:
            # no declared tenants: seed the background TEMPLATE with the
            # edge's own service moments (the fleet bg_template convention),
            # so a later rate-only load report prices the load like this
            # workload instead of at zero service time. Inert until a report
            # arrives — state() ignores the template while the rate is 0.
            bg_rate = 0.0
            bg_mean = spec.tier.service_time_s
            bg_var = implied_service_var(spec.tier)
        return cls(
            name=spec.tier.name,
            service_mean_s=spec.tier.service_time_s,
            parallelism_k=spec.tier.parallelism_k,
            service_var_s=implied_service_var(spec.tier),
            background_rate=bg_rate,
            background_service_s=bg_mean,
            background_service_var=bg_var,
            bandwidth_Bps=spec.bandwidth_Bps,
        )

    def observe_load(
        self,
        background_rate: float,
        service_mean_s: float | None = None,
        service_var: float | None = None,
    ) -> None:
        """Edge load report (§4.2): EWMA the reported aggregate *other-tenant*
        rate into this handle's background estimate — the same lagged view the
        closed-loop cluster simulator's clients act on. The optional moments
        refresh the background mixture template when the edge reports what the
        load is made of; without them the current template holds, falling back
        to this workload's own service moments if the template is degenerate
        (a hand-built handle with no moments) — reported load must never be
        priced at zero service time."""
        if background_rate < 0:
            raise ValueError("background rate report must be non-negative")
        if service_mean_s is not None and service_mean_s <= 0:
            raise ValueError("background service mean report must be positive")
        if service_var is not None and service_var < 0:
            raise ValueError("background service variance report must be non-negative")
        self.background_rate = self.load_reports.update(float(background_rate))
        if service_mean_s is None and self.background_service_s <= 0.0:
            self.background_service_s = self.service_mean_s
            self.background_service_var = self.service_var_s
        if service_mean_s is not None:
            self.background_service_s = float(service_mean_s)
        if service_var is not None:
            self.background_service_var = float(service_var)

    def state(self, wl_service_mean: float | None = None) -> EdgeServerState:
        mine = wl_service_mean if wl_service_mean is not None else self.service_mean_s
        lam_bg = self.background_rate
        lam_own = self.arrivals.rate() if self.arrivals else 0.0
        lam_total = lam_bg + lam_own
        # aggregate mixture moments across tenants (paper §3.4)
        if lam_total > 0 and lam_bg > 0:
            w_bg = lam_bg / lam_total
            mean = w_bg * self.background_service_s + (1 - w_bg) * mine
            second = w_bg * (
                self.background_service_var + self.background_service_s**2
            ) + (1 - w_bg) * (self.service_var_s + mine**2)
            var = max(0.0, second - mean**2)
        else:
            mean, var = mine, self.service_var_s
        return EdgeServerState(
            name=self.name,
            service_rate=1.0 / max(mean, 1e-9),
            arrival_rate=lam_total,
            service_time_s=mine,
            service_var=var,
            parallelism_k=self.parallelism_k,
            bandwidth_Bps=self.bandwidth_Bps,
        )


class OffloadGateway:
    """Routes a request stream between on-device and edge execution."""

    def __init__(
        self,
        device_tier: Tier,
        edges: Sequence[EdgeHandle],
        wl: Workload,
        *,
        bandwidth_Bps: float,
        epoch_s: float = 1.0,
        hysteresis: float = 0.0,
        return_results: bool = True,
        deadline_timeout: Callable[[float], float] | None = None,
        auditor=None,
        tracer=None,
        metrics=None,
    ):
        self.device = device_tier
        self.edges = list(edges)
        self.wl = wl
        self.epoch_s = epoch_s
        # observability (repro_torch.obs, all duck-typed): the manager records the
        # decision audit + decide span; the gateway adds the modelled transfer
        # span and feeds the metrics registry
        self.tracer = tracer
        self.metrics = metrics
        self.manager = AdaptiveOffloadManager(
            device_tier, hysteresis=hysteresis, return_results=return_results,
            auditor=auditor, tracer=tracer, audit_source="gateway",
        )
        self.bandwidth = EwmaEstimator(alpha=0.5, initial=bandwidth_Bps)
        self.arrivals = SlidingRateEstimator(window_s=30.0)
        self.decisions: list[Decision] = []
        self.deadline_timeout = deadline_timeout
        self.redispatches = 0

    @classmethod
    def from_scenario(cls, scn, **kwargs) -> "OffloadGateway":
        """Build the deployable gateway from the same validated
        ``repro_torch.core.Scenario`` that drives ``analytic``/``simulate`` — no
        per-consumer re-assembly of tiers, handles, or bandwidths."""
        kwargs.setdefault("return_results", scn.return_results)
        return cls(
            scn.device,
            [EdgeHandle.from_spec(e) for e in scn.edges],
            scn.workload,
            bandwidth_Bps=float(np.asarray(scn.network.bandwidth_Bps)),
            **kwargs,
        )

    # -- telemetry inputs ---------------------------------------------------
    def observe_bandwidth(self, measured_Bps: float) -> None:
        self.bandwidth.update(measured_Bps)

    def observe_arrival(self, t: float) -> None:
        self.arrivals.record(t)

    # -- epoch decision (Algorithm 1) ----------------------------------------
    def decide(self, now: float) -> Decision:
        measured = self.arrivals.rate(now)
        lam = measured if measured > 0 else self.wl.arrival_rate
        # one decision path: the manager's step() hook builds the snapshot and
        # runs Algorithm 1 for both this gateway and repro_torch.fleet.replay
        d = self.manager.step(
            now,
            {
                "workload": self.wl,
                "lam_dev": lam,
                "bandwidth_Bps": self.bandwidth.value,
                "edges": [e.state() for e in self.edges],
            },
        )
        self.decisions.append(d)
        if self.tracer is not None and d.edge_index != ON_DEVICE:
            # the modelled transfer this decision commits the epoch's
            # requests to: request leg out now, response leg back after the
            # edge's service (mean-model stamps, same clock as the decision)
            edge = self.edges[d.edge_index]
            b = edge.bandwidth_Bps if edge.bandwidth_Bps is not None \
                else self.bandwidth.value
            if b > 0:
                track = f"edge[{d.edge_index}]"
                t_req = self.wl.req_bytes / b
                self.tracer.span(
                    t=now, dur=t_req, name="transfer:request", cat="transfer",
                    track=track, bytes=self.wl.req_bytes, bandwidth_Bps=b)
                if self.manager.return_results and self.wl.res_bytes > 0:
                    self.tracer.span(
                        t=now + t_req + edge.service_mean_s,
                        dur=self.wl.res_bytes / b, name="transfer:response",
                        cat="transfer", track=track, bytes=self.wl.res_bytes,
                        bandwidth_Bps=b)
        if self.metrics is not None:
            self.metrics.counter("gateway.decisions").inc()
            if d.edge_index != ON_DEVICE:
                self.metrics.counter("gateway.offloaded_epochs").inc()
            self.metrics.gauge("gateway.bandwidth_Bps").set(self.bandwidth.value)
            self.metrics.gauge("gateway.arrival_rate").set(lam)
            if np.isfinite(d.predicted_latency_s):
                self.metrics.histogram(
                    "gateway.predicted_latency_s").record(d.predicted_latency_s)
        return d

    # -- straggler mitigation -------------------------------------------------
    def check_deadline(self, predicted_s: float, elapsed_s: float) -> bool:
        """True -> re-dispatch: the request blew through its model-predicted
        deadline (default 5x predicted mean ~= an M/M/1 p99)."""
        timeout = (
            self.deadline_timeout(predicted_s)
            if self.deadline_timeout
            else 5.0 * predicted_s
        )
        if elapsed_s > timeout:
            self.redispatches += 1
            return True
        return False

    @property
    def switches(self) -> int:
        return self.manager.switches
