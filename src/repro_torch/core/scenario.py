"""Unified, validated `Scenario` spec — the single entry point to the repo.

The paper's pipeline is "describe an operating point -> predict with closed
forms -> validate with the simulator -> act with Algorithm 1". Before this
module, each of those consumers re-assembled the operating point its own way
(tuples into :mod:`latency`, closures into :mod:`crossover`, ``ServiceDist``
objects into :mod:`simulation`, hand-built ``EdgeServerState`` into
:mod:`manager`). A :class:`Scenario` is the one declarative description all
four consume:

    scn = Scenario(workload=..., device=..., network=..., edges=(...,))
    analytic(scn)            # closed-form LatencyBreakdown per strategy
    simulate(scn, seed=0)    # discrete-event validation of the same spec
    crossovers(scn, "bandwidth")   # quantitative crossover queries
    scn.manager().decide(scn.workload, scn.snapshot(), scn.edge_states())

Validation is eager and FastSim-style ("fail before running"): a bad spec
raises :class:`ScenarioError` naming the offending field at construction
time, not ``inf``/NaN half-way through a sweep. The existing low-level
functions remain the stable kernel layer underneath; nothing here re-derives
queueing math.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, fields, replace
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from . import simulation as S
from .crossover import (
    Crossover,
    arrival_rate_crossovers,
    bandwidth_crossover,
    smallest_true,
    solve_crossover,
)
from .latency import (
    LatencyBreakdown,
    NetworkPath,
    ServiceModel,
    Tier,
    Workload,
    edge_offload_latency,
    on_device_latency,
)
from .manager import AdaptiveOffloadManager, EdgeServerState
from .multitenant import AggregateLoad, TenantStream, aggregate_streams, multitenant_edge_latency
from .tail import (
    Station,
    mixture_station,
    offload_stations,
    proc_station,
    sojourn_quantile,
)
from .telemetry import TelemetrySnapshot

__all__ = [
    "ScenarioError",
    "EdgeSpec",
    "Scenario",
    "ClusterSpec",
    "ClientClass",
    "MeanFieldSpec",
    "ScenarioPrediction",
    "analytic",
    "analytic_tail",
    "tail_stations",
    "tier_station",
    "simulate",
    "crossovers",
    "implied_service_var",
    "parse_strategy",
]

# ServiceModel -> repro_torch.core.tail kind code (identical numbering to
# repro_torch.fleet.batch.MODEL_CODES, asserted in tests)
_TAIL_KINDS = {
    ServiceModel.DETERMINISTIC: 0,
    ServiceModel.EXPONENTIAL: 1,
    ServiceModel.GENERAL: 2,
}


def implied_service_var(tier: Tier) -> float:
    """Var[s] implied by the tier's queueing formulation.

    DETERMINISTIC service has zero variance, EXPONENTIAL has mean^2, GENERAL
    carries its explicit ``service_var``. Mixture math (multi-tenant
    aggregates, Algorithm-1 M/G/1 inputs) must use this — feeding ``0`` for
    an exponential tier would silently downgrade M/M/1 to M/D/1.
    """
    if tier.service_model is ServiceModel.EXPONENTIAL:
        return tier.service_time_s**2
    if tier.service_model is ServiceModel.GENERAL:
        return tier.service_var
    return 0.0


class ScenarioError(ValueError):
    """A scenario spec failed eager validation. ``field`` names the culprit."""

    def __init__(self, field_path: str, message: str):
        self.field = field_path
        super().__init__(f"{field_path}: {message}")


def _require(cond: bool, field_path: str, message: str) -> None:
    if not cond:
        raise ScenarioError(field_path, message)


def _coerce_model(value: Any, field_path: str) -> ServiceModel:
    if isinstance(value, ServiceModel):
        return value
    try:
        return ServiceModel(value)
    except ValueError:
        known = ", ".join(m.value for m in ServiceModel)
        raise ScenarioError(
            field_path, f"unknown service model {value!r} (known: {known})"
        ) from None


def _validate_tier(tier: Tier, field_path: str) -> Tier:
    _require(isinstance(tier, Tier), field_path, f"expected a Tier, got {type(tier).__name__}")
    _require(tier.service_time_s > 0, f"{field_path}.service_time_s",
             f"must be positive, got {tier.service_time_s!r}")
    _require(tier.parallelism_k > 0, f"{field_path}.parallelism_k",
             f"must be positive, got {tier.parallelism_k!r}")
    _require(tier.service_var >= 0, f"{field_path}.service_var",
             f"must be non-negative, got {tier.service_var!r}")
    model = _coerce_model(tier.service_model, f"{field_path}.service_model")
    return tier if model is tier.service_model else replace(tier, service_model=model)


# ---------------------------------------------------------------------------
# EdgeSpec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EdgeSpec:
    """One edge server: its tier plus the background tenants it already hosts.

    ``background`` are the *other* applications multiplexed onto this edge
    (paper §3.4); the scenario's own workload stream is added automatically
    wherever the aggregate matters. ``bandwidth_Bps`` overrides the
    scenario-level network path for this edge only (``0.0`` would be invalid,
    not "unset" — only ``None`` means "use the shared path").
    """

    tier: Tier
    background: tuple[TenantStream, ...] = ()
    bandwidth_Bps: float | None = None

    def __post_init__(self):
        if not isinstance(self.background, tuple):
            object.__setattr__(self, "background", tuple(self.background))

    @property
    def name(self) -> str:
        return self.tier.name

    def own_stream(self, wl: Workload) -> TenantStream:
        """The scenario workload's own stream as this edge would see it.

        Variance is the one the tier's service model implies (s^2 for
        EXPONENTIAL, 0 for DETERMINISTIC), so adding an epsilon-rate
        background tenant leaves the M/M/1 prediction continuous instead of
        discontinuously dropping to the M/D/1 form.
        """
        return TenantStream(
            arrival_rate=wl.arrival_rate,
            service_mean_s=self.tier.service_time_s,
            service_var=implied_service_var(self.tier),
            name=wl.name,
        )

    def aggregate(self, wl: Workload) -> AggregateLoad:
        """Mixture moments of background + the scenario's own stream."""
        return aggregate_streams((self.own_stream(wl),) + self.background)

    def to_state(self, wl: Workload) -> EdgeServerState:
        """The Algorithm-1 input (``EdgeServerState``) for this edge.

        Mirrors ``serving.gateway.EdgeHandle.state``: the aggregate arrival
        rate and mixture variance include the workload's own stream, while
        ``service_time_s`` stays the workload's own service time on this tier
        (Alg. 1 line 6 uses s_edge of THIS workload).
        """
        agg = self.aggregate(wl)
        return EdgeServerState(
            name=self.tier.name,
            service_rate=agg.service_rate,
            arrival_rate=agg.arrival_rate,
            service_time_s=self.tier.service_time_s,
            service_var=agg.service_var,
            parallelism_k=self.tier.parallelism_k,
            bandwidth_Bps=self.bandwidth_Bps,
        )


# ---------------------------------------------------------------------------
# Scenario
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Scenario:
    """A complete, validated operating point (device + edges + network + load).

    Frozen and eagerly validated: positivity of every rate/size, per-queue
    stability (device proc, device NIC, each edge's aggregate proc + NIC),
    and service-model sanity all fail at construction with the offending
    field named. Set ``allow_unstable=True`` for specs that deliberately
    cross stability boundaries (saturation studies, wide sweeps) — the
    closed forms then return ``inf`` there, exactly as the kernel layer does.
    """

    workload: Workload
    device: Tier
    network: NetworkPath
    edges: tuple[EdgeSpec, ...] = ()
    return_results: bool = True
    allow_unstable: bool = False
    name: str = "scenario"

    def __post_init__(self):
        if not isinstance(self.edges, tuple):
            object.__setattr__(self, "edges", tuple(self.edges))
        self._validate()

    # -- validation (FastSim-style: fail before running) ---------------------
    def _validate(self) -> None:
        wl, dev, net = self.workload, self.device, self.network
        _require(isinstance(wl, Workload), "workload",
                 f"expected a Workload, got {type(wl).__name__}")
        _require(wl.arrival_rate > 0, "workload.arrival_rate",
                 f"must be positive, got {wl.arrival_rate!r}")
        _require(wl.req_bytes > 0, "workload.req_bytes",
                 f"must be positive, got {wl.req_bytes!r}")
        _require(wl.res_bytes >= 0, "workload.res_bytes",
                 f"must be non-negative, got {wl.res_bytes!r}")
        _require(isinstance(net, NetworkPath), "network",
                 f"expected a NetworkPath, got {type(net).__name__}")
        _require(float(np.asarray(net.bandwidth_Bps)) > 0, "network.bandwidth_Bps",
                 f"must be positive, got {net.bandwidth_Bps!r}")

        coerced = _validate_tier(dev, "device")
        if coerced is not dev:
            object.__setattr__(self, "device", coerced)

        new_edges = []
        for i, e in enumerate(self.edges):
            path = f"edges[{i}]"
            _require(isinstance(e, EdgeSpec), path,
                     f"expected an EdgeSpec, got {type(e).__name__}")
            tier = _validate_tier(e.tier, f"{path}.tier")
            if e.bandwidth_Bps is not None:
                _require(e.bandwidth_Bps > 0, f"{path}.bandwidth_Bps",
                         f"must be positive (use None for 'unset'), got {e.bandwidth_Bps!r}")
            for j, t in enumerate(e.background):
                bpath = f"{path}.background[{j}]"
                _require(t.arrival_rate > 0, f"{bpath}.arrival_rate",
                         f"must be positive, got {t.arrival_rate!r}")
                _require(t.service_mean_s > 0, f"{bpath}.service_mean_s",
                         f"must be positive, got {t.service_mean_s!r}")
                _require(t.service_var >= 0, f"{bpath}.service_var",
                         f"must be non-negative, got {t.service_var!r}")
            new_edges.append(e if tier is e.tier else replace(e, tier=tier))
        if any(a is not b for a, b in zip(new_edges, self.edges)):
            object.__setattr__(self, "edges", tuple(new_edges))

        if not self.allow_unstable:
            self._validate_stability()

    def _validate_stability(self) -> None:
        wl, dev = self.workload, self.device
        lam = wl.arrival_rate
        kmu_dev = dev.parallelism_k / dev.service_time_s
        _require(lam < kmu_dev, "device",
                 f"unstable: arrival_rate {lam} >= k*mu {kmu_dev:.4g} "
                 "(set allow_unstable=True to permit)")
        for i, e in enumerate(self.edges):
            path = f"edges[{i}]"
            net = self.network_for(e)
            b = float(np.asarray(net.bandwidth_Bps))
            _require(lam < b / wl.req_bytes, f"{path}.bandwidth_Bps" if e.bandwidth_Bps
                     is not None else "network.bandwidth_Bps",
                     f"device NIC unstable: arrival_rate {lam} >= B/D_req "
                     f"{b / wl.req_bytes:.4g} (set allow_unstable=True to permit)")
            agg = e.aggregate(wl)
            kmu_e = e.tier.parallelism_k * agg.service_rate
            _require(agg.arrival_rate < kmu_e, path,
                     f"unstable: aggregate arrival_rate {agg.arrival_rate:.4g} >= "
                     f"k*mu {kmu_e:.4g} (set allow_unstable=True to permit)")
            if self.return_results and wl.res_bytes > 0:
                _require(agg.arrival_rate < b / wl.res_bytes, path,
                         f"edge NIC unstable: aggregate arrival_rate "
                         f"{agg.arrival_rate:.4g} >= B/D_res {b / wl.res_bytes:.4g} "
                         "(set allow_unstable=True to permit)")

    # -- serialisation --------------------------------------------------------
    def to_dict(self) -> dict:
        """Plain-JSON dict; ``from_dict(to_dict(scn)) == scn`` (``Tier.meta``
        is session-local and intentionally not serialised)."""

        def tier_d(t: Tier) -> dict:
            return {
                "name": t.name,
                "service_time_s": t.service_time_s,
                "parallelism_k": t.parallelism_k,
                "service_model": t.service_model.value,
                "service_var": t.service_var,
            }

        return {
            "name": self.name,
            "workload": {
                "arrival_rate": self.workload.arrival_rate,
                "req_bytes": self.workload.req_bytes,
                "res_bytes": self.workload.res_bytes,
                "name": self.workload.name,
            },
            "device": tier_d(self.device),
            "network": {"bandwidth_Bps": self.network.bandwidth_Bps},
            "edges": [
                {
                    "tier": tier_d(e.tier),
                    "background": [
                        {
                            "arrival_rate": t.arrival_rate,
                            "service_mean_s": t.service_mean_s,
                            "service_var": t.service_var,
                            "name": t.name,
                        }
                        for t in e.background
                    ],
                    "bandwidth_Bps": e.bandwidth_Bps,
                }
                for e in self.edges
            ],
            "return_results": self.return_results,
            "allow_unstable": self.allow_unstable,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "Scenario":
        """Inverse of :meth:`to_dict`. Missing required fields and unknown
        service-model strings raise :class:`ScenarioError` naming the field."""

        def get(m: Mapping, key: str, path: str):
            try:
                return m[key]
            except (KeyError, TypeError):
                raise ScenarioError(f"{path}.{key}" if path else key,
                                    "missing required field") from None

        def tier_f(td: Mapping, path: str) -> Tier:
            return Tier(
                name=td.get("name", "tier"),
                service_time_s=get(td, "service_time_s", path),
                parallelism_k=td.get("parallelism_k", 1.0),
                service_model=_coerce_model(td.get("service_model", "md1"),
                                            f"{path}.service_model"),
                service_var=td.get("service_var", 0.0),
            )

        wl_d = get(d, "workload", "")
        dev_d = get(d, "device", "")
        net_d = get(d, "network", "")
        return cls(
            workload=Workload(
                arrival_rate=get(wl_d, "arrival_rate", "workload"),
                req_bytes=get(wl_d, "req_bytes", "workload"),
                res_bytes=get(wl_d, "res_bytes", "workload"),
                name=wl_d.get("name", "workload"),
            ),
            device=tier_f(dev_d, "device"),
            network=NetworkPath(bandwidth_Bps=get(net_d, "bandwidth_Bps", "network")),
            edges=tuple(
                EdgeSpec(
                    tier=tier_f(get(ed, "tier", f"edges[{i}]"), f"edges[{i}].tier"),
                    background=tuple(
                        TenantStream(
                            arrival_rate=get(td, "arrival_rate",
                                             f"edges[{i}].background[{j}]"),
                            service_mean_s=get(td, "service_mean_s",
                                               f"edges[{i}].background[{j}]"),
                            service_var=td.get("service_var", 0.0),
                            name=td.get("name", "tenant"),
                        )
                        for j, td in enumerate(ed.get("background", []))
                    ),
                    bandwidth_Bps=ed.get("bandwidth_Bps"),
                )
                for i, ed in enumerate(d.get("edges", []))
            ),
            return_results=d.get("return_results", True),
            allow_unstable=d.get("allow_unstable", False),
            name=d.get("name", "scenario"),
        )

    # -- sweeps ---------------------------------------------------------------
    def replaced(self, field_path: str, value: Any) -> "Scenario":
        """A copy with the dotted/indexed ``field_path`` set to ``value``
        (e.g. ``"network.bandwidth_Bps"``, ``"edges[0].tier.service_time_s"``).
        Re-validates eagerly like any construction."""
        parts = _parse_path(field_path)
        return _set_path(self, parts, value, field_path)

    def sweep(self, field_path: str, values: Iterable) -> list["Scenario"]:
        """A family of scenarios varying one field — the vectorised form every
        figure-style experiment uses. ``values`` may be any iterable, including
        numpy arrays (elements are coerced to plain Python numbers so swept
        specs stay exactly JSON-round-trippable). Sweeps routinely cross
        stability boundaries on purpose, so swept copies carry
        ``allow_unstable=True`` and the closed forms report ``inf`` past
        saturation."""
        base = self if self.allow_unstable else replace(self, allow_unstable=True)
        return [base.replaced(field_path, _coerce_value(v)) for v in values]

    def grid(self, axes: Mapping[str, Iterable]) -> list["Scenario"]:
        """Cartesian multi-axis sweep: one scenario per combination of axis
        values, in C order (last axis fastest — matching
        ``np.meshgrid(..., indexing="ij")`` raveled, and therefore row ``i`` of
        ``repro_torch.fleet.ScenarioBatch.from_sweep(scn, axes)``). Like
        :meth:`sweep`, grid points carry ``allow_unstable=True``."""
        import itertools

        base = self if self.allow_unstable else replace(self, allow_unstable=True)
        paths = list(axes)
        value_lists = [[_coerce_value(v) for v in axes[p]] for p in paths]
        for p, vals in zip(paths, value_lists):
            _require(len(vals) > 0, p, "grid axis must have at least one value")
        out = []
        for combo in itertools.product(*value_lists):
            scn = base
            for p, v in zip(paths, combo):
                scn = scn.replaced(p, v)
            out.append(scn)
        return out

    # -- consumer constructors -------------------------------------------------
    def network_for(self, edge: EdgeSpec) -> NetworkPath:
        return (
            self.network
            if edge.bandwidth_Bps is None
            else NetworkPath(bandwidth_Bps=edge.bandwidth_Bps)
        )

    def edge_states(self) -> tuple[EdgeServerState, ...]:
        """Algorithm-1 inputs for every edge, derived from this one spec."""
        return tuple(e.to_state(self.workload) for e in self.edges)

    def snapshot(
        self,
        time_s: float = 0.0,
        *,
        bandwidth_Bps: float | None = None,
        arrival_rate: float | None = None,
    ) -> TelemetrySnapshot:
        """A telemetry snapshot of this operating point (overridable for
        replaying schedules like the paper's Fig. 6 bandwidth trace)."""
        return TelemetrySnapshot(
            time_s=time_s,
            lam_dev=self.workload.arrival_rate if arrival_rate is None else arrival_rate,
            bandwidth_Bps=float(np.asarray(
                self.network.bandwidth_Bps if bandwidth_Bps is None else bandwidth_Bps
            )),
        )

    def manager(self, **kwargs) -> AdaptiveOffloadManager:
        """An :class:`AdaptiveOffloadManager` for this scenario's device tier
        (``hysteresis=``/``tail_z=`` pass through; ``return_results``
        defaults to this scenario's setting so Algorithm 1 models the same
        network legs as :func:`analytic`)."""
        kwargs.setdefault("return_results", self.return_results)
        return AdaptiveOffloadManager(self.device, **kwargs)

    # -- method sugar for the module-level consumers ---------------------------
    def analytic(self) -> "ScenarioPrediction":
        return analytic(self)

    def analytic_tail(self, q: float, *, method: str = "euler") -> dict[str, float]:
        return analytic_tail(self, q, method=method)

    def simulate(self, strategy: str | None = None, **kwargs) -> S.SimResult:
        return simulate(self, strategy, **kwargs)

    def crossovers(self, axis: str, **kwargs) -> Crossover:
        return crossovers(self, axis, **kwargs)


# ---------------------------------------------------------------------------
# ClusterSpec: N clients sharing one edge pool (closed-loop §6 setting)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClusterSpec:
    """N clients contending for the ``base`` scenario's edge servers.

    ``base`` is the per-client template: its device tier, workload payloads,
    network path, and ``edges`` (the shared pool every client may offload to).
    ``arrival_scale`` optionally gives each client its own multiplier on the
    template arrival rate (empty = homogeneous fleet). The closed-loop
    semantics — each client's offload decision adds its stream to the chosen
    edge's aggregate, which every other client then observes — live in
    :mod:`repro_torch.fleet.cluster`; this spec is the validated, serialisable
    description they consume, exactly as :class:`Scenario` is for the
    open-loop paths.
    """

    base: Scenario
    n_clients: int
    arrival_scale: tuple[float, ...] = ()
    name: str = "cluster"

    def __post_init__(self):
        if not isinstance(self.arrival_scale, tuple):
            object.__setattr__(self, "arrival_scale", tuple(self.arrival_scale))
        _require(isinstance(self.base, Scenario), "base",
                 f"expected a Scenario, got {type(self.base).__name__}")
        _require(bool(self.base.edges), "base.edges",
                 "a cluster needs at least one shared edge server")
        _require(
            isinstance(self.n_clients, (int, np.integer))
            and not isinstance(self.n_clients, bool)
            and self.n_clients >= 1,
            "n_clients", f"must be a positive integer, got {self.n_clients!r}")
        if self.arrival_scale:
            _require(len(self.arrival_scale) == self.n_clients, "arrival_scale",
                     f"length {len(self.arrival_scale)} != n_clients {self.n_clients}")
            for i, s in enumerate(self.arrival_scale):
                _require(bool(np.isfinite(s)) and s > 0, f"arrival_scale[{i}]",
                         f"must be positive and finite, got {s!r}")

    @property
    def n_edges(self) -> int:
        return len(self.base.edges)

    def arrival_rates(self) -> np.ndarray:
        """(N,) per-client true arrival rates (template rate x scale)."""
        scale = np.asarray(self.arrival_scale, dtype=np.float64) \
            if self.arrival_scale else np.ones(self.n_clients)
        return self.base.workload.arrival_rate * scale

    def client(self, i: int) -> Scenario:
        """Client ``i``'s open-loop view (its own arrival rate, the shared
        edge pool, no other clients). Carries ``allow_unstable=True`` — the
        whole point of the closed loop is that the pool can saturate when
        everyone piles onto one edge, and the closed forms report that as
        ``inf`` rather than refusing the spec."""
        if not 0 <= i < self.n_clients:
            raise ScenarioError("n_clients", f"client index {i} out of range "
                                f"(n_clients {self.n_clients})")
        scn = self.base if self.base.allow_unstable else \
            replace(self.base, allow_unstable=True)
        lam = float(self.arrival_rates()[i])
        if lam != scn.workload.arrival_rate:
            scn = scn.replaced("workload.arrival_rate", lam)
        return scn

    def to_dict(self) -> dict:
        """Plain-JSON dict; ``from_dict(to_dict(spec)) == spec``."""
        return {
            "name": self.name,
            "base": self.base.to_dict(),
            "n_clients": int(self.n_clients),
            "arrival_scale": list(self.arrival_scale),
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ClusterSpec":
        try:
            base = d["base"]
            n_clients = d["n_clients"]
        except (KeyError, TypeError):
            missing = "base" if not isinstance(d, Mapping) or "base" not in d \
                else "n_clients"
            raise ScenarioError(missing, "missing required field") from None
        return cls(
            base=Scenario.from_dict(base),
            n_clients=int(n_clients),
            arrival_scale=tuple(float(s) for s in d.get("arrival_scale", [])),
            name=d.get("name", "cluster"),
        )


# ---------------------------------------------------------------------------
# ClientClass / MeanFieldSpec: client-*class* aggregation for mean-field scale
# ---------------------------------------------------------------------------


def _tier_to_dict(t: Tier) -> dict:
    return {
        "name": t.name,
        "service_time_s": t.service_time_s,
        "parallelism_k": t.parallelism_k,
        "service_model": t.service_model.value,
        "service_var": t.service_var,
    }


def _tier_from_dict(td: Mapping, path: str) -> Tier:
    try:
        s = td["service_time_s"]
    except (KeyError, TypeError):
        raise ScenarioError(f"{path}.service_time_s", "missing required field") \
            from None
    return Tier(
        name=td.get("name", "tier"),
        service_time_s=s,
        parallelism_k=td.get("parallelism_k", 1.0),
        service_model=_coerce_model(td.get("service_model", "md1"),
                                    f"{path}.service_model"),
        service_var=td.get("service_var", 0.0),
    )


@dataclass(frozen=True)
class ClientClass:
    """One homogeneous cohort of a mean-field fleet.

    A class is a (device tier, arrival-rate band, bandwidth-trace band)
    bucket: ``n_clients`` statistically identical clients whose arrival rate
    is ``arrival_scale`` x the base workload rate, whose shared-path
    bandwidth is ``bandwidth_scale`` x the base network path (the
    "bandwidth-trace class" — well-connected vs cellular cohorts), and whose
    device tier is ``device`` (``None`` = the base scenario's device). The
    mean-field layer evolves one offload-fraction row per class instead of
    one decision per client, which is what takes the closed loop from tens
    of clients to millions.
    """

    n_clients: int
    arrival_scale: float = 1.0
    bandwidth_scale: float = 1.0
    device: Tier | None = None
    name: str = "class"

    def __post_init__(self):
        _require(
            isinstance(self.n_clients, (int, np.integer))
            and not isinstance(self.n_clients, bool)
            and self.n_clients >= 1,
            "n_clients", f"must be a positive integer, got {self.n_clients!r}")
        for field_name in ("arrival_scale", "bandwidth_scale"):
            v = getattr(self, field_name)
            _require(bool(np.isfinite(v)) and v > 0, field_name,
                     f"must be positive and finite, got {v!r}")
        if self.device is not None:
            coerced = _validate_tier(self.device, "device")
            if coerced is not self.device:
                object.__setattr__(self, "device", coerced)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "n_clients": int(self.n_clients),
            "arrival_scale": float(self.arrival_scale),
            "bandwidth_scale": float(self.bandwidth_scale),
            "device": None if self.device is None else _tier_to_dict(self.device),
        }

    @classmethod
    def from_dict(cls, d: Mapping, path: str = "classes[?]") -> "ClientClass":
        try:
            n = d["n_clients"]
        except (KeyError, TypeError):
            raise ScenarioError(f"{path}.n_clients", "missing required field") \
                from None
        dev = d.get("device")
        return cls(
            n_clients=int(n),
            arrival_scale=float(d.get("arrival_scale", 1.0)),
            bandwidth_scale=float(d.get("bandwidth_scale", 1.0)),
            device=None if dev is None else _tier_from_dict(dev, f"{path}.device"),
            name=d.get("name", "class"),
        )


@dataclass(frozen=True)
class MeanFieldSpec:
    """A fleet described by client *classes* instead of individual clients.

    ``base`` is the shared template exactly as in :class:`ClusterSpec` (its
    ``edges`` are the shared pool every class may offload to); ``classes``
    partition the fleet into homogeneous cohorts. The mean-field semantics —
    per-class offload fractions whose rate-weighted sum is the endogenous
    edge load — live in :mod:`repro_torch.fleet.meanfield`; this spec is the
    validated, serialisable description they consume.

    For small fleets the spec expands to the exact per-client
    :class:`ClusterSpec` via :meth:`to_cluster`, which is what the
    mean-field-vs-exact validation gate runs on.
    """

    base: Scenario
    classes: tuple[ClientClass, ...] = ()
    name: str = "meanfield"

    def __post_init__(self):
        if not isinstance(self.classes, tuple):
            object.__setattr__(self, "classes", tuple(self.classes))
        _require(isinstance(self.base, Scenario), "base",
                 f"expected a Scenario, got {type(self.base).__name__}")
        _require(bool(self.base.edges), "base.edges",
                 "a mean-field fleet needs at least one shared edge server")
        _require(bool(self.classes), "classes",
                 "a mean-field fleet needs at least one client class")
        for i, c in enumerate(self.classes):
            _require(isinstance(c, ClientClass), f"classes[{i}]",
                     f"expected a ClientClass, got {type(c).__name__}")

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    @property
    def n_edges(self) -> int:
        return len(self.base.edges)

    @property
    def n_total(self) -> int:
        """Total clients across all classes (the fleet the fractions model)."""
        return int(sum(c.n_clients for c in self.classes))

    def class_counts(self) -> np.ndarray:
        """(C,) clients per class."""
        return np.array([c.n_clients for c in self.classes], dtype=np.float64)

    def arrival_rates(self) -> np.ndarray:
        """(C,) per-client true arrival rate of each class."""
        return self.base.workload.arrival_rate * np.array(
            [c.arrival_scale for c in self.classes], dtype=np.float64)

    def bandwidth_Bps(self, base_Bps: float | None = None) -> np.ndarray:
        """(C,) per-client shared-path bandwidth of each class — the base
        network path (or an override, e.g. one epoch of a trace) times each
        class's ``bandwidth_scale``."""
        b = float(np.asarray(self.base.network.bandwidth_Bps)) \
            if base_Bps is None else float(base_Bps)
        return b * np.array(
            [c.bandwidth_scale for c in self.classes], dtype=np.float64)

    def device_tier(self, c: int) -> Tier:
        """Class ``c``'s device tier (its override, or the base device)."""
        cl = self.classes[c]
        return self.base.device if cl.device is None else cl.device

    def class_index(self) -> np.ndarray:
        """(n_total,) expanded client -> class map, class-major order —
        matches :meth:`to_cluster`'s client ordering."""
        return np.repeat(np.arange(self.n_classes),
                         [c.n_clients for c in self.classes])

    def to_cluster(self) -> ClusterSpec:
        """The exact per-client :class:`ClusterSpec` this spec aggregates.

        Clients are laid out class-major (all of class 0, then class 1, ...,
        matching :meth:`class_index`). Per-class ``bandwidth_scale`` expands
        through :meth:`bandwidth_Bps` as a per-client array override to
        ``solve_equilibrium``; per-class ``device`` overrides cannot be
        expressed in a single-device-tier :class:`ClusterSpec` and are
        refused loudly rather than silently dropped.
        """
        for i, c in enumerate(self.classes):
            _require(c.device is None or c.device == self.base.device,
                     f"classes[{i}].device",
                     "per-class device tiers have no exact ClusterSpec "
                     "equivalent (the exact solver models one shared device "
                     "tier); compare such specs analytically instead")
        scale = np.repeat([c.arrival_scale for c in self.classes],
                          [c.n_clients for c in self.classes])
        return ClusterSpec(
            base=self.base,
            n_clients=self.n_total,
            arrival_scale=tuple(float(s) for s in scale),
            name=f"{self.name}-exact",
        )

    def to_dict(self) -> dict:
        """Plain-JSON dict; ``from_dict(to_dict(spec)) == spec``."""
        return {
            "name": self.name,
            "base": self.base.to_dict(),
            "classes": [c.to_dict() for c in self.classes],
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "MeanFieldSpec":
        try:
            base = d["base"]
            classes = d["classes"]
        except (KeyError, TypeError):
            missing = "base" if not isinstance(d, Mapping) or "base" not in d \
                else "classes"
            raise ScenarioError(missing, "missing required field") from None
        return cls(
            base=Scenario.from_dict(base),
            classes=tuple(ClientClass.from_dict(cd, f"classes[{i}]")
                          for i, cd in enumerate(classes)),
            name=d.get("name", "meanfield"),
        )


# ---------------------------------------------------------------------------
# field-path parsing for replaced()/sweep()
# ---------------------------------------------------------------------------

_PATH_TOKEN = re.compile(r"([A-Za-z_][A-Za-z_0-9]*)((?:\[\d+\])*)$")


def _coerce_value(v: Any) -> Any:
    """numpy scalars -> plain Python numbers (keeps to_dict JSON-clean)."""
    return v.item() if isinstance(v, np.generic) else v


def _parse_path(field_path: str) -> list:
    parts: list = []
    for token in field_path.split("."):
        m = _PATH_TOKEN.match(token)
        if not m:
            raise ScenarioError(field_path, f"malformed field path segment {token!r}")
        parts.append(m.group(1))
        for idx in re.findall(r"\[(\d+)\]", m.group(2)):
            parts.append(int(idx))
    return parts


def _set_path(obj: Any, parts: Sequence, value: Any, full_path: str) -> Any:
    if not parts:
        return value
    head, rest = parts[0], parts[1:]
    if isinstance(head, int):
        seq = list(obj)
        if not 0 <= head < len(seq):
            raise ScenarioError(full_path, f"index {head} out of range (len {len(seq)})")
        seq[head] = _set_path(seq[head], rest, value, full_path)
        return tuple(seq)
    if not hasattr(obj, head) or head not in {f.name for f in fields(obj)}:
        raise ScenarioError(full_path, f"{type(obj).__name__} has no field {head!r}")
    return replace(obj, **{head: _set_path(getattr(obj, head), rest, value, full_path)})


# ---------------------------------------------------------------------------
# analytic(scn): closed-form prediction per strategy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScenarioPrediction:
    """Closed-form :class:`LatencyBreakdown` per strategy of one scenario.

    Keys are ``"on_device"`` and ``"edge[i]"`` (matching
    ``Decision.target_name``); ``best_strategy`` is the analytic argmin.
    """

    breakdowns: dict[str, LatencyBreakdown]

    def __getitem__(self, strategy: str) -> LatencyBreakdown:
        return self.breakdowns[strategy]

    def __iter__(self):
        return iter(self.breakdowns)

    def items(self):
        return self.breakdowns.items()

    def totals(self) -> dict[str, float]:
        return {k: float(np.asarray(b.total)) for k, b in self.breakdowns.items()}

    @property
    def best_strategy(self) -> str:
        totals = self.totals()
        return min(totals, key=totals.get)

    @property
    def best(self) -> LatencyBreakdown:
        return self.breakdowns[self.best_strategy]


def analytic(scn: Scenario) -> ScenarioPrediction:
    """Paper Eq. 1/2 (+ Lemma 3.2 multi-tenant form) for every strategy.

    Wraps the kernel layer exactly: ``on_device_latency`` for the device,
    ``edge_offload_latency`` for a dedicated edge, and
    ``multitenant_edge_latency`` when the edge hosts background tenants.
    """
    out: dict[str, LatencyBreakdown] = {
        "on_device": on_device_latency(scn.workload, scn.device, breakdown=True)
    }
    for i, e in enumerate(scn.edges):
        net = scn.network_for(e)
        if e.background:
            b = multitenant_edge_latency(
                scn.workload, e.tier, net,
                (e.own_stream(scn.workload),) + e.background,
                return_results=scn.return_results, breakdown=True,
            )
        else:
            b = edge_offload_latency(
                scn.workload, e.tier, net,
                return_results=scn.return_results, breakdown=True,
            )
        out[f"edge[{i}]"] = b
    return ScenarioPrediction(out)


# ---------------------------------------------------------------------------
# analytic_tail(scn, q): closed-form sojourn quantiles per strategy
# ---------------------------------------------------------------------------


def tier_station(tier: Tier, lam: float) -> Station:
    """A :mod:`repro_torch.core.tail` processing station for ``tier`` under arrival
    rate ``lam`` — the service-model dispatch (M/D/1 / M/M/1 / M/G/1 on the
    paper's k*mu aggregation) in distributional form."""
    return proc_station(lam, _TAIL_KINDS[tier.service_model],
                        tier.service_time_s, tier.service_var, tier.parallelism_k)


def tail_stations(scn: Scenario, strategy: str | None = None) -> tuple[Station, ...]:
    """The Fig. 1 tandem of ``strategy``'s path as :mod:`repro_torch.core.tail`
    stations: on-device is the single processing queue; ``edge[j]`` is device
    NIC -> edge proc (own model, or the §3.4 gamma-matched mixture when the
    edge hosts background tenants) -> return NIC. The mean of the composed
    distribution equals :func:`analytic`'s total on the same path, so tails
    and means can never disagree about the operating point."""
    strategy, j = _resolve_strategy(scn, strategy)
    wl = scn.workload
    if j < 0:
        return (tier_station(scn.device, wl.arrival_rate),)
    e = scn.edges[j]
    b = float(np.asarray(scn.network_for(e).bandwidth_Bps))
    if e.background:
        agg = e.aggregate(wl)
        proc = mixture_station(agg.arrival_rate, agg.service_mean_s,
                               agg.service_var, e.tier.parallelism_k)
    else:
        proc = tier_station(e.tier, wl.arrival_rate)
    return offload_stations(wl.arrival_rate, wl.req_bytes, wl.res_bytes, b,
                            proc, return_results=scn.return_results)


def analytic_tail(scn: Scenario, q: float, *, method: str = "euler") -> dict[str, float]:
    """The q-quantile (q in (0, 1)) of the end-to-end latency distribution
    per strategy — keys match :meth:`ScenarioPrediction.totals`.

    ``method="euler"`` inverts the Pollaczek-Khinchine transform numerically
    (accuracy-first default); ``method="asymptote"`` uses the cheap
    dominant-singularity exponential tail that the jitted fleet/cluster paths
    vectorise. Unstable strategies report ``inf``, like the mean forms.
    """
    out = {"on_device": sojourn_quantile(tail_stations(scn, "on_device"), q,
                                         method=method)}
    for i in range(len(scn.edges)):
        out[f"edge[{i}]"] = sojourn_quantile(tail_stations(scn, f"edge[{i}]"), q,
                                             method=method)
    return out


# ---------------------------------------------------------------------------
# simulate(scn): the same spec through the discrete-event testbed
# ---------------------------------------------------------------------------


def _service_dist(tier: Tier) -> S.ServiceDist:
    if tier.service_model is ServiceModel.DETERMINISTIC:
        return S.Deterministic(tier.service_time_s)
    if tier.service_model is ServiceModel.EXPONENTIAL:
        return S.Exponential(tier.service_time_s)
    return S.LogNormal(tier.service_time_s, tier.service_var)


def _tenant_dist(t: TenantStream) -> S.ServiceDist:
    return (
        S.Deterministic(t.service_mean_s)
        if t.service_var == 0
        else S.LogNormal(t.service_mean_s, t.service_var)
    )


def parse_strategy(strategy: str, n_edges: int | None = None) -> int:
    """THE parser for strategy labels: -1 for ``"on_device"``, j for
    ``"edge[j]"`` (range-checked when ``n_edges`` is given). Every consumer
    of ``Decision.target_name``-style labels — the scalar simulator, the
    validation corpus/differential harness — goes through here, so a
    malformed label always fails the same way: a ScenarioError naming the
    ``strategy`` field."""
    if strategy == "on_device":
        return -1
    m = re.fullmatch(r"edge\[(\d+)\]", strategy) if isinstance(strategy, str) else None
    if m is not None:
        j = int(m.group(1))
        if n_edges is None or j < n_edges:
            return j
    known = ["on_device"] + (
        ["edge[j]"] if n_edges is None else [f"edge[{i}]" for i in range(n_edges)])
    raise ScenarioError("strategy", f"unknown strategy {strategy!r} (known: {known})")


def _resolve_strategy(scn: Scenario, strategy: str | None) -> tuple[str, int]:
    if strategy is None:
        strategy = "edge[0]" if scn.edges else "on_device"
    return strategy, parse_strategy(strategy, len(scn.edges))


def _integer_k(tier: Tier, field_path: str) -> int:
    """The simulator runs k discrete servers; the closed forms fold k into
    k*mu and allow fractional k (§3.5). Refuse to silently simulate a
    different system than the one being predicted."""
    k = tier.parallelism_k
    if round(k) != k:
        raise ScenarioError(
            f"{field_path}.parallelism_k",
            f"fractional parallelism {k!r} cannot be simulated exactly "
            "(discrete servers); round it or compare via analytic() only",
        )
    return max(1, int(k))


def simulate(
    scn: Scenario,
    strategy: str | None = None,
    *,
    seed: int = 0,
    n: int = 100_000,
) -> S.SimResult:
    """Discrete-event simulation of ``scn`` under ``strategy``.

    Derives the right ``ServiceDist`` from each tier's ``ServiceModel``
    (deterministic / exponential / lognormal-general) and the right network
    stages from the spec, so prediction and validation can never drift apart
    on inputs (fractional ``parallelism_k`` is refused rather than silently
    rounded). ``strategy`` defaults to ``"edge[0]"`` when edges exist, else
    ``"on_device"``; multi-tenant edges use the shared-station simulator with
    the scenario's own stream observed.
    """
    strategy, idx = _resolve_strategy(scn, strategy)
    wl = scn.workload
    if strategy == "on_device":
        return S.simulate_on_device(
            wl.arrival_rate,
            _service_dist(scn.device),
            k=_integer_k(scn.device, "device"),
            n=n,
            seed=seed,
        )
    e = scn.edges[idx]
    net = scn.network_for(e)
    b = float(np.asarray(net.bandwidth_Bps))
    k_edge = _integer_k(e.tier, f"edges[{idx}].tier")
    if not e.background:
        return S.simulate_offload(
            wl.arrival_rate,
            _service_dist(e.tier),
            k_edge,
            bandwidth_Bps=b,
            req_bytes=wl.req_bytes,
            res_bytes=wl.res_bytes if scn.return_results else 0.0,
            n=n,
            seed=seed,
        )
    streams = [(wl.arrival_rate, _service_dist(e.tier))] + [
        (t.arrival_rate, _tenant_dist(t)) for t in e.background
    ]
    # rate-proportional counts -> every stream spans the same time horizon,
    # so the observed stream never sees a partially-drained edge
    lam_total = sum(rate for rate, _ in streams)
    horizon = max(n, 2_000 * len(streams)) / lam_total
    counts = [max(1, int(round(rate * horizon))) for rate, _ in streams]
    return S.simulate_multitenant_offload(
        streams,
        k_edge,
        bandwidth_Bps=b,
        req_bytes=wl.req_bytes,
        res_bytes=wl.res_bytes if scn.return_results else 0.0,
        observe_stream=0,
        n_per_stream=counts,
        seed=seed,
    )


# ---------------------------------------------------------------------------
# crossovers(scn, axis): quantitative crossover queries
# ---------------------------------------------------------------------------


def crossovers(
    scn: Scenario,
    axis: str,
    *,
    edge: int = 0,
    quantile: float | None = None,
    tail_method: str = "euler",
    **kwargs,
) -> Crossover:
    """Where does the preferred strategy flip along ``axis``?

    ``axis``: ``"bandwidth"`` (Fig. 4), ``"arrival_rate"`` (Fig. 5b; first
    crossover — they need not be unique), or ``"tenancy"`` (Fig. 5c; value is
    the smallest tenant count m at which on-device wins). Replaces the
    hand-rolled closures callers used to feed :mod:`crossover` — the solvers
    there stay the kernel layer. Edges with background tenants are compared
    via the multi-tenant (M/G/1) latency, so the answer always agrees with
    ``analytic`` on the same spec.

    ``quantile`` switches the comparison from expected latencies to the
    q-quantile of the full sojourn distributions (:mod:`repro_torch.core.tail`) —
    the SLO view. Percentile crossovers are a result class the paper's mean
    forms cannot express: because offload paths stack three queues, their
    tails are heavier than the single on-device queue's, so p99 crossovers
    systematically shift toward on-device relative to mean crossovers.
    """
    _require(bool(scn.edges), "edges", "crossover queries need at least one edge")
    _require(0 <= edge < len(scn.edges), "edges", f"edge index {edge} out of range")
    e = scn.edges[edge]
    wl, dev = scn.workload, scn.device

    def multitenant_diff(wl_at: Workload, net: NetworkPath) -> float:
        streams = (e.own_stream(wl_at),) + e.background
        te = float(np.asarray(multitenant_edge_latency(
            wl_at, e.tier, net, streams, return_results=scn.return_results)))
        return te - float(np.asarray(on_device_latency(wl_at, dev)))

    def first_on_device_wins(te_of_m, td: float, template: TenantStream,
                             max_tenants: int) -> int | None:
        """Smallest m (own stream + (m-1) template copies) with te(m) > td.

        Homogeneous templates — service moments equal to the own stream's,
        the paper's §4.8 setup and the default — make te(m) monotone in m
        (fixed mixture moments, growing load), so the search is
        ``smallest_true``'s exponential bracket + integer bisection. A
        heterogeneous template can dip first (the mixture mean shifts toward
        the template), so it keeps the exhaustive first-hit scan.
        """
        own = e.own_stream(wl)
        homogeneous = (template.service_mean_s == own.service_mean_s
                       and template.service_var == own.service_var)
        if homogeneous:
            return smallest_true(lambda m: te_of_m(m) > td, max_tenants)
        for m in range(1, max_tenants + 1):
            if te_of_m(m) > td:
                return m
        return None

    def dev_tail(wl_at: Workload) -> float:
        return sojourn_quantile((tier_station(dev, wl_at.arrival_rate),),
                                quantile, method=tail_method)

    def edge_tail(wl_at: Workload, b: float) -> float:
        """T_edge_q at the given operating point — the same stations
        ``tail_stations`` composes, with workload/bandwidth swapped in
        (bandwidth sweeps override any per-edge path, exactly like the mean
        solvers)."""
        if e.background:
            agg = aggregate_streams((e.own_stream(wl_at),) + e.background)
            proc = mixture_station(agg.arrival_rate, agg.service_mean_s,
                                   agg.service_var, e.tier.parallelism_k)
        else:
            proc = tier_station(e.tier, wl_at.arrival_rate)
        return sojourn_quantile(
            offload_stations(wl_at.arrival_rate, wl_at.req_bytes,
                             wl_at.res_bytes, b, proc,
                             return_results=scn.return_results),
            quantile, method=tail_method)

    if quantile is not None:
        net = scn.network_for(e)
        b0 = float(np.asarray(net.bandwidth_Bps))
        if axis == "bandwidth":
            lo = kwargs.pop("lo_Bps", 1e4)
            hi = kwargs.pop("hi_Bps", 1e9)
            td_fixed = dev_tail(wl)  # bandwidth-independent: one inversion

            def diff_b(b: float) -> float:
                return edge_tail(wl, b) - td_fixed

            return solve_crossover(diff_b, lo, hi, **kwargs)
        if axis == "arrival_rate":
            lo = kwargs.pop("lo", 0.01)
            caps = [dev.parallelism_k / dev.service_time_s, b0 / wl.req_bytes]
            if not e.background:
                caps.append(e.tier.parallelism_k / e.tier.service_time_s)
                if scn.return_results and wl.res_bytes > 0:
                    caps.append(b0 / wl.res_bytes)
            hi = kwargs.pop("hi", None) or 0.999 * min(caps)
            if hi <= lo:
                return Crossover(None, None, lo, hi)

            def diff_lam(lam: float) -> float:
                wl_at = replace(wl, arrival_rate=lam)
                return edge_tail(wl_at, b0) - dev_tail(wl_at)

            return solve_crossover(diff_lam, lo, hi, **kwargs)
        if axis == "tenancy":
            max_tenants = kwargs.pop("max_tenants", 1024)
            template = kwargs.pop("tenant_template", None) or (
                e.background[0] if e.background else e.own_stream(wl)
            )
            if kwargs:
                raise TypeError(
                    f"unexpected keyword arguments for tenancy axis: {sorted(kwargs)}"
                )
            td = sojourn_quantile(tail_stations(scn, "on_device"), quantile,
                                  method=tail_method)

            def te_quantile(m: int) -> float:
                agg = aggregate_streams(
                    (e.own_stream(wl),) + (template,) * (m - 1))
                proc = mixture_station(agg.arrival_rate, agg.service_mean_s,
                                       agg.service_var, e.tier.parallelism_k)
                return sojourn_quantile(
                    offload_stations(wl.arrival_rate, wl.req_bytes,
                                     wl.res_bytes, b0, proc,
                                     return_results=scn.return_results),
                    quantile, method=tail_method)

            m_star = first_on_device_wins(te_quantile, td, template, max_tenants)
            return Crossover(
                value=None if m_star is None else float(m_star),
                offload_wins_above=None if m_star is None else False,
                lo=1.0, hi=float(max_tenants),
            )
        raise ScenarioError(
            "axis", f"unknown axis {axis!r} (known: bandwidth, arrival_rate, tenancy)"
        )

    if axis == "bandwidth":
        if e.background:
            lo = kwargs.pop("lo_Bps", 1e4)
            hi = kwargs.pop("hi_Bps", 1e9)
            return solve_crossover(
                lambda b: multitenant_diff(wl, NetworkPath(b)), lo, hi, **kwargs
            )
        return bandwidth_crossover(
            wl, dev, e.tier, return_results=scn.return_results, **kwargs
        )
    if axis == "arrival_rate":
        if e.background:
            net = scn.network_for(e)
            b = float(np.asarray(net.bandwidth_Bps))
            lo = kwargs.pop("lo", 0.01)
            # stay inside the device/NIC stability region; edge saturation
            # shows up as inf and is filtered by the solver's finite scan
            caps = [dev.parallelism_k / dev.service_time_s, b / wl.req_bytes]
            hi = kwargs.pop("hi", None) or 0.999 * min(caps)
            if hi <= lo:
                return Crossover(None, None, lo, hi)
            return solve_crossover(
                lambda lam: multitenant_diff(replace(wl, arrival_rate=lam), net),
                lo, hi, **kwargs,
            )
        xs = arrival_rate_crossovers(
            wl, dev, e.tier, scn.network_for(e),
            return_results=scn.return_results, **kwargs
        )
        return xs[0] if xs else Crossover(None, None, 0.0, 0.0)
    if axis == "tenancy":
        max_tenants = kwargs.pop("max_tenants", 1024)
        template = kwargs.pop("tenant_template", None) or (
            e.background[0] if e.background else e.own_stream(wl)
        )
        if kwargs:
            raise TypeError(
                f"unexpected keyword arguments for tenancy axis: {sorted(kwargs)}"
            )
        # m counts ALL tenants on the edge including the scenario's own
        # stream: T_edge(m) = own + (m-1) template copies. In the paper's
        # homogeneous setup (no background, template == own stream) this is
        # exactly tenancy_crossover's [template]*m; unlike that kernel form
        # it never drops the own stream when a template is supplied, so the
        # answer agrees with analytic() on the corresponding spec.
        net = scn.network_for(e)
        td = float(np.asarray(on_device_latency(wl, dev)))

        def te_mean(m: int) -> float:
            streams = (e.own_stream(wl),) + (template,) * (m - 1)
            return float(np.asarray(multitenant_edge_latency(
                wl, e.tier, net, streams, return_results=scn.return_results)))

        m_star = first_on_device_wins(te_mean, td, template, max_tenants)
        return Crossover(
            value=None if m_star is None else float(m_star),
            offload_wins_above=None if m_star is None else False,
            lo=1.0,
            hi=float(max_tenants),
        )
    raise ScenarioError(
        "axis", f"unknown axis {axis!r} (known: bandwidth, arrival_rate, tenancy)"
    )
