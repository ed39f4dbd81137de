"""End-to-end latency models for on-device processing and edge offloading.

Transcribes the paper's Eq. (1)/(2) decompositions and Lemmas 3.1-3.3.
All functions are numpy-broadcasting: pass scalars for a single prediction or
arrays (e.g. a bandwidth sweep) and every term broadcasts. Unstable operating
points yield ``inf`` (the adaptive manager treats them as never-preferable).

Units: seconds, bytes, bytes/second, requests/second.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np

__all__ = [
    "ServiceModel",
    "Tier",
    "Workload",
    "NetworkPath",
    "mm1_wait",
    "md1_wait",
    "mg1_wait",
    "proc_wait",
    "on_device_latency",
    "edge_offload_latency",
    "lemma31_rhs",
    "lemma33_rhs",
    "lemma32_rhs",
    "offload_wins",
    "LatencyBreakdown",
]

_INF = np.inf


def _stable_where(lam, effective_mu, value):
    """inf wherever the queue is unstable (lam >= effective_mu)."""
    lam = np.asarray(lam, dtype=np.float64)
    effective_mu = np.asarray(effective_mu, dtype=np.float64)
    ok = (lam < effective_mu) & (effective_mu > 0) & (lam >= 0)
    return np.where(ok, value, _INF)


def mm1_wait(lam, mu):
    """Paper Eq. 7 — numpy-broadcasting variant of queueing.mm1_wait."""
    lam = np.asarray(lam, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = 1.0 / (mu - lam) - 1.0 / mu
    return _stable_where(lam, mu, w)


def md1_wait(lam, mu, k=1.0):
    """Paper Eq. 6 — M/D/k via aggregated-rate M/D/1: 1/2(1/(k mu - lam) - 1/(k mu))."""
    lam = np.asarray(lam, dtype=np.float64)
    kmu = np.asarray(mu, dtype=np.float64) * np.asarray(k, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = 0.5 * (1.0 / (kmu - lam) - 1.0 / kmu)
    return _stable_where(lam, kmu, w)


def mg1_wait(lam, mu, var_s, k=1.0):
    """Paper Eq. 11 — P-K M/G/1 wait with aggregated service rate k*mu.

    E[w] = (rho + lam * (k mu) * Var[s]) / (2 (k mu - lam)), rho = lam/(k mu).
    Matches the form used in Lemma 3.2's right-hand side.
    """
    lam = np.asarray(lam, dtype=np.float64)
    kmu = np.asarray(mu, dtype=np.float64) * np.asarray(k, dtype=np.float64)
    var_s = np.asarray(var_s, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = lam / kmu
        w = (rho + lam * kmu * var_s) / (2.0 * (kmu - lam))
    return _stable_where(lam, kmu, w)


class ServiceModel(str, enum.Enum):
    """Which queueing formulation models a tier's service (paper §3.3/§3.5)."""

    DETERMINISTIC = "md1"  # DNN inference: constant op count -> M/D/1 (Lemma 3.1)
    EXPONENTIAL = "mm1"  # RNN/LLM: length-dependent service -> M/M/1 (Lemma 3.3)
    GENERAL = "mg1"  # multi-tenant aggregate -> M/G/1 (Lemma 3.2)


@dataclass(frozen=True)
class Tier:
    """An accelerator tier (client device, edge pod, ...).

    ``service_time_s`` is the paper's s_dev / s_edge (mean). ``parallelism_k``
    is the paper's effective parallelism, folded into the service rate as k*mu
    (their M/D/k -> M/D/1 aggregation; k may be fractional, §3.5).
    """

    name: str
    service_time_s: float
    parallelism_k: float = 1.0
    service_model: ServiceModel = ServiceModel.DETERMINISTIC
    service_var: float = 0.0  # Var[s]; only read for ServiceModel.GENERAL
    meta: dict[str, Any] = field(default_factory=dict, compare=False)

    @property
    def service_rate(self) -> float:
        """mu = 1/s (paper: 'service rate is the inverse of service time')."""
        return 1.0 / self.service_time_s

    def with_service(self, service_time_s: float, service_var: float | None = None) -> "Tier":
        return replace(
            self,
            service_time_s=service_time_s,
            service_var=self.service_var if service_var is None else service_var,
        )

    @classmethod
    def from_measured(cls, profile, occupancy: int = 1, *,
                      name: str | None = None) -> "Tier":
        """Build a tier from a measured service-time profile.

        ``profile`` is duck-typed: anything exposing
        ``service_moments(occupancy) -> (mean_s, var_s, service_model)``
        works — canonically a ``repro_torch.measure.MeasuredProfile`` fitted from a
        real engine run. The measured request-level distribution at the given
        batch occupancy becomes the tier's two service moments, classified
        into the paper's taxonomy (M/D/1, M/M/1, or two-moment M/G/1), and
        ``occupancy`` becomes the effective parallelism k — ``occupancy``
        requests are in service concurrently, so the aggregate rate is
        k*mu exactly as in the paper's M/D/k -> M/D/1 folding (§3.5).

        The result is an ordinary :class:`Tier`: it flows through
        ``analytic()``, ``analytic_tail()``, ``fleet.analytic_vec``,
        crossovers, and the manager with no special-casing.
        """
        if occupancy < 1:
            raise ValueError(f"occupancy must be >= 1, got {occupancy}")
        mean_s, var_s, model = profile.service_moments(occupancy)
        mean_s, var_s = float(mean_s), float(var_s)
        if not mean_s > 0:
            raise ValueError(f"measured mean service must be > 0, got {mean_s}")
        if var_s < 0:
            raise ValueError(f"measured service variance must be >= 0, got {var_s}")
        model = ServiceModel(model)
        meta = {"measured": True, "occupancy": int(occupancy)}
        for attr in ("arch", "clock", "seed", "n_requests"):
            if hasattr(profile, attr):
                meta[attr] = getattr(profile, attr)
        return cls(
            name=name or f"measured:{meta.get('arch', 'profile')}@{occupancy}",
            service_time_s=mean_s,
            parallelism_k=float(occupancy),
            service_model=model,
            # only M/G/1 reads Var[s]; zero it otherwise so equality/
            # serialization of DETERMINISTIC/EXPONENTIAL tiers stays canonical
            service_var=var_s if model is ServiceModel.GENERAL else 0.0,
            meta=meta,
        )


@dataclass(frozen=True)
class Workload:
    """A request stream: Poisson(lam) arrivals with given payload sizes."""

    arrival_rate: float  # lambda (RPS)
    req_bytes: float  # D_req
    res_bytes: float  # D_res
    name: str = "workload"


@dataclass(frozen=True)
class NetworkPath:
    """The device<->edge network path. mu_net = B / D (paper §3.3, Alg. 1)."""

    bandwidth_Bps: float  # B

    def nic_rate(self, payload_bytes) -> np.ndarray:
        return np.asarray(self.bandwidth_Bps, dtype=np.float64) / np.asarray(
            payload_bytes, dtype=np.float64
        )

    def transmission(self, payload_bytes) -> np.ndarray:
        """n = D / B."""
        return np.asarray(payload_bytes, dtype=np.float64) / np.asarray(
            self.bandwidth_Bps, dtype=np.float64
        )


def proc_wait(tier: Tier, lam, *, service_time=None, service_var=None):
    """Processing-queue wait at a tier under arrival rate lam.

    Dispatches on the tier's queueing formulation exactly as the paper does:
    M/D/1 (Eq. 6) for deterministic, M/M/1 (Eq. 7, aggregated) for
    exponential, M/G/1 (Eq. 11) for general service.
    """
    s = np.asarray(tier.service_time_s if service_time is None else service_time)
    v = np.asarray(tier.service_var if service_var is None else service_var)
    with np.errstate(divide="ignore", invalid="ignore"):
        mu = 1.0 / s
    if tier.service_model is ServiceModel.DETERMINISTIC:
        return md1_wait(lam, mu, tier.parallelism_k)
    if tier.service_model is ServiceModel.EXPONENTIAL:
        return mm1_wait(lam, mu * tier.parallelism_k)
    if tier.service_model is ServiceModel.GENERAL:
        return mg1_wait(lam, mu, v, tier.parallelism_k)
    raise ValueError(f"unknown service model {tier.service_model}")


@dataclass(frozen=True)
class LatencyBreakdown:
    """Term-by-term decomposition (mirrors paper Eq. 1/2) for explainability.

    The paper's selling point is *explainable* closed forms — the manager
    logs this breakdown so an operator can see exactly which term drove a
    placement flip.
    """

    total: Any
    terms: dict[str, Any]

    def __getitem__(self, key):
        return self.terms[key]


def on_device_latency(wl: Workload, dev: Tier, *, breakdown: bool = False):
    """Paper Eq. 2: T_dev = w_dev^proc + s_dev."""
    w = proc_wait(dev, wl.arrival_rate)
    total = w + dev.service_time_s
    if not breakdown:
        return total
    return LatencyBreakdown(total, {"w_proc_dev": w, "s_dev": dev.service_time_s})


def edge_offload_latency(
    wl: Workload,
    edge: Tier,
    net: NetworkPath,
    *,
    edge_arrival_rate=None,
    return_results: bool = True,
    breakdown: bool = False,
):
    """Paper Eq. 1: T_edge = w_dev^net + n_req + w_edge^proc + s_edge + w_edge^net + n_res.

    ``edge_arrival_rate`` is the *aggregate* arrival rate at the edge
    (lambda_edge = sum_i lambda_i under multi-tenancy, §3.4); defaults to the
    workload's own rate (dedicated edge). ``return_results=False`` drops the
    reverse network path for results consumed at the edge (paper §3.3: "can be
    generalized ... by omitting this network delay").
    """
    lam = wl.arrival_rate
    lam_edge = lam if edge_arrival_rate is None else edge_arrival_rate

    mu_net_dev = net.nic_rate(wl.req_bytes)
    w_net_dev = mm1_wait(lam, mu_net_dev)  # device NIC sees this stream only
    n_req = net.transmission(wl.req_bytes)

    w_proc_edge = proc_wait(edge, lam_edge)
    s_edge = edge.service_time_s

    if return_results:
        mu_net_edge = net.nic_rate(wl.res_bytes)
        # Edge NIC carries completions of everything the edge serves
        # (throughput = aggregate arrival rate under stability, paper §3.3.1).
        w_net_edge = mm1_wait(lam_edge, mu_net_edge)
        n_res = net.transmission(wl.res_bytes)
    else:
        w_net_edge = np.zeros_like(np.asarray(n_req))
        n_res = np.zeros_like(np.asarray(n_req))

    total = w_net_dev + n_req + w_proc_edge + s_edge + w_net_edge + n_res
    if not breakdown:
        return total
    return LatencyBreakdown(
        total,
        {
            "w_net_dev": w_net_dev,
            "n_req": n_req,
            "w_proc_edge": w_proc_edge,
            "s_edge": s_edge,
            "w_net_edge": w_net_edge,
            "n_res": n_res,
        },
    )


# ---------------------------------------------------------------------------
# Lemma right-hand sides. Each lemma states: edge offloading has HIGHER
# average latency than on-device iff  s_dev - s_edge < RHS.
# ---------------------------------------------------------------------------


def _net_terms(lam_dev, lam_edge, wl: Workload, net: NetworkPath):
    """Common first three RHS terms: the two NIC waits + transmissions."""
    mu_nd = net.nic_rate(wl.req_bytes)
    mu_ne = net.nic_rate(wl.res_bytes)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = lam_dev / (mu_nd * (mu_nd - lam_dev))
        t2 = lam_edge / (mu_ne * (mu_ne - lam_edge))
    t1 = _stable_where(lam_dev, mu_nd, t1)
    t2 = _stable_where(lam_edge, mu_ne, t2)
    t3 = (np.asarray(wl.req_bytes) + np.asarray(wl.res_bytes)) / np.asarray(
        net.bandwidth_Bps, dtype=np.float64
    )
    return t1 + t2 + t3


def lemma31_rhs(wl: Workload, dev: Tier, edge: Tier, net: NetworkPath):
    """Lemma 3.1 RHS (Eq. 3): deterministic-service (DNN) crossover bound."""
    lam = np.asarray(wl.arrival_rate, dtype=np.float64)
    rhs = _net_terms(lam, lam, wl, net)
    ke_mu = edge.parallelism_k * edge.service_rate
    kd_mu = dev.parallelism_k * dev.service_rate
    with np.errstate(divide="ignore", invalid="ignore"):
        edge_term = 0.5 * (1.0 / (ke_mu - lam) - 1.0 / ke_mu)
        dev_term = 0.5 * (1.0 / (kd_mu - lam) - 1.0 / kd_mu)
    edge_term = _stable_where(lam, ke_mu, edge_term)
    dev_term = _stable_where(lam, kd_mu, dev_term)
    return rhs + edge_term - dev_term


def lemma33_rhs(wl: Workload, dev: Tier, edge: Tier, net: NetworkPath):
    """Lemma 3.3 RHS (Eq. 12): exponential-service (RNN/LLM) crossover bound."""
    lam = np.asarray(wl.arrival_rate, dtype=np.float64)
    rhs = _net_terms(lam, lam, wl, net)
    ke_mu = edge.parallelism_k * edge.service_rate
    kd_mu = dev.parallelism_k * dev.service_rate
    with np.errstate(divide="ignore", invalid="ignore"):
        edge_term = 1.0 / (ke_mu - lam) - 1.0 / ke_mu
        dev_term = 1.0 / (kd_mu - lam) - 1.0 / kd_mu
    edge_term = _stable_where(lam, ke_mu, edge_term)
    dev_term = _stable_where(lam, kd_mu, dev_term)
    return rhs + edge_term - dev_term


def lemma32_rhs(
    wl: Workload,
    dev: Tier,
    edge: Tier,
    net: NetworkPath,
    *,
    edge_arrival_rate,
    edge_service_var,
):
    """Lemma 3.2 RHS (Eq. 10): multi-tenant edge (M/G/1) crossover bound.

    ``edge_arrival_rate`` = lambda_edge = sum_i lambda_i; ``edge_service_var``
    = Var[s_edge] of the aggregate mixture (see multitenant.aggregate_streams).
    """
    lam_dev = np.asarray(wl.arrival_rate, dtype=np.float64)
    lam_edge = np.asarray(edge_arrival_rate, dtype=np.float64)
    rhs = _net_terms(lam_dev, lam_edge, wl, net)

    ke_mu = edge.parallelism_k * edge.service_rate
    kd_mu = dev.parallelism_k * dev.service_rate
    with np.errstate(divide="ignore", invalid="ignore"):
        rho_edge = lam_edge / ke_mu
        edge_term = (rho_edge + lam_edge * ke_mu * np.asarray(edge_service_var)) / (
            2.0 * (ke_mu - lam_edge)
        )
        dev_term = 0.5 * (1.0 / (kd_mu - lam_dev) - 1.0 / kd_mu)
    edge_term = _stable_where(lam_edge, ke_mu, edge_term)
    dev_term = _stable_where(lam_dev, kd_mu, dev_term)
    return rhs + edge_term - dev_term


def offload_wins(wl: Workload, dev: Tier, edge: Tier, net: NetworkPath, **kw):
    """True where edge offloading has LOWER expected latency (direct Eq.1 vs Eq.2).

    Equivalent to the lemma inequality NOT holding; tested for consistency
    against the lemma RHS forms.
    """
    return np.asarray(
        edge_offload_latency(wl, edge, net, **kw) < on_device_latency(wl, dev)
    )
