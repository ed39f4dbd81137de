"""Multi-tenant edge modelling (paper §3.4).

An edge server multiplexed across m devices sees the superposition of m
independent Poisson streams — itself Poisson with lambda_edge = sum_i lambda_i
— and an *arbitrary mixture* service distribution, hence M/G/1 (Lemma 3.2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .latency import NetworkPath, ServiceModel, Tier, Workload, edge_offload_latency

__all__ = [
    "TenantStream",
    "AggregateLoad",
    "aggregate_streams",
    "mixture_moments",
    "multitenant_edge_latency",
]


@dataclass(frozen=True)
class TenantStream:
    """One co-located application's offloaded stream as seen by the edge."""

    arrival_rate: float  # lambda_i
    service_mean_s: float  # s_i (service time of THIS app's requests at the edge)
    service_var: float = 0.0  # within-app service variance
    name: str = "tenant"


@dataclass(frozen=True)
class AggregateLoad:
    """The edge's effective M/G/1 inputs under multiplexing."""

    arrival_rate: float  # lambda_edge
    service_mean_s: float  # s_edge = sum_i (lambda_i/lambda_edge) s_i
    service_var: float  # Var[s_edge] of the mixture
    utilisation: float  # rho_edge = lambda_edge * s_edge

    @property
    def service_rate(self) -> float:
        return 1.0 / self.service_mean_s


def mixture_moments(rates, means, variances):
    """Vectorized §3.4 aggregation: the mixture's (rate, mean, variance).

    Reduces over the LAST axis — for ``(..., m)`` inputs of per-stream rates,
    service means, and within-stream variances, returns ``(lam_tot, mean_mix,
    var_mix)`` with shape ``(...)``: Poisson-superposition total rate, the
    rate-weighted mean, and the law-of-total-variance mixture variance. A
    zero total rate yields ``(0, 0, 0)`` (no load, not an error) so closed
    loops with momentarily-idle edges stay finite; :func:`aggregate_streams`
    is the validated scalar form built on top of this.
    """
    rates = np.asarray(rates, dtype=np.float64)
    means = np.asarray(means, dtype=np.float64)
    variances = np.asarray(variances, dtype=np.float64)
    lam_tot = rates.sum(axis=-1)
    safe = np.where(lam_tot > 0, lam_tot, 1.0)
    mean_mix = (rates * means).sum(axis=-1) / safe
    second = (rates * (variances + means**2)).sum(axis=-1) / safe
    var_mix = np.maximum(0.0, second - mean_mix**2)
    zero = lam_tot <= 0
    return (
        lam_tot,
        np.where(zero, 0.0, mean_mix),
        np.where(zero, 0.0, var_mix),
    )


def aggregate_streams(streams: Sequence[TenantStream]) -> AggregateLoad:
    """Poisson superposition + mixture moments (paper §3.4).

    lambda_edge = sum_i lambda_i                         (superposition, [43])
    s_edge      = sum_i (lambda_i / lambda_edge) s_i     (weighted mean)
    Var[s_edge] = E[s^2] - s_edge^2
                = sum_i w_i (var_i + s_i^2) - s_edge^2   (law of total variance)
    """
    if not streams:
        raise ValueError("need at least one tenant stream")
    if sum(t.arrival_rate for t in streams) <= 0:
        raise ValueError("aggregate arrival rate must be positive")
    lam_edge, s_edge, var = mixture_moments(
        [t.arrival_rate for t in streams],
        [t.service_mean_s for t in streams],
        [t.service_var for t in streams],
    )
    return AggregateLoad(float(lam_edge), float(s_edge), float(var),
                         float(lam_edge) * float(s_edge))


def multitenant_edge_latency(
    wl: Workload,
    edge: Tier,
    net: NetworkPath,
    streams: Sequence[TenantStream],
    **kw,
):
    """End-to-end offload latency for ``wl`` when the edge also serves ``streams``.

    The edge tier is re-parameterised with the aggregate mixture service
    (mean + variance) and evaluated as M/G/1 — exactly Lemma 3.2's setting.
    ``wl``'s own stream must be included in ``streams`` by the caller.
    """
    agg = aggregate_streams(streams)
    edge_mg1 = Tier(
        name=edge.name,
        service_time_s=agg.service_mean_s,
        parallelism_k=edge.parallelism_k,
        service_model=ServiceModel.GENERAL,
        service_var=agg.service_var,
    )
    return edge_offload_latency(
        wl, edge_mg1, net, edge_arrival_rate=agg.arrival_rate, **kw
    )
