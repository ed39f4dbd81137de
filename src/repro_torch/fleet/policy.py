"""Shared decision/scoring core for the trace replays (§5) and the
closed-loop cluster simulator (§6).

Both :mod:`repro_torch.fleet.replay` (one client, exogenous conditions) and
:mod:`repro_torch.fleet.cluster` (N clients, endogenous edge load) answer the same
two questions every epoch:

  * what would each static policy name mean as a target index, and
  * what does a chosen target actually cost under the TRUE conditions?

This module is the single home for those answers — policy-label parsing (via
``scenario.parse_strategy``, the one label parser), the per-edge background
*template* (the service-moment mixture a churned load report is re-expanded
with), the closed-form true-condition scoring of one target, and the bounded
saturation penalty that keeps policy means comparable across epochs that
cross a stability boundary.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Sequence

import numpy as np

from repro_torch.core.latency import NetworkPath, edge_offload_latency, on_device_latency
from repro_torch.core.manager import ON_DEVICE
from repro_torch.core.multitenant import TenantStream, aggregate_streams, multitenant_edge_latency
from repro_torch.core.scenario import (
    Scenario,
    ScenarioError,
    implied_service_var,
    parse_strategy,
    tier_station,
)
from repro_torch.core.tail import mixture_station, offload_stations, sojourn_quantile

__all__ = ["parse_policy", "bg_template", "static_fractions", "true_latency",
           "clamp_saturation"]


def parse_policy(name: str, n_edges: int) -> int:
    """Static policy label -> target index (``ON_DEVICE`` or an edge index).

    Thin wrapper over :func:`repro_torch.core.scenario.parse_strategy` so replay
    and cluster policies fail exactly like every other strategy label, with
    the error renamed to the ``policies`` field the caller passed."""
    try:
        return parse_strategy(name, n_edges)
    except ScenarioError as err:
        raise ScenarioError("policies", str(err)) from None


def static_fractions(name: str, n_classes: int, n_edges: int) -> np.ndarray:
    """(C, E+1) mean-field fraction matrix of an all-clients static policy.

    Column 0 is on-device and column ``j + 1`` is edge ``j`` — the layout
    the mean-field fleet (``fleet/meanfield.py``, still to port) uses for every
    fraction state. Each class
    puts its whole mass on the parsed target, so the matrix is the state a
    fleet pinned to ``name`` occupies; labels parse (and fail) exactly like
    replay and cluster policies."""
    if n_classes < 1:
        raise ValueError(f"n_classes must be positive, got {n_classes}")
    target = parse_policy(name, n_edges)
    f = np.zeros((n_classes, n_edges + 1), dtype=np.float64)
    f[:, 0 if target == ON_DEVICE else target + 1] = 1.0
    return f


def bg_template(scn: Scenario, j: int) -> tuple[float, float, float]:
    """(rate, mean, var) of edge j's spec background aggregate; tenant churn
    scales the rate while preserving the mixture's service moments. Edges
    declared without background churn homogeneous copies of the edge's own
    service (the paper's §4.8 setup)."""
    e = scn.edges[j]
    if e.background:
        agg = aggregate_streams(e.background)
        return agg.arrival_rate, agg.service_mean_s, agg.service_var
    return 0.0, e.tier.service_time_s, implied_service_var(e.tier)


def true_latency(
    scn: Scenario, target: int, bw: float, lam: float, bg_rates: np.ndarray,
    templates: Sequence[tuple[float, float, float]],
    *,
    slo_quantile: float | None = None,
    tail_method: str = "euler",
) -> float:
    """Closed-form latency of ``target`` under the true epoch conditions.

    With ``slo_quantile`` set, the score is the q-quantile of the path's
    sojourn distribution (:mod:`repro_torch.core.tail`) instead of the mean — the
    same objective an SLO-mode manager optimises, so adaptive-vs-static
    comparisons stay apples to apples under an SLO."""
    wl = replace(scn.workload, arrival_rate=float(lam))
    if slo_quantile is not None:
        return _true_tail_latency(scn, target, bw, wl, bg_rates, templates,
                                  slo_quantile, tail_method)
    if target == ON_DEVICE:
        return float(np.asarray(on_device_latency(wl, scn.device)))
    e = scn.edges[target]
    net = NetworkPath(bw) if e.bandwidth_Bps is None else NetworkPath(e.bandwidth_Bps)
    rate = float(bg_rates[target])
    _, mean, var = templates[target]
    if rate > 0:
        streams = (e.own_stream(wl), TenantStream(rate, mean, var))
        return float(np.asarray(multitenant_edge_latency(
            wl, e.tier, net, streams, return_results=scn.return_results)))
    return float(np.asarray(edge_offload_latency(
        wl, e.tier, net, return_results=scn.return_results)))


def _true_tail_latency(
    scn: Scenario, target: int, bw: float, wl, bg_rates, templates,
    q: float, method: str,
) -> float:
    """The q-quantile twin of the mean scoring above: identical station
    composition to ``scenario.tail_stations`` with the trace-churned
    background re-aggregated at the reported rate."""
    if target == ON_DEVICE:
        return float(sojourn_quantile((tier_station(scn.device, wl.arrival_rate),),
                                      q, method=method))
    e = scn.edges[target]
    b = float(bw if e.bandwidth_Bps is None else e.bandwidth_Bps)
    rate = float(bg_rates[target])
    _, mean, var = templates[target]
    if rate > 0:
        agg = aggregate_streams((e.own_stream(wl), TenantStream(rate, mean, var)))
        proc = mixture_station(agg.arrival_rate, agg.service_mean_s,
                               agg.service_var, e.tier.parallelism_k)
    else:
        proc = tier_station(e.tier, wl.arrival_rate)
    stations = offload_stations(wl.arrival_rate, wl.req_bytes, wl.res_bytes,
                                b, proc, return_results=scn.return_results)
    return float(sojourn_quantile(stations, q, method=method))


def clamp_saturation(latencies: np.ndarray, penalty_s: float) -> tuple[np.ndarray, int]:
    """Replace non-finite / beyond-penalty epoch latencies with the bounded
    saturation penalty. One epoch of saturation accrues a bounded backlog, and
    bounded penalties keep policy means comparable. Returns the clamped array
    and the number of clamped entries."""
    lat = np.asarray(latencies, dtype=np.float64)
    saturated = ~np.isfinite(lat) | (lat > penalty_s)
    return np.where(saturated, penalty_s, lat), int(saturated.sum())
