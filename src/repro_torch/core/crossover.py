"""Quantitative performance-crossover solvers.

The paper's headline capability: "precise, quantitative performance crossover
predictions". Each solver finds the operating-point value at which
T_edge(x) == T_dev(x) by bisection on the (continuous) latency difference,
returning the crossover plus which side prefers offloading.

These power Fig. 4 (bandwidth crossovers), Fig. 5b (request-rate crossover)
and Fig. 5c (tenancy crossover at m co-located apps).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Sequence

import numpy as np

from .latency import NetworkPath, Tier, Workload, edge_offload_latency, on_device_latency
from .multitenant import TenantStream, multitenant_edge_latency

__all__ = [
    "Crossover",
    "solve_crossover",
    "smallest_true",
    "bandwidth_crossover",
    "arrival_rate_crossovers",
    "tenancy_crossover",
    "service_gap_bound",
]


@dataclass(frozen=True)
class Crossover:
    value: float | None  # crossover location, None if no sign change in range
    offload_wins_above: bool | None  # direction of advantage past the crossover
    lo: float
    hi: float


def _bisect(f: Callable[[float], float], lo: float, hi: float, iters: int = 200) -> float:
    flo = f(lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        if fm == 0.0:
            return mid
        if (fm > 0) == (flo > 0):
            lo, flo = mid, fm
        else:
            hi = mid
    return 0.5 * (lo + hi)


def solve_crossover(
    diff: Callable[[float], float], lo: float, hi: float, *, samples: int = 256
) -> Crossover:
    """Find x in [lo, hi] where diff(x) = T_edge - T_dev changes sign.

    diff > 0 means on-device wins at x. Scans a grid for the first sign
    change (multiple crossovers can exist — Fig. 4b — the first is returned;
    use ``samples`` sweeps for the rest), then bisects. Grids spanning more
    than two decades are sampled geometrically so narrow low-end crossover
    regions (e.g. bandwidth sweeps) are not skipped.
    """
    if lo > 0 and hi / lo > 100:
        xs = np.geomspace(lo, hi, samples)
    else:
        xs = np.linspace(lo, hi, samples)
    vals = [diff(float(x)) for x in xs]
    # Sign changes are only trusted between grid-ADJACENT finite samples.
    # Filtering non-finite samples first and pairing the survivors used to
    # pair points on opposite sides of an instability pocket (a run of
    # inf/NaN between them): a sign flip across the pocket sent _bisect into
    # the non-finite region and reported a bogus "crossover" at a stability
    # boundary. A pocket now yields no pair, exactly like the vectorized
    # fleet_crossover scan.
    for (x0, v0), (x1, v1) in zip(zip(xs, vals), zip(xs[1:], vals[1:])):
        if not (math.isfinite(v0) and math.isfinite(v1)):
            continue
        if v0 == 0.0:
            return Crossover(float(x0), v1 < 0, lo, hi)
        if (v0 > 0) != (v1 > 0):
            x = _bisect(diff, float(x0), float(x1))
            return Crossover(x, v1 < 0, lo, hi)
    return Crossover(None, None, lo, hi)


def bandwidth_crossover(
    wl: Workload,
    dev: Tier,
    edge: Tier,
    *,
    lo_Bps: float = 1e4,
    hi_Bps: float = 1e9,
    **kw,
) -> Crossover:
    """Bandwidth above which offloading wins (Fig. 4). Monotone in B."""

    def diff(b: float) -> float:
        net = NetworkPath(bandwidth_Bps=b)
        te = float(edge_offload_latency(wl, edge, net, **kw))
        td = float(on_device_latency(wl, dev))
        return te - td

    return solve_crossover(diff, lo_Bps, hi_Bps)


def arrival_rate_crossovers(
    wl: Workload,
    dev: Tier,
    edge: Tier,
    net: NetworkPath,
    *,
    lo: float = 0.01,
    hi: float | None = None,
    samples: int = 512,
    **kw,
) -> list[Crossover]:
    """All request-rate crossovers in (lo, hi) — Fig. 5b shows these need not
    be unique (competing lambda effects, §3.3 'Practical takeaways')."""
    # stay strictly inside every queue's stability region
    caps = [
        dev.parallelism_k * dev.service_rate,
        edge.parallelism_k * edge.service_rate,
        float(net.nic_rate(wl.req_bytes)),
        float(net.nic_rate(wl.res_bytes)),
    ]
    hi = hi if hi is not None else 0.999 * min(caps)
    if hi <= lo:
        return []

    def diff(lam: float) -> float:
        w = replace(wl, arrival_rate=lam)
        return float(edge_offload_latency(w, edge, net, **kw)) - float(
            on_device_latency(w, dev)
        )

    out: list[Crossover] = []
    xs = np.linspace(lo, hi, samples)
    vals = [diff(float(x)) for x in xs]
    for (x0, v0), (x1, v1) in zip(zip(xs, vals), zip(xs[1:], vals[1:])):
        if math.isfinite(v0) and math.isfinite(v1) and (v0 > 0) != (v1 > 0):
            x = _bisect(diff, float(x0), float(x1))
            out.append(Crossover(x, v1 < 0, lo, hi))
    return out


def smallest_true(predicate: Callable[[int], bool], max_n: int) -> int | None:
    """Smallest m in [1, max_n] with ``predicate(m)`` True, assuming the
    predicate is monotone (False ... False True ... True).

    Exponential bracketing then integer bisection: O(log max_n) evaluations
    instead of a linear scan — the difference between ~20 and ~1024 closed-
    form evaluations per tenancy query. Returns None when the predicate is
    False everywhere in range.
    """
    if max_n < 1:
        return None
    if predicate(1):
        return 1
    lo = 1  # highest index known False
    hi = 1
    while hi < max_n:
        hi = min(hi * 2, max_n)
        if predicate(hi):
            break
        lo = hi
    else:
        return None
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if predicate(mid):
            hi = mid
        else:
            lo = mid
    return hi


def tenancy_crossover(
    wl: Workload,
    dev: Tier,
    edge: Tier,
    net: NetworkPath,
    tenant_template: TenantStream,
    *,
    max_tenants: int = 1024,
) -> int | None:
    """Smallest number of co-located tenants m at which on-device wins (Fig. 5c).

    Tenants are homogeneous copies of ``tenant_template`` (the paper's §4.8
    setup: m InceptionV4 apps at 2 RPS each), so T_edge(m) is monotone
    increasing in m (more load on a fixed mixture; ``inf`` past saturation)
    and the scan is a bracket-and-bisect on the tenant count — pinned equal
    to the old linear scan by tests. Returns None if offloading wins even at
    ``max_tenants``.
    """
    td = float(on_device_latency(wl, dev))

    def on_device_wins(m: int) -> bool:
        streams: Sequence[TenantStream] = [tenant_template] * m
        return float(multitenant_edge_latency(wl, edge, net, streams)) > td

    return smallest_true(on_device_wins, max_tenants)


def service_gap_bound(kind: str, wl: Workload, dev: Tier, edge: Tier, net: NetworkPath, **kw):
    """The lemma RHS as a *bound on the service-time gap* s_dev - s_edge.

    kind in {"md1" (Lemma 3.1), "mm1" (Lemma 3.3), "mg1" (Lemma 3.2)}.
    On-device wins iff (s_dev - s_edge) < bound.
    """
    from . import latency as L

    if kind == "md1":
        return L.lemma31_rhs(wl, dev, edge, net)
    if kind == "mm1":
        return L.lemma33_rhs(wl, dev, edge, net)
    if kind == "mg1":
        return L.lemma32_rhs(wl, dev, edge, net, **kw)
    raise ValueError(kind)
