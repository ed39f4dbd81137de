"""Batched discrete-event simulation: tandem FCFS stations as Lindley scans.

`repro_torch.core.simulation` simulates one scenario at a time with a
Python-loop Lindley recursion. Here the same feed-forward tandem FCFS
networks run for thousands of scenarios at once on the card: every station
is one launch of a hand-written kernel (``kernels/lindley_scan``), one
thread per scenario row walking the job axis. Single-server stations (every
NIC stage, and k = 1 processing) go through the k = 1 Lindley scan; a
processing stage with any row at k > 1 goes through the k-server entry of
the same kernel library, which keeps each row's (k_max,) earliest-free-server
state — the translation of the heap in ``simulation.station_pass``
(identical departures; only tie-breaking among equal-free servers can differ,
which cannot change any departure time).

Semantics mirror ``scenario.simulate`` exactly for dedicated-edge and
on-device strategies: Poisson arrivals, per-tier service distributions derived
from the ServiceModel (deterministic / exponential / lognormal-general),
exponential NIC stages with mean D/B, and inter-stage resorting by departure
where k > 1 allows overtaking. Multi-tenant edges need the shared-station
merge and are delegated to the scalar simulator (raised here, not silently
mis-simulated).

Randomness: the draws come from a ``torch.Generator`` on the target device,
seeded from ``seed``, one standard (B, N) array per stage, drawn right before
its stage so that no more than one stage's draws is resident at a time. A
caller may instead pass the standard draws (:data:`DRAW_NAMES`); the tests
hand both packages the same draws that way, since torch cannot replay
``jax.random``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from ..core.simulation import steady_slice
from ..device import resolve_device
from ..kernels.lindley_scan.ops import lindley_kserver, lindley_scan
from .analytic_vec import FLOAT
from .batch import ScenarioBatch

__all__ = ["DRAW_NAMES", "FleetSimResult", "lindley_station", "simulate_fleet"]

# the standard draws of each strategy, in the order the generator makes them:
# unit-mean exponentials ("inter", "nic_req", "nic_res", "service_exp") and
# standard normals ("service_normal", for lognormal service only)
DRAW_NAMES = {
    "on_device": ("inter", "service_exp", "service_normal"),
    "edge": ("inter", "nic_req", "service_exp", "service_normal", "nic_res"),
}


def lindley_station(arrivals: torch.Tensor, services: torch.Tensor, k=1, *,
                    k_max: int | None = None) -> torch.Tensor:
    """FCFS k-server station, batched: departure times for (B, N) arrivals.

    The exact counterpart of ``simulation.station_pass`` — jobs start in
    arrival order on the earliest-free server. ``k`` may be an int (shared)
    or a (B,) array of per-scenario server counts; ``k_max`` bounds the packed
    server state (defaults to max(k)). Rows all at k = 1 take the k = 1 scan.
    """
    k_np = np.asarray(k)
    k_needed = int(np.max(k_np))
    if k_max is None:
        k_max = k_needed
    elif k_max < k_needed:
        raise ValueError(
            f"k_max={k_max} is smaller than the largest server count "
            f"{k_needed}; the station would silently run with fewer servers")
    if k_needed == 1:
        return lindley_scan(arrivals, services)
    k_rows = torch.as_tensor(np.broadcast_to(k_np, arrivals.shape[:1]).astype(np.int32),
                             device=arrivals.device)
    return lindley_kserver(arrivals, services, k_rows, k_max)


def _arrival_clock(inter: torch.Tensor) -> torch.Tensor:
    """Arrival times: the cumsum of each row's gaps. torch scans a tensor that
    holds a single row with CUB's device-wide scan, whose float sums depend on
    how its tiles' look-back runs, so a lone row's clock could move by an ulp
    between two runs of one seed; a zero second row keeps it on the row-wise
    scan that every batch takes, and a seeded run repeats bit for bit."""
    if inter.shape[0] == 1 and inter.device.type == "cuda":
        return torch.cumsum(torch.cat([inter, torch.zeros_like(inter)]), dim=1)[:1]
    return torch.cumsum(inter, dim=1)


def _resort_by_departure(dep: torch.Tensor, orig_arrival: torch.Tensor):
    """FCFS order at the next station is by arrival there (= departure here);
    carry each job's original arrival through the permutation."""
    perm = torch.argsort(dep, dim=1, stable=True)
    return torch.take_along_dim(dep, perm, dim=1), torch.take_along_dim(orig_arrival, perm,
                                                                         dim=1)


def _service_samples(model, s, var, draw) -> torch.Tensor:
    """(B, N) service draws per scenario row, dispatching on MODEL_CODES:
    deterministic / exponential / lognormal(mean, var) — the same three
    distributions ``scenario._service_dist`` derives. ``draw(name)`` gives the
    standard (B, N) draws; each is asked for only if some row needs it."""
    s = s[:, None]
    var = var[:, None]
    out = None
    if bool((model == 1).any()):
        out = draw("service_exp").mul_(s)  # s * Exp(1)
    if bool((model == 2).any()):
        # LogNormal(mean, var) moment-matched exactly as simulation.LogNormal
        sigma2 = torch.log1p(var / (s * s))
        mu = torch.log(s) - 0.5 * sigma2
        ln_draw = torch.exp(mu + torch.sqrt(sigma2) * draw("service_normal"))
        ln_draw = torch.where(var == 0.0, s, ln_draw)  # degenerate general -> constant
        out = ln_draw if out is None else torch.where(model[:, None] == 2, ln_draw, out)
        del ln_draw
    if out is None:
        return s.expand(-1, draw.n).contiguous()
    if bool((model == 0).any()):
        out = torch.where(model[:, None] == 0, s, out)
    return out


class _Draws:
    """The standard draws of one run: the caller's, where it passed them,
    else made by ``gen`` when first asked for. Each comes back as a fresh
    float64 tensor on ``device`` that the simulator may overwrite."""

    def __init__(self, names, given: Mapping | None, gen: torch.Generator, shape, device):
        if given is not None and set(given) - set(names):
            raise ValueError(f"unknown draws {sorted(set(given) - set(names))}; "
                             f"this strategy takes {names}")
        self.given, self.gen = given, gen
        self.shape, self.device, self.n = shape, device, shape[1]

    def __call__(self, name: str) -> torch.Tensor:
        t = torch.empty(self.shape, dtype=FLOAT, device=self.device)
        if self.given is None:
            if name == "service_normal":
                return t.normal_(generator=self.gen)
            return t.exponential_(generator=self.gen)
        if name not in self.given:
            raise ValueError(f"draw {name!r} is needed but was not passed")
        a = self.given[name]
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a, dtype=np.float64))  # a writable copy
        if tuple(a.shape) != self.shape:
            raise ValueError(f"draw {name!r} has shape {tuple(a.shape)}, not {self.shape}")
        return t.copy_(a)


@dataclass(frozen=True)
class FleetSimResult:
    """Observed per-scenario latencies of one batched simulation."""

    latencies: np.ndarray  # (B, N) in original arrival order
    arrivals: np.ndarray  # (B, N)
    warmup_frac: float = 0.1

    def _steady(self) -> np.ndarray:
        return self.latencies[:, steady_slice(self.latencies.shape[1],
                                              self.warmup_frac)]

    @property
    def mean(self) -> np.ndarray:
        """(B,) steady-state mean latency per scenario."""
        return self._steady().mean(axis=1)

    def percentile(self, q: float) -> np.ndarray:
        return np.percentile(self._steady(), q, axis=1)


def simulate_fleet(
    batch: ScenarioBatch,
    strategy: str = "on_device",
    *,
    n: int = 20_000,
    seed: int = 0,
    k_max: int | None = None,
    draws: Mapping[str, np.ndarray | torch.Tensor] | None = None,
    device=None,
) -> FleetSimResult:
    """Simulate every scenario in the batch under one strategy, on ``device``
    (default: the card).

    ``strategy`` is ``"on_device"`` or ``"edge[j]"`` (dedicated edges only —
    rows whose target edge hosts background tenants raise, because the shared
    multi-tenant station needs the scalar ``scenario.simulate`` path). The
    trim/mean conventions match ``simulation.SimResult`` so per-scenario means
    are directly comparable against ``simulate_tandem`` on the same spec.

    ``draws`` replaces the generator: a mapping from the strategy's
    :data:`DRAW_NAMES` to (B, n) standard draws (unit-mean exponentials, and
    standard normals for lognormal service); service draws are read only as
    the rows' service models need them.
    """
    m = re.fullmatch(r"on_device|edge\[(\d+)\]", strategy)
    if not m:
        raise ValueError(f"unknown strategy {strategy!r}")
    edge = None if m.group(1) is None else int(m.group(1))
    dev = resolve_device(device)
    shape = (batch.size, n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def col(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=FLOAT, device=dev)

    if edge is None:
        k_dev = np.rint(batch.dev_k).astype(np.int64)
        if not np.all(k_dev == batch.dev_k):
            raise ValueError("fractional device parallelism_k cannot be simulated "
                             "exactly; round it or compare via fleet_analytic only")
        draw = _Draws(DRAW_NAMES["on_device"], draws, gen, shape, dev)
        arrivals = _arrival_clock(draw("inter").div_(col(batch.lam)[:, None]))
        services = _service_samples(torch.as_tensor(batch.dev_model, device=dev),
                                    col(batch.dev_s), col(batch.dev_var), draw)
        dep = lindley_station(arrivals, services, np.maximum(k_dev, 1), k_max=k_max)
        del services
        latencies = dep.sub_(arrivals)
        return FleetSimResult(latencies.cpu().numpy(), arrivals.cpu().numpy())

    if edge >= batch.max_edges or not bool(np.all(batch.edge_mask[:, edge])):
        raise ValueError(f"strategy {strategy!r}: not every scenario has that edge")
    if np.any(batch.bg_lam[:, edge] > 0):
        raise ValueError(
            f"strategy {strategy!r}: background tenants need the shared-station "
            "simulator — use scenario.simulate for those rows"
        )
    k_edge = np.rint(batch.edge_k[:, edge]).astype(np.int64)
    if not np.all(k_edge == batch.edge_k[:, edge]):
        raise ValueError("fractional edge parallelism_k cannot be simulated "
                         "exactly; round it or compare via fleet_analytic only")
    k_edge = np.maximum(k_edge, 1)

    bw = np.where(np.isnan(batch.edge_bw[:, edge]), batch.bandwidth_Bps,
                  batch.edge_bw[:, edge])
    req_mean = col(batch.req_bytes / bw)[:, None]
    res_mean = col(np.where(batch.return_results, batch.res_bytes, 0.0) / bw)[:, None]
    draw = _Draws(DRAW_NAMES["edge"], draws, gen, shape, dev)
    arrivals = _arrival_clock(draw("inter").div_(col(batch.lam)[:, None]))

    # stage 1: device NIC (k=1, exponential mean D_req/B); k=1 departures
    # are already non-decreasing, so no resort is needed before stage 2
    t = lindley_scan(arrivals, draw("nic_req").mul_(req_mean))
    orig = arrivals

    # stage 2: edge processing (k servers, tier service model)
    services = _service_samples(torch.as_tensor(batch.edge_model[:, edge], device=dev),
                                col(batch.edge_s[:, edge]), col(batch.edge_var[:, edge]), draw)
    dep = lindley_station(t, services, k_edge, k_max=k_max)
    del services, t
    # k>1 can overtake; at k = 1 everywhere the departures are already in
    # arrival order (service times are non-negative), the stable sort would be
    # the identity, and it is skipped
    overtakes = bool(np.any(k_edge > 1))
    if overtakes:
        t, orig = _resort_by_departure(dep, orig)
    else:
        t = dep
    del dep

    # stage 3: edge NIC return path (k=1, exponential mean D_res/B; zero
    # mean collapses to zero service when results are consumed at the edge)
    latency = lindley_scan(t, draw("nic_res").mul_(res_mean)).sub_(orig)
    del t
    if overtakes:
        # report in original arrival order for warmup trimming (cf. SimResult)
        perm = torch.argsort(orig, dim=1, stable=True)
        latency = torch.take_along_dim(latency, perm, dim=1)
        orig = torch.take_along_dim(orig, perm, dim=1)
        del perm
    return FleetSimResult(latency.cpu().numpy(), orig.cpu().numpy())
