"""Collaborative (split) processing — tandem queue model (paper §3.3 ext.).

A request is partially processed on the device (service s'_dev), the
intermediate activation of size D_inter crosses the network, and the edge
finishes the remaining computation (service s'_edge). The end-to-end model is
the tandem composition of Fig. 1b then Fig. 1a with the request payload
replaced by D_inter.

The planner enumerates split points of a layered model (s = 0 .. L, where
s = 0 is full offload and s = L is full on-device) using per-layer cost
profiles and picks the argmin — this is what §4.6 evaluates (Fig. 5a).
A copy of the JAX package's module with the same arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .latency import (
    NetworkPath,
    Tier,
    Workload,
    edge_offload_latency,
    mm1_wait,
    on_device_latency,
    proc_wait,
)

__all__ = ["SplitPoint", "split_latency", "LayerProfile", "SplitPlanner", "SplitPlan"]


@dataclass(frozen=True)
class SplitPoint:
    """A concrete split: device does s'_dev of work, ships D_inter bytes."""

    dev_service_s: float  # s'_dev
    edge_service_s: float  # s'_edge
    inter_bytes: float  # D_inter
    index: int = -1  # split layer index (bookkeeping)


def split_latency(
    wl: Workload,
    dev: Tier,
    edge: Tier,
    net: NetworkPath,
    sp: SplitPoint,
    *,
    edge_arrival_rate=None,
    breakdown: bool = False,
):
    """Tandem-queue end-to-end latency of a split execution.

    T_split = w_dev^proc(s'_dev) + s'_dev                     (partial local)
            + w_dev^net + D_inter/B                           (ship activation)
            + w_edge^proc(s'_edge) + s'_edge                  (finish at edge)
            + w_edge^net + D_res/B                            (return result)

    Degenerate cases reduce exactly to the base models (tested):
      s'_dev = 0, D_inter = D_req  -> edge_offload_latency
      s'_edge = 0, D_inter = 0     -> on_device_latency      (no network legs)
    """
    lam = wl.arrival_rate
    lam_edge = lam if edge_arrival_rate is None else edge_arrival_rate

    terms = {}
    # --- device partial processing (Fig. 1b with service s'_dev) ---
    if sp.dev_service_s > 0:
        terms["w_proc_dev"] = proc_wait(dev, lam, service_time=sp.dev_service_s)
        terms["s_dev_partial"] = sp.dev_service_s
    else:
        terms["w_proc_dev"] = 0.0
        terms["s_dev_partial"] = 0.0

    # --- network leg with the intermediate payload (Fig. 1a forward path) ---
    if sp.inter_bytes > 0:
        mu_net_dev = net.nic_rate(sp.inter_bytes)
        terms["w_net_dev"] = mm1_wait(lam, mu_net_dev)
        terms["n_inter"] = net.transmission(sp.inter_bytes)
    else:
        terms["w_net_dev"] = 0.0
        terms["n_inter"] = 0.0

    # --- edge remainder + return path ---
    if sp.edge_service_s > 0:
        terms["w_proc_edge"] = proc_wait(edge, lam_edge, service_time=sp.edge_service_s)
        terms["s_edge_partial"] = sp.edge_service_s
        mu_net_edge = net.nic_rate(wl.res_bytes)
        terms["w_net_edge"] = mm1_wait(lam_edge, mu_net_edge)
        terms["n_res"] = net.transmission(wl.res_bytes)
    else:
        terms["w_proc_edge"] = 0.0
        terms["s_edge_partial"] = 0.0
        terms["w_net_edge"] = 0.0
        terms["n_res"] = 0.0

    total = sum(terms.values())
    if breakdown:
        from .latency import LatencyBreakdown

        return LatencyBreakdown(total, terms)
    return total


@dataclass(frozen=True)
class LayerProfile:
    """Per-layer cost: service seconds on each tier + output activation bytes."""

    dev_service_s: float
    edge_service_s: float
    out_bytes: float
    name: str = "layer"


@dataclass(frozen=True)
class SplitPlan:
    index: int  # layers [0, index) on device, [index, L) on edge
    latency_s: float
    point: SplitPoint | None  # None for pure strategies
    strategy: str  # "device" | "edge" | "split"


class SplitPlanner:
    """Chooses full-local vs full-offload vs the best split point.

    Mirrors §4.6: later split points ship larger intermediate activations, so
    the tandem model naturally penalises them; the planner just evaluates the
    closed form at every boundary.
    """

    def __init__(self, layers: Sequence[LayerProfile], wl: Workload):
        self.layers = list(layers)
        self.wl = wl

    def candidate(self, index: int) -> SplitPoint:
        if not 0 <= index <= len(self.layers):
            raise IndexError(index)
        dev_s = float(sum(l.dev_service_s for l in self.layers[:index]))
        edge_s = float(sum(l.edge_service_s for l in self.layers[index:]))
        if index == 0:
            inter = self.wl.req_bytes  # full offload ships the raw request
        elif index == len(self.layers):
            inter = 0.0  # nothing crosses the network
        else:
            inter = float(self.layers[index - 1].out_bytes)
        return SplitPoint(dev_s, edge_s, inter, index=index)

    def plan(
        self,
        dev: Tier,
        edge: Tier,
        net: NetworkPath,
        *,
        edge_arrival_rate=None,
    ) -> SplitPlan:
        n = len(self.layers)
        best: SplitPlan | None = None
        for idx in range(n + 1):
            sp = self.candidate(idx)
            lat = float(
                split_latency(
                    self.wl, dev, edge, net, sp, edge_arrival_rate=edge_arrival_rate
                )
            )
            strategy = "edge" if idx == 0 else ("device" if idx == n else "split")
            cand = SplitPlan(idx, lat, sp, strategy)
            if best is None or cand.latency_s < best.latency_s:
                best = cand
        assert best is not None
        return best

    def sweep(self, dev: Tier, edge: Tier, net: NetworkPath, **kw) -> np.ndarray:
        """Latency at every split boundary (for Fig. 5a-style plots)."""
        return np.array(
            [
                split_latency(self.wl, dev, edge, net, self.candidate(i), **kw)
                for i in range(len(self.layers) + 1)
            ]
        )
