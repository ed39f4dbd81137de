"""Mean-field cluster layer: client *classes* instead of clients, in torch
float64 on the card.

The exact closed loop (:mod:`repro_torch.fleet.cluster`) carries per-client
state, so its cost is linear in N. This module evolves the *distribution* of
decisions instead: the fleet is partitioned into C homogeneous classes
(:class:`MeanFieldSpec`'s (device tier, arrival-rate band, bandwidth band)
buckets) and the state is a (C, E+1) matrix of offload fractions ``f[c, j]``
— the fraction of class c currently targeting on-device (column 0) or edge
j-1. The endogenous edge load is a sum of class rates times offload
fractions,

    L_j = sum_c n_c * f[c, j+1] * lam_c  (+ the exogenous trace background),

and every cost evaluation runs the same Algorithm-1 closed forms the exact
cluster uses (``_predict_vec`` / ``_predict_tail_vec``), over one row per
(class, current-target) sub-cohort rather than one row per client. The
marginal decider's own stream is excluded from its current edge's
background (``L_j - lam_c``), mirroring the exact solver's self-exclusion,
so the mean-field fixed point and the exact equilibrium answer the same
question and :func:`cross_check_meanfield` can gate one against the other.

A step is O(C * E^2) elementwise work — independent of N — so a
million-client fleet costs what a handful of classes cost. The epochs of
:func:`simulate_meanfield` are a Python loop of a few dozen small launches
each; no TPU kernel sat on this path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.scenario import MeanFieldSpec, ScenarioError, implied_service_var
from ..device import resolve_device
from .analytic_vec import FLOAT
from .batch import MODEL_CODES
from .cluster import (
    _as_tensors,
    _bg_moments,
    _f64,
    _price,
    _slo_method,
    solve_equilibrium,
)
from .policy import bg_template, clamp_saturation
from .traces import Trace, TraceBatch

__all__ = [
    "MeanFieldEquilibrium",
    "MeanFieldResult",
    "solve_meanfield_equilibrium",
    "simulate_meanfield",
    "cross_check_meanfield",
]


# ---------------------------------------------------------------------------
# static spec arrays: one row per (class, current-target) sub-cohort
# ---------------------------------------------------------------------------


def _mf_arrays(spec: MeanFieldSpec) -> dict[str, np.ndarray]:
    """The ``_spec_arrays``-shaped column dict for the mean-field cost rows.

    Rows are laid out class-major over current targets: row ``c*(E+1) + m``
    is "a class-c client currently at target m" (m=0 on-device, m=j+1 edge
    j). Device columns are per-row (classes may override the device tier);
    edge columns stay (E,) and broadcast, exactly as in the exact cluster.
    """
    base = spec.base
    c_n, e_n = spec.n_classes, spec.n_edges
    devices = [spec.device_tier(c) for c in range(c_n)]
    templates = [bg_template(base, j) for j in range(e_n)]
    edge_s = np.array([e.tier.service_time_s for e in base.edges])

    def per_row(vals, dtype=np.float64):
        return np.repeat(np.asarray(vals, dtype=dtype), e_n + 1)

    return {
        "lam_spec": per_row(spec.arrival_rates()),  # (R,)
        "req_bytes": np.float64(base.workload.req_bytes),
        "res_bytes": np.float64(base.workload.res_bytes),
        "return_results": np.bool_(base.return_results),
        "dev_s": per_row([d.service_time_s for d in devices]),
        "dev_k": per_row([d.parallelism_k for d in devices]),
        "dev_var": per_row([d.service_var for d in devices]),
        "dev_model": per_row([MODEL_CODES[d.service_model] for d in devices],
                             dtype=np.int8),
        "edge_s": edge_s,
        "edge_k": np.array([e.tier.parallelism_k for e in base.edges]),
        "edge_var": np.array([e.tier.service_var for e in base.edges]),
        "edge_model": np.array(
            [MODEL_CODES[e.tier.service_model] for e in base.edges], dtype=np.int8),
        "edge_bw": np.array(
            [np.nan if e.bandwidth_Bps is None else e.bandwidth_Bps
             for e in base.edges]),
        "endo_mean": edge_s,
        "endo_var": np.array([implied_service_var(e.tier) for e in base.edges]),
        "exo_rate": np.array([t[0] for t in templates]),
        "exo_mean": np.array([t[1] for t in templates]),
        "exo_var": np.array([t[2] for t in templates]),
        # self-exclusion mask: row (c, m) excludes ONE own stream from edge
        # j's background iff it currently sits there (m == j+1) — the exact
        # solver's `endo_total - own`, in sub-cohort form
        "self_mask": np.equal.outer(
            np.tile(np.arange(e_n + 1), c_n), np.arange(1, e_n + 1)
        ).astype(np.float64),  # (R, E)
        "counts": spec.class_counts(),  # (C,)
    }


def _mf_loads(f, counts, lam_c):
    """(E,) endogenous edge load: sum of class rates x offload fractions."""
    return torch.sum((counts * lam_c)[:, None] * f[:, 1:], dim=0)


def _mf_cost(cst, lam_c, bw_c, endo_loads, exo, slo_q, tail_method):
    """(C, E+1, E+1) cost table: ``cost[c, m, j]`` is the Algorithm-1 latency
    a class-c client currently at target m predicts for target j, with its
    own stream excluded from its current edge's background."""
    e1 = cst["self_mask"].shape[1] + 1
    lam_row = torch.repeat_interleave(lam_c, e1)
    bw_row = torch.repeat_interleave(bw_c, e1)
    endo = torch.clamp(endo_loads[None, :] - cst["self_mask"] * lam_row[:, None], min=0.0)
    bg = _bg_moments(cst, endo, exo[None, :])
    t_dev, t_edge = _price(cst, lam_row, bw_row, bg, slo_q, tail_method)
    stacked = torch.cat([t_dev[:, None], t_edge], dim=1)
    return stacked.reshape(lam_c.shape[0], e1, e1)


def _mf_respond(cost, f):
    """Best response of every sub-cohort: all of class c's mass currently at
    m moves to ``argmin_j cost[c, m, j]`` (the first argmin — on-device wins
    ties, then the lowest edge index, the exact solver's tie-break)."""
    e1 = cost.shape[1]
    br = torch.argmin(cost, dim=2)  # (C, E+1) target in 0..E
    onehot = (br[:, :, None] == torch.arange(e1, device=f.device)[None, None, :]).to(f.dtype)
    return torch.einsum("cm,cmj->cj", f, onehot)


def _mf_step(cst, f, lam_c, bw_c, exo, eta, slo_q=None, tail_method="asymptote"):
    """One damped best-response step; returns everything the solver and the
    diurnal replay both need: the updated fractions, the per-(c, m) move
    costs, the per-(c, m) staying cost, the per-class expected latency, and
    the edge loads ``f`` induces."""
    loads = _mf_loads(f, cst["counts"], lam_c)
    cost = _mf_cost(cst, lam_c, bw_c, loads, exo, slo_q, tail_method)
    e1 = cost.shape[1]
    diag = torch.arange(e1, device=f.device)
    stay = cost[:, diag, diag]  # (C, E+1) cost of staying
    lat_class = torch.sum(f * stay, dim=1)  # (C,) expected latency per class
    f_new = (1.0 - eta) * f + eta * _mf_respond(cost, f)
    return f_new, cost, stay, lat_class, loads


def _start(c_n: int, e1: int, device) -> torch.Tensor:
    """Every class on-device: the fraction state both solvers start from."""
    f = torch.zeros((c_n, e1), dtype=FLOAT, device=device)
    f[:, 0] = 1.0
    return f


# ---------------------------------------------------------------------------
# fixed point: solve_meanfield_equilibrium
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeanFieldEquilibrium:
    """A fixed point of the fraction -> load -> best-response map.

    The mean-field twin of :class:`repro_torch.fleet.cluster.Equilibrium`:
    instead of one choice per client it carries per-class offload fractions,
    and the per-class latency is the fraction-weighted staying cost at the
    fixed point. ``regret_pct`` is the equilibrium residual — the worst
    relative gap between any occupied sub-cohort's staying cost and its best
    response, 0 at an exact Wardrop equilibrium."""

    fractions: np.ndarray  # (C, E+1) column 0 = on-device
    iterations: int
    converged: bool
    regret_pct: float  # worst occupied-mass relative regret at exit
    latency_s: np.ndarray  # (C,) fraction-weighted per-class latency
    class_latency_s: np.ndarray  # (C, E+1) staying cost per (class, target)
    cost_s: np.ndarray  # (C, E+1, E+1) full move-cost table [class, at, to]
    edge_loads: np.ndarray  # (E,) endogenous offloaded rate per edge
    rho_edges: np.ndarray  # (E,) processing utilization incl. exogenous load
    arrival_rates: np.ndarray  # (C,) per-client class rates solved at
    bandwidth_Bps: np.ndarray  # (C,) per-class bandwidth solved at
    exo_rates: np.ndarray  # (E,) exogenous background rates used
    counts: np.ndarray  # (C,) clients per class

    @property
    def n_total(self) -> int:
        return int(self.counts.sum())

    @property
    def mean_latency_s(self) -> float:
        """Count-weighted fleet mean latency at the fixed point."""
        w = self.counts / self.counts.sum()
        return float(np.sum(w * self.latency_s))

    @property
    def offload_frac(self) -> float:
        w = self.counts / self.counts.sum()
        return float(np.sum(w * self.fractions[:, 1:].sum(axis=1)))

    def expected_counts(self) -> dict[str, float]:
        """Expected clients per target, keyed like ``Equilibrium.counts``."""
        per_target = (self.counts[:, None] * self.fractions).sum(axis=0)
        out = {"on_device": float(per_target[0])}
        for j in range(per_target.shape[0] - 1):
            out[f"edge[{j}]"] = float(per_target[j + 1])
        return out


def _rho_edges(cst, loads, exo) -> np.ndarray:
    """Processing utilization of the realized per-edge aggregate mixture —
    the same mixture fold ``solve_equilibrium`` reports."""
    loads = np.asarray(loads, dtype=np.float64)
    exo = np.asarray(exo, dtype=np.float64)
    lam_tot = loads + exo
    wsum = loads * cst["endo_mean"] + exo * cst["exo_mean"]
    return np.where(lam_tot > 0, wsum / cst["edge_k"], 0.0)


def solve_meanfield_equilibrium(
    spec: MeanFieldSpec,
    *,
    bandwidth_Bps: float | np.ndarray | None = None,
    exo_rates: np.ndarray | None = None,
    damping: float = 0.5,
    max_iter: int = 500,
    tol_pct: float = 1e-3,
    slo_quantile: float | None = None,
    tail_method: str = "asymptote",
    device=None,
) -> MeanFieldEquilibrium:
    """Iterate fractions -> loads -> best responses to a Wardrop fixed point,
    on ``device`` (default: the card).

    Every sub-cohort (class c currently at target m) best-responds against
    the loads the current fractions induce, with its own marginal stream
    excluded from its current edge; a fraction ``damping`` of each cohort
    moves per iteration. Pure best response can cycle (the same stampede the
    exact solver damps with sequential sweeps); damped mass movement
    converges to the mixed (Wardrop) equilibrium instead, where every
    occupied target of a class prices within ``tol_pct`` of that class's
    best option. When the residual stalls, the damping factor is halved.

    ``bandwidth_Bps`` overrides the *base* bandwidth (scalar, scaled by each
    class's ``bandwidth_scale``) or gives explicit per-class values ((C,)
    array, used verbatim). ``slo_quantile`` switches costs from means to
    q-quantiles (``tail_method``), exactly like the exact solver.
    """
    if not 0.0 < damping <= 1.0:
        raise ValueError(f"damping must be in (0, 1], got {damping}")
    tail_method = _slo_method(slo_quantile, tail_method)

    c_n, e_n = spec.n_classes, spec.n_edges
    cst_np = _mf_arrays(spec)
    lam_c = spec.arrival_rates()
    if bandwidth_Bps is None or np.ndim(bandwidth_Bps) == 0:
        bw_c = spec.bandwidth_Bps(None if bandwidth_Bps is None else float(bandwidth_Bps))
    else:
        bw_c = np.asarray(bandwidth_Bps, dtype=np.float64)
        if bw_c.shape != (c_n,):
            raise ScenarioError("bandwidth_Bps", f"expected shape ({c_n},), got {bw_c.shape}")
    exo = np.asarray(exo_rates, dtype=np.float64) if exo_rates is not None \
        else cst_np["exo_rate"].copy()
    if exo.shape != (e_n,):
        raise ScenarioError("exo_rates", f"expected shape ({e_n},), got {exo.shape}")

    dev = resolve_device(device)
    cst = _as_tensors(cst_np, dev)
    lam_t, bw_t, exo_t = _f64(lam_c, dev), _f64(bw_c, dev), _f64(exo, dev)
    f = _start(c_n, e_n + 1, dev)
    eta = float(damping)
    converged = False
    iterations = 0
    best_regret = np.inf
    stall = 0

    def evaluate(f):
        f_new, cost, stay, lat, loads = _mf_step(cst, f, lam_t, bw_t, exo_t, eta,
                                                 slo_quantile, tail_method)
        # occupied-mass relative regret: how far above its best option any
        # current sub-cohort is pricing (0 at a Wardrop equilibrium;
        # non-finite best = everything saturated, nowhere better to go)
        best = torch.amin(cost, dim=2)
        gap = torch.where((f > 1e-9) & torch.isfinite(best), (stay - best) / best, 0.0)
        return f_new, cost, stay, lat, loads, float(torch.max(gap)) * 100.0

    while iterations < max_iter:
        iterations += 1
        f_new, cost, stay, lat, loads, regret = evaluate(f)
        if regret <= tol_pct:
            converged = True
            break
        if regret < best_regret * (1 - 1e-9):
            best_regret, stall = regret, 0
        else:
            stall += 1
            if stall >= 20:  # residual stalled: damp harder
                eta, stall = max(eta / 2.0, 1e-3), 0
        f = f_new
    if not converged:
        # the loop exhausted after updating f: refresh the diagnostics so the
        # reported state is self-consistent with `fractions`
        _f_new, cost, stay, lat, loads, regret = evaluate(f)

    loads_np = loads.cpu().numpy()
    return MeanFieldEquilibrium(
        fractions=f.cpu().numpy(),
        iterations=iterations,
        converged=converged,
        regret_pct=regret,
        latency_s=lat.cpu().numpy(),
        class_latency_s=stay.cpu().numpy(),
        cost_s=cost.cpu().numpy(),
        edge_loads=loads_np,
        rho_edges=_rho_edges(cst_np, loads_np, exo),
        arrival_rates=lam_c,
        bandwidth_Bps=bw_c,
        exo_rates=exo,
        counts=cst_np["counts"],
    )


# ---------------------------------------------------------------------------
# the diurnal day: a loop over epochs, O(C * E^2) per step
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeanFieldResult:
    """A mean-field closed-loop trajectory (the million-client replay)."""

    spec: MeanFieldSpec
    times: np.ndarray  # (T,)
    fractions: np.ndarray  # (T, C, E+1) decision-time fraction state
    edge_loads: np.ndarray  # (T, E) endogenous offloaded rate per edge
    rho_edges: np.ndarray  # (T, E) utilization incl. exogenous load
    latency_s: np.ndarray  # (T, C) per-class expected latency (clamped)
    saturated_epochs: int  # class-epochs clamped at the saturation penalty

    @property
    def n_epochs(self) -> int:
        return int(len(self.times))

    @property
    def client_epochs(self) -> int:
        """Clients-modeled x epochs — the throughput numerator (N-independent
        work pricing an N-client fleet)."""
        return int(self.spec.n_total * self.n_epochs)

    @property
    def mean_latency_s(self) -> float:
        w = self.spec.class_counts() / self.spec.n_total
        return float(np.mean(self.latency_s @ w))

    @property
    def offload_frac(self) -> np.ndarray:
        """(T,) count-weighted offloaded fraction of the fleet per epoch."""
        w = self.spec.class_counts() / self.spec.n_total
        return self.fractions[:, :, 1:].sum(axis=2) @ w


def simulate_meanfield(
    spec: MeanFieldSpec,
    traces: TraceBatch | Trace,
    *,
    switch_fraction: float = 0.25,
    saturation_penalty_s: float = 30.0,
    slo_quantile: float | None = None,
    tail_method: str = "asymptote",
    device=None,
) -> MeanFieldResult:
    """Drive the class-fraction state through a per-*class* trace batch, on
    ``device`` (default: the card).

    ``traces`` columns are per class, not per client (``n_clients`` must
    equal ``spec.n_classes``): column c is the measured bandwidth / churned
    arrival rate every member of class c sees (build it with the class's
    ``bandwidth_scale`` folded in). Per epoch every class re-prices against
    the loads the current fractions induce (the mean-field analog of the
    exact loop's one-epoch information lag) and ``switch_fraction`` of each
    sub-cohort moves to its best response — the continuum analog of the
    exact loop's ``stagger`` cohorts. Per-class latencies are clamped at
    ``saturation_penalty_s`` exactly like the exact replay scoring."""
    if isinstance(traces, Trace):
        traces = TraceBatch.from_trace(traces, spec.n_classes)
    if traces.n_clients != spec.n_classes:
        raise ScenarioError(
            "traces", f"trace batch has {traces.n_clients} class columns but "
            f"the spec has {spec.n_classes} classes")
    if traces.n_edges not in (0, spec.n_edges):
        raise ScenarioError(
            "traces", f"trace batch has {traces.n_edges} edge columns but the "
            f"spec has {spec.n_edges} edges")
    if not 0.0 < switch_fraction <= 1.0:
        raise ValueError(f"switch_fraction must be in (0, 1], got {switch_fraction}")
    tail_method = _slo_method(slo_quantile, tail_method)

    cst_np = _mf_arrays(spec)
    t_n, e_n = traces.n_epochs, spec.n_edges
    exo_true = traces.edge_bg_rate if traces.n_edges else \
        np.broadcast_to(cst_np["exo_rate"], (t_n, e_n)).copy()

    dev = resolve_device(device)
    cst = _as_tensors(cst_np, dev)
    lam_ct, bw_ct = _f64(traces.arrival_rate, dev), _f64(traces.bandwidth_Bps, dev)
    exo_t = _f64(exo_true, dev)
    f = _start(spec.n_classes, e_n + 1, dev)
    fractions = torch.empty((t_n,) + tuple(f.shape), dtype=FLOAT, device=dev)
    loads = torch.empty((t_n, e_n), dtype=FLOAT, device=dev)
    lat = torch.empty((t_n, spec.n_classes), dtype=FLOAT, device=dev)
    for t in range(t_n):
        fractions[t] = f
        f, _cost, _stay, lat[t], loads[t] = _mf_step(
            cst, f, lam_ct[t], bw_ct[t], exo_t[t], float(switch_fraction), slo_quantile,
            tail_method)
    loads_np = loads.cpu().numpy()
    lat_np, saturated = clamp_saturation(lat.cpu().numpy(), saturation_penalty_s)
    return MeanFieldResult(
        spec=spec,
        times=np.asarray(traces.times),
        fractions=fractions.cpu().numpy(),
        edge_loads=loads_np,
        rho_edges=_rho_edges(cst_np, loads_np, exo_true),
        latency_s=lat_np,
        saturated_epochs=saturated,
    )


# ---------------------------------------------------------------------------
# the gate: mean-field vs the exact small-N solver
# ---------------------------------------------------------------------------


def cross_check_meanfield(
    spec: MeanFieldSpec,
    *,
    bandwidth_Bps: float | None = None,
    exo_rates: np.ndarray | None = None,
    rho_gate: float = 0.9,
    rho_floor: float = 0.02,
    max_iter: int = 50,
    slo_quantile: float | None = None,
    tail_method: str = "asymptote",
    device=None,
) -> dict:
    """Validate the mean-field fixed point against the exact solver, both on
    ``device`` (default: the card).

    Expands ``spec`` to its exact per-client :class:`ClusterSpec`
    (class-major layout, per-class bandwidth honoured as a per-client
    override), solves both equilibria under identical conditions, and
    compares (a) per-class latencies — the exact solver's class mean vs the
    fraction-weighted mean-field latency — and (b) per-edge processing
    utilizations. Rows above ``rho_gate`` are informational (near saturation
    integer-client granularity dominates), edge rows below ``rho_floor`` too
    (relative error on a near-idle edge is noise); ``gated_max_mape_pct`` is
    what the validation harness holds to 5%."""
    mf = solve_meanfield_equilibrium(
        spec, bandwidth_Bps=bandwidth_Bps, exo_rates=exo_rates,
        slo_quantile=slo_quantile, tail_method=tail_method, device=device)
    cluster = spec.to_cluster()
    bw_clients = np.repeat(spec.bandwidth_Bps(bandwidth_Bps),
                           [c.n_clients for c in spec.classes])
    eq = solve_equilibrium(
        cluster, bandwidth_Bps=bw_clients, exo_rates=exo_rates, max_iter=max_iter,
        slo_quantile=slo_quantile, tail_method=tail_method, device=device)

    idx = spec.class_index()
    rho_by_class_mf = np.array([
        max([mf.rho_edges[j] for j in range(spec.n_edges)
             if mf.fractions[c, j + 1] > 1e-6], default=0.0)
        for c in range(spec.n_classes)
    ])
    classes = []
    for c, cl in enumerate(spec.classes):
        exact_lat = float(np.mean(eq.latency_s[idx == c]))
        mf_lat = float(mf.latency_s[c])
        err_pct = abs(mf_lat - exact_lat) / exact_lat * 100.0
        classes.append({
            "class": cl.name,
            "n_clients": int(cl.n_clients),
            "arrival_rate": float(mf.arrival_rates[c]),
            "rho": float(rho_by_class_mf[c]),
            "meanfield_s": mf_lat,
            "exact_s": exact_lat,
            "mape_pct": err_pct,
            "gated": bool(rho_by_class_mf[c] <= rho_gate),
        })
    edges = []
    for j in range(spec.n_edges):
        exact_rho = float(eq.rho_edges[j])
        mf_rho = float(mf.rho_edges[j])
        err_pct = abs(mf_rho - exact_rho) / exact_rho * 100.0 \
            if exact_rho > 0 else (0.0 if mf_rho == 0 else np.inf)
        edges.append({
            "edge": j,
            "meanfield_rho": mf_rho,
            "exact_rho": exact_rho,
            "mape_pct": err_pct,
            "gated": bool(rho_floor <= exact_rho <= rho_gate),
        })

    gated = [r["mape_pct"] for r in classes + edges if r["gated"]]
    return {
        "classes": classes,
        "edges": edges,
        "meanfield_converged": bool(mf.converged),
        "exact_converged": bool(eq.converged),
        "gated_mean_mape_pct": float(np.mean(gated)) if gated else None,
        "gated_max_mape_pct": float(np.max(gated)) if gated else None,
        "rho_gate": rho_gate,
        "rho_floor": rho_floor,
        "config": {"max_iter": max_iter, "slo_quantile": slo_quantile},
    }
