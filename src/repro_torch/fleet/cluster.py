"""Closed-loop multi-client edge-cluster simulation (the paper's §6 setting
at fleet scale), in torch float64 on the card.

``repro_torch.fleet.replay`` scores ONE client against exogenous traces —
nothing that client does changes the load anyone else observes. A real
multi-tenant edge deployment is coupled: when a client offloads, its stream
joins the chosen edge's aggregate, every other client's model of that edge
worsens, and their next decisions shift load elsewhere. This module closes
that loop for N clients sharing E edge servers over T epochs:

  * every epoch, every client decides on-device vs offload(e) with exactly
    the §4.2 estimator path the scalar :class:`AdaptiveOffloadManager.step`
    runs — EWMA bandwidth and edge-load reports, a sliding-window arrival
    estimate over Poisson counts — transcribed to (N,)/(N, E) tensors; the
    decide step itself (first-argmin, hysteresis, cohort gate) is one launch
    of the hand-written ``decision_scan`` kernel;
  * the per-edge background load is *endogenous*: the offloaders' arrival
    rates superpose (``multitenant.mixture_moments``, §3.4) on top of any
    exogenous background from the trace, and the resulting loads are what
    next epoch's estimators observe;
  * per-client expected latency under the TRUE conditions is evaluated with
    the ``analytic_vec`` closed forms over all T*N client-epochs at once;
  * :func:`solve_equilibrium` finds the fixed point of the decision->load
    map under constant conditions, and :func:`cross_check_equilibrium`
    validates the closed-loop analytic means against the event-driven
    simulators.

``slo_quantile`` switches decisions and true-condition scoring from expected
latencies to the q-quantile of each path's closed-form sojourn distribution
(:mod:`repro_torch.fleet.tail_vec`; ``tail_method="asymptote"`` by default,
the cheap dominant-singularity form, or ``"euler"``, the exact inversion).

Every tensor is float64 (``FLOAT``, passed explicitly; torch's default dtype
is never touched) on ``device`` (default: the card).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Mapping, Sequence

import numpy as np
import torch

from ..core.latency import NetworkPath
from ..core.manager import ON_DEVICE
from ..core.multitenant import TenantStream, mixture_moments
from ..core.scenario import ClusterSpec, Scenario, ScenarioError
from ..core.scenario import analytic as scalar_analytic
from ..core.scenario import implied_service_var
from ..core.simulation import steady_slice
from ..core.tail import KIND_EXP, KIND_GAMMA, euler_grow_iters, resolve_tail_method
from ..device import resolve_device
from ..kernels.decision_scan.ops import decision_scan
from .analytic_vec import (
    FLOAT,
    _device_latency_vec,
    _edge_latency_vec,
    _implied_var_vec,
    _proc_wait_vec,
    mg1_wait_vec,
    mm1_wait_vec,
)
from .batch import MODEL_CODES, ScenarioBatch
from .policy import bg_template, clamp_saturation, parse_policy
from .sim_vec import simulate_fleet
from .tail_vec import _device_tail_vec, _edge_tail_vec, _stack_stations, sojourn_quantile_vec
from .traces import Trace, TraceBatch

__all__ = [
    "ClusterPolicyResult",
    "ClusterResult",
    "Equilibrium",
    "simulate_cluster",
    "solve_equilibrium",
    "induced_scenario",
    "cross_check_equilibrium",
    "predict_decisions",
    "predict_terms",
]


# client-epochs the SLO scoring evaluates at once (each at its chosen target:
# a three-station tandem, or the device's one station). The Euler path carries each row over a 27-point
# complex128 contour, the asymptote over 144 root-finding steps; these keep
# either near 10 GB of temporaries, far inside one 80 GB card.
TAIL_ROWS_PER_CHUNK = {"euler": 1 << 19, "asymptote": 1 << 22}


def _slo_method(slo_quantile: float | None, tail_method: str) -> str:
    """Validate ``slo_quantile`` and resolve the tail method it is priced by
    (Euler hands off to the asymptote past ``EULER_Q_MAX``)."""
    if slo_quantile is None:
        return tail_method
    if not 0.0 < slo_quantile < 1.0:
        raise ValueError(f"slo_quantile must be in (0, 1), got {slo_quantile}")
    if tail_method not in ("euler", "asymptote"):
        raise ValueError(f"unknown tail_method {tail_method!r} (known: euler, asymptote)")
    return resolve_tail_method(slo_quantile, tail_method)


# ---------------------------------------------------------------------------
# static spec arrays
# ---------------------------------------------------------------------------


def _spec_arrays(spec: ClusterSpec) -> dict[str, np.ndarray]:
    """The client-independent columns every cluster evaluation consumes."""
    base = spec.base
    e_n = spec.n_edges
    edge_s = np.array([e.tier.service_time_s for e in base.edges])
    templates = [bg_template(base, j) for j in range(e_n)]
    return {
        "lam_spec": spec.arrival_rates(),  # (N,)
        "req_bytes": np.float64(base.workload.req_bytes),
        "res_bytes": np.float64(base.workload.res_bytes),
        "return_results": np.bool_(base.return_results),
        "dev_s": np.float64(base.device.service_time_s),
        "dev_k": np.float64(base.device.parallelism_k),
        "dev_var": np.float64(base.device.service_var),
        "dev_model": np.int8(MODEL_CODES[base.device.service_model]),
        "edge_s": edge_s,
        "edge_k": np.array([e.tier.parallelism_k for e in base.edges]),
        "edge_var": np.array([e.tier.service_var for e in base.edges]),
        "edge_model": np.array(
            [MODEL_CODES[e.tier.service_model] for e in base.edges], dtype=np.int8),
        "edge_bw": np.array(
            [np.nan if e.bandwidth_Bps is None else e.bandwidth_Bps
             for e in base.edges]),
        # endogenous template: what one unit of *cluster* load looks like on
        # edge j — the shared workload's own service moments there
        "endo_mean": edge_s,
        "endo_var": np.array([implied_service_var(e.tier) for e in base.edges]),
        # exogenous template: the spec's declared background mixture, whose
        # rate the trace churns while the service moments hold (cf. replay)
        "exo_rate": np.array([t[0] for t in templates]),
        "exo_mean": np.array([t[1] for t in templates]),
        "exo_var": np.array([t[2] for t in templates]),
    }


def _as_tensors(cst: Mapping[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """Floats as float64, the bool as bool, service-model codes as int8."""
    out = {}
    for k, v in cst.items():
        v = np.asarray(v)
        dtype = FLOAT if v.dtype.kind == "f" else None
        out[k] = torch.as_tensor(v, dtype=dtype, device=device)
    return out


def _f64(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=FLOAT, device=device)


# ---------------------------------------------------------------------------
# Algorithm 1 over (N, E) tensors — the manager's prediction path, transcribed
# ---------------------------------------------------------------------------


def _bg_moments(cst, endo, exo):
    """The (bg_lam, bg_wsum, bg_ssum) background columns from endogenous and
    exogenous per-edge rates, each expanded with its own service template —
    THE mixture-moment expansion, shared by the prediction path, the decision
    loop, and the truth-scoring tables so the three can never drift apart.
    ``endo``/``exo`` broadcast against the (E,) templates."""
    bg_lam = endo + exo
    bg_wsum = endo * cst["endo_mean"] + exo * cst["exo_mean"]
    bg_ssum = endo * (cst["endo_var"] + cst["endo_mean"] ** 2) + exo * (
        cst["exo_var"] + cst["exo_mean"] ** 2)
    return bg_lam, bg_wsum, bg_ssum


def _predict_terms_vec(cst, lam_hat, bw_hat, bg_lam, bg_wsum, bg_ssum):
    """The per-term decomposition behind :func:`_predict_vec`, keyed exactly
    like ``LatencyBreakdown`` (w_proc_dev/s_dev; w_net_dev/n_req/w_proc_edge/
    s_edge/w_net_edge/n_res) — device terms (N,), edge terms (N, E). The
    totals are DERIVED from these by ordered summation."""
    shape = torch.broadcast_shapes(lam_hat.shape + (1,), bg_lam.shape)
    w_proc_dev = _proc_wait_vec(
        cst["dev_model"], lam_hat, cst["dev_s"], cst["dev_var"], cst["dev_k"])
    s_dev = cst["dev_s"].expand(lam_hat.shape)

    own_var = _implied_var_vec(cst["edge_model"], cst["edge_s"], cst["edge_var"])
    lam = lam_hat[:, None]
    lam_tot = lam + bg_lam
    mean_mix = (lam * cst["edge_s"] + bg_wsum) / lam_tot
    second = (lam * (own_var + cst["edge_s"] ** 2) + bg_ssum) / lam_tot
    var_mix = torch.clamp(second - mean_mix**2, min=0.0)
    w_proc_edge = mg1_wait_vec(lam_tot, 1.0 / mean_mix, var_mix, cst["edge_k"]).expand(shape)

    b = torch.where(torch.isnan(cst["edge_bw"]), bw_hat[:, None], cst["edge_bw"])
    w_net_dev = mm1_wait_vec(lam, b / cst["req_bytes"]).expand(shape)
    n_req = (cst["req_bytes"] / b).expand(shape)
    use_res = cst["return_results"] & (cst["res_bytes"] > 0)
    w_net_edge = torch.where(use_res, mm1_wait_vec(lam_tot, b / cst["res_bytes"]), 0.0)
    n_res = torch.where(use_res, (cst["res_bytes"] / b).expand(shape), 0.0)
    return {
        "w_proc_dev": w_proc_dev,
        "s_dev": s_dev,
        "w_net_dev": w_net_dev,
        "n_req": n_req,
        "w_proc_edge": w_proc_edge,
        "s_edge": cst["edge_s"].expand(shape),
        "w_net_edge": w_net_edge,
        "n_res": n_res,
    }


def _sum_terms(terms):
    """(t_dev, t_edge) from the term dict — LatencyBreakdown's exact
    summation order (matches the scalar manager's ordered sum)."""
    t_dev = terms["w_proc_dev"] + terms["s_dev"]
    t_edge = (terms["w_net_dev"] + terms["n_req"] + terms["w_proc_edge"]
              + terms["s_edge"] + terms["w_net_edge"] + terms["n_res"])
    return t_dev, t_edge


def _predict_vec(cst, lam_hat, bw_hat, bg_lam, bg_wsum, bg_ssum):
    """(N,) t_dev and (N, E) t_edge exactly as ``AdaptiveOffloadManager.step``
    computes them from the same estimates (Alg. 1 lines 1-6): the device via
    its service-model dispatch, each edge as M/G/1 on the aggregate mixture
    (own stream folded in) with the OWN service time on line 6."""
    return _sum_terms(
        _predict_terms_vec(cst, lam_hat, bw_hat, bg_lam, bg_wsum, bg_ssum))


def _predict_tail_vec(cst, lam_hat, bw_hat, bg_lam, bg_wsum, bg_ssum, q: float,
                      method: str, grow_iters: int | None = None):
    """The q-quantile twin of :func:`_predict_vec`: the station composition an
    SLO-mode ``AdaptiveOffloadManager`` prices (device NIC -> aggregate-mixture
    M/G/1 wait + OWN service -> return NIC), over (N, E)."""
    n = lam_hat.shape[0]
    e_n = cst["edge_s"].shape[0]
    t_dev = sojourn_quantile_vec(_stack_stations({
        "lam": lam_hat,
        "wkind": cst["dev_model"],
        "wmean": cst["dev_s"] / cst["dev_k"],
        "wvar": cst["dev_var"],
        "fkind": cst["dev_model"],
        "fmean": cst["dev_s"],
        "fvar": cst["dev_var"],
    }), q, method=method, slot_kinds=(None,), grow_iters=grow_iters)

    own_var = _implied_var_vec(cst["edge_model"], cst["edge_s"], cst["edge_var"])
    lam = lam_hat[:, None]
    lam_tot = lam + bg_lam
    mean_mix = (lam * cst["edge_s"] + bg_wsum) / lam_tot
    second = (lam * (own_var + cst["edge_s"] ** 2) + bg_ssum) / lam_tot
    var_mix = torch.clamp(second - mean_mix**2, min=0.0)

    b = torch.where(torch.isnan(cst["edge_bw"]), bw_hat[:, None], cst["edge_bw"])
    req_mean = cst["req_bytes"] / b
    use_res = cst["return_results"] & (cst["res_bytes"] > 0)
    res_mean = torch.where(use_res, cst["res_bytes"] / b, 0.0)
    shape = (n, e_n)
    kexp = torch.full(shape, KIND_EXP, dtype=torch.int8, device=lam_hat.device)
    kgam = torch.full(shape, KIND_GAMMA, dtype=torch.int8, device=lam_hat.device)
    zero = torch.zeros(shape, dtype=FLOAT, device=lam_hat.device)
    stations = _stack_stations(
        {"lam": lam, "wkind": kexp, "wmean": req_mean, "wvar": zero,
         "fkind": kexp, "fmean": req_mean, "fvar": zero},
        {"lam": lam_tot, "wkind": kgam, "wmean": mean_mix / cst["edge_k"],
         "wvar": var_mix, "fkind": kgam, "fmean": cst["edge_s"], "fvar": var_mix},
        {"lam": lam_tot, "wkind": kexp, "wmean": res_mean, "wvar": zero,
         "fkind": kexp, "fmean": res_mean, "fvar": zero},
    )
    t_edge = sojourn_quantile_vec(stations, q, method=method, slot_kinds=("nic", None, "nic"),
                                  grow_iters=grow_iters)
    return t_dev, t_edge


def _tail_grow_iters(slo_quantile: float, tail_method: str) -> int | None:
    """Bracket-doubling count of the Euler tail path (None for the asymptote)."""
    return euler_grow_iters(slo_quantile) if tail_method == "euler" else None


def _price(cst, lam_hat, bw_hat, bg, slo_quantile, tail_method):
    """(t_dev, t_edge) the managers decide on: means, or q-quantiles."""
    if slo_quantile is None:
        return _predict_vec(cst, lam_hat, bw_hat, *bg)
    return _predict_tail_vec(cst, lam_hat, bw_hat, *bg, slo_quantile, tail_method,
                             _tail_grow_iters(slo_quantile, tail_method))


def _stacked(t_dev, t_edge):
    """(1, N, E+1) costs, column 0 on-device: one epoch for ``decision_scan``."""
    return torch.cat([t_dev[:, None], t_edge], dim=1)[None]


def _estimates(spec: ClusterSpec, cst, lam_hat, bandwidth_hat, endo_hat, exo_hat):
    """Estimate inputs as float64 tensors; non-positive arrival estimates fall
    back to the client's spec rate, exactly like the closed loop."""
    dev = cst["lam_spec"].device
    lam_hat = torch.atleast_1d(_f64(lam_hat, dev))
    if lam_hat.shape[0] != spec.n_clients:
        raise ScenarioError(
            "n_clients", f"expected {spec.n_clients} per-client estimates, "
            f"got {lam_hat.shape[0]}")
    lam_hat = torch.where(lam_hat > 0, lam_hat, cst["lam_spec"])
    bw_hat = _f64(bandwidth_hat, dev).expand(lam_hat.shape)
    endo = _f64(endo_hat, dev).reshape(lam_hat.shape[0], spec.n_edges)
    exo = _f64(exo_hat, dev).reshape(spec.n_edges)
    return (lam_hat, bw_hat) + _bg_moments(cst, endo, exo[None, :])


def predict_decisions(
    spec: ClusterSpec,
    lam_hat,
    bandwidth_hat,
    endo_hat,
    exo_hat,
    *,
    prev_choice=None,
    hysteresis: float = 0.0,
    slo_quantile: float | None = None,
    tail_method: str = "asymptote",
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One epoch of cluster decisions from explicit estimates, on ``device``
    (default: the card).

    ``lam_hat``/``bandwidth_hat`` are (N,) per-client estimates, ``endo_hat``
    the (N, E) estimated *other-client* load per edge, ``exo_hat`` the (E,)
    estimated exogenous background. Returns ``(choices, t_dev, t_edge)`` —
    the same numbers ``AdaptiveOffloadManager.step`` produces client by
    client from identical inputs. Non-positive arrival estimates fall back to
    the client's spec rate, exactly like the closed-loop scan. The decision
    is one ``decision_scan`` launch: hysteresis against ``prev_choice``
    applies when it is given (global epoch 1 of a one-cohort scan), never
    otherwise (epoch 0). With ``slo_quantile`` the costs are q-quantiles by
    ``tail_method``."""
    tail_method = _slo_method(slo_quantile, tail_method)
    cst = _as_tensors(_spec_arrays(spec), resolve_device(device))
    lam_hat, bw_hat, *bg = _estimates(spec, cst, lam_hat, bandwidth_hat, endo_hat, exo_hat)
    t_dev, t_edge = _price(cst, lam_hat, bw_hat, bg, slo_quantile, tail_method)
    n = spec.n_clients
    cohort = torch.zeros(n, dtype=torch.int32, device=t_dev.device)
    if prev_choice is None:
        prev, t0 = None, 0
    else:
        prev = torch.as_tensor(np.asarray(prev_choice, dtype=np.int32).reshape(n),
                               device=t_dev.device)
        t0 = 1
    choice = decision_scan(_stacked(t_dev, t_edge), cohort, hysteresis=float(hysteresis),
                           stagger=1, prev=prev, t0=t0)[0]
    return choice.cpu().numpy(), t_dev.cpu().numpy(), t_edge.cpu().numpy()


def predict_terms(
    spec: ClusterSpec,
    lam_hat,
    bandwidth_hat,
    endo_hat,
    exo_hat,
    *,
    device=None,
) -> dict[str, np.ndarray]:
    """The per-term decomposition behind one epoch of (mean-mode) cluster
    decisions — ``predict_decisions``' totals, shown working, on ``device``
    (default: the card).

    Same estimate inputs and fallback semantics as :func:`predict_decisions`.
    Returns LatencyBreakdown-keyed arrays — device terms ``w_proc_dev``/
    ``s_dev`` (N,), edge terms ``w_net_dev``/``n_req``/``w_proc_edge``/
    ``s_edge``/``w_net_edge``/``n_res`` (N, E) — plus their ordered sums
    ``t_dev`` (N,) and ``t_edge`` (N, E), which match ``predict_decisions``
    bit for bit on identical inputs (both are ``_sum_terms`` over
    ``_predict_terms_vec``)."""
    cst = _as_tensors(_spec_arrays(spec), resolve_device(device))
    terms = _predict_terms_vec(cst, *_estimates(spec, cst, lam_hat, bandwidth_hat,
                                                endo_hat, exo_hat))
    t_dev, t_edge = _sum_terms(terms)
    out = {k: v.cpu().numpy() for k, v in terms.items()}
    out["t_dev"] = t_dev.cpu().numpy()
    out["t_edge"] = t_edge.cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# the closed decision loop: a Python loop over epochs, one kernel launch each
# ---------------------------------------------------------------------------


def _closed_loop(cst, cohort, bw_true, lam_true, exo_true, n_req_all, *, window: int,
                 stagger: int, dt: float, bw_alpha: float, bg_alpha: float,
                 hysteresis: float, shards: int = 1, slo_quantile: float | None = None,
                 tail_method: str = "asymptote"):
    """Decisions, loads and estimates of the adaptive policy over all T
    epochs, for the (possibly padded) client axis of ``lam_true``.

    Carry: per-client EWMA bandwidth, the sliding-window ring of per-epoch
    Poisson arrival counts, per-client EWMA estimates of the *other* clients'
    per-edge load (fed by last epoch's reports — the closed loop's one-epoch
    information lag), the shared EWMA exogenous-load estimate, and the
    previous decision (hysteresis).

    The epochs run as a Python loop, and each epoch's decide step and cohort
    gate is one ``decision_scan`` launch with ``t0`` = the epoch and ``prev``
    = the carry. The kernel cannot take all T epochs at once here: the costs
    of epoch t depend on the choices of epoch t-1 through the endogenous-load
    reports. ``stagger`` desynchronizes the control epochs: client i
    re-decides only on epochs where ``t % stagger == cohort_i`` and holds its
    previous target in between.

    Within an epoch every per-client quantity is elementwise in the client
    axis; the ONLY cross-client coupling is the endogenous-load total. With
    ``shards > 1`` that total is summed per block of N / shards clients and
    then over the blocks (the single-card twin of the reference's sharded
    scan: the same math, the sum re-associated). With ``slo_quantile`` the
    managers price q-quantiles instead of means."""
    t_n, n = lam_true.shape
    e_n = exo_true.shape[1]
    dev = lam_true.device
    edges = torch.arange(e_n, device=dev)

    est_bw = torch.zeros(n, dtype=FLOAT, device=dev)
    counts = torch.zeros((n, window), dtype=FLOAT, device=dev)
    est_endo = torch.zeros((n, e_n), dtype=FLOAT, device=dev)
    est_exo = torch.zeros(e_n, dtype=FLOAT, device=dev)
    prev = torch.full((n,), ON_DEVICE, dtype=torch.int32, device=dev)
    # the rate window's span as a 0-d tensor on the loop's device: CUDA divides
    # a tensor by a Python scalar as a multiply by its reciprocal, which can
    # round one ulp away from the CPU's true division; by a device tensor it
    # divides, so the card's estimates equal the CPU's bit for bit
    span = torch.tensor(window * dt, dtype=FLOAT, device=dev)

    choices = torch.empty((t_n, n), dtype=torch.int32, device=dev)
    endo_totals = torch.empty((t_n, e_n), dtype=FLOAT, device=dev)
    bw_out = torch.empty((t_n, n), dtype=FLOAT, device=dev)
    lam_out = torch.empty((t_n, n), dtype=FLOAT, device=dev)
    endo_out = torch.empty((t_n, n, e_n), dtype=FLOAT, device=dev)
    exo_out = torch.empty((t_n, e_n), dtype=FLOAT, device=dev)

    for idx in range(t_n):
        first = idx == 0
        bw_t, lam_t, exo_t = bw_true[idx], lam_true[idx], exo_true[idx]

        # -- telemetry (§4.2): estimators, never raw instantaneous values --
        est_bw = bw_t if first else bw_alpha * bw_t + (1 - bw_alpha) * est_bw
        est_exo = exo_t if first else bg_alpha * exo_t + (1 - bg_alpha) * est_exo
        counts[:, idx % window] = n_req_all[idx]
        rate = counts.sum(dim=1) / span
        lam_hat = torch.where(rate > 0, rate, cst["lam_spec"])

        # -- Algorithm 1 on the estimated state (means or q-quantiles), then
        # one decision launch --
        bg = _bg_moments(cst, est_endo, est_exo[None, :])
        t_dev, t_edge = _price(cst, lam_hat, est_bw, bg, slo_quantile, tail_method)
        choice = decision_scan(_stacked(t_dev, t_edge), cohort, hysteresis=hysteresis,
                               stagger=stagger, prev=prev, t0=idx)[0]

        # -- the loop closes: decisions become next epoch's edge loads -----
        off = choice[:, None] == edges[None, :]
        own = torch.where(off, lam_t[:, None], 0.0)
        if shards == 1:
            endo_total = own.sum(dim=0)
        else:
            endo_total = own.reshape(shards, n // shards, e_n).sum(dim=1).sum(dim=0)
        report = endo_total[None, :] - own

        choices[idx] = choice
        endo_totals[idx] = endo_total
        bw_out[idx] = est_bw
        lam_out[idx] = lam_hat
        endo_out[idx] = est_endo
        exo_out[idx] = est_exo
        est_endo = report if first else bg_alpha * report + (1 - bg_alpha) * est_endo
        prev = choice
    return choices, endo_totals, bw_out, lam_out, endo_out, exo_out


def _pad_clients(cst, bw_true, lam_true, n_req, pad: int):
    """Append ``pad`` inert dummy clients so the client axis splits evenly
    into shards. A dummy has TRUE arrival rate 0 — zero counts and zero
    contribution to every endogenous sum — so its presence is exact, not
    approximate; its spec-rate fallback is a harmless 1 rps (its decisions
    are computed and discarded). Padding happens after the counts are drawn,
    so real clients' draws are untouched."""
    if pad == 0:
        return cst, bw_true, lam_true, n_req
    cst = dict(cst)
    cst["lam_spec"] = torch.cat([cst["lam_spec"], cst["lam_spec"].new_ones(pad)])

    def padcols(a, fill):
        return torch.cat([a, a.new_full((a.shape[0], pad), fill)], dim=1)

    return cst, padcols(bw_true, 1.0), padcols(lam_true, 0.0), padcols(n_req, 0.0)


# ---------------------------------------------------------------------------
# true-condition scoring: the analytic_vec closed forms over all T*N epochs
# ---------------------------------------------------------------------------


def _truth_batch(cst, lam_true, bw_true, exo_true, choices):
    """The (T*N)-row ScenarioBatch-style column dict of every client-epoch
    under the TRUE conditions, with the endogenous aggregate minus the
    client's own contribution at its chosen edge as background. Columns that
    are the same in every row are broadcast views, not copies."""
    t_n, n = lam_true.shape
    e_n = exo_true.shape[1]
    edges = torch.arange(e_n, device=lam_true.device)
    off = choices[..., None] == edges[None, None, :]
    own = torch.where(off, lam_true[..., None], 0.0)
    endo_total = torch.sum(own, dim=1)  # (T, E)
    bg_other = endo_total[:, None, :] - own  # (T, N, E)
    del own
    bg_lam, bg_wsum, bg_ssum = _bg_moments(cst, bg_other, exo_true[:, None, :])
    del bg_other
    b = t_n * n

    def rows(v):  # (B,) broadcast of a scalar column
        return v.expand(b)

    def table(v):  # (B, E) broadcast of an (E,) column
        return v.expand(b, e_n)

    c = {
        "lam": lam_true.reshape(b),
        "req_bytes": rows(cst["req_bytes"]),
        "res_bytes": rows(cst["res_bytes"]),
        "bandwidth_Bps": bw_true.reshape(b),
        "return_results": rows(cst["return_results"]),
        "dev_s": rows(cst["dev_s"]),
        "dev_k": rows(cst["dev_k"]),
        "dev_var": rows(cst["dev_var"]),
        "dev_model": rows(cst["dev_model"]),
        "edge_mask": torch.ones((1, 1), dtype=torch.bool, device=lam_true.device).expand(b, e_n),
        "edge_s": table(cst["edge_s"]),
        "edge_k": table(cst["edge_k"]),
        "edge_var": table(cst["edge_var"]),
        "edge_model": table(cst["edge_model"]),
        "edge_bw": table(cst["edge_bw"]),
        "bg_lam": bg_lam.reshape(b, e_n),
        "bg_wsum": bg_wsum.reshape(b, e_n),
        "bg_ssum": bg_ssum.reshape(b, e_n),
    }
    return c, endo_total


def _latency_tables(cst, lam_true, bw_true, exo_true, choices):
    """(T, N) t_dev and (T, N, E) t_edge expected latency under the TRUE
    conditions — one batched ``_edge_latency_vec`` call over T*N rows."""
    t_n, n = lam_true.shape
    e_n = exo_true.shape[1]
    c, endo_total = _truth_batch(cst, lam_true, bw_true, exo_true, choices)
    t_dev = _device_latency_vec(c).reshape(t_n, n)
    t_edge = _edge_latency_vec(c).reshape(t_n, n, e_n)
    return t_dev, t_edge, endo_total


def _latency_tables_tail(cst, lam_true, bw_true, exo_true, choices, q: float,
                         tail_method: str):
    """The q-quantile twin of :func:`_latency_tables` (analytic semantics:
    the mixture mean as s_edge, exactly like ``_edge_tail_vec``), for the
    equilibrium's one epoch; the closed loop scores only the chosen targets
    (:func:`_score_chosen_tail`)."""
    t_n, n = lam_true.shape
    e_n = exo_true.shape[1]
    grow = _tail_grow_iters(q, tail_method)
    c, endo_total = _truth_batch(cst, lam_true, bw_true, exo_true, choices)
    t_dev = _device_tail_vec(c, q, tail_method, grow).reshape(t_n, n)
    t_edge = _edge_tail_vec(c, q, tail_method, grow).reshape(t_n, n, e_n)
    return t_dev, t_edge, endo_total


def _score_chosen_tail(cst, lam_true, bw_true, exo_true, choices, q: float, tail_method: str):
    """(T, N) true-condition q-quantile of every client-epoch at the target it
    chose, and the (T, E) endogenous loads.

    Each value is the entry of :func:`_latency_tables_tail`'s table the
    client sits at, evaluated alone: the background at the chosen edge is
    the same ``endo_total - own`` and the same mixture expansion, and a
    quantile is a per-row computation, so scoring one target per row
    instead of all E + 1 changes no value. Rows go in chunks of
    ``TAIL_ROWS_PER_CHUNK``."""
    t_n, n = lam_true.shape
    e_n = exo_true.shape[1]
    edges = torch.arange(e_n, device=lam_true.device)
    own = torch.where(choices[..., None] == edges[None, None, :], lam_true[..., None], 0.0)
    endo_total = torch.sum(own, dim=1)  # (T, E)
    del own
    grow = _tail_grow_iters(q, tail_method)
    step = TAIL_ROWS_PER_CHUNK[tail_method]
    lam = lam_true.reshape(-1)
    bw = bw_true.reshape(-1)
    choice = choices.reshape(-1).long()
    lat = torch.empty_like(lam)
    rows = torch.arange(t_n * n, device=lam.device)
    dev_rows, edge_rows = rows[choice < 0], rows[choice >= 0]
    for r in torch.split(dev_rows, step):
        c = {"lam": lam[r]} | {k: cst[k].expand(r.shape[0])
                              for k in ("dev_s", "dev_k", "dev_var", "dev_model")}
        lat[r] = _device_tail_vec(c, q, tail_method, grow)
    for r in torch.split(edge_rows, step):
        t, j = r // n, choice[r]
        g = {k: cst[k][j] for k in ("endo_mean", "endo_var", "exo_mean", "exo_var")}
        bg = _bg_moments(g, endo_total[t, j] - lam[r], exo_true[t, j])
        per_row = {"lam": lam[r], "bandwidth_Bps": bw[r]} | {
            k: cst[k].expand(r.shape[0]) for k in ("req_bytes", "res_bytes", "return_results")}
        per_edge = {k: cst[k][j] for k in ("edge_s", "edge_k", "edge_var", "edge_model",
                                           "edge_bw")}
        per_edge |= dict(zip(("bg_lam", "bg_wsum", "bg_ssum"), bg))
        per_edge["edge_mask"] = torch.ones_like(r, dtype=torch.bool)
        c = per_row | {k: v[:, None] for k, v in per_edge.items()}  # E = 1: the chosen edge
        lat[r] = _edge_tail_vec(c, q, tail_method, grow)[:, 0]
    return lat.reshape(t_n, n), endo_total


def _score_assignment(cst, lam_true, bw_true, exo_true, choices, slo_quantile=None,
                      tail_method: str = "asymptote") -> tuple[np.ndarray, np.ndarray]:
    """True-condition latency of every (epoch, client) under ``choices``
    ((T, N) int32 on the device) — the mean, or the q-quantile when
    ``slo_quantile`` is set — and the (T, E) endogenous loads."""
    if slo_quantile is not None:
        lat, endo_total = _score_chosen_tail(cst, lam_true, bw_true, exo_true, choices,
                                             slo_quantile, tail_method)
        return lat.cpu().numpy(), endo_total.cpu().numpy()
    t_dev, t_edge, endo_total = _latency_tables(cst, lam_true, bw_true, exo_true, choices)
    stacked = torch.cat([t_dev[:, :, None], t_edge], dim=2)
    del t_edge
    lat = torch.take_along_dim(stacked, (choices.long() + 1)[..., None], dim=2)[..., 0]
    return lat.cpu().numpy(), endo_total.cpu().numpy()


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClusterPolicyResult:
    """One policy's scored trajectory through the cluster replay."""

    name: str
    latencies_s: np.ndarray  # (T, N) true-condition latency per client-epoch
    choices: np.ndarray  # (T, N) per-epoch target (ON_DEVICE for local)
    edge_loads: np.ndarray  # (T, E) endogenous offloaded rate per edge
    saturated_epochs: int  # client-epochs clamped at the saturation penalty

    @property
    def mean_latency_s(self) -> float:
        return float(np.mean(self.latencies_s))

    @property
    def per_client_mean_s(self) -> np.ndarray:
        return self.latencies_s.mean(axis=0)

    @property
    def switches(self) -> int:
        """Total decision changes across all clients (flapping metric)."""
        return int(np.sum(self.choices[1:] != self.choices[:-1]))

    @property
    def offload_frac(self) -> float:
        return float(np.mean(self.choices >= 0))


@dataclass(frozen=True)
class ClusterResult:
    """Closed-loop replay outcome: per-policy scores + estimator trajectories."""

    spec: ClusterSpec
    traces: TraceBatch
    policies: dict[str, ClusterPolicyResult]
    est_bandwidth_Bps: np.ndarray  # (T, N) EWMA view the managers acted on
    est_arrival_rate: np.ndarray  # (T, N) sliding-window view
    est_endo_rate: np.ndarray  # (T, N, E) estimated other-client load per edge
    est_exo_rate: np.ndarray  # (T, E) estimated exogenous background

    @property
    def client_epochs(self) -> int:
        return int(self.traces.n_epochs * self.traces.n_clients)

    @property
    def adaptive_wins(self) -> bool:
        """§6 criterion: adaptive mean <= every static policy's mean."""
        a = self.policies["adaptive"].mean_latency_s
        return all(
            a <= p.mean_latency_s for n, p in self.policies.items() if n != "adaptive"
        )


def simulate_cluster(
    spec: ClusterSpec,
    traces: TraceBatch | Trace,
    *,
    policies: Sequence[str] = ("adaptive", "on_device", "edge[0]"),
    seed: int = 0,
    n_req=None,
    bw_alpha: float = 0.5,
    bg_alpha: float = 0.5,
    rate_window_epochs: int = 5,
    saturation_penalty_s: float = 30.0,
    hysteresis: float = 0.0,
    stagger: int = 1,
    shards: int = 1,
    slo_quantile: float | None = None,
    tail_method: str = "asymptote",
    device=None,
    tracer=None,
) -> ClusterResult:
    """Drive N clients through the trace batch with the loop closed, on
    ``device`` (default: the card).

    The adaptive policy runs the vectorized Algorithm-1 path per client per
    epoch (decisions feed the loads the estimators see next epoch), one
    ``decision_scan`` launch per epoch; every policy — adaptive and the
    all-clients statics — is then scored under the TRUE conditions with one
    batched ``analytic_vec`` evaluation over all T*N client-epochs, with the
    same bounded saturation penalty the scalar replay applies. ``stagger``
    spreads clients over k staggered decision cohorts (see ``_closed_loop``);
    leave it at 1 for fully synchronous control.

    ``n_req`` gives the per-epoch Poisson arrival counts (T, N); without it
    they are drawn on the device with ``torch.poisson`` from a generator
    seeded with ``seed``. (The reference draws them from a ``jax.random``
    chain that torch cannot replay; its tests hand both packages the same
    counts this way.)

    ``shards`` splits the client axis into that many blocks for the
    endogenous-load sum, padding with inert zero-rate dummies when it does
    not divide N: decisions match ``shards=1`` exactly, float outputs to the
    re-association of that one sum. The decide step runs over every client
    at once either way.

    ``slo_quantile`` switches decisions AND true-condition scoring from
    expected latencies to q-quantiles (``tail_method``, the asymptote by
    default); the scoring then evaluates each client-epoch's quantile at the
    target it chose only.

    ``tracer`` (a ``repro_torch.obs.Tracer``) gets one fleet-wide ``decide``
    span per epoch of the adaptive policy (clients offloaded and on-device,
    mean scored latency), built on the host from the choices and latencies
    the loop already copied there: it adds no launch and no device read."""
    if isinstance(traces, Trace):
        traces = TraceBatch.from_trace(traces, spec.n_clients)
    if traces.n_clients != spec.n_clients:
        raise ScenarioError(
            "traces", f"trace batch has {traces.n_clients} client columns but "
            f"the cluster has {spec.n_clients} clients")
    if traces.n_edges not in (0, spec.n_edges):
        raise ScenarioError(
            "traces", f"trace batch has {traces.n_edges} edge columns but the "
            f"cluster has {spec.n_edges} edges")
    if rate_window_epochs < 1:
        raise ValueError("rate_window_epochs must be >= 1")
    if not 1 <= stagger <= spec.n_clients:
        raise ValueError(f"stagger must be in [1, n_clients], got {stagger}")
    if not 1 <= shards <= spec.n_clients:
        raise ValueError(f"shards must be in [1, n_clients], got {shards}")
    tail_method = _slo_method(slo_quantile, tail_method)

    dev = resolve_device(device)
    cst_np = _spec_arrays(spec)
    t_n, e_n = traces.n_epochs, spec.n_edges
    # a trace without edge columns means "no churn", not "no tenants" (cf.
    # replay): the spec's declared exogenous rates hold every epoch
    exo_np = traces.edge_bg_rate if traces.n_edges else \
        np.broadcast_to(cst_np["exo_rate"], (t_n, e_n)).copy()

    static_targets = {
        name: parse_policy(name, e_n) for name in policies if name != "adaptive"
    }

    cst = _as_tensors(cst_np, dev)
    bw = _f64(traces.bandwidth_Bps, dev)
    lam = _f64(traces.arrival_rate, dev)
    exo = _f64(exo_np, dev)

    results: dict[str, ClusterPolicyResult] = {}
    est_bw = est_lam = est_endo = est_exo = None
    if "adaptive" in policies:
        if n_req is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            counts = torch.poisson(lam * traces.epoch_s, generator=gen)
        else:
            counts = _f64(n_req, dev)
            if tuple(counts.shape) != (t_n, spec.n_clients):
                raise ValueError(f"n_req must be ({t_n}, {spec.n_clients}), got "
                                 f"{tuple(counts.shape)}")
        n_pad = spec.n_clients + (-spec.n_clients) % shards
        cst_p, bw_p, lam_p, counts_p = _pad_clients(cst, bw, lam, counts,
                                                    n_pad - spec.n_clients)
        cohort = (torch.arange(n_pad, device=dev) % stagger).to(torch.int32)
        choice_t, _loads, bw_e, lam_e, endo_e, exo_e = _closed_loop(
            cst_p, cohort, bw_p, lam_p, exo, counts_p, window=int(rate_window_epochs),
            stagger=int(stagger), dt=float(traces.epoch_s), bw_alpha=float(bw_alpha),
            bg_alpha=float(bg_alpha), hysteresis=float(hysteresis), shards=int(shards),
            slo_quantile=slo_quantile, tail_method=tail_method)
        keep = spec.n_clients
        choice_t = choice_t[:, :keep].contiguous()
        est_bw, est_lam = bw_e[:, :keep].cpu().numpy(), lam_e[:, :keep].cpu().numpy()
        est_endo, est_exo = endo_e[:, :keep].cpu().numpy(), exo_e.cpu().numpy()
        del endo_e
        lat, loads = _score_assignment(cst, lam, bw, exo, choice_t, slo_quantile, tail_method)
        lat, saturated = clamp_saturation(lat, saturation_penalty_s)
        choices = choice_t.cpu().numpy()
        results["adaptive"] = ClusterPolicyResult("adaptive", lat, choices, loads, saturated)
        if tracer is not None:
            # per-epoch fleet-aggregate decide spans, stamped on the trace clock
            dt = float(traces.epoch_s)
            for t in range(t_n):
                offloaded = int(np.sum(choices[t] >= 0))
                tracer.span(
                    t=t * dt, dur=dt, name="decide", cat="decide",
                    track="cluster", epoch=t, offloaded=offloaded,
                    on_device=int(choices.shape[1] - offloaded),
                    mean_latency_s=float(np.mean(lat[t])))

    for name, tgt in static_targets.items():
        choices = torch.full((t_n, spec.n_clients), tgt, dtype=torch.int32, device=dev)
        lat, loads = _score_assignment(cst, lam, bw, exo, choices, slo_quantile, tail_method)
        lat, saturated = clamp_saturation(lat, saturation_penalty_s)
        results[name] = ClusterPolicyResult(name, lat, choices.cpu().numpy(), loads,
                                            saturated)

    t_shape = (t_n, spec.n_clients)
    return ClusterResult(
        spec=spec,
        traces=traces,
        policies=results,
        est_bandwidth_Bps=est_bw if est_bw is not None else np.zeros(t_shape),
        est_arrival_rate=est_lam if est_lam is not None else np.zeros(t_shape),
        est_endo_rate=est_endo if est_endo is not None else np.zeros((*t_shape, e_n)),
        est_exo_rate=est_exo if est_exo is not None else np.zeros((t_n, e_n)),
    )


# ---------------------------------------------------------------------------
# fixed-point equilibrium under constant conditions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Equilibrium:
    """A fixed point of the decision -> load -> decision map.

    Carries the operating conditions it was solved under (per-client arrival
    rates and bandwidths, exogenous edge rates) so downstream consumers —
    the event-driven cross-check above all — evaluate exactly the system the
    fixed point belongs to, overrides included."""

    choices: np.ndarray  # (N,) per-client target at the fixed point
    iterations: int  # best-response evaluations performed
    converged: bool
    oscillation: bool  # True when damped switching had to engage
    latency_s: np.ndarray  # (N,) analytic per-client latency at the fixed point
    edge_loads: np.ndarray  # (E,) endogenous offloaded rate per edge
    rho_edges: np.ndarray  # (E,) processing utilization incl. exogenous load
    arrival_rates: np.ndarray  # (N,) the rates the fixed point was solved at
    bandwidth_Bps: np.ndarray  # (N,) per-client shared-path bandwidth used
    exo_rates: np.ndarray  # (E,) exogenous background rates used

    @property
    def mean_latency_s(self) -> float:
        return float(np.mean(self.latency_s))

    @property
    def max_latency_s(self) -> float:
        """Worst per-client latency at the fixed point — the number an SLO
        constrains. With ``slo_quantile`` set at solve time, ``latency_s``
        holds per-client quantiles, so this is the worst client's quantile."""
        return float(np.max(self.latency_s))

    def meets_slo(self, slo_s: float) -> bool:
        """Feasibility predicate the provisioning solver bisects over: a
        converged fixed point whose worst client is within the budget.
        Non-convergence counts as infeasible — an oscillating assignment has
        no per-client latency anyone can promise."""
        return bool(self.converged and self.max_latency_s <= slo_s)

    def counts(self) -> dict[str, int]:
        """Clients per target, keyed like ``Decision.target_name``."""
        out = {"on_device": int(np.sum(self.choices == ON_DEVICE))}
        for j in range(len(self.edge_loads)):
            out[f"edge[{j}]"] = int(np.sum(self.choices == j))
        return out


def solve_equilibrium(
    spec: ClusterSpec,
    *,
    bandwidth_Bps: float | np.ndarray | None = None,
    arrival_rates: np.ndarray | None = None,
    exo_rates: np.ndarray | None = None,
    max_iter: int = 20,
    slo_quantile: float | None = None,
    tail_method: str = "asymptote",
    device=None,
) -> Equilibrium:
    """Iterate decisions -> loads to a fixed point under constant conditions,
    on ``device`` (default: the card).

    Clients best-respond synchronously with perfect information (the true
    closed forms, no estimator lag): each synchronous step is one
    ``decision_scan`` launch (argmin - 1, no hysteresis). When the decision
    vector revisits a previous state — the classic cycle where a crowd
    stampedes onto the cheapest edge, saturates it, and stampedes off again —
    the solver switches to *damped* tie-breaking: one sequential
    best-response sweep per iteration (clients move one at a time in index
    order against the live assignment, argmin ties broken deterministically
    toward on-device / the lowest edge index; a host argmin over one row per
    client). Each damped move strictly lowers the mover's latency given the
    others, so the dynamics descend a congestion potential instead of
    oscillating; a sweep with no moves is the fixed point.

    With ``slo_quantile`` set, clients best-respond on q-quantiles
    (``tail_method``) instead of means, and ``latency_s`` reports each
    client's quantile at the fixed point."""
    tail_method = _slo_method(slo_quantile, tail_method)
    n, e_n = spec.n_clients, spec.n_edges
    dev = resolve_device(device)
    cst_np = _spec_arrays(spec)
    lam = np.asarray(arrival_rates, dtype=np.float64) if arrival_rates is not None \
        else spec.arrival_rates()
    if lam.shape != (n,):
        raise ScenarioError("arrival_rates", f"expected shape ({n},), got {lam.shape}")
    bw_default = float(np.asarray(spec.base.network.bandwidth_Bps))
    bw = np.broadcast_to(
        np.asarray(bw_default if bandwidth_Bps is None else bandwidth_Bps,
                   dtype=np.float64), (n,)).copy()
    exo = np.asarray(exo_rates, dtype=np.float64) if exo_rates is not None \
        else cst_np["exo_rate"].copy()
    if exo.shape != (e_n,):
        raise ScenarioError("exo_rates", f"expected shape ({e_n},), got {exo.shape}")

    cst = _as_tensors(cst_np, dev)
    lam_t, bw_t, exo_t = _f64(lam[None, :], dev), _f64(bw[None, :], dev), _f64(exo[None, :], dev)
    cohort = torch.zeros(n, dtype=torch.int32, device=dev)

    def tables(ch: np.ndarray) -> torch.Tensor:
        """(1, N, E+1) true-condition costs under the assignment ``ch``."""
        choices = torch.as_tensor(ch[None, :], dtype=torch.int32, device=dev)
        if slo_quantile is None:
            t_dev, t_edge, _ = _latency_tables(cst, lam_t, bw_t, exo_t, choices)
        else:
            t_dev, t_edge, _ = _latency_tables_tail(cst, lam_t, bw_t, exo_t, choices,
                                                    slo_quantile, tail_method)
        return _stacked(t_dev[0], t_edge[0])

    choices = np.full(n, ON_DEVICE, dtype=np.int32)
    seen = {choices.tobytes()}
    damped = False
    converged = False
    iterations = 0

    stacked = tables(choices)
    while iterations < max_iter:
        iterations += 1
        if not damped:
            best = decision_scan(stacked, cohort)[0].cpu().numpy()
            if np.array_equal(best, choices):
                converged = True
                break
            if best.tobytes() in seen:
                damped = True  # oscillation: fall back to damped sweeps
                continue
            seen.add(best.tobytes())
            choices = best
            stacked = tables(choices)
        else:
            # one sequential sweep: each client best-responds against the
            # LIVE assignment, so no two clients can stampede together
            moved = False
            host = stacked[0].cpu().numpy()
            for i in range(n):
                b_i = int(np.argmin(host[i])) - 1
                if b_i != choices[i]:
                    choices[i] = b_i
                    moved = True
                    stacked = tables(choices)
                    host = stacked[0].cpu().numpy()
            if not moved:
                converged = True
                break

    # every exit path above leaves `stacked` consistent with `choices`
    latency = stacked[0].cpu().numpy()[np.arange(n), choices + 1]
    off = choices[:, None] == np.arange(e_n)[None, :]
    endo = np.where(off, lam[:, None], 0.0).sum(axis=0)

    # processing utilization of the realized aggregate mixture per edge
    rates = np.concatenate([np.where(off, lam[:, None], 0.0), exo[None, :]], axis=0)
    means = np.concatenate([
        np.broadcast_to(cst_np["endo_mean"], (n, e_n)), cst_np["exo_mean"][None, :]
    ], axis=0)
    variances = np.concatenate([
        np.broadcast_to(cst_np["endo_var"], (n, e_n)), cst_np["exo_var"][None, :]
    ], axis=0)
    lam_tot, mean_mix, _ = mixture_moments(rates.T, means.T, variances.T)
    rho = lam_tot * mean_mix / cst_np["edge_k"]

    return Equilibrium(
        choices=choices,
        iterations=iterations,
        converged=converged,
        oscillation=damped,
        latency_s=latency,
        edge_loads=endo,
        rho_edges=rho,
        arrival_rates=lam,
        bandwidth_Bps=bw,
        exo_rates=exo,
    )


# ---------------------------------------------------------------------------
# event-driven cross-check (the differential pattern, closed-loop)
# ---------------------------------------------------------------------------


def induced_scenario(
    spec: ClusterSpec,
    choices: np.ndarray,
    i: int,
    *,
    bandwidth_Bps: float | None = None,
    arrival_rates: np.ndarray | None = None,
    exo_rates: np.ndarray | None = None,
    allow_unstable: bool = False,
    name: str | None = None,
) -> Scenario:
    """Client ``i``'s open-loop equivalent of a cluster assignment.

    The other clients' realized offload streams become explicit background
    ``TenantStream``s on their chosen edges — one stream PER client, not one
    pre-aggregated lump, because each client owns its device NIC: lumping 47
    two-rps uplinks into one 94-rps stream would saturate the simulator's
    single per-stream NIC and silently throttle + smooth the load the edge
    sees (the analytic mixture is identical either way; the event-driven
    arrival process is not). The induced spec then runs through every
    open-loop path unchanged: ``analytic()``, ``simulate()``, the validation
    corpus.

    ``exo_rates`` overrides the exogenous background: the spec's declared
    per-edge streams are replaced by one template stream at the given rate
    (the same re-expansion a churned trace gets). ``None`` keeps the spec's
    streams verbatim — preferable when they apply, because the simulator
    gives every background stream its own device NIC."""
    choices = np.asarray(choices, dtype=np.int64).reshape(spec.n_clients)
    lam = np.asarray(arrival_rates, dtype=np.float64) if arrival_rates is not None \
        else spec.arrival_rates()
    base = spec.base
    cst = _spec_arrays(spec)

    edges = []
    for j, e in enumerate(base.edges):
        if exo_rates is None:
            bg = e.background
        elif exo_rates[j] > 0:
            bg = (TenantStream(
                arrival_rate=float(exo_rates[j]),
                service_mean_s=float(cst["exo_mean"][j]),
                service_var=float(cst["exo_var"][j]),
                name="exogenous",
            ),)
        else:
            bg = ()
        for c in range(spec.n_clients):
            if c != i and choices[c] == j:
                bg = bg + (TenantStream(
                    arrival_rate=float(lam[c]),
                    service_mean_s=float(cst["endo_mean"][j]),
                    service_var=float(cst["endo_var"][j]),
                    name=f"cluster-client[{c}]",
                ),)
        edges.append(replace(e, background=bg))

    return Scenario(
        workload=replace(base.workload, arrival_rate=float(lam[i])),
        device=base.device,
        network=base.network if bandwidth_Bps is None
        else NetworkPath(float(bandwidth_Bps)),
        edges=tuple(edges),
        return_results=base.return_results,
        allow_unstable=allow_unstable,
        name=name or f"{spec.name}-client{i}",
    )


def cross_check_equilibrium(
    spec: ClusterSpec,
    eq: Equilibrium,
    *,
    n: int = 120_000,
    seed: int = 0,
    rho_gate: float = 0.9,
    device=None,
) -> dict:
    """Validate the closed-loop analytic means against event-driven simulation.

    The operating point — per-client arrival rates and bandwidths, exogenous
    edge rates — comes from the :class:`Equilibrium` itself, so overrides
    passed to :func:`solve_equilibrium` are honoured and the simulated system
    is exactly the one the fixed point belongs to. Clients are grouped by
    (target, arrival rate, bandwidth) — within a group every client is
    statistically identical, so one representative simulation per group
    covers the fleet. On-device groups run through the batched Lindley
    simulator (``simulate_fleet`` on ``device``, default: the card);
    offloading groups run the scalar shared-station multi-tenant simulator
    on the representative's *induced* scenario (the other offloaders as
    background streams), observing the representative's own stream. Groups
    whose bottleneck utilization exceeds ``rho_gate`` are reported but not
    gated."""
    lam = eq.arrival_rates
    # spec-default exogenous rates keep the spec's own per-stream background
    # (each stream gets its own NIC in the sim); overridden rates are
    # re-expanded through the template
    exo = None if np.array_equal(eq.exo_rates, _spec_arrays(spec)["exo_rate"]) \
        else eq.exo_rates
    choices = eq.choices

    def induced(i: int) -> Scenario:
        return induced_scenario(
            spec, choices, i,
            bandwidth_Bps=float(eq.bandwidth_Bps[i]),
            arrival_rates=lam,
            exo_rates=exo,
            allow_unstable=True,
        )

    groups: dict[tuple[int, float, float], list[int]] = {}
    for i in range(spec.n_clients):
        groups.setdefault(
            (int(choices[i]), float(lam[i]), float(eq.bandwidth_Bps[i])), []
        ).append(i)

    reports = []
    dev_members = [(key, members[0]) for key, members in groups.items()
                   if key[0] == ON_DEVICE]

    # -- on-device groups: one batched simulation -----------------------------
    dev_means: dict[tuple[int, float, float], float] = {}
    if dev_members:
        batch = ScenarioBatch.from_scenarios([induced(i) for _, i in dev_members])
        res = simulate_fleet(batch, "on_device", n=n, seed=seed, device=device)
        steady = res.latencies[:, steady_slice(n)]
        for row, (key, _i) in enumerate(dev_members):
            dev_means[key] = float(steady[row].mean())

    for key, members in sorted(groups.items()):
        tgt, lam_i, _bw_i = key
        rep = members[0]
        scn = induced(rep)
        strategy = "on_device" if tgt == ON_DEVICE else f"edge[{tgt}]"
        pred = float(np.asarray(scalar_analytic(scn).totals()[strategy]))
        if tgt == ON_DEVICE:
            rho = lam_i * scn.device.service_time_s / scn.device.parallelism_k
            sim_mean = dev_means[key]
        else:
            e = scn.edges[tgt]
            b = float(np.asarray(scn.network_for(e).bandwidth_Bps))
            agg = e.aggregate(scn.workload)
            rhos = [lam_i * scn.workload.req_bytes / b,
                    agg.arrival_rate * agg.service_mean_s / e.tier.parallelism_k]
            if scn.return_results and scn.workload.res_bytes > 0:
                rhos.append(agg.arrival_rate * scn.workload.res_bytes / b)
            rho = float(max(rhos))
            res = scn.simulate(strategy, n=n, seed=seed + rep)
            sim_mean = res.stream_mean(0) if res.stream_ids is not None else res.mean
        err_pct = abs(pred - sim_mean) / sim_mean * 100.0
        reports.append({
            "target": strategy,
            "n_clients": len(members),
            "arrival_rate": lam_i,
            "rho": rho,
            "analytic_s": pred,
            "sim_mean_s": sim_mean,
            "mape_pct": err_pct,
            "gated": bool(rho <= rho_gate),
        })

    gated = [r["mape_pct"] for r in reports if r["gated"]]
    return {
        "groups": reports,
        "n_groups": len(reports),
        "gated_mean_mape_pct": float(np.mean(gated)) if gated else None,
        "gated_max_mape_pct": float(np.max(gated)) if gated else None,
        "rho_gate": rho_gate,
        "config": {"n": n, "seed": seed},
    }
