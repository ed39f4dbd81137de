"""Batched sojourn-time quantiles over a :class:`ScenarioBatch`, in torch
float64 on the card.

The batched twin of the scalar tail layer in :mod:`repro_torch.core.tail`:
the Pollaczek-Khinchine sojourn transform per station (wait factor on the
paper's k*mu aggregation, full service on top), the Fig. 1 tandem
composition under the independence approximation, Abate-Whitt Euler
inversion for the exact method (:mod:`repro_torch.fleet.euler_vec`), and the
dominant-singularity exponential asymptote as the cheap method the closed
loop prices with. ``fleet_tail(batch, 0.99)`` is to ``Scenario.analytic_tail``
what ``fleet_analytic`` is to ``Scenario.analytic()``; the differential
harness pins the two per row.

The asymptote takes the scalar layer's rule for a dominant pole that does
not stand alone: a row whose second-smallest candidate decay rate lies
within ``POLE_GAP_REL`` of the smallest (identical tandem stations share a
double pole, where the residue formula divides by zero) is gathered and
resolved on the Euler path, beyond ``EULER_Q_MAX`` too, exactly as
``core.tail._quantile_asymptote`` does. Rows with separated poles keep the
reference's arithmetic, and the candidate order (every wait pole, then every
exponential-service pole) breaks exact ties as the scalar breaks them.

Every tensor is float64 (complex128 on the contour), made on the device of
the batch columns; algorithm constants come from ``core.tail``, since the
agreement gates depend on both sides running the identical algorithm. These
are elementwise passes and small reductions; no TPU kernel sat on this path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.tail import (
    ETA_BISECT_ITERS,
    ETA_GROW_ITERS,
    GAMMA_DET_CV2,
    KIND_DET,
    KIND_EXP,
    KIND_GAMMA,
    POLE_GAP_REL,
    euler_grow_iters,
    resolve_tail_method,
)
from ..device import resolve_device
from .analytic_vec import _batch_tensors, _implied_var_vec
from .batch import ScenarioBatch
from .euler_vec import quantile_euler_vec

__all__ = ["FleetTailPrediction", "fleet_tail", "sojourn_quantile_vec"]

_INF = float("inf")
_TINY = 1e-300
STATION_KEYS = ("lam", "wkind", "wmean", "wvar", "fkind", "fmean", "fvar")


# ---------------------------------------------------------------------------
# station-field containers: a dict of tensors, station axis LAST
# (lam, wkind, wmean, wvar, fkind, fmean, fvar) — core.tail.Station, columnar
# ---------------------------------------------------------------------------


def _stack_stations(*stations) -> dict[str, torch.Tensor]:
    """Stack per-station field dicts along a new trailing station axis, every
    field of every station broadcast to one leading shape first."""
    shape = torch.broadcast_shapes(*[s[k].shape for s in stations for k in STATION_KEYS])
    return {k: torch.stack([s[k].expand(shape) for s in stations], dim=-1)
            for k in STATION_KEYS}


# ---------------------------------------------------------------------------
# exponential-tail asymptote — the cheap method the closed loop prices with
# ---------------------------------------------------------------------------


def _mgf_vec(kind, mean, var, eta):
    """Real M_S(eta); garbage (huge finite) past the divergence point, masked
    by the caller. eta broadcasts against the station fields."""
    det = torch.exp(torch.clamp(eta * mean, max=700.0))
    exp_ = 1.0 / torch.clamp(1.0 - eta * mean, min=_TINY)
    gamma_real = var > GAMMA_DET_CV2 * mean * mean
    safe_mean = torch.where(mean > 0, mean, 1.0)
    safe_var = torch.where(gamma_real, var, 1.0)
    shape = safe_mean * safe_mean / safe_var
    scale = safe_var / safe_mean
    gam = torch.exp(torch.clamp(
        -shape * torch.log(torch.clamp(1.0 - eta * scale, min=_TINY)), max=700.0))
    gam = torch.where(gamma_real, gam, det)
    out = torch.where(kind == KIND_DET, det, torch.where(kind == KIND_EXP, exp_, gam))
    return torch.where(mean > 0, out, torch.ones_like(out))


def _mgf_prime_vec(kind, mean, var, eta):
    """M_S'(eta) = E[S e^{eta S}], same conventions as ``_mgf_vec``."""
    det = mean * torch.exp(torch.clamp(eta * mean, max=700.0))
    exp_ = mean / torch.clamp(1.0 - eta * mean, min=_TINY) ** 2
    gamma_real = var > GAMMA_DET_CV2 * mean * mean
    safe_mean = torch.where(mean > 0, mean, 1.0)
    safe_var = torch.where(gamma_real, var, 1.0)
    shape = safe_mean * safe_mean / safe_var
    scale = safe_var / safe_mean
    gam = mean * torch.exp(torch.clamp(
        -(shape + 1.0) * torch.log(torch.clamp(1.0 - eta * scale, min=_TINY)), max=700.0))
    gam = torch.where(gamma_real, gam, det)
    out = torch.where(kind == KIND_DET, det, torch.where(kind == KIND_EXP, exp_, gam))
    return torch.where(mean > 0, out, torch.zeros_like(out))


def _wait_pole_vec(st):
    """Per-station Cramer decay rate (inf where the station never queues) —
    the twin of ``tail._wait_pole``: the exp closed form, otherwise geometric
    growth and fixed-count bisection with identical constants."""
    lam, wkind = st["lam"], st["wkind"]
    wmean, wvar = st["wmean"], st["wvar"]
    rho = lam * wmean
    safe_wmean = torch.where(wmean > 0, wmean, 1.0)
    exp_root = (1.0 - rho) / safe_wmean

    def g(eta):
        return lam * (_mgf_vec(wkind, wmean, wvar, eta) - 1.0) - eta

    # divergence point of the wait-service MGF (det -> inf, capped at 700/m)
    gamma_real = wvar > GAMMA_DET_CV2 * wmean * wmean
    safe_var = torch.where(gamma_real, wvar, 1.0)
    div = torch.where(
        wkind == KIND_EXP, 1.0 / safe_wmean,
        torch.where((wkind == KIND_GAMMA) & gamma_real, wmean / safe_var, _INF))
    cap = torch.minimum(div * (1.0 - 1e-12), 700.0 / safe_wmean)
    hi = torch.minimum(exp_root, cap)
    for _ in range(ETA_GROW_ITERS):
        hi = torch.where(g(hi) <= 0.0, torch.minimum(hi * 2.0, cap), hi)
    lo = torch.zeros_like(hi)
    for _ in range(ETA_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        le = g(mid) <= 0.0
        lo, hi = torch.where(le, mid, lo), torch.where(le, hi, mid)
    root = torch.where(wkind == KIND_EXP, exp_root, 0.5 * (lo + hi))
    return torch.where((lam > 0) & (rho > 0), root, _INF)


def _quantile_asymptote_vec(st, q: float, slot_kinds=None):
    """Quantile from ``P(T > t) ~ (r/eta) e^{-eta t}`` per row; rows whose
    dominant pole is shared within ``POLE_GAP_REL`` go to the Euler path."""
    lam, wmean = st["lam"], st["wmean"]
    rho = lam * wmean
    eta_w = _wait_pole_vec(st)  # (..., S)
    safe_fmean = torch.where(st["fmean"] > 0, st["fmean"], 1.0)
    eta_s = torch.where((st["fkind"] == KIND_EXP) & (st["fmean"] > 0), 1.0 / safe_fmean, _INF)
    cands = torch.cat([eta_w, eta_s], dim=-1)  # wait poles first
    eta, idx = torch.min(cands, dim=-1)  # the first of equal minima, as the scalar's min()
    no_pole = ~torch.isfinite(eta)
    second = torch.topk(cands, 2, dim=-1, largest=False).values[..., 1]
    shared = ~no_pole & (second <= eta * (1.0 + POLE_GAP_REL))
    eta_b = torch.where(no_pole, 1.0, eta)[..., None]

    # per-station factors at the global eta (garbage at the dominant pole's
    # own factor — excluded from the products below by construction)
    m_w = _mgf_vec(st["wkind"], wmean, st["wvar"], eta_b)
    m_f = _mgf_vec(st["fkind"], st["fmean"], st["fvar"], eta_b)
    g = lam * (m_w - 1.0) - eta_b
    w_fac = torch.where(rho > 0, (1.0 - rho) * (-eta_b) / torch.where(
        torch.abs(g) > _TINY, g, -_TINY), 1.0)
    t_fac = torch.abs(w_fac) * m_f
    log_t = torch.log(torch.clamp(t_fac, min=_TINY))
    prod_others = torch.exp(torch.sum(log_t, dim=-1, keepdim=True) - log_t)

    mgf_p = _mgf_prime_vec(st["wkind"], wmean, st["wvar"], eta_b)
    res_wait = (1.0 - rho) * eta_b / (lam * mgf_p - 1.0) * m_f * prod_others
    res_serv = (1.0 / safe_fmean) * torch.abs(w_fac) * prod_others
    r_cands = torch.cat([res_wait, res_serv], dim=-1)
    r = torch.take_along_dim(r_cands, idx[..., None], dim=-1)[..., 0]

    eta0 = eta_b[..., 0]
    t_q = torch.log(torch.clamp(r, min=_TINY) / (eta0 * (1.0 - q))) / eta0
    t_q = torch.where((r > 0) & torch.isfinite(r), torch.clamp(t_q, min=0.0), _INF)
    out = torch.where(no_pole, torch.sum(st["fmean"], dim=-1), t_q)
    # a shared dominant pole is no simple pole: those rows take the Euler
    # path (the scalar's rule; unstable rows are overwritten by the caller)
    unstable = torch.any(rho >= 1.0, dim=-1)
    pick = shared & ~unstable
    if bool(pick.any()):
        out = out.clone()
        rows = {k: v[pick] for k, v in st.items()}
        out[pick] = quantile_euler_vec(rows, q, slot_kinds, euler_grow_iters(q))
    return out


def sojourn_quantile_vec(st: dict, q: float, *, method: str = "euler",
                         slot_kinds: tuple | None = None,
                         grow_iters: int | None = None):
    """q-quantile of the composed sojourn for station-field tensors (station
    axis last).

    ``slot_kinds`` is an optional tuple of per-slot service-kind hints for
    the Euler path (see :mod:`repro_torch.fleet.euler_vec`); ``grow_iters``
    its bracket-doubling count (default ``euler_grow_iters(q)``). The
    asymptote's shared-pole rows take the Euler path with the hints and
    ``euler_grow_iters(q)``."""
    unstable = torch.any(st["lam"] * st["wmean"] >= 1.0, dim=-1)
    if method == "asymptote":
        val = _quantile_asymptote_vec(st, q, slot_kinds)
    elif method == "euler":
        val = quantile_euler_vec(st, q, slot_kinds, grow_iters)
    else:
        raise ValueError(f"unknown method {method!r} (known: euler, asymptote)")
    # exact closed form for a pure single M/M/1 station (both methods), as in
    # the scalar layer: t_q = -ln(1-q)/(mu - lam)
    if st["lam"].shape[-1] == 1:
        lam = st["lam"][..., 0]
        mean = st["fmean"][..., 0]
        is_mm1 = ((st["wkind"][..., 0] == KIND_EXP) & (st["fkind"][..., 0] == KIND_EXP)
                  & (st["wmean"][..., 0] == mean) & (mean > 0))
        safe_mean = torch.where(mean > 0, mean, 1.0)
        exact = -math.log1p(-q) / (1.0 / safe_mean - lam)
        val = torch.where(is_mm1, exact, val)
    return torch.where(unstable, _INF, val)


# ---------------------------------------------------------------------------
# ScenarioBatch-column station builders (shared with fleet.cluster)
# ---------------------------------------------------------------------------


def _device_stations(c) -> dict:
    """(B, 1) station fields for the on-device path — Eq. 2's single queue."""
    return _stack_stations({
        "lam": c["lam"],
        "wkind": c["dev_model"],
        "wmean": c["dev_s"] / c["dev_k"],
        "wvar": c["dev_var"],
        "fkind": c["dev_model"],
        "fmean": c["dev_s"],
        "fvar": c["dev_var"],
    })


def _edge_stations(c) -> dict:
    """(B, E, 3) station fields for the offload path: device NIC -> edge proc
    (own model, or the §3.4 gamma-matched mixture when background tenants are
    present) -> return NIC. Mirrors ``analytic_vec._edge_latency_vec`` so the
    tail and mean evaluations can never drift on inputs."""
    lam = c["lam"][:, None]
    has_bg = c["bg_lam"] > 0.0

    own_var = _implied_var_vec(c["edge_model"], c["edge_s"], c["edge_var"])
    lam_tot = lam + c["bg_lam"]
    mean_mix = (lam * c["edge_s"] + c["bg_wsum"]) / lam_tot
    second_mix = (lam * (own_var + c["edge_s"] ** 2) + c["bg_ssum"]) / lam_tot
    var_mix = torch.clamp(second_mix - mean_mix**2, min=0.0)

    b = torch.where(torch.isnan(c["edge_bw"]), c["bandwidth_Bps"][:, None], c["edge_bw"])
    req = c["req_bytes"][:, None]
    res = c["res_bytes"][:, None]
    lam_edge = torch.where(has_bg, lam_tot, lam * torch.ones_like(lam_tot))
    ret = c["return_results"][:, None]
    res_mean = torch.where(ret, res / b, 0.0)

    kexp = torch.full_like(c["edge_model"], KIND_EXP)
    zero = torch.zeros_like(c["edge_s"])
    proc_kind = torch.where(has_bg, KIND_GAMMA, c["edge_model"])
    nic_in = {"lam": lam * torch.ones_like(c["edge_s"]), "wkind": kexp,
              "wmean": req / b, "wvar": zero, "fkind": kexp, "fmean": req / b,
              "fvar": zero}
    proc = {"lam": lam_edge, "wkind": proc_kind,
            "wmean": torch.where(has_bg, mean_mix, c["edge_s"]) / c["edge_k"],
            "wvar": torch.where(has_bg, var_mix, c["edge_var"]),
            "fkind": proc_kind,
            "fmean": torch.where(has_bg, mean_mix, c["edge_s"]),
            "fvar": torch.where(has_bg, var_mix, c["edge_var"])}
    nic_out = {"lam": lam_edge, "wkind": kexp, "wmean": res_mean, "wvar": zero,
               "fkind": kexp, "fmean": res_mean, "fvar": zero}
    return _stack_stations(nic_in, proc, nic_out)


def _device_tail_vec(c, q: float, method: str, grow_iters: int | None = None,
                     dev_hint: str | None = None):
    """(B,) on-device q-quantile — the tail twin of ``_device_latency_vec``."""
    return sojourn_quantile_vec(_device_stations(c), q, method=method,
                                slot_kinds=(dev_hint,), grow_iters=grow_iters)


def _edge_tail_vec(c, q: float, method: str, grow_iters: int | None = None,
                   proc_hint: str | None = None):
    """(B, E) offload q-quantile — the tail twin of ``_edge_latency_vec``.
    The NIC slots are exponential with ``wmean == fmean`` by construction
    (``nic_station``), so they take the ``"nic"`` hint; the processing slot
    takes the batch-derived ``proc_hint`` or the runtime dispatch."""
    val = sojourn_quantile_vec(_edge_stations(c), q, method=method,
                               slot_kinds=("nic", proc_hint, "nic"),
                               grow_iters=grow_iters)
    return torch.where(c["edge_mask"], val, _INF)


def _uniform_kind_hint(kinds: np.ndarray) -> str | None:
    """Service-kind hint for a concrete model column: ``"det"`` / ``"exp"``
    when every row dispatches to the same branch (sweeps vary load, not
    service model), else None (runtime dispatch). The hints select formulas,
    never change them."""
    k = np.asarray(kinds)
    if k.size and np.all(k == KIND_DET):
        return "det"
    if k.size and np.all(k == KIND_EXP):
        return "exp"
    return None


@dataclass(frozen=True)
class FleetTailPrediction:
    """Per-scenario closed-form q-quantile latencies of one fleet evaluation.

    Mirrors :class:`FleetPrediction` (same ``best_edge`` convention, same
    ``totals`` labelling), but every number is the q-th sojourn quantile
    instead of the mean — the batch form of ``Scenario.analytic_tail``.
    """

    q: float
    t_dev: np.ndarray  # (B,)
    t_edge: np.ndarray  # (B, E)
    best_edge: np.ndarray  # (B,) int

    @property
    def size(self) -> int:
        return int(self.t_dev.shape[0])

    def strategy_names(self) -> list[str]:
        return ["on_device" if j < 0 else f"edge[{j}]"
                for j in self.best_edge.tolist()]

    def totals(self, i: int) -> dict[str, float]:
        out = {"on_device": float(self.t_dev[i])}
        for j in range(self.t_edge.shape[1]):
            out[f"edge[{j}]"] = float(self.t_edge[i, j])
        return out


def fleet_tail(batch: ScenarioBatch, q: float, *, method: str = "euler",
               device=None) -> FleetTailPrediction:
    """q-quantile end-to-end latency of every scenario and strategy, on
    ``device`` (default: the card) — per row the number
    ``Scenario.analytic_tail(q, method=...)`` gives."""
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {q}")
    if method not in ("euler", "asymptote"):
        raise ValueError(f"unknown method {method!r} (known: euler, asymptote)")
    method = resolve_tail_method(q, method)
    grow_iters = euler_grow_iters(q) if method == "euler" else None
    np_arrays = batch.arrays()
    dev_hint = _uniform_kind_hint(np_arrays["dev_model"])
    proc_hint = None
    if not np.any(np.asarray(np_arrays["bg_lam"]) > 0.0):
        proc_hint = _uniform_kind_hint(np_arrays["edge_model"])
    c = _batch_tensors(batch, resolve_device(device))
    t_dev = _device_tail_vec(c, q, method, grow_iters, dev_hint)
    t_edge = _edge_tail_vec(c, q, method, grow_iters, proc_hint)
    stacked = torch.cat([t_dev[:, None], t_edge], dim=1)
    best = torch.argmin(stacked, dim=1) - 1  # the first of equal minima: on-device wins ties
    return FleetTailPrediction(q=q, t_dev=t_dev.cpu().numpy(), t_edge=t_edge.cpu().numpy(),
                               best_edge=best.cpu().numpy())
