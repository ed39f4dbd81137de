"""Batched exact Pollaczek-Khinchine quantile inversion, in torch float64
and complex128: the Euler path behind ``fleet_tail(batch, q,
method="euler")``.

Each scenario row's sojourn transform is the product of per-station
Pollaczek-Khinchine transforms (wait factor on the paper's k*mu aggregation,
full service on top), inverted with Abate-Whitt Euler summation on the
27-point contour ``theta_k = (A + 2 pi i k) / (2t)``. The quantile search
is the scalar ``core.tail._quantile_euler`` trajectory, replayed phase for
phase on every row at once:

  * start at ``max(2 * mean, 1e-12)`` and double ``euler_grow_iters(q)``
    times (Markov's inequality caps the q-quantile at ``mean / (1 - q)``);
  * ``EULER_BISECT_ITERS`` bisections, the last below-q point of the growth
    phase as a free lower bracket;
  * ``EULER_NEWTON_ITERS`` safeguarded Newton steps on the free Abate-Whitt
    density (the density's transform is ``T*(theta)`` bare, the CDF's
    ``T*(theta)/theta``: one set of transform evaluations gives both), the
    bisection midpoint whenever the Newton candidate leaves the bracket (a
    candidate on an end of it is a converged iterate and stays, as in the
    port's scalar: ROADMAP C9).

Why the trajectory is shared, not just the CDF: the Euler-inverted CDF of
near-deterministic mixtures carries oscillatory inversion noise of amplitude
~``e^-A`` with wavelength ~``t/(N+M+1)``; near a quantile level it can cross
more than once, and two different-but-correct root finders land on different
crossings. Walking the identical evaluation sequence on a CDF that is
arithmetically the scalar's term for term (one ``exp`` of a selected
exponent equals the scalar's ``exp`` of either branch) keeps the two within
float noise, which the differential harness gates at 1e-8.

Service transforms take static per-slot hints: ``"exp"``/``"nic"`` mean the
slot is exponential in every row (a pure rational LST, no transcendentals;
``"nic"`` also reuses the one LST for the wait factor, since a NIC station
has ``wmean == fmean``), ``"det"`` one complex ``exp``, ``None`` the runtime
dispatch. The hints select formulas, never values.

The loops are Python loops of elementwise passes over (rows, 27) complex128
tensors on the caller's device; no TPU kernel sat on this path and none is
written for it.
"""

from __future__ import annotations

import math

import torch

from ..core.tail import (
    _EULER_WEIGHTS,
    EULER_A,
    EULER_BISECT_ITERS,
    EULER_M,
    EULER_N,
    EULER_NEWTON_ITERS,
    GAMMA_DET_CV2,
    KIND_EXP,
    KIND_GAMMA,
    euler_grow_iters,
)

__all__ = ["cdf_pdf_vec", "quantile_euler_vec"]

_INF = float("inf")
_TINY = 1e-300
_WINDOW = slice(EULER_N, EULER_N + EULER_M + 1)


def _slot_service_lst(kind, mean, var, theta, hint):
    """Complex LST E[e^{-theta S}] of one slot's service distribution
    (``mean == 0`` is the inert factor 1). Without a hint, det and
    degenerate gamma share the exponent ``-theta m`` with real gamma's
    ``-shape log(1 + theta scale)``: one complex exp of the selected
    exponent, the scalar branches' values."""
    if hint in ("exp", "nic"):
        out = 1.0 / (1.0 + theta * mean)
        return torch.where(mean > 0, out, torch.ones_like(out))
    if hint == "det":
        out = torch.exp(-theta * mean)
        return torch.where(mean > 0, out, torch.ones_like(out))
    exp_ = 1.0 / (1.0 + theta * mean)
    gamma_real = var > GAMMA_DET_CV2 * mean * mean
    safe_mean = torch.where(mean > 0, mean, 1.0)
    safe_var = torch.where(gamma_real, var, 1.0)
    shape = safe_mean * safe_mean / safe_var
    scale = safe_var / safe_mean
    use_gamma = (kind == KIND_GAMMA) & gamma_real
    expo = torch.where(use_gamma, -shape * torch.log(1.0 + theta * scale), -theta * mean)
    out = torch.where(kind == KIND_EXP, exp_, torch.exp(expo))
    return torch.where(mean > 0, out, torch.ones_like(out))


def _total_lst_slots(st, theta, slot_kinds):
    """Product of per-slot sojourn transforms ``W* Sf*`` at ``theta``
    (trailing contour axis K). The slot loop is unrolled in Python — S is 1
    (device) or 3 (offload tandem) — so each slot's hint prunes its branches
    on its own."""
    n_slots = st["lam"].shape[-1]
    if slot_kinds is None:
        slot_kinds = (None,) * n_slots
    out = None
    for s in range(n_slots):
        hint = slot_kinds[s]
        lam = st["lam"][..., s, None]
        wmean = st["wmean"][..., s, None]
        rho = lam * wmean
        f = _slot_service_lst(st["fkind"][..., s, None], st["fmean"][..., s, None],
                              st["fvar"][..., s, None], theta, hint)
        if hint == "nic":
            sw = f
        else:
            sw = _slot_service_lst(st["wkind"][..., s, None], wmean,
                                   st["wvar"][..., s, None], theta, hint)
        w = (1.0 - rho) * theta / (theta - lam * (1.0 - sw))
        w = torch.where(rho > 0, w, torch.ones_like(w))
        fac = w * f
        out = fac if out is None else out * fac
    return out


def _implied_var_st(kind, mean, var):
    return torch.where(kind == KIND_EXP, mean * mean,
                       torch.where(kind == KIND_GAMMA, var, 0.0))


def _sojourn_mean_vec(st):
    """Per-path mean: sum of P-K waits + full service means (inf past rho=1)."""
    rho = st["lam"] * st["wmean"]
    v = _implied_var_st(st["wkind"], st["wmean"], st["wvar"])
    w = st["lam"] * (st["wmean"] ** 2 + v) / (2.0 * torch.clamp(1.0 - rho, min=_TINY))
    w = torch.where(rho > 0, torch.where(rho < 1.0, w, _INF), 0.0)
    return torch.sum(w + st["fmean"], dim=-1)


def _contour(t):
    """The contour points (..., K) at ``t`` (...), their alternating half
    weights, the Euler window weights and the ``e^{A/2}/t`` scale."""
    ks = torch.arange(EULER_N + EULER_M + 1, dtype=t.dtype, device=t.device)
    theta = (EULER_A + 2j * math.pi * ks) / (2.0 * t[..., None])
    sign = torch.where(ks == 0, 0.5, 1.0).to(t.dtype) * ((-1.0) ** ks)
    weights = torch.as_tensor(_EULER_WEIGHTS, dtype=t.dtype, device=t.device)
    scale = math.exp(EULER_A / 2.0) / t
    return theta, sign, weights, scale


def cdf_pdf_vec(st, t, slot_kinds=None):
    """(CDF, PDF) of the composed sojourn at ``t``, one contour evaluation.

    The CDF's transform is ``T*(theta)/theta``, the density's ``T*(theta)``
    itself; the PDF is clipped at 0 (inversion noise dips slightly negative
    in flat regions, and the Newton safeguard treats a zero derivative as
    "fall back to bisection")."""
    theta, sign, weights, scale = _contour(t)
    vals = _total_lst_slots(st, theta, slot_kinds)
    cdf_part = torch.cumsum(sign * (vals / theta).real, dim=-1)
    pdf_part = torch.cumsum(sign * vals.real, dim=-1)
    cdf = torch.clamp(scale * (cdf_part[..., _WINDOW] @ weights), 0.0, 1.0)
    pdf = torch.clamp(scale * (pdf_part[..., _WINDOW] @ weights), min=0.0)
    return cdf, pdf


def _cdf_vec(st, t, slot_kinds=None):
    """CDF only: the growth and bisection phases skip the density's cumsum
    and contraction (the cost changes, never the values)."""
    theta, sign, weights, scale = _contour(t)
    vals = _total_lst_slots(st, theta, slot_kinds)
    cdf_part = torch.cumsum(sign * (vals / theta).real, dim=-1)
    return torch.clamp(scale * (cdf_part[..., _WINDOW] @ weights), 0.0, 1.0)


def quantile_euler_vec(st, q: float, slot_kinds=None, grow_iters: int | None = None):
    """q-quantile of the composed sojourn by exact Euler inversion, batched
    over the leading axes of the station fields (station axis last).

    Replays the scalar trajectory (see the module docstring): ``grow_iters``
    doublings (default ``euler_grow_iters(q)``), then the bisections and
    the safeguarded Newton steps. Rows with an infinite mean (an unstable
    station) return inf, as the scalar layer does."""
    if grow_iters is None:
        grow_iters = euler_grow_iters(float(q))
    mean = _sojourn_mean_vec(st)
    finite = torch.isfinite(mean)
    safe_mean = torch.where(finite, mean, 1.0)
    hi0 = torch.clamp(2.0 * safe_mean, min=1e-12)

    hi = hi0
    for _ in range(grow_iters):
        hi = torch.where(_cdf_vec(st, hi, slot_kinds) < q, hi * 2.0, hi)
    # if the bracket grew, the last doubled-from point hi/2 is a known
    # below-q evaluation: one free bisection
    lo = torch.where(hi > hi0, 0.5 * hi, 0.0)

    for _ in range(EULER_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        below = _cdf_vec(st, mid, slot_kinds) < q
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    t = 0.5 * (lo + hi)

    for _ in range(EULER_NEWTON_ITERS):
        cdf, pdf = cdf_pdf_vec(st, t, slot_kinds)
        below = cdf < q
        lo = torch.where(below, t, lo)
        hi = torch.where(below, hi, t)
        step = t - (cdf - q) / torch.where(pdf > 0.0, pdf, 1.0)
        ok = (pdf > 0.0) & (step >= lo) & (step <= hi)
        t = torch.where(ok, step, 0.5 * (lo + hi))
    return torch.where(finite, torch.minimum(torch.maximum(t, lo), hi), _INF)
