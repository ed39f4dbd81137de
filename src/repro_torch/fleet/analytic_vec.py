"""Batched closed forms over a :class:`ScenarioBatch`, in torch float64.

Vectorized transcription of exactly the scalar path in
``repro_torch.core.latency`` / ``multitenant`` / ``scenario``: M/D/1, M/M/1
and M/G/1 (P-K) waits with the paper's k*mu aggregation, the Eq. 1/2
end-to-end compositions, the §3.4 multi-tenant mixture (own stream folded
into the stored background sums at evaluation time), and batched bisection
for crossover points. One call evaluates the whole fleet on the card, every
row within 1e-9 relative of ``scenario.analytic()`` on the same spec.

All arithmetic is float64 (``FLOAT``, passed explicitly to every tensor this
module makes; torch's default dtype is never touched): arrival rates and
bandwidths span nine decades, and the crossover bisection resolves roots to
the last bits. Unstable operating points yield ``inf``, exactly as the scalar
layer does. These are elementwise closed forms, so the library's own
elementwise kernels carry them; no TPU kernel sat on this path.

An exact Erlang-C M/M/k wait (``mmk_wait_erlang_vec``) rides along as the
batched counterpart of the scalar Erlang-C oracle that the paper's k*mu
aggregation is scored against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .batch import ScenarioBatch

__all__ = [
    "FLOAT",
    "FleetPrediction",
    "FleetCrossover",
    "fleet_analytic",
    "fleet_crossover",
    "mm1_wait_vec",
    "md1_wait_vec",
    "mg1_wait_vec",
    "mmk_wait_erlang_vec",
]

FLOAT = torch.float64
_INF = float("inf")


def _batch_tensors(batch: ScenarioBatch, device) -> dict[str, torch.Tensor]:
    """The batch's columns as tensors on ``device``: floats as float64, the
    bool masks as bool, the service-model codes as int64."""
    out = {}
    for name, arr in batch.arrays().items():
        if arr.dtype == np.bool_:
            out[name] = torch.as_tensor(arr, device=device)
        elif np.issubdtype(arr.dtype, np.integer):
            out[name] = torch.as_tensor(arr.astype(np.int64), device=device)
        else:
            out[name] = torch.as_tensor(arr, dtype=FLOAT, device=device)
    return out


def _stable_where(lam, effective_mu, value):
    """inf wherever the queue is unstable — mirrors latency._stable_where."""
    ok = (lam < effective_mu) & (effective_mu > 0) & (lam >= 0)
    return torch.where(ok, value, _INF)


def mm1_wait_vec(lam, mu):
    """Paper Eq. 7: E[w] = 1/(mu - lam) - 1/mu."""
    w = 1.0 / (mu - lam) - 1.0 / mu
    return _stable_where(lam, mu, w)


def md1_wait_vec(lam, mu, k=1.0):
    """Paper Eq. 6: M/D/k via aggregated-rate M/D/1."""
    kmu = mu * k
    w = 0.5 * (1.0 / (kmu - lam) - 1.0 / kmu)
    return _stable_where(lam, kmu, w)


def mg1_wait_vec(lam, mu, var_s, k=1.0):
    """Paper Eq. 11: P-K M/G/1 wait with aggregated service rate k*mu."""
    kmu = mu * k
    rho = lam / kmu
    w = (rho + lam * kmu * var_s) / (2.0 * (kmu - lam))
    return _stable_where(lam, kmu, w)


def mmk_wait_erlang_vec(lam, mu, k, *, max_k: int = 64, device=None):
    """Exact M/M/k wait (Erlang C), batched over integer server counts.

    The per-row sum over n < k is evaluated as a masked sum to ``max_k``
    terms, so heterogeneous k across the batch stays one pass. Takes
    array-likes (broadcast together) and returns a float64 numpy array of
    their broadcast shape, computed on ``device`` (default: the card).
    """
    dev = resolve_device(device)
    lam_np = np.asarray(lam, dtype=np.float64)
    mu_np = np.asarray(mu, dtype=np.float64)
    k_np = np.asarray(k, dtype=np.float64)
    if np.max(k_np) > max_k:
        raise ValueError(
            f"k={np.max(k_np)} exceeds max_k={max_k}; raise max_k or the "
            "truncated Erlang-B sum would be silently wrong")
    out_shape = np.broadcast_shapes(lam_np.shape, mu_np.shape, k_np.shape)

    def t(a):
        return torch.as_tensor(np.atleast_1d(a), dtype=FLOAT, device=dev)

    lam_t, mu_t, k_t = torch.broadcast_tensors(t(lam_np), t(mu_np), t(k_np))
    a = lam_t / mu_t  # offered load in Erlangs
    rho = a / k_t
    n = torch.arange(max_k, dtype=FLOAT, device=dev)
    log_n = torch.log(torch.clamp(n, min=1.0))
    log_fact = torch.cumsum(log_n, 0)  # log(n!) since log(0!) = log(1) = 0
    # sum_{n<k} a^n/n!, a^k/k! — in log space for numeric range
    log_a = torch.log(a)
    log_terms = n * log_a[..., None] - log_fact
    mask = n < k_t[..., None]
    summation = torch.sum(torch.where(mask, torch.exp(log_terms), 0.0), dim=-1)
    log_fact_km1 = torch.sum(torch.where(mask, log_n, 0.0), dim=-1)  # log((k-1)!)
    last = torch.exp(k_t * log_a - (log_fact_km1 + torch.log(k_t))) / (1.0 - rho)
    p_wait = last / (summation + last)
    w = torch.where(lam_t == 0.0, 0.0, p_wait / (k_t * mu_t - lam_t))
    out = _stable_where(lam_t, k_t * mu_t, w)
    return out.cpu().numpy().reshape(out_shape)


def _proc_wait_vec(model, lam, s, var, k):
    """Processing-queue wait, dispatching on the MODEL_CODES integer —
    the vectorized twin of ``latency.proc_wait``."""
    mu = 1.0 / s
    w_det = md1_wait_vec(lam, mu, k)
    w_exp = mm1_wait_vec(lam, mu * k)
    w_gen = mg1_wait_vec(lam, mu, var, k)
    return torch.where(model == 0, w_det, torch.where(model == 1, w_exp, w_gen))


def _implied_var_vec(model, s, var):
    """Var[s] implied by the service model (scenario.implied_service_var)."""
    return torch.where(model == 1, s * s, torch.where(model == 2, var, 0.0))


def _edge_latency_vec(c):
    """(B, E) end-to-end offload latency per edge — Eq. 1, with the §3.4
    mixture re-parameterisation wherever an edge hosts background tenants."""
    lam = c["lam"][:, None]
    has_bg = c["bg_lam"] > 0.0

    # mixture moments of background + the scenario's own stream (exactly
    # aggregate_streams: weighted mean, law-of-total-variance second moment)
    own_var = _implied_var_vec(c["edge_model"], c["edge_s"], c["edge_var"])
    lam_tot = lam + c["bg_lam"]
    mean_mix = (lam * c["edge_s"] + c["bg_wsum"]) / lam_tot
    second_mix = (lam * (own_var + c["edge_s"] ** 2) + c["bg_ssum"]) / lam_tot
    var_mix = torch.clamp(second_mix - mean_mix**2, min=0.0)

    # dedicated edge: dispatch on the tier's own model at the own rate;
    # multi-tenant edge: M/G/1 on the aggregate (Lemma 3.2), s_edge = mixture mean
    w_proc_own = _proc_wait_vec(c["edge_model"], lam, c["edge_s"], c["edge_var"], c["edge_k"])
    w_proc_mix = mg1_wait_vec(lam_tot, 1.0 / mean_mix, var_mix, c["edge_k"])
    w_proc = torch.where(has_bg, w_proc_mix, w_proc_own)
    s_edge = torch.where(has_bg, mean_mix, c["edge_s"])
    lam_edge = torch.where(has_bg, lam_tot, lam)

    b = torch.where(torch.isnan(c["edge_bw"]), c["bandwidth_Bps"][:, None], c["edge_bw"])
    req = c["req_bytes"][:, None]
    res = c["res_bytes"][:, None]
    w_net_dev = mm1_wait_vec(lam, b / req)  # device NIC sees this stream only
    n_req = req / b
    ret = c["return_results"][:, None]
    w_net_edge = torch.where(ret, mm1_wait_vec(lam_edge, b / res), 0.0)
    n_res = torch.where(ret, res / b, 0.0)

    total = w_net_dev + n_req + w_proc + s_edge + w_net_edge + n_res
    return torch.where(c["edge_mask"], total, _INF)


def _device_latency_vec(c):
    """(B,) on-device latency — Eq. 2."""
    w = _proc_wait_vec(c["dev_model"], c["lam"], c["dev_s"], c["dev_var"], c["dev_k"])
    return w + c["dev_s"]


@dataclass(frozen=True)
class FleetPrediction:
    """Per-scenario closed-form latencies of one fleet evaluation.

    ``best_edge`` follows the manager's convention: -1 means on-device,
    j >= 0 means ``edge[j]`` (padded edges are inf and never win).
    """

    t_dev: np.ndarray  # (B,)
    t_edge: np.ndarray  # (B, E)
    best_edge: np.ndarray  # (B,) int

    @property
    def size(self) -> int:
        return int(self.t_dev.shape[0])

    @property
    def best_latency(self) -> np.ndarray:
        stacked = np.concatenate([self.t_dev[:, None], self.t_edge], axis=1)
        return stacked[np.arange(self.size), self.best_edge + 1]

    def strategy_names(self) -> list[str]:
        """Decision.target_name-style labels per scenario."""
        return [
            "on_device" if j < 0 else f"edge[{j}]" for j in self.best_edge.tolist()
        ]

    def totals(self, i: int) -> dict[str, float]:
        """Scenario i's totals keyed like ScenarioPrediction.totals()
        (padded edge slots report inf)."""
        out = {"on_device": float(self.t_dev[i])}
        for j in range(self.t_edge.shape[1]):
            out[f"edge[{j}]"] = float(self.t_edge[i, j])
        return out


def fleet_analytic(batch: ScenarioBatch, *, device=None) -> FleetPrediction:
    """Closed-form per-strategy latency of every scenario, on ``device``
    (default: the card)."""
    c = _batch_tensors(batch, resolve_device(device))
    t_dev = _device_latency_vec(c)
    t_edge = _edge_latency_vec(c)
    stacked = torch.cat([t_dev[:, None], t_edge], dim=1)
    # torch.argmin returns the first of equal minima => on-device wins ties,
    # matching ScenarioPrediction.best_strategy
    best = torch.argmin(stacked, dim=1) - 1
    return FleetPrediction(
        t_dev=t_dev.cpu().numpy(),
        t_edge=t_edge.cpu().numpy(),
        best_edge=best.cpu().numpy(),
    )


# ---------------------------------------------------------------------------
# batched crossover solving (bandwidth / arrival_rate axes)
# ---------------------------------------------------------------------------


def _diff_at(c, x, axis_code: int, edge: int):
    """T_edge[edge](x) - T_dev(x) with the axis value substituted per row."""
    if axis_code == 0:  # bandwidth
        c = dict(c, bandwidth_Bps=x)
        # a swept shared path overrides any per-edge bandwidth, matching the
        # scalar solvers which always sweep NetworkPath(b)
        c["edge_bw"] = torch.full_like(c["edge_bw"], float("nan"))
    else:  # arrival rate
        c = dict(c, lam=x)
    t_dev = _device_latency_vec(c)
    t_edge = _edge_latency_vec(c)
    return t_edge[:, edge] - t_dev


def _diff_on_grid(c, xs, axis_code: int, edge: int, rows_per_chunk: int = 1 << 22):
    """(B, S) differences at every grid sample: each row's columns repeated
    once per sample, evaluated as one flat batch, in chunks of samples that
    keep the flat batch near ``rows_per_chunk`` rows."""
    b, samples = xs.shape
    step = max(1, min(samples, rows_per_chunk // max(b, 1)))
    out = torch.empty_like(xs)
    for j0 in range(0, samples, step):
        m = min(step, samples - j0)
        flat = {k: v.repeat_interleave(m, dim=0) for k, v in c.items()}
        vals = _diff_at(flat, xs[:, j0:j0 + m].reshape(-1), axis_code, edge)
        out[:, j0:j0 + m] = vals.view(b, m)
    return out


@dataclass(frozen=True)
class FleetCrossover:
    """Batched Crossover: nan value where no sign change exists in [lo, hi]."""

    value: np.ndarray  # (B,)
    offload_wins_above: np.ndarray  # (B,) bool, meaningful where found
    found: np.ndarray  # (B,) bool
    lo: np.ndarray
    hi: np.ndarray


def fleet_crossover(
    batch: ScenarioBatch,
    axis: str,
    *,
    edge: int = 0,
    lo=None,
    hi=None,
    samples: int | None = None,
    iters: int = 200,
    device=None,
) -> FleetCrossover:
    """Where does the preferred strategy flip, for every scenario at once?

    ``axis`` is ``"bandwidth"`` (default range 1e4..1e9 B/s, as
    ``bandwidth_crossover``) or ``"arrival_rate"`` (per-row upper bound just
    inside every queue's stability region, as ``arrival_rate_crossovers``;
    the first crossover is returned). Same grid-scan-then-bisect procedure as
    ``repro_torch.core.crossover.solve_crossover``, batched: the scan for the
    first sign change is one pass over the (B, samples) grid, then a fixed
    count of bisection steps on every row at once.
    """
    if batch.max_edges == 0 or not 0 <= edge < batch.max_edges:
        raise ValueError(f"edge index {edge} out of range for batch with "
                         f"{batch.max_edges} edge slots")
    dev = resolve_device(device)
    c = _batch_tensors(batch, dev)
    b = batch.size

    def full(v):
        return torch.full((b,), v, dtype=FLOAT, device=dev)

    if axis == "bandwidth":
        axis_code = 0
        linear = False
        samples = 256 if samples is None else samples
        lo_arr = full(1e4 if lo is None else lo)
        hi_arr = full(1e9 if hi is None else hi)
    elif axis == "arrival_rate":
        axis_code = 1
        linear = True
        samples = 512 if samples is None else samples
        lo_arr = full(0.01 if lo is None else lo)
        if hi is None:
            # stay strictly inside every queue's stability region
            bw = torch.where(torch.isnan(c["edge_bw"][:, edge]), c["bandwidth_Bps"],
                             c["edge_bw"][:, edge])
            caps_dev = c["dev_k"] / c["dev_s"]
            caps_req = bw / c["req_bytes"]
            has_bg = c["bg_lam"][:, edge] > 0
            caps_edge = c["edge_k"][:, edge] / c["edge_s"][:, edge]
            caps_res = bw / c["res_bytes"]
            cap_nobg = torch.minimum(
                torch.minimum(caps_dev, caps_edge), torch.minimum(caps_req, caps_res))
            cap_bg = torch.minimum(caps_dev, caps_req)
            hi_arr = 0.999 * torch.where(has_bg, cap_bg, cap_nobg)
        else:
            hi_arr = full(hi)
    else:
        raise ValueError(f"unknown axis {axis!r} (known: bandwidth, arrival_rate)")

    # per-row grid: geometric when the span exceeds two decades (mirrors
    # solve_crossover), linear otherwise — or forced linear for the arrival
    # axis, matching arrival_rate_crossovers' linspace scan
    t = torch.linspace(0.0, 1.0, samples, dtype=FLOAT, device=dev)
    geom = lo_arr[:, None] * (hi_arr / lo_arr)[:, None] ** t[None, :]
    lin = lo_arr[:, None] + (hi_arr - lo_arr)[:, None] * t[None, :]
    use_geom = (lo_arr > 0) & (hi_arr / lo_arr > 100) & (not linear)
    xs = torch.where(use_geom[:, None], geom, lin)
    vals = _diff_on_grid(c, xs, axis_code, edge)

    # the first sign change between grid-ADJACENT finite samples. A
    # non-finite sample breaks the pairing: pairing across an instability
    # pocket (a run of inf between opposite-sign finite regions) would send
    # the bisection into the non-finite region and report a bogus crossover
    # at a stability boundary — the same rule as solve_crossover's scan.
    prev, cur = vals[:, :-1], vals[:, 1:]
    pair = torch.isfinite(prev) & torch.isfinite(cur)
    hit = pair & (((prev > 0) != (cur > 0)) | (prev == 0.0))
    found = hit.any(dim=1)
    j = torch.argmax(hit.to(torch.int8), dim=1)  # first hit (0 where none)
    rows = torch.arange(b, device=dev)
    blo = torch.where(found, xs[rows, j], 0.0)
    bhi = torch.where(found, xs[rows, j + 1], 0.0)
    bflo = torch.where(found, prev[rows, j], 0.0)
    wins = found & (cur[rows, j] < 0)

    exact = found & (bflo == 0.0)  # grid point landed on the root
    lo_b, hi_b, flo = blo, bhi, bflo
    for _ in range(iters):
        mid = 0.5 * (lo_b + hi_b)
        fm = _diff_at(c, mid, axis_code, edge)
        same = (fm > 0) == (flo > 0)
        lo_b = torch.where(same, mid, lo_b)
        flo = torch.where(same, fm, flo)
        hi_b = torch.where(same, hi_b, mid)
    root = 0.5 * (lo_b + hi_b)
    value = torch.where(found, torch.where(exact, blo, root), float("nan"))
    return FleetCrossover(
        value=value.cpu().numpy(),
        offload_wins_above=wins.cpu().numpy(),
        found=found.cpu().numpy(),
        lo=lo_arr.cpu().numpy(),
        hi=hi_arr.cpu().numpy(),
    )
