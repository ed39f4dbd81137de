"""Closed-form sojourn-time *distributions* per station (tail-latency layer).

The paper's closed forms predict expected end-to-end latencies, but real
offloading policies are driven by SLO percentiles — "Selective Edge Computing
for Mobile Analytics" and the deadline-constrained offloading literature both
decide under hard per-request latency budgets, not means. This module extends
the repo's Eq. 1/2 decompositions from means to full sojourn distributions:

  * **M/M/1 (exact)** — the sojourn time of a stable M/M/1 queue is
    exponential with rate ``mu - lambda``, so every quantile is closed form:
    ``t_q = -ln(1 - q) / (mu - lambda)``.
  * **M/D/1 and M/G/1 (numeric)** — the waiting-time distribution is known
    only through its Pollaczek-Khinchine Laplace-Stieltjes transform
    ``W*(s) = (1 - rho) s / (s - lam (1 - S*(s)))``; we invert it numerically
    with the Abate-Whitt Euler-summation algorithm (discretisation error
    ~``e^-A`` ~ 1e-8) and find quantiles by bisection on the CDF.
  * **Exponential-tail asymptote (cheap fallback)** — the sojourn tail decays
    as ``P(T > t) ~ C e^{-eta t}`` where ``eta`` is the dominant singularity
    of the transform (the Cramer root ``lam (M_S(eta) - 1) = eta`` for the
    wait factor, the service pole for exponential service); ``C`` follows from
    the residue. Exact for M/M/1, asymptotically exact for high quantiles
    elsewhere, and cheap enough to vectorise inside jitted decision loops
    (:mod:`repro_torch.fleet.tail_vec` is the batched twin).

Tandem composition (the Fig. 1 device NIC -> edge proc -> edge NIC path) uses
the **independence approximation**: the end-to-end sojourn transform is the
product of per-station sojourn transforms. This is exact for tandem ·/M/1
stations with Poisson input (Reich's theorem) and an approximation when an
M/D/1 or M/G/1 station sits in the middle; the validation harness quantifies
the error against the discrete-event simulator (tail-percentile gate:
analytic p99 within 10% of simulated ``percentile(99)`` at rho <= 0.9).

GENERAL service is represented by a two-moment gamma match in the transform
domain (the simulator draws lognormal): the mismatch is a quantified model
approximation, reported but not gated — exactly how the repo treats the
paper's k>1 aggregation.

Plain numpy/math only — this is the kernel layer; it must stay importable
without JAX (the vectorised twin lives in ``repro_torch.fleet.tail_vec``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np

__all__ = [
    "KIND_DET",
    "KIND_EXP",
    "KIND_GAMMA",
    "Station",
    "nic_station",
    "proc_station",
    "mixture_station",
    "offload_stations",
    "mm1_sojourn_quantile",
    "resolve_tail_method",
    "euler_grow_iters",
    "sojourn_cdf",
    "sojourn_pdf",
    "sojourn_quantile",
    "sojourn_mean",
]

# service-distribution kind codes — intentionally identical to
# repro_torch.fleet.batch.MODEL_CODES (det=0, exp=1, general/gamma=2) so batched
# columns feed the vectorized twin without remapping
KIND_DET, KIND_EXP, KIND_GAMMA = 0, 1, 2

# Abate-Whitt Euler-summation constants (A controls the discretisation error
# ~e^-A; N+M+1 transform evaluations per CDF point). The vectorized twin in
# repro_torch.fleet.tail_vec MUST use the same constants — the <=1e-6 scalar-vs-vec
# agreement gate depends on both sides running the identical algorithm.
EULER_A = 18.4
EULER_N = 15
EULER_M = 11
_EULER_WEIGHTS = np.array(
    [math.comb(EULER_M, j) * 0.5**EULER_M for j in range(EULER_M + 1)]
)

# fixed iteration counts so scalar and vectorized quantiles are deterministic
# and bit-comparable; the scalar-vs-vec agreement gate (<= 1e-8 on euler
# quantiles) depends on both sides walking the IDENTICAL search trajectory,
# because the Euler-inverted CDF of near-deterministic mixtures carries
# oscillatory inversion noise (~e^-A amplitude, wavelength ~t/(N+M+1)) that
# can cross a quantile level more than once — two different-but-correct root
# finders may land on different crossings. The shared trajectory is:
# geometric bracket growth from 2*mean (doubling count derived from q — see
# ``euler_grow_iters``), EULER_BISECT_ITERS bisections to isolate a bracket
# narrower than the noise wavelength, then EULER_NEWTON_ITERS safeguarded
# Newton steps on the free Abate-Whitt density (midpoint fallback whenever
# the Newton candidate leaves the bracket; a candidate ON an end of the
# bracket stays — see ``_quantile_euler``).
EULER_BISECT_ITERS = 10
EULER_NEWTON_ITERS = 8
ETA_GROW_ITERS = 64
ETA_BISECT_ITERS = 80


def euler_grow_iters(q: float) -> int:
    """Bracket doublings from ``2 * mean`` guaranteed to cover the q-quantile.

    Markov's inequality gives ``P(T > t) <= mean/t``, so ``t_q <=
    mean/(1-q)`` and ``ceil(log2(1/(1-q)))`` doublings of ``2 * mean`` always
    reach past it; one extra doubling of margin keeps the ~e^-A inversion
    noise from faking ``F(hi) < q`` right at the boundary. A pure function of
    q (static at trace time) so the jitted batch path runs the same growth
    schedule as the scalar without data-dependent iteration counts.
    """
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {q}")
    return max(0, math.ceil(math.log2(1.0 / (1.0 - q)))) + 1

# gamma service with cv^2 below this is evaluated as deterministic: the exact
# transform needs shape * log(1 + theta/shape-ish) with shape = 1/cv^2, which
# cancels catastrophically once cv^2 reaches float-residue scale (mixture
# variances of homogeneous streams come out as ~1e-19, not exactly 0)
GAMMA_DET_CV2 = 1e-12

# the Euler-inverted CDF is only accurate to ~e^-A ~ 1e-8 absolute, so
# quantiles with 1-q inside two decades of that noise floor would bisect
# against inversion noise and silently underestimate. Past this q the
# numeric method hands off to the exponential-tail asymptote — which is
# asymptotically EXACT in precisely that q -> 1 regime.
EULER_Q_MAX = 1.0 - 1e-6

# the single-pole asymptote needs its dominant pole to stand alone: a second
# pole at (1 + gap) * eta adds a term of opposite sign whose residue grows as
# 1/gap, and the two cancel over t ~ 1/(gap * eta). Stations that share their
# dominant pole (identical tandem stations: a double pole, where the residue
# formula divides by zero) or sit within this relative gap of it have their
# quantile resolved on the Euler path instead.
POLE_GAP_REL = 1e-2


def resolve_tail_method(q: float, method: str) -> str:
    """The method actually used for quantile q (euler -> asymptote beyond
    ``EULER_Q_MAX``). Exposed so the jitted batch/cluster paths — where the
    switch must happen before tracing — resolve it identically."""
    if method == "euler" and q > EULER_Q_MAX:
        return "asymptote"
    return method


def _gamma_is_det(mean: float, var: float) -> bool:
    return var <= GAMMA_DET_CV2 * mean * mean


class Station(NamedTuple):
    """One FCFS station of a tandem path, in transform-ready form.

    ``lam`` is the Poisson arrival rate. The *wait* service distribution
    (``wkind``/``wmean``/``wvar``) parameterises the P-K waiting-time
    transform — it carries the paper's k*mu aggregation, i.e. mean ``s/k``
    with the variance kept unscaled, exactly matching ``latency.proc_wait``'s
    mean formulas. The *full* service distribution (``fkind``/``fmean``/
    ``fvar``) is what the job actually experiences after its wait (full
    ``s``), so ``E[sojourn] = E[W_aggregated] + s`` reproduces the repo's
    mean model term for term. A station with ``fmean == 0`` and ``lam*wmean
    == 0`` is inert (transform factor 1) — used for disabled return paths.
    """

    lam: float
    wkind: int
    wmean: float
    wvar: float
    fkind: int
    fmean: float
    fvar: float


# ---------------------------------------------------------------------------
# station constructors (the vocabulary scenario/manager/policy compose with)
# ---------------------------------------------------------------------------


def nic_station(lam: float, payload_bytes: float, bandwidth_Bps: float) -> Station:
    """The paper's M/M/1 NIC: exponential service with mean D/B.

    ``payload_bytes == 0`` (a disabled transfer leg) degenerates to an inert
    station, mirroring how the mean model drops the term.
    """
    mean = payload_bytes / bandwidth_Bps if payload_bytes > 0 else 0.0
    return Station(lam, KIND_EXP, mean, 0.0, KIND_EXP, mean, 0.0)


def proc_station(lam: float, kind: int, service_s: float, service_var: float,
                 k: float = 1.0) -> Station:
    """A processing station dispatched on the tier's service model.

    DETERMINISTIC -> M/D/1 on the aggregated rate; EXPONENTIAL -> M/M/1 on
    k*mu; GENERAL -> M/G/1 via a two-moment gamma match (mean ``s/k``,
    variance kept unscaled — the exact aggregation ``mg1_wait`` uses).
    """
    return Station(lam, kind, service_s / k, service_var, kind, service_s, service_var)


def mixture_station(lam_tot: float, mean_mix: float, var_mix: float,
                    k: float = 1.0) -> Station:
    """The §3.4 multi-tenant aggregate as an M/G/1 station (Lemma 3.2):
    gamma-matched mixture moments for both the wait and the full service —
    the distributional twin of ``multitenant_edge_latency``'s
    re-parameterisation (``s_edge`` = mixture mean)."""
    return Station(lam_tot, KIND_GAMMA, mean_mix / k, var_mix,
                   KIND_GAMMA, mean_mix, var_mix)


def offload_stations(
    lam: float,
    req_bytes: float,
    res_bytes: float,
    bandwidth_Bps: float,
    proc: Station,
    *,
    return_results: bool = True,
) -> tuple[Station, Station, Station]:
    """THE Fig. 1 offload tandem: device NIC -> ``proc`` -> return NIC.

    ``lam`` is the workload's own rate (the device NIC sees only this
    stream); the return NIC carries everything the edge serves, i.e.
    ``proc.lam`` (own rate on a dedicated edge, the aggregate on a shared
    one). Every tail consumer — ``scenario.tail_stations``, the quantile
    crossover solvers, the replay's true-condition scoring — composes through
    here, so the station stack can never drift between them.
    """
    res = res_bytes if return_results else 0.0
    return (
        nic_station(lam, req_bytes, bandwidth_Bps),
        proc,
        nic_station(proc.lam, res, bandwidth_Bps),
    )


# ---------------------------------------------------------------------------
# transform-domain primitives
# ---------------------------------------------------------------------------


def _service_lst(kind: int, mean: float, var: float, theta: np.ndarray) -> np.ndarray:
    """Laplace-Stieltjes transform E[e^{-theta S}] of one service distribution
    (theta may be a complex array). mean == 0 means a degenerate zero service
    (factor 1)."""
    if mean <= 0.0:
        return np.ones_like(theta)
    if kind == KIND_DET:
        return np.exp(-theta * mean)
    if kind == KIND_EXP:
        return 1.0 / (1.0 + theta * mean)
    if _gamma_is_det(mean, var):  # near-zero-variance gamma -> deterministic
        return np.exp(-theta * mean)
    shape = mean * mean / var
    scale = var / mean
    return np.exp(-shape * np.log(1.0 + theta * scale))


def _service_mgf(kind: int, mean: float, var: float, eta: float) -> float:
    """Real moment generating function M_S(eta) = E[e^{eta S}] (eta below the
    distribution's divergence point). Formulas (not the complex LST at -eta)
    so the vectorized twin can reproduce every bit of the asymptote path."""
    if mean <= 0.0:
        return 1.0
    if kind == KIND_DET or (kind == KIND_GAMMA and _gamma_is_det(mean, var)):
        return math.exp(eta * mean)
    if kind == KIND_EXP:
        return 1.0 / (1.0 - eta * mean)
    shape = mean * mean / var
    scale = var / mean
    return math.exp(-shape * math.log(1.0 - eta * scale))


def _service_mgf_prime(kind: int, mean: float, var: float, eta: float) -> float:
    """M_S'(eta) = E[S e^{eta S}]."""
    if mean <= 0.0:
        return 0.0
    if kind == KIND_DET or (kind == KIND_GAMMA and _gamma_is_det(mean, var)):
        return mean * math.exp(eta * mean)
    if kind == KIND_EXP:
        return mean / (1.0 - eta * mean) ** 2
    shape = mean * mean / var
    scale = var / mean
    return mean * (1.0 - eta * scale) ** (-shape - 1.0)


def _service_divergence(kind: int, mean: float, var: float) -> float:
    """The MGF's divergence point (sup of eta with finite M_S(eta))."""
    if mean <= 0.0 or kind == KIND_DET or (kind == KIND_GAMMA and _gamma_is_det(mean, var)):
        return math.inf
    if kind == KIND_EXP:
        return 1.0 / mean
    return mean / var


def _implied_var(kind: int, mean: float, var: float) -> float:
    """Var[S] the kind implies (exp carries mean^2, det zero) — the same
    convention as ``scenario.implied_service_var``."""
    if kind == KIND_EXP:
        return mean * mean
    if kind == KIND_GAMMA:
        return var
    return 0.0


def _station_lst(st: Station, theta: np.ndarray) -> np.ndarray:
    """Sojourn transform of one station: T*(theta) = W*(theta) Sf*(theta),
    with W* the Pollaczek-Khinchine waiting-time transform."""
    rho = st.lam * st.wmean
    f = _service_lst(st.fkind, st.fmean, st.fvar, theta)
    if st.lam <= 0.0 or rho <= 0.0:
        return f
    sw = _service_lst(st.wkind, st.wmean, st.wvar, theta)
    w = (1.0 - rho) * theta / (theta - st.lam * (1.0 - sw))
    return w * f


def _total_lst(stations: Sequence[Station], theta: np.ndarray) -> np.ndarray:
    """End-to-end sojourn transform under the tandem independence
    approximation (exact for ·/M/1 tandems with Poisson input)."""
    out = np.ones_like(theta)
    for st in stations:
        out = out * _station_lst(st, theta)
    return out


def _wait_mean(st: Station) -> float:
    """E[W] of one station via P-K on the aggregated moments (identical to
    ``latency.proc_wait`` / ``queueing.mg1_wait`` on the same inputs)."""
    rho = st.lam * st.wmean
    if st.lam <= 0.0 or rho <= 0.0:
        return 0.0
    if rho >= 1.0:
        return math.inf
    v = _implied_var(st.wkind, st.wmean, st.wvar)
    return st.lam * (st.wmean**2 + v) / (2.0 * (1.0 - rho))


def sojourn_mean(stations: Sequence[Station]) -> float:
    """Sum of per-station E[W] + full service means — equals the repo's
    closed-form mean total on the same path (tested)."""
    return float(sum(_wait_mean(st) + st.fmean for st in stations))


def _unstable(stations: Sequence[Station]) -> bool:
    return any(st.lam * st.wmean >= 1.0 for st in stations)


# ---------------------------------------------------------------------------
# numeric CDF (Abate-Whitt Euler summation) + quantile by bisection
# ---------------------------------------------------------------------------


def _cdf_pdf(stations: Sequence[Station], t_arr: np.ndarray):
    """(F(t), f(t)) of the composed sojourn from ONE set of transform
    evaluations: Abate-Whitt inverts any transform on the same contour
    ``theta_k = (A + 2 pi i k) / (2t)`` — the CDF's transform is
    ``T*(theta)/theta``, the density's is ``T*(theta)`` itself. Sharing the
    ``T*`` products is what makes the quantile search's Newton derivative
    free. The density is clipped at 0 (inversion noise dips slightly negative
    in flat regions; the safeguard treats zero as "fall back to bisection").
    """
    ks = np.arange(EULER_N + EULER_M + 1)
    theta = (EULER_A + 2j * np.pi * ks) / (2.0 * t_arr[..., None])
    vals = _total_lst(stations, theta)
    sign = np.where(ks == 0, 0.5, 1.0) * ((-1.0) ** ks)
    window = slice(EULER_N, EULER_N + EULER_M + 1)
    scale = np.exp(EULER_A / 2.0) / t_arr
    cdf_part = np.cumsum(sign * (vals / theta).real, axis=-1)
    pdf_part = np.cumsum(sign * vals.real, axis=-1)
    cdf = np.clip(scale * (cdf_part[..., window] @ _EULER_WEIGHTS), 0.0, 1.0)
    pdf = np.maximum(scale * (pdf_part[..., window] @ _EULER_WEIGHTS), 0.0)
    return cdf, pdf


def sojourn_cdf(stations: Sequence[Station], t) -> np.ndarray:
    """P(T <= t) of the composed sojourn, by numeric transform inversion.

    Vectorised over ``t`` (> 0). Accuracy ~1e-8 absolute away from atoms of
    the distribution; at an atom (e.g. ``t == s`` for a lightly loaded
    deterministic station) the Euler sum converges to the jump midpoint.
    """
    t_arr = np.atleast_1d(np.asarray(t, dtype=np.float64))
    ks = np.arange(EULER_N + EULER_M + 1)
    theta = (EULER_A + 2j * np.pi * ks) / (2.0 * t_arr[..., None])
    vals = _total_lst(stations, theta) / theta  # transform of the CDF
    terms = np.where(ks == 0, 0.5, 1.0) * ((-1.0) ** ks) * vals.real
    partial = np.cumsum(terms, axis=-1)
    acc = partial[..., EULER_N : EULER_N + EULER_M + 1] @ _EULER_WEIGHTS
    out = np.clip(np.exp(EULER_A / 2.0) / t_arr * acc, 0.0, 1.0)
    return out if np.ndim(t) else out[0]


def sojourn_pdf(stations: Sequence[Station], t) -> np.ndarray:
    """Density f(t) of the composed sojourn by the same Euler inversion
    (transform ``T*(theta)`` bare instead of ``T*(theta)/theta``), clipped at
    0. Smoothed at atoms — an M/D/1 jump shows up as a steep finite peak of
    width ~``t/(N+M+1)``, not a delta.
    """
    t_arr = np.atleast_1d(np.asarray(t, dtype=np.float64))
    pdf = _cdf_pdf(stations, t_arr)[1]
    return pdf if np.ndim(t) else pdf[0]


def mm1_sojourn_quantile(lam: float, mu: float, q: float) -> float:
    """Exact M/M/1 sojourn quantile: t_q = -ln(1 - q) / (mu - lambda).

    The sojourn time of a stable M/M/1 queue is exponential with rate
    ``mu - lambda`` (PASTA + the geometric queue-length distribution), so the
    whole distribution — not just the mean 1/(mu - lambda) — is closed form.
    """
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {q}")
    if mu <= 0 or lam < 0 or lam >= mu:
        return math.inf
    return -math.log1p(-q) / (mu - lam)


def _quantile_euler(stations: Sequence[Station], q: float) -> float:
    """Quantile of the Euler-inverted CDF along the shared search trajectory.

    Three phases, all with iteration counts fixed by module constants so the
    vectorized twin (``repro_torch.fleet.euler_vec``) can replay the identical
    evaluation sequence: (1) geometric growth from ``2 * mean`` — anchors the
    bracket to the *leftmost* octave where the CDF reaches q, which matters
    because the inversion noise of near-deterministic mixtures can cross q
    more than once; (2) ``EULER_BISECT_ITERS`` bisections, shrinking the
    bracket below the noise wavelength ~``t/(N+M+1)`` so exactly one crossing
    remains inside; (3) ``EULER_NEWTON_ITERS`` safeguarded Newton steps using
    the free density from ``_cdf_pdf``, falling back to the midpoint whenever
    the Newton candidate leaves the bracket (so the bracket still halves and
    the worst case stays a bisection). A candidate on an end of the bracket
    has not left it: that is a converged iterate (``cdf == q`` to the last
    bit makes the step zero, and the end it lands on is the iterate itself),
    and it stays. The reference rejects it with strict bounds and jumps to
    the midpoint of a bracket still up to 1e-5 of t wide, so its answer turns
    on the last bit of ``cdf - q`` and two implementations of the one
    trajectory part there (ROADMAP C9).
    """
    mean = sojourn_mean(stations)
    if not math.isfinite(mean):
        return math.inf
    hi0 = np.asarray(max(2.0 * mean, 1e-12))
    hi = hi0
    for _ in range(euler_grow_iters(q)):
        hi = np.where(sojourn_cdf(stations, hi) < q, hi * 2.0, hi)
    # if the bracket grew, the last doubled-from point hi/2 is a known
    # below-q evaluation — one free bisection
    lo = np.where(hi > hi0, 0.5 * hi, 0.0)
    for _ in range(EULER_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        below = sojourn_cdf(stations, mid) < q
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    t = 0.5 * (lo + hi)
    for _ in range(EULER_NEWTON_ITERS):
        cdf, pdf = _cdf_pdf(stations, np.atleast_1d(t))
        cdf, pdf = cdf[0], pdf[0]
        below = cdf < q
        lo = np.where(below, t, lo)
        hi = np.where(below, hi, t)
        newton = t - (cdf - q) / np.where(pdf > 0.0, pdf, 1.0)
        ok = (pdf > 0.0) & (newton >= lo) & (newton <= hi)
        t = np.where(ok, newton, 0.5 * (lo + hi))
    return float(np.clip(t, lo, hi))


# ---------------------------------------------------------------------------
# exponential-tail asymptote (dominant-singularity decay rate)
# ---------------------------------------------------------------------------


def _wait_pole(st: Station) -> float:
    """The Cramer decay rate of the waiting-time tail: the unique positive
    root of ``lam (M_Sw(eta) - 1) = eta`` (below the MGF's divergence point).

    Exponential wait-service has the closed-form root ``(1 - rho)/wmean``
    (which is why the asymptote is exact for M/M/1); deterministic and gamma
    roots are found by geometric bracket growth + fixed-iteration bisection —
    the same procedure, with the same constants, as the vectorized twin.
    """
    rho = st.lam * st.wmean
    if st.lam <= 0.0 or rho <= 0.0:
        return math.inf
    if rho >= 1.0:
        return 0.0
    if st.wkind == KIND_EXP:
        return (1.0 - rho) / st.wmean

    def g(eta: float) -> float:
        return st.lam * (_service_mgf(st.wkind, st.wmean, st.wvar, eta) - 1.0) - eta

    div = _service_divergence(st.wkind, st.wmean, st.wvar)
    # the root is at least the exponential-service root whenever the service
    # is NOT more variable than exponential (MGF ordering); grow from there
    hi = (1.0 - rho) / st.wmean
    cap = min(div * (1.0 - 1e-12), 700.0 / st.wmean)
    hi = min(hi, cap)
    for _ in range(ETA_GROW_ITERS):
        hi = min(hi * 2.0, cap) if g(hi) <= 0.0 else hi
    lo = 0.0
    for _ in range(ETA_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        if g(mid) <= 0.0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _wait_mgf(st: Station, eta: float) -> float:
    """E[e^{eta W}] = W*(-eta), finite only below the station's wait pole."""
    rho = st.lam * st.wmean
    if st.lam <= 0.0 or rho <= 0.0:
        return 1.0
    g = st.lam * (_service_mgf(st.wkind, st.wmean, st.wvar, eta) - 1.0) - eta
    return (1.0 - rho) * (-eta) / g


def _station_lst_real(st: Station, eta: float) -> float:
    """T*(-eta) on the real axis (the station's sojourn MGF at eta), finite
    only below the station's own dominant singularity."""
    return _wait_mgf(st, eta) * _service_mgf(st.fkind, st.fmean, st.fvar, eta)


def shares_dominant_pole(cands: Sequence[tuple[float, int, bool]]) -> bool:
    """Whether the smallest decay rate among the (eta, station, is_wait)
    candidates has another candidate within ``POLE_GAP_REL`` of it."""
    etas = sorted(c[0] for c in cands)
    return len(etas) > 1 and etas[1] <= etas[0] * (1.0 + POLE_GAP_REL)


def _quantile_asymptote(stations: Sequence[Station], q: float) -> float:
    """Quantile from ``P(T > t) ~ (r/eta) e^{-eta t}``.

    ``eta`` is the smallest candidate decay rate across every factor of the
    product transform — each station's wait pole plus the service pole of
    exponential full service — and ``r`` is the residue of the product at
    that (simple) pole: the dominant factor's local residue times every other
    factor evaluated at ``-eta``. Exact for a single M/M/1 station;
    increasingly accurate as q -> 1 elsewhere. Known limits: gamma service
    branch points are not simple poles (their tails are lighter than the
    matching wait pole whenever the station queues, so they are excluded).
    A dominant pole shared with another factor, or within ``POLE_GAP_REL``
    of one, is no simple pole either: that quantile is resolved on the Euler
    path (also beyond ``EULER_Q_MAX``, where its noise floor makes it an
    estimate rather than the inversion's 1e-8) instead of dividing by zero.
    """
    # candidate order (all wait poles, then all exp-service poles) matches the
    # vectorized twin's stacking so exact ties break identically
    cands: list[tuple[float, int, bool]] = [
        (_wait_pole(st), i, True) for i, st in enumerate(stations)
    ] + [
        (1.0 / st.fmean if st.fkind == KIND_EXP and st.fmean > 0.0 else math.inf,
         i, False)
        for i, st in enumerate(stations)
    ]
    eta, j, is_wait = min(cands, key=lambda c: c[0])
    if not math.isfinite(eta):  # no queueing anywhere and no exp service
        return sum(st.fmean for st in stations)
    if shares_dominant_pole(cands):
        return _quantile_euler(stations, q)
    st_j = stations[j]
    if is_wait:
        rho = st_j.lam * st_j.wmean
        denom = st_j.lam * _service_mgf_prime(st_j.wkind, st_j.wmean, st_j.wvar, eta) - 1.0
        r = (1.0 - rho) * eta / denom
        r *= _service_mgf(st_j.fkind, st_j.fmean, st_j.fvar, eta)
    else:
        r = (1.0 / st_j.fmean) * _wait_mgf(st_j, eta)
    for i, st in enumerate(stations):
        if i != j:
            r *= _station_lst_real(st, eta)
    if not (r > 0.0 and math.isfinite(r)):
        return math.inf
    return max(math.log(r / (eta * (1.0 - q))) / eta, 0.0)


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


def sojourn_quantile(
    stations: Sequence[Station], q: float, *, method: str = "euler"
) -> float:
    """The q-quantile (q in (0, 1)) of the composed end-to-end sojourn time.

    ``method="euler"`` (default) inverts the exact product transform with
    Abate-Whitt Euler summation; ``method="asymptote"`` uses the cheap
    dominant-singularity exponential tail (the form the jitted fleet/cluster
    paths vectorise). A single M/M/1 station short-circuits to the exact
    closed form under both methods. Unstable stations (rho >= 1) yield
    ``inf``, exactly as the mean closed forms do.
    """
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {q}")
    if method not in ("euler", "asymptote"):
        raise ValueError(f"unknown method {method!r} (known: euler, asymptote)")
    method = resolve_tail_method(q, method)
    stations = [st for st in stations]
    if not stations:
        raise ValueError("need at least one station")
    if _unstable(stations):
        return math.inf
    if (
        len(stations) == 1
        and stations[0].wkind == KIND_EXP
        and stations[0].fkind == KIND_EXP
        and stations[0].wmean == stations[0].fmean
        and stations[0].fmean > 0.0
    ):
        return mm1_sojourn_quantile(stations[0].lam, 1.0 / stations[0].fmean, q)
    if method == "asymptote":
        return _quantile_asymptote(stations, q)
    return _quantile_euler(stations, q)
