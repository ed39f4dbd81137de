"""Closed-form queueing primitives used by the paper's latency models.

Every function transcribes an equation from the paper ("To Offload or Not To
Offload", CS.DC 2025) and cites it. All times are in seconds, all rates in
requests/second unless noted. Functions are plain-float (math) so they can be
called from schedulers at request granularity; the numpy forms live in
:mod:`repro_torch.core.latency` and the batched torch forms in
:mod:`repro_torch.fleet.analytic_vec`. A copy of the JAX package's module with
the same arithmetic.

Stability convention: a queue is *stable* iff utilisation rho = lambda/mu < 1.
For unstable inputs the closed forms diverge; we return ``math.inf`` instead
of raising so the adaptive manager (Algorithm 1) can treat saturated options
as infinitely bad and never pick them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = [
    "mm1_wait",
    "mm1_response",
    "md1_wait",
    "md1_wait_aggregated",
    "mm1_wait_aggregated",
    "mg1_wait",
    "gg1_wait_upper_bound",
    "mmk_wait_erlang",
    "mdk_wait_approx",
    "utilisation",
    "QueueStats",
]

_EPS = 1e-12


def utilisation(lam: float, mu: float, k: float = 1.0) -> float:
    """rho = lambda / (k mu). Paper §3.4 ("aggregate utilization")."""
    if mu <= 0 or k <= 0:
        return math.inf
    return lam / (k * mu)


def _unstable(lam: float, effective_mu: float) -> bool:
    return lam < 0 or effective_mu <= 0 or lam >= effective_mu - _EPS


def mm1_wait(lam: float, mu: float) -> float:
    """Expected M/M/1/FCFS queueing delay (paper Eq. 7).

    E[w] = 1/(mu - lambda) - 1/mu

    Used by the paper for network interfaces (single NIC controller) and —
    via the aggregated-rate reduction (Lemma 3.3) — for variable-service
    workloads (RNN / LLM).
    """
    if _unstable(lam, mu):
        return math.inf
    if lam == 0.0:
        return 0.0
    return 1.0 / (mu - lam) - 1.0 / mu


def mm1_response(lam: float, mu: float) -> float:
    """Expected M/M/1 response (sojourn) time = wait + service = 1/(mu-lambda)."""
    if _unstable(lam, mu):
        return math.inf
    return 1.0 / (mu - lam)


def md1_wait(lam: float, mu: float) -> float:
    """Expected M/D/1/FCFS queueing delay via the P-K formula (paper Eq. 6 with k=1).

    E[w] = 1/2 (1/(mu - lambda) - 1/mu)

    Deterministic service — the paper's model for DNN inference on
    accelerators (service time is constant because the op count per request
    is constant; their citation [27]).
    """
    if _unstable(lam, mu):
        return math.inf
    if lam == 0.0:
        return 0.0
    return 0.5 * (1.0 / (mu - lam) - 1.0 / mu)


def md1_wait_aggregated(lam: float, mu: float, k: float) -> float:
    """Paper Eq. 6: M/D/k reduced to M/D/1 with aggregated rate k*mu.

    E[w] = 1/2 (1/(k mu - lambda) - 1/(k mu))

    The paper argues (citing [48, 49]) that accelerators with small, fine-
    grained parallelism k are well-approximated by aggregating the service
    rate; k may be non-integer ("continuous multiplier", §3.5).
    """
    return md1_wait(lam, k * mu)


def mm1_wait_aggregated(lam: float, mu: float, k: float) -> float:
    """Lemma 3.3's building block: M/M/1 wait with aggregated rate k*mu.

    E[w] = 1/(k mu - lambda) - 1/(k mu)
    """
    return mm1_wait(lam, k * mu)


def mg1_wait(lam: float, mu: float, var_s: float) -> float:
    """Expected M/G/1/FCFS queueing delay via the P-K formula (paper Eq. 11).

    E[w] = (rho + lambda * mu * Var[s]) / (2 (mu - lambda))

    with rho = lambda/mu. The paper uses this for the multi-tenant edge where
    the aggregate service-time distribution across co-located applications is
    arbitrary (Lemma 3.2).

    Consistency checks (tested):
      Var[s] = 0        -> reduces to md1_wait           (deterministic)
      Var[s] = 1/mu^2   -> reduces to mm1_wait           (exponential)
    """
    if _unstable(lam, mu):
        return math.inf
    if lam == 0.0:
        return 0.0
    if var_s < 0:
        raise ValueError(f"variance must be >= 0, got {var_s}")
    rho = lam / mu
    return (rho + lam * mu * var_s) / (2.0 * (mu - lam))


def gg1_wait_upper_bound(lam: float, mu: float, var_a: float, var_s: float) -> float:
    """Marshall's G/G/1 upper bound on expected wait (paper Eq. 13, [30]).

    E[w] <= lambda (sigma_a^2 + sigma_s^2) / (2 (1 - rho))

    The paper offers this for bursty (non-Poisson) arrivals.
    """
    if _unstable(lam, mu):
        return math.inf
    if lam == 0.0:
        return 0.0
    if var_a < 0 or var_s < 0:
        raise ValueError("variances must be >= 0")
    rho = lam / mu
    return lam * (var_a + var_s) / (2.0 * (1.0 - rho))


# ---------------------------------------------------------------------------
# Exact / reference alternatives (not used by the paper's closed forms, but
# kept as oracles for tests and for quantifying the paper's M/D/k -> M/D/1
# aggregation error; ``fleet.analytic_vec``'s batched M/M/k is held to
# ``mmk_wait_erlang``).
# ---------------------------------------------------------------------------


def mmk_wait_erlang(lam: float, mu: float, k: int) -> float:
    """Exact M/M/k expected wait via the Erlang-C formula.

    The paper deliberately avoids M/M/k (birth-death derivation requires
    integer k, §3.5); we keep the exact form as a test oracle for integer k.
    """
    if k < 1 or int(k) != k:
        raise ValueError("Erlang-C requires integer k >= 1")
    k = int(k)
    if _unstable(lam, k * mu):
        return math.inf
    if lam == 0.0:
        return 0.0
    a = lam / mu  # offered load in Erlangs
    rho = a / k
    # P(wait) — Erlang C
    summation = sum(a**n / math.factorial(n) for n in range(k))
    last = a**k / (math.factorial(k) * (1.0 - rho))
    p_wait = last / (summation + last)
    return p_wait / (k * mu - lam)


def mdk_wait_approx(lam: float, mu: float, k: int) -> float:
    """Crommelin-style approximation for M/D/k expected wait.

    E[w_{M/D/k}] ~= E[w_{M/M/k}] / 2  (deterministic service halves the P-K
    variability term). Used only to quantify the aggregation error of the
    paper's Eq. 6 reduction; not part of the paper's models.
    """
    return 0.5 * mmk_wait_erlang(lam, mu, k)


@dataclass(frozen=True)
class QueueStats:
    """Summary of one queueing station's predicted steady-state behaviour."""

    lam: float
    mu: float
    k: float
    wait: float
    service: float
    utilisation: float

    @property
    def response(self) -> float:
        return self.wait + self.service

    @property
    def stable(self) -> bool:
        return self.utilisation < 1.0
