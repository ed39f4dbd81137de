"""Service-time derivation (paper §3.2, §4.2).

The models take mean (and variance of) service time per tier as *input*. The
paper's menu: (a) empirical profiling, (b) a learned latency predictor
(:mod:`repro_torch.core.predictor`), or (c) an analytic roofline estimate from a
step's FLOP/byte counts (:mod:`repro_torch.perf`). This module implements (a)
and (c) plus the paper's §4.1 procedure for fitting the effective parallelism k
from observed response-time-vs-rate scaling. A copy of the JAX package's module
with the same arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from .latency import ServiceModel, Tier, proc_wait

__all__ = [
    "ServiceEstimate",
    "from_profile",
    "from_roofline",
    "fit_parallelism",
]


@dataclass(frozen=True)
class ServiceEstimate:
    mean_s: float
    var_s: float
    n_samples: int
    source: str  # "profile" | "roofline" | "predictor"

    def as_tier(self, name: str, *, k: float = 1.0, model: ServiceModel = ServiceModel.DETERMINISTIC) -> Tier:
        return Tier(
            name=name,
            service_time_s=self.mean_s,
            parallelism_k=k,
            service_model=model,
            service_var=self.var_s,
        )


def from_profile(samples: Sequence[float]) -> ServiceEstimate:
    """Empirical profiling (paper: nvidia-smi per-process execution times /
    representative-input-set averages). Mean + unbiased variance."""
    arr = np.asarray(list(samples), dtype=np.float64)
    if arr.size == 0:
        raise ValueError("no profile samples")
    var = float(arr.var(ddof=1)) if arr.size > 1 else 0.0
    return ServiceEstimate(float(arr.mean()), var, int(arr.size), "profile")


def from_roofline(
    flops: float,
    hbm_bytes: float,
    *,
    peak_flops: float,
    hbm_bw: float,
    collective_s: float = 0.0,
    efficiency: float = 1.0,
) -> ServiceEstimate:
    """Analytic service time from the 3-term roofline of a compiled step.

    s = max(flops/peak, bytes/bw, collective_s) / efficiency

    flops/bytes come from an analytic count (``perf.flops.cell_flops`` and
    the step's weight and cache bytes) and collective_s from a collective
    inventory (see repro_torch.perf.roofline); the peaks from a
    ``perf.hardware.HardwareSpec`` such as ``H100_SXM``. ``efficiency``
    discounts peak to a realistic fraction (MFU-style).
    """
    if peak_flops <= 0 or hbm_bw <= 0 or not 0 < efficiency <= 1:
        raise ValueError("invalid hardware constants")
    s = max(flops / peak_flops, hbm_bytes / hbm_bw, collective_s) / efficiency
    return ServiceEstimate(float(s), 0.0, 0, "roofline")


def fit_parallelism(
    lam_grid: Sequence[float],
    observed_mean_latency: Sequence[float],
    service_time_s: float,
    *,
    service_model: ServiceModel = ServiceModel.DETERMINISTIC,
    k_lo: float = 0.5,
    k_hi: float = 64.0,
    iters: int = 80,
) -> float:
    """Fit the effective parallelism k (paper §4.1).

    "We estimate k by empirically measuring how response time varies with
    request rate ... and identify a value of k that best captures the
    observed scaling behavior." Golden-section search over k minimising the
    squared error between the closed-form response time (wait(k) + s) and the
    observed means. k is continuous per §3.5.
    """
    lam = np.asarray(list(lam_grid), dtype=np.float64)
    obs = np.asarray(list(observed_mean_latency), dtype=np.float64)
    if lam.shape != obs.shape or lam.size == 0:
        raise ValueError("lam grid and observations must match and be non-empty")

    def loss(k: float) -> float:
        tier = Tier("fit", service_time_s, parallelism_k=k, service_model=service_model)
        pred = proc_wait(tier, lam) + service_time_s
        finite = np.isfinite(pred)
        if not finite.any():
            return np.inf
        # unstable grid points predicted as inf but observed finite -> big penalty
        penalty = float((~finite).sum()) * 1e6
        return float(np.mean((pred[finite] - obs[finite]) ** 2)) + penalty

    # golden-section search
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = k_lo, k_hi
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = loss(c), loss(d)
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = loss(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = loss(d)
    return float(0.5 * (a + b))
