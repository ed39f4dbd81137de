"""Plain PyTorch decision scan: the version the CPU runs and the card's kernel
(``csrc/decision_scan.cu``) is held against, decision for decision."""

from __future__ import annotations

import torch

__all__ = ["ON_DEVICE", "decision_scan_reference"]

ON_DEVICE = -1  # target index convention (repro_torch.core.manager.ON_DEVICE)


def decision_scan_reference(
    costs: torch.Tensor,  # (T, N, E+1) stacked costs, column 0 = on-device
    cohort: torch.Tensor,  # (N,) int32
    *,
    hysteresis: float = 0.0,
    stagger: int = 1,
    prev: torch.Tensor | None = None,
    t0: int = 0,
) -> torch.Tensor:
    """(T, N) int32 choice trajectory under first-argmin + hysteresis + cohort
    staggering: epoch t is global epoch ``t0 + t``, and the carry starts from
    ``prev`` (default ``ON_DEVICE``). ``(1 - hysteresis)`` is taken in double
    and rounded once to the costs' dtype, as the reference does."""
    t_n, n, _ = costs.shape
    dev = costs.device
    cohort = cohort.to(device=dev, dtype=torch.int32)
    prev = torch.full((n,), ON_DEVICE, dtype=torch.int32, device=dev) if prev is None \
        else prev.to(device=dev, dtype=torch.int32)
    factor = torch.tensor(1.0 - hysteresis, dtype=costs.dtype, device=dev)
    out = torch.empty((t_n, n), dtype=torch.int32, device=dev)
    for t in range(t_n):
        idx = t0 + t
        c_t = costs[t]
        # torch.argmin: the first NaN, else the first of equal minima
        choice = torch.argmin(c_t, dim=1).to(torch.int32) - 1
        decided = choice
        if idx >= stagger and hysteresis > 0.0:
            predicted = torch.amin(c_t, dim=1)  # NaN if any column is NaN
            prev_t = torch.gather(c_t, 1, (prev + 1).long()[:, None])[:, 0]
            keep = (choice != prev) & torch.isfinite(prev_t) & (predicted > factor * prev_t)
            decided = torch.where(keep, prev, choice)
        prev = torch.where(cohort == idx % stagger, decided, prev)
        out[t] = prev
    return out
