"""Plain PyTorch Lindley recursions: the versions the CPU runs and the card's
kernels (``csrc/lindley_scan.cu``) are held against, bit for bit."""

from __future__ import annotations

import torch

__all__ = ["lindley_scan_reference", "lindley_kserver_reference"]


def lindley_scan_reference(arrivals: torch.Tensor, services: torch.Tensor) -> torch.Tensor:
    """dep_i = max(arr_i, dep_{i-1}) + svc_i per row, the clock from -inf."""
    arr_t, svc_t = arrivals.t().contiguous(), services.t().contiguous()
    out = torch.empty_like(arr_t)
    clk = torch.full(arr_t.shape[1:], float("-inf"), dtype=arrivals.dtype,
                     device=arrivals.device)
    for t in range(arr_t.shape[0]):
        clk = torch.maximum(arr_t[t], clk) + svc_t[t]
        out[t] = clk
    return out.t().contiguous()


def lindley_kserver_reference(arrivals: torch.Tensor, services: torch.Tensor, k: torch.Tensor,
                              k_max: int) -> torch.Tensor:
    """FCFS k-server departures per row: each job starts on the first free
    server of lowest index (slots >= k_row start, and stay, at +inf) at
    max(arrival, free time); that server is then free at the job's departure.
    Servers start free at time 0, as ``simulation.station_pass``'s heap does."""
    b = arrivals.shape[0]
    arr_t, svc_t = arrivals.t().contiguous(), services.t().contiguous()
    out = torch.empty_like(arr_t)
    slot = torch.arange(k_max, device=arrivals.device)
    free = torch.full((b, k_max), float("inf"), dtype=arrivals.dtype, device=arrivals.device)
    free[slot[None, :] < k.to(arrivals.device)[:, None]] = 0.0
    rows = torch.arange(b, device=arrivals.device)
    for t in range(arr_t.shape[0]):
        idx = torch.argmin(free, dim=1)  # the first of equal minima
        dep = torch.maximum(arr_t[t], free[rows, idx]) + svc_t[t]
        free[rows, idx] = dep
        out[t] = dep
    return out.t().contiguous()
