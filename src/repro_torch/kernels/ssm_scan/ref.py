"""Plain PyTorch selective scan (Mamba S6): the version the CPU runs and the
card's kernel (``csrc/ssm_scan.cu``) is held against. A loop over time, in
fp32, with the arithmetic of the JAX package's ``ssm_scan_reference``."""

from __future__ import annotations

import torch

__all__ = ["ssm_scan_reference"]


def ssm_scan_reference(dt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor, u: torch.Tensor,
                       A: torch.Tensor, h0: torch.Tensor | None = None):
    """h_t = exp(dt_t A) * h_{t-1} + (dt_t u_t) B_t ;  y_t = sum_n h_t[n] C_t[n].

    dt, u (B, T, D); Bc, Cc (B, T, N); A (D, N) negative; h0 (B, D, N) fp32 or
    None for zeros. Returns (y (B, T, D) in u's dtype, h_final (B, D, N) fp32);
    each y_t is rounded once to u's dtype."""
    B, T, D = u.shape
    N = A.shape[1]
    h = (torch.zeros((B, D, N), dtype=torch.float32, device=u.device) if h0 is None
         else h0.float())
    a = A.float()[None]
    y = torch.empty((B, T, D), dtype=u.dtype, device=u.device)
    for t in range(T):
        dtf = dt[:, t].float()
        decay = torch.exp(dtf[..., None] * a)
        inp = (dtf * u[:, t].float())[..., None] * Bc[:, t].float()[:, None, :]
        h = decay * h + inp
        y[:, t] = torch.einsum("bdn,bn->bd", h, Cc[:, t].float()).to(u.dtype)
    return y, h
