"""Plain PyTorch selective scan (Mamba S6): the version the CPU runs and the
card's kernels (``csrc/ssm_scan.cu``) are held against. Loops over time, in
fp32, with the arithmetic of the JAX package's ``ssm_scan_reference``: the
scan, its states at every chunk start, and its backward."""

from __future__ import annotations

import torch

__all__ = ["ssm_scan_reference", "ssm_scan_chunk_states", "ssm_scan_backward_reference"]


def _zeros_or(h0: torch.Tensor | None, B: int, D: int, N: int, device) -> torch.Tensor:
    return (torch.zeros((B, D, N), dtype=torch.float32, device=device) if h0 is None
            else h0.float())


def _step(h, dt_t, u_t, B_t, a):
    """h_t from h_{t-1}: (exp(dt_t A), h_t), in fp32."""
    dtf = dt_t.float()
    decay = torch.exp(dtf[..., None] * a)
    return decay, decay * h + (dtf * u_t.float())[..., None] * B_t.float()[:, None, :]


def ssm_scan_reference(dt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor, u: torch.Tensor,
                       A: torch.Tensor, h0: torch.Tensor | None = None):
    """h_t = exp(dt_t A) * h_{t-1} + (dt_t u_t) B_t ;  y_t = sum_n h_t[n] C_t[n].

    dt, u (B, T, D); Bc, Cc (B, T, N); A (D, N) negative; h0 (B, D, N) fp32 or
    None for zeros. Returns (y (B, T, D) in u's dtype, h_final (B, D, N) fp32);
    each y_t is rounded once to u's dtype."""
    B, T, D = u.shape
    h = _zeros_or(h0, B, D, A.shape[1], u.device)
    a = A.float()[None]
    ys = []
    for t in range(T):
        _, h = _step(h, dt[:, t], u[:, t], Bc[:, t], a)
        ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t].float()).to(u.dtype))
    return torch.stack(ys, dim=1), h


def ssm_scan_chunk_states(dt: torch.Tensor, Bc: torch.Tensor, u: torch.Tensor, A: torch.Tensor,
                          h0: torch.Tensor | None, chunk: int) -> torch.Tensor:
    """The state before every chunk's first step: (B, ceil(T / chunk), D, N)
    fp32, entry k the h before step k * chunk (entry 0 is h0, zeros when
    None)."""
    B, T, D = u.shape
    N = A.shape[1]
    h = _zeros_or(h0, B, D, N, u.device)
    a = A.float()[None]
    states = []
    for t in range(T):
        if t % chunk == 0:
            states.append(h)
        _, h = _step(h, dt[:, t], u[:, t], Bc[:, t], a)
    if not states:
        return torch.zeros((B, 0, D, N), dtype=torch.float32, device=u.device)
    return torch.stack(states, dim=1)


def ssm_scan_backward_reference(dt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                                u: torch.Tensor, A: torch.Tensor, h0: torch.Tensor | None,
                                dy: torch.Tensor, dh_final: torch.Tensor | None = None):
    """The scan's gradients by an explicit reverse loop in fp32 (not autograd).
    With a_t = exp(dt_t A) and dh_t the gradient reaching h_t,
    dh_t = C_t dy_t + a_{t+1} dh_{t+1}, from dh_final (zeros when None):

        ddt_t = sum_n dh_t (A a_t h_{t-1} + u_t B_t)    du_t = dt_t sum_n dh_t B_t
        dB_t = sum_d dh_t dt_t u_t                        dC_t = sum_d h_t dy_t
        dA = sum_{b,t} dh_t dt_t a_t h_{t-1}              dh0 = a_1 dh_1

    y's rounding to u's dtype passes dy through unchanged. Returns (ddt, dBc,
    dCc, du, dA, dh0), each in its input's dtype; dA and dh0 fp32."""
    B, T, D = u.shape
    N = A.shape[1]
    h = _zeros_or(h0, B, D, N, u.device)
    a = A.float()[None]
    before = []  # h_{t-1} for every t
    for t in range(T):
        before.append(h)
        _, h = _step(h, dt[:, t], u[:, t], Bc[:, t], a)
    g = (torch.zeros((B, D, N), dtype=torch.float32, device=u.device) if dh_final is None
         else dh_final.float())
    ddt, du = (torch.empty((B, T, D), dtype=torch.float32, device=u.device) for _ in range(2))
    dB, dC = (torch.empty((B, T, N), dtype=torch.float32, device=u.device) for _ in range(2))
    dA = torch.zeros((D, N), dtype=torch.float32, device=u.device)
    for t in reversed(range(T)):
        dtf, uf, dyf = dt[:, t].float(), u[:, t].float(), dy[:, t].float()
        bf, cf = Bc[:, t].float()[:, None, :], Cc[:, t].float()[:, None, :]
        decay = torch.exp(dtf[..., None] * a)
        ah = decay * before[t]  # a_t h_{t-1}
        xw = (dtf * uf)[..., None]
        g = g + dyf[..., None] * cf  # dh_t
        ddt[:, t] = (g * (a * ah + uf[..., None] * bf)).sum(-1)
        du[:, t] = dtf * (g * bf).sum(-1)
        dB[:, t] = (g * xw).sum(1)
        dC[:, t] = ((ah + xw * bf) * dyf[..., None]).sum(1)  # h_t dy_t
        dA += (g * dtf[..., None] * ah).sum(0)
        g = decay * g
    return (ddt.to(dt.dtype), dB.to(Bc.dtype), dC.to(Cc.dtype), du.to(u.dtype), dA, g)
