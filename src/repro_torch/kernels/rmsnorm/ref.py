"""Plain PyTorch RMSNorm ((1+scale) parameterisation, fp32 core), the
residual add before it, and their backward: the versions the CPU runs and the
card's kernels are held against."""

from __future__ import annotations

import torch

__all__ = ["rmsnorm_reference", "rmsnorm_add_reference", "rmsnorm_backward_reference"]


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_add_reference(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                          eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, y): s = x + r in x's dtype, y = rmsnorm(s), the reference's
    ``x = x + y; h = rms_norm(x, ...)``."""
    s = x + r
    return s, rmsnorm_reference(s, scale, eps)


def rmsnorm_backward_reference(x: torch.Tensor, scale: torch.Tensor, gy: torch.Tensor,
                               eps: float = 1e-6, gs: torch.Tensor | None = None):
    """(dx, dscale) of y = x * rstd * (1 + scale), rstd = rsqrt(mean(x^2) + eps),
    in fp32: with u = gy * (1 + scale) and x_hat = x * rstd,
    dx = rstd * (u - x_hat * mean(u * x_hat)) and dscale = sum over rows of
    gy * x_hat. ``gs``, the gradient reaching ``x`` directly (``rmsnorm_add``'s
    s), is added to dx."""
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    g = gy.float()
    u = g * (1.0 + scale.float())
    dx = rstd * (u - xhat * torch.mean(u * xhat, dim=-1, keepdim=True))
    dscale = (g * xhat).reshape(-1, x.shape[-1]).sum(0)
    if gs is not None:
        dx = dx + gs.float()
    return dx.to(x.dtype), dscale.to(scale.dtype)
