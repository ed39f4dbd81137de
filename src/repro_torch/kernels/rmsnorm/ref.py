"""Plain PyTorch RMSNorm ((1+scale) parameterisation, fp32 core) and the
residual add before it: the versions the CPU runs and the card's kernels are
held against."""

from __future__ import annotations

import torch

__all__ = ["rmsnorm_reference", "rmsnorm_add_reference"]


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
