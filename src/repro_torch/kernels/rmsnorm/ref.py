"""Plain PyTorch RMSNorm ((1+scale) parameterisation, fp32 core): the
version the CPU runs and the card's kernel is held against."""

from __future__ import annotations

import torch

__all__ = ["rmsnorm_reference"]


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)
