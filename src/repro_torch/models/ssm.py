"""Mamba (S6) selective-state-space mixer [arXiv:2312.00752].

The port's counterpart of ``repro.models.ssm``. The projections (in, x, dt,
out) are matrix products around the scan; the recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t runs in the selective-scan kernel
wrapper (``kernels/ssm_scan``): the Hopper kernel for CUDA tensors, its plain
loop for CPU tensors. The reference evaluates the recurrence with a
``lax.scan`` and never calls its Pallas kernel; the port wires the kernel in.

Prefill returns the layer's decode cache: the last d_conv - 1 raw conv inputs
and the scan's final state (fp32). Decode consumes one token per sequence
from that cache: O(1) per token.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan.ops import ssm_scan

from .params import TSpec

__all__ = ["mamba_template", "mamba_cache_template", "mamba_forward", "mamba_decode"]


def _dt_rank(cfg: ModelConfig) -> int:
    return math.ceil(cfg.d_model / 16)


def mamba_template(cfg: ModelConfig) -> dict:
    d, di, n = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    dtr, dc = _dt_rank(cfg), cfg.mamba_d_conv
    return {
        "in_proj": TSpec((d, 2 * di), ("embed", "ff"), init="fan_in"),
        "conv_w": TSpec((dc, di), (None, "ff"), init="normal", std=0.1),
        "conv_b": TSpec((di,), ("ff",), init="zeros"),
        "x_proj": TSpec((di, dtr + 2 * n), ("ff", None), init="fan_in"),
        "dt_proj": TSpec((dtr, di), (None, "ff"), init="fan_in"),
        "dt_bias": TSpec((di,), ("ff",), init="zeros"),
        "A_log": TSpec((di, n), ("ff", None), init="ones"),
        "D": TSpec((di,), ("ff",), init="ones"),
        "out_proj": TSpec((di, d), ("ff", "embed"), init="fan_in"),
    }


def mamba_cache_template(cfg: ModelConfig, batch: int) -> dict:
    di, n, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {
        "conv": TSpec((batch, dc - 1, di), ("cache_batch", None, "ff"), init="zeros"),
        "h": TSpec((batch, di, n), ("cache_batch", "ff", None), init="zeros", dtype="float32"),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (logaddexp(x, 0));
    ``F.softplus`` turns into the identity above 20, which this does not."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssm_inputs(p, x: torch.Tensor):
    """The input projection split into (u, z), each (B, S, d_inner)."""
    return (x @ p["in_proj"]).chunk(2, dim=-1)


def _ssm_core(p, u_conv: torch.Tensor, cfg: ModelConfig, h0: torch.Tensor | None):
    """The selective scan over u_conv (B, S, di) from h0 (None for zeros).
    Returns (y (B, S, di), h_final (B, di, n) fp32)."""
    n, dtr = cfg.mamba_d_state, _dt_rank(cfg)
    dbc = u_conv @ p["x_proj"]  # (B, S, dtr + 2n)
    dt_in, Bc, Cc = dbc.split([dtr, n, n], dim=-1)  # Bc, Cc: strided column slices
    dt = _softplus(dt_in @ p["dt_proj"] + p["dt_bias"])  # (B, S, di)
    A = -torch.exp(p["A_log"].float())  # (di, n), negative real
    y, h_final = ssm_scan(dt, Bc, Cc, u_conv, A, h0)
    return y + u_conv * p["D"], h_final


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, *, return_cache: bool = False):
    """x: (B, S, d) -> (B, S, d) [, cache {conv (B, dc-1, di), h (B, di, n)}]."""
    S = x.shape[1]
    dc = cfg.mamba_d_conv
    u, z = _ssm_inputs(p, x)
    # causal depthwise conv along the sequence, summed in the reference's order
    u_pad = F.pad(u, (0, 0, dc - 1, 0))
    u_conv = sum(u_pad[:, i:i + S] * p["conv_w"][i] for i in range(dc)) + p["conv_b"]
    y, h_final = _ssm_core(p, F.silu(u_conv), cfg, None)
    out = (y * F.silu(z)) @ p["out_proj"]
    if not return_cache:
        return out
    # conv cache = the last dc - 1 raw conv inputs (pre-activation), as decode reads them
    return out, {"conv": u_pad[:, S:S + dc - 1], "h": h_final}


def mamba_decode(p, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """x: (B, 1, d); cache {conv (B, dc-1, di), h (B, di, n)} -> (y, new cache).
    The new cache is returned, not written: the caller stores it."""
    u, z = _ssm_inputs(p, x)  # (B, 1, di)
    window = torch.cat([cache["conv"], u], dim=1)  # (B, dc, di)
    u_conv = torch.einsum("bcd,cd->bd", window, p["conv_w"]) + p["conv_b"]
    # the einsum may come back channel-major; the scan reads (B, 1, di) rows
    y, h = _ssm_core(p, F.silu(u_conv).contiguous()[:, None, :], cfg, cache["h"])
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, {"conv": window[:, 1:], "h": h}
