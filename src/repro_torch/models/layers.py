"""Shared layer primitives: RMSNorm, RoPE, MLP, embeddings.

The port's counterpart of ``repro.models.layers``. ``rms_norm`` and
``rms_norm_add`` (the residual add and the norm after it, one launch) go
through the RMSNorm kernel wrappers: the Hopper kernel for a CUDA tensor,
its plain version for a CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_add
from repro_torch.sharding.partition import hint

from .params import TSpec

__all__ = [
    "rms_norm",
    "rms_norm_add",
    "rope_tables",
    "rope_rotate",
    "rope_apply",
    "mlp_template",
    "mlp_apply",
    "norm_template",
    "embed_template",
    "softcap",
]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32 ([arXiv:1910.07467]); (1+scale) parameterisation
    (gemma-style, zero-init-friendly)."""
    return rmsnorm(x, scale, eps)


def rms_norm_add(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm after it: (x + r, rms_norm(x + r)), the
    sum rounded to x's dtype before the norm reads it."""
    return rmsnorm_add(x, r, scale, eps)


def norm_template(d: int) -> TSpec:
    return TSpec((d,), ("embed",), init="zeros")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """(cos, sin) tables for absolute positions (S,) or (B, S), shaped
    (1 or B, S, 1, hd) to broadcast against (B, S, H, hd). The sine is
    sign-folded for rotate-half ([-sin, sin]), so ``rope_rotate`` is one
    multiply-add. A model computes the tables once per call for all layers."""
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs  # (S, half) or (B, S, half)
    if positions.ndim == 1:
        ang = ang[None]
    ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, S, H, hd) by ``rope_tables`` (llama rotate-half):
    [x1 cos - x2 sin, x2 cos + x1 sin] in fp32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    xf = x.float()
    swapped = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return torch.addcmul(xf * cos, swapped, sin).to(x.dtype)


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding ([arXiv:2104.09864], llama rotate-half convention).

    x: (B, S, H, hd); positions: (S,) or (B, S) absolute token positions.
    """
    return rope_rotate(x, *rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# MLP (plain or gated GLU)
# ---------------------------------------------------------------------------


def mlp_template(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    t = {
        "wi": TSpec((d, f), ("embed", "ff"), init="fan_in"),
        "wo": TSpec((f, d), ("ff", "embed"), init="fan_in"),
    }
    if cfg.gated_mlp:
        t["wg"] = TSpec((d, f), ("embed", "ff"), init="fan_in")
    return t


def _act(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = _act(cfg.mlp_act)
    h = hint(x @ p["wi"], "batch", "seq_inner", "ff")
    if cfg.gated_mlp:
        h = act(x @ p["wg"]) * h
    else:
        h = act(h)
    return hint(h @ p["wo"], "batch", "seq", None)


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------


def embed_template(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab  # shard-friendly padding; ids stay < vocab_size
    t = {"embedding": TSpec((v, cfg.d_model), ("vocab", "embed"), std=0.02)}
    if not cfg.tie_embeddings:
        t["unembed"] = TSpec((cfg.d_model, v), ("embed", "vocab"), init="fan_in")
    return t
