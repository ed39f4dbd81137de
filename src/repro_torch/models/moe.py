"""Mixture-of-Experts: GShard-style top-k token-choice routing with capacity.

The port's counterpart of ``repro.models.moe``: dense one-hot dispatch and
combine ([arXiv:2006.16668]), tokens split into dispatch groups of
``moe_group_size``, each expert's buffer holding ``capacity`` tokens per
group; a (token, slot) pair past its expert's capacity is dropped. No Pallas
kernel sits on this path in the reference; the products stay
``torch.einsum`` (batched matrix products).

Variants (chosen in ``models.lm``):
  "moe"       — routed experts only (dbrx, jamba)
  "moe_dense" — routed experts + parallel dense residual MLP (arctic)
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from .layers import _act
from .params import TSpec

__all__ = ["moe_template", "moe_apply", "capacity", "route", "router_aux_loss"]


def moe_template(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": TSpec((d, e), ("embed", "expert"), init="fan_in"),
        "wi": TSpec((e, d, f), ("expert", "embed", "expert_ff"), init="fan_in"),
        "wg": TSpec((e, d, f), ("expert", "embed", "expert_ff"), init="fan_in"),
        "wo": TSpec((e, f, d), ("expert", "expert_ff", "embed"), init="fan_in"),
    }


def _largest_divisor(n: int, upper: int) -> int:
    """Largest divisor of n that is <= upper (group tokens exactly)."""
    for s in range(upper, 0, -1):
        if n % s == 0:
            return s
    return 1


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    """Per-group per-expert capacity C = ceil(k * s * cf / E), rounded up to a
    multiple of 4 and at least 4."""
    c = math.ceil(
        cfg.num_experts_per_tok * group_tokens * cfg.capacity_factor / cfg.num_experts)
    return max(4, ((c + 3) // 4) * 4)


def route(p, xt: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Router probabilities (g, s, E) from fp32 logits, and each token's
    top-k experts (g, s, k), most probable first."""
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    return probs, torch.topk(probs, cfg.num_experts_per_tok, dim=-1).indices


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). Routed top-k with capacity dropping."""
    B, S, d = x.shape
    E, topk = cfg.num_experts, cfg.num_experts_per_tok
    n = B * S
    s = _largest_divisor(n, min(cfg.moe_group_size, n))
    g = n // s
    C = capacity(cfg, s)

    xt = x.reshape(g, s, d)
    probs, expert_idx = route(p, xt, cfg)
    gate_vals = torch.gather(probs, -1, expert_idx)  # (g, s, topk), as top-k returns them
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # position of each (token, slot) inside its expert's buffer, counted over
    # the token-major (s * topk) flattening
    onehot_e = F.one_hot(expert_idx, E).float()  # (g, s, topk, E)
    flat = onehot_e.reshape(g, s * topk, E)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(dim=-1).reshape(g, s, topk)
    keep = pos < C
    # dispatch and combine per k-slot, accumulated in the model dtype
    disp = torch.zeros((g, s, E, C), dtype=x.dtype, device=x.device)
    comb = torch.zeros_like(disp)
    for kk in range(topk):
        oe = (onehot_e[:, :, kk] * keep[:, :, kk, None]).to(x.dtype)  # (g, s, E)
        # a dropped pair has oe = 0, so clamping its position changes nothing
        oc = F.one_hot(pos[:, :, kk].long().clamp(max=C - 1), C).to(x.dtype)  # (g, s, C)
        slot = oe[..., None] * oc[:, :, None, :]
        disp = disp + slot
        comb = comb + slot * gate_vals[:, :, kk, None, None].to(x.dtype)

    expert_in = torch.einsum("gsec,gsd->egcd", disp, xt)
    act = _act(cfg.mlp_act)
    h = torch.einsum("egcd,edf->egcf", expert_in, p["wi"])
    h = act(torch.einsum("egcd,edf->egcf", expert_in, p["wg"])) * h
    expert_out = torch.einsum("egcf,efd->egcd", h, p["wo"])
    out = torch.einsum("gsec,egcd->gsd", comb, expert_out)
    return out.reshape(B, S, d)


def router_aux_loss(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch [arXiv:2101.03961] style): E
    times the sum over experts of the share of top-k choices it takes and its
    mean router probability. The reference defines it and no loss calls it."""
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)  # (B, S, E)
    idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1).indices
    counts = F.one_hot(idx, cfg.num_experts).float().sum(dim=(0, 1, 2))
    frac_tokens = counts / torch.clamp(counts.sum(), min=1.0)
    frac_probs = probs.mean(dim=(0, 1))
    return cfg.num_experts * torch.sum(frac_tokens * frac_probs)
