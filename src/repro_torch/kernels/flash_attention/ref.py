"""Plain PyTorch flash-attention semantics: GQA scaled-dot-product attention
with optional causal mask, sliding window and gemma2 score soft-capping.

Unlike ``repro.kernels.flash_attention.ref`` (head-major), this takes the
model's (B, S, heads, hd) layout, the layout the port's kernel reads.
Unchunked: it materialises the full score matrix (what the kernel avoids).
"""

from __future__ import annotations

import torch

__all__ = ["flash_attention_reference", "NEG_INF"]

NEG_INF = -2.0e38


def flash_attention_reference(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, K, hd)
    v: torch.Tensor,  # (B, Skv, K, hd)
    *,
    causal: bool = True,
    window: int = 0,  # 0 = unbounded
    softcap: float = 0.0,
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qr = q.reshape(B, Sq, K, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qr.float(), k.float()) * hd**-0.5
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    q_pos = torch.arange(Sq, device=q.device) + (Skv - Sq)
    k_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)
