"""Plain PyTorch GQA decode attention (one token vs a KV cache).

Takes the model layout: q (B, 1, H, hd), caches (B, S, K, hd); keys at
positions <= pos are attended (one scalar pos for the whole batch), so the
cache may hold anything past pos.
"""

from __future__ import annotations

import torch

__all__ = ["decode_attention_reference"]

NEG_INF = -2.0e38


def decode_attention_reference(
    q: torch.Tensor,  # (B, 1, H, hd)
    k: torch.Tensor,  # (B, S, K, hd)
    v: torch.Tensor,
    pos: int,
    *,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, _, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qr = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qr.float(), k.float()) * hd**-0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    valid = torch.arange(S, device=q.device) <= pos
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v.dtype), v)
    return out.reshape(B, 1, H, hd)
