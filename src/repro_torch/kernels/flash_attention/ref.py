"""Plain PyTorch flash-attention semantics: GQA scaled-dot-product attention
with optional causal mask, sliding window and gemma2 score soft-capping.

Unlike ``repro.kernels.flash_attention.ref`` (head-major), this takes the
model's (B, S, heads, hd) layout, the layout the port's kernel reads.
Unchunked: it materialises the full score matrix (what the kernel avoids).
``flash_attention_backward_reference`` is the plain backward the card's
backward kernel is held against (the CPU's backward).
"""

from __future__ import annotations

import torch

__all__ = ["flash_attention_reference", "flash_attention_backward_reference", "NEG_INF"]

NEG_INF = -2.0e38


def flash_attention_reference(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, K, hd)
    v: torch.Tensor,  # (B, Skv, K, hd)
    *,
    causal: bool = True,
    window: int = 0,  # 0 = unbounded
    softcap: float = 0.0,
    chunk: int = 512,  # the wrapper's backward chunk; autograd differentiates this unchunked
    return_lse: bool = False,
):
    """The output, and with ``return_lse`` also each row's log-sum-exp of its
    scaled, capped, masked scores, (B, H, Sq) fp32 (the kernel's second
    output in training)."""
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
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v).reshape(B, Sq, H, hd)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1).reshape(B, H, Sq)
    return out


def flash_attention_backward_reference(q, k, v, o, do, *, causal: bool, window: int,
                                       softcap: float, chunk: int):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` with output ``o``, given
    ``do``, in fp32, over query chunks of ``chunk`` rows. For each chunk, over
    the keys it can see (up to its last query when causal, from its first
    query's window on when windowed): the scores again (scale, soft-cap,
    mask), P = softmax, dV += P^T dO, dP = dO V^T, D = rowsum(dO * O),
    dS = P * (dP - D) times the soft-cap's tanh derivative and the scale,
    dQ = dS K, dK += dS^T Q; a KV head's dk and dv sum over its query group.
    Each gradient is returned in its input's dtype. The softmax is taken
    anew (the kernel reads the forward's log-sum-exp instead)."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    off = Skv - Sq  # the queries are the last Sq of the Skv positions
    scale = hd**-0.5
    kf, vf = k.float(), v.float()
    dq = torch.empty((B, Sq, K, G, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Skv, K, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for s in range(0, Sq, chunk):
        e = min(s + chunk, Sq)
        hi = min(Skv, e + off) if causal else Skv
        lo = max(0, s + off - window + 1) if window > 0 else 0
        qc, oc, doc = (t[:, s:e].float().reshape(B, e - s, K, G, hd) for t in (q, o, do))
        kb, vb = kf[:, lo:hi], vf[:, lo:hi]
        scores = torch.einsum("bqkgh,bskh->bkgqs", qc, kb) * scale
        if softcap > 0:
            t = torch.tanh(scores / softcap)
            scores = softcap * t
        q_pos = torch.arange(s, e, device=q.device)[:, None] + off
        k_pos = torch.arange(lo, hi, device=q.device)[None, :]
        mask = torch.ones((e - s, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window > 0:
            mask &= k_pos > q_pos - window
        p = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
        dv[:, lo:hi] += torch.einsum("bkgqs,bqkgh->bskh", p, doc)
        dp = torch.einsum("bqkgh,bskh->bkgqs", doc, vb)
        delta = (doc * oc).sum(-1).permute(0, 2, 3, 1)[..., None]  # (B, K, G, c, 1)
        ds = p * (dp - delta)
        if softcap > 0:
            ds = ds * (1.0 - t * t)
        ds = ds * scale
        dq[:, s:e] = torch.einsum("bkgqs,bskh->bqkgh", ds, kb)
        dk[:, lo:hi] += torch.einsum("bkgqs,bqkgh->bskh", ds, qc)
    return dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
