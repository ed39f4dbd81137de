"""Attention: GQA with RoPE, optional sliding window + softcap, KV caches.

The port's counterpart of ``repro.models.attention``:
  * full-sequence (prefill): projections, RoPE, then the flash-attention
    kernel wrapper (the reference ran XLA's query-chunked attention here);
  * decode: one query token against the cache, through the decode-attention
    kernel wrapper. Global layers use an append cache; local (sliding-window)
    layers a ring buffer of min(cache_len, W) slots, slot = pos % W. The
    cache is preallocated and the new token's K/V are written into it in
    place, where the reference built a new cache with
    ``dynamic_update_slice``;
  * cross-attention (encoder-decoder): decoder queries against the encoder
    output's K/V (``cross_kv``), with no rotary on either side; at prefill
    through the flash kernel unmasked (any number of queries and keys), at
    decode through the decode kernel over every cached frame.

Training differentiates the full-sequence and cross paths through the flash
wrapper's backward, over query chunks of ``cfg.seq_chunk`` rows (the
reference's chunk).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention

from .layers import rope_rotate, rope_tables
from .params import TSpec

__all__ = [
    "attn_template",
    "kv_cache_template",
    "attn_forward",
    "attn_decode",
    "prefill_cache_from_kv",
    "cross_kv",
    "cross_attn_forward",
]


def attn_template(cfg: ModelConfig) -> dict:
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {
        "wq": TSpec((d, q), ("embed", "qkv"), init="fan_in"),
        "wk": TSpec((d, kv), ("embed", "kv"), init="fan_in"),
        "wv": TSpec((d, kv), ("embed", "kv"), init="fan_in"),
        "wo": TSpec((q, d), ("qkv", "embed"), init="fan_in"),
    }


def kv_cache_template(cfg: ModelConfig, batch: int, cache_len: int, *, local: bool) -> dict:
    s = min(cache_len, cfg.window_size) if local else cache_len
    shape = (batch, s, cfg.num_kv_heads, cfg.resolved_head_dim)
    axes = ("cache_batch", "cache_seq", None, None)
    return {
        "k": TSpec(shape, axes, init="zeros"),
        "v": TSpec(shape, axes, init="zeros"),
    }


def attn_forward(p, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True,
                 local: bool = False, return_kv: bool = False, rope_cs=None):
    """x: (B, S, d). Full-sequence attention through the flash kernel.

    ``rope_cs`` takes (cos, sin) tables precomputed for positions 0..S-1, so a
    model computes them once for all its layers."""
    B, S, _ = x.shape
    K, hd, H = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_heads
    q = (x @ p["wq"]).view(B, S, H, hd)
    k = (x @ p["wk"]).view(B, S, K, hd)
    v = (x @ p["wv"]).view(B, S, K, hd)
    if cfg.rope:
        cos, sin = rope_cs if rope_cs is not None else rope_tables(
            torch.arange(S, device=x.device), hd, cfg.rope_theta)
        q = rope_rotate(q, cos, sin)
        k = rope_rotate(k, cos, sin)
    window = cfg.window_size if local else 0
    out = flash_attention(q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap,
                          chunk=cfg.seq_chunk)
    y = out.reshape(B, S, H * hd) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


def prefill_cache_from_kv(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig, *, local: bool):
    """Convert full-sequence K/V into the decode cache layout.

    Global: the identity (append cache, S slots). Local: a ring buffer of the
    last W positions, position t in slot t % W: zero-padded to W slots when
    S <= W, else the last W positions rolled by (S - W) % W."""
    if not local:
        return {"k": k, "v": v}
    W = cfg.window_size
    S = k.shape[1]
    if S <= W:
        return {"k": F.pad(k, (0, 0, 0, 0, 0, W - S)), "v": F.pad(v, (0, 0, 0, 0, 0, W - S))}
    shift = (S - W) % W
    return {"k": torch.roll(k[:, -W:], shift, dims=1),
            "v": torch.roll(v[:, -W:], shift, dims=1)}


def attn_decode(p, x: torch.Tensor, cache: dict, pos: int, cfg: ModelConfig, *,
                local: bool = False, rope_cs=None):
    """x: (B, 1, d); pos: the absolute position of this token, shared by the
    whole batch. Writes the token's K/V into ``cache`` in place, at slot
    ``pos`` (global) or ``pos % W`` (local ring), and returns (y, cache).

    A ring needs no mask of its own: the reference attends slot i iff
    pos - ((pos - i) mod W) >= 0, which for every pos below the cache's
    capacity is the set i <= pos clipped to the ring, the set that
    ``decode_attention`` attends (min(pos + 1, slots) keys). Softmax does
    not depend on the keys' order, and the cached K already carry RoPE."""
    pos = int(pos)
    B = x.shape[0]
    K, hd, H = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_heads
    q = (x @ p["wq"]).view(B, 1, H, hd)
    k_new = (x @ p["wk"]).view(B, 1, K, hd)
    v_new = (x @ p["wv"]).view(B, 1, K, hd)
    if cfg.rope:
        cos, sin = rope_cs if rope_cs is not None else rope_tables(
            torch.tensor([pos], device=x.device), hd, cfg.rope_theta)
        q = rope_rotate(q, cos, sin)
        k_new = rope_rotate(k_new, cos, sin)
    slot = pos % cfg.window_size if local else pos
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    out = decode_attention(q, cache["k"], cache["v"], pos, softcap=cfg.attn_softcap)
    y = out.reshape(B, 1, H * hd) @ p["wo"]
    return y, cache


def cross_kv(p, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder output's cross-attention K and V, (B, Se, K, hd) each: no
    rotary (the reference rotates only self-attention's keys)."""
    B, Se, _ = enc_out.shape
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return (enc_out @ p["wk"]).view(B, Se, K, hd), (enc_out @ p["wv"]).view(B, Se, K, hd)


def cross_attn_forward(p, x: torch.Tensor, enc_k: torch.Tensor, enc_v: torch.Tensor,
                       cfg: ModelConfig, *, decode: bool = False):
    """x: (B, Sq, d) against the encoder's K/V (B, Se, K, hd); every query
    sees every frame, and q carries no rotary. At prefill the flash kernel
    runs unmasked, so Sq may exceed Se; at decode (Sq = 1) the decode kernel
    attends all Se cached frames (pos Se - 1) and leaves the cache as it is."""
    B, S, _ = x.shape
    hd, H = cfg.resolved_head_dim, cfg.num_heads
    q = (x @ p["wq"]).view(B, S, H, hd)
    if decode:
        out = decode_attention(q, enc_k, enc_v, enc_k.shape[1] - 1, softcap=cfg.attn_softcap)
    else:
        out = flash_attention(q, enc_k, enc_v, causal=False, softcap=cfg.attn_softcap,
                              chunk=cfg.seq_chunk)
    return out.reshape(B, S, H * hd) @ p["wo"]
