"""Flash-attention wrapper: the plain version for a CPU tensor, the
hand-written Hopper kernel (``csrc/flash_attention.cu``) for a CUDA tensor.

Takes the model's (B, S, heads, hd) layout; the kernel reads it through
strides, so nothing is transposed. Causal and windowed attention take the
queries as the last Sq of the Skv positions (Sq <= Skv); unmasked attention
(an encoder's, or cross-attention) takes any Sq and Skv.
``flash_attention.launches`` counts the kernel's launches (CPU calls never
touch it).

Gradients: where grad mode is on and q, k or v requires grad, a CUDA call
goes through an ``autograd.Function`` whose forward is the same kernel
launch, saving q, k, v and the output, and whose backward is
``flash_attention_backward``: torch operations in fp32 over query chunks
of ``chunk`` rows, each recomputing its scores (the reference has no
backward kernel; XLA differentiates its query-chunked attention,
rematerialising each chunk's scores).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import NEG_INF, flash_attention_reference

__all__ = ["flash_attention", "flash_attention_backward", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128, 256)  # instantiated in csrc/flash_attention.cu
_ARGTYPES = (
    (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (ctypes.c_longlong,) * 12
    + (ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
)


def flash_attention_backward(q, k, v, o, do, *, causal: bool, window: int, softcap: float,
                             chunk: int):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` with output ``o``, given
    ``do``, in fp32, over query chunks of ``chunk`` rows. For each chunk, over
    the keys it can see (up to its last query when causal, from its first
    query's window on when windowed): the scores again (scale, soft-cap,
    mask), P = softmax, dV += P^T dO, dP = dO V^T, D = rowsum(dO * O),
    dS = P * (dP - D) times the soft-cap's tanh derivative and the scale,
    dQ = dS K, dK += dS^T Q; a KV head's dk and dv sum over its query group.
    Each gradient is returned in its input's dtype."""
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


class _Flash(torch.autograd.Function):
    """out = forward(q, k, v, ...) (the kernel on the card; the plain version
    in the CPU tests), differentiated by ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, chunk, forward):
        out = forward(q, k, v, causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, out)
        ctx.args = dict(causal=causal, window=window, softcap=softcap, chunk=chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, do, **ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, K, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    chunk: int = 512,  # query rows per chunk of the backward
) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window,
                                         softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on the CPU or a CUDA card, not {q.device}")
    B, Sq, H, hd = q.shape
    Bk, Skv, K, hdk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or hdk != hd or K == 0 or H % K:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "are not (B, Sq, H, hd), (B, Skv, K, hd) with K dividing H")
    if Sq > Skv and (causal or window):  # unmasked, every key is visible to every query
        raise ValueError(f"causal or windowed attention takes the queries as the tail of the "
                         f"keys: Sq {Sq} > Skv {Skv} is refused (only unmasked attention, "
                         "causal=False and window=0, takes more queries than keys)")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    _build.check_cuda_tensors(q=q, k=k, v=v)
    if _build.requires_grad(q, k, v):
        out = _Flash.apply(q, k, v, causal, window, softcap, chunk, _launch)
    else:
        out = _launch(q, k, v, causal=causal, window=window, softcap=softcap)
    flash_attention.launches += 1
    return out


def _launch(q, k, v, *, causal: bool, window: int, softcap: float) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    fn = _build.function("flash_attention", "flash_attention_launch", _ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              B, H, K, Sq, Skv, hd,
              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
              hd**-0.5, int(causal), int(window), float(softcap), _build.stream_handle())
    _build.check(code, "flash_attention")
    return out


flash_attention.launches = 0
