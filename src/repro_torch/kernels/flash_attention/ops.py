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
launch, also writing each row's log-sum-exp, and saving q, k, v, the output
and that LSE, and whose backward is ``flash_attention_backward``: on the card
the backward kernels of the same file (each row's LSE and D = rowsum(dO * O);
dK/dV per query head and key tile, a kv head's parts then added in head
order; dQ per query tile; wgmma fed by TMA, planned by ``backward_plan``; no
atomics, so repeatable bit for bit), counted by
``flash_attention_backward.launches``; on the CPU the plain chunked backward
(``ref.flash_attention_backward_reference``; the reference has no backward
kernel: XLA differentiates its query-chunked attention, rematerialising
each chunk's scores).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from ..launches import launched
from .ref import flash_attention_backward_reference, flash_attention_reference

__all__ = ["flash_attention", "flash_attention_backward", "backward_plan", "backward_visits",
           "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128, 256)  # instantiated in csrc/flash_attention.cu
_TAIL = (ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (ctypes.c_longlong,) * 12 + _TAIL
_BWD_ARGTYPES = (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 11 + (ctypes.c_longlong,) * 15 + _TAIL
STATS_PAD = 128  # csrc/flash_attention.cu bwd::STATS_PAD


class BackwardPlan(NamedTuple):
    """The backward's tiles (``bwd::BCfg`` of csrc/flash_attention.cu, whose C
    entry refuses other ones), grids and scratch. dK/dV: a CTA per (query head,
    ``key_tile`` keys, b), ``splits`` of them across hd (64 of dK/dV's columns
    each), sweeping the query steps of ``query_step`` rows that see the tile.
    dQ: a CTA per (query head, ``query_tile`` rows, b), ``dq_splits`` across hd
    (128 columns each), sweeping key steps of ``key_step``. Each split CTA
    computes its tile's S and dP over the whole head dim."""
    key_tile: int
    query_step: int
    query_tile: int
    key_step: int
    stats_rows: int  # rows of (lse log2 e, D) per (b, h): Sq rounded up to STATS_PAD
    splits: int
    dq_splits: int
    dkdv_grid: tuple[int, int, int]
    dq_grid: tuple[int, int, int]
    stats_shape: tuple[int, ...]  # fp32 scratch
    parts_shape: tuple[int, ...] | None  # each query head's fp32 dK and dV where H > K


def backward_plan(B: int, Sq: int, Skv: int, H: int, K: int, hd: int) -> BackwardPlan:
    """The backward's launches for q (B, Sq, H, hd) and k, v (B, Skv, K, hd)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the backward kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    key_tile = query_tile = 128  # two consumer warpgroups of 64 rows
    query_step = key_step = 32 if hd == 256 else 64
    splits, dq_splits = max(1, hd // 64), max(1, hd // 128)
    stats_rows = -(-Sq // STATS_PAD) * STATS_PAD
    return BackwardPlan(key_tile, query_step, query_tile, key_step, stats_rows, splits, dq_splits,
                        (H * splits, -(-Skv // key_tile), B),
                        (H * dq_splits, -(-Sq // query_tile), B),
                        (B, H, stats_rows, 2), (B, Skv, H, hd) if H > K else None)


def backward_visits(plan: BackwardPlan, Sq: int, Skv: int, causal: bool, window: int):
    """The tile pairs whose products the two kernels compute, in their loops
    (csrc/flash_attention.cu mirrors these ranges): dK/dV as ((key tile,
    query step), keys, queries), dQ as ((query tile, key step), keys,
    queries), each key and query range clipped to Skv and Sq. Each split
    CTA of a tile repeats its tile's visits for its own columns."""
    off = Skv - Sq
    dkdv, dq = [], []
    for kt in range(plan.dkdv_grid[1]):
        k0 = kt * plan.key_tile
        q_lo = max(0, k0 - off) if causal else 0
        q_hi = min(Sq, k0 + plan.key_tile - 1 + window - off) if window > 0 else Sq
        qt0 = q_lo // plan.query_step
        steps = -(-q_hi // plan.query_step) - qt0 if q_hi > q_lo else 0
        keys = range(k0, min(k0 + plan.key_tile, Skv))
        for i in range(steps):
            q0 = (qt0 + i) * plan.query_step
            dkdv.append(((kt, qt0 + i), keys, range(q0, min(q0 + plan.query_step, Sq))))
    for qt in range(plan.dq_grid[1]):
        q0 = qt * plan.query_tile
        pos_lo, pos_hi = q0 + off, min(q0 + plan.query_tile, Sq) - 1 + off
        kv_end = min(Skv, pos_hi + 1) if causal else Skv
        kv_begin = max(0, pos_lo - window + 1) if window > 0 else 0
        t0 = kv_begin // plan.key_step
        steps = -(-kv_end // plan.key_step) - t0 if kv_end > kv_begin else 0
        queries = range(q0, min(q0 + plan.query_tile, Sq))
        for i in range(steps):
            j0 = (t0 + i) * plan.key_step
            dq.append(((qt, t0 + i), range(j0, min(j0 + plan.key_step, Skv)), queries))
    return dkdv, dq


def flash_attention_backward(q, k, v, o, do, *, causal: bool, window: int, softcap: float,
                             chunk: int, lse=None):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` with output ``o``, given
    ``do``, each in its input's dtype. CPU tensors take the plain backward
    (``chunk`` query rows at a time; ``lse`` unread); CUDA tensors the
    backward kernel, which reads the forward's ``lse`` (B, H, Sq) fp32 and
    takes what the forward kernel takes (bf16, a head dim of ``HEAD_DIMS``);
    anything else raises."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, do, causal=causal, window=window,
                                                  softcap=softcap, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward runs on the CPU or a CUDA card, not "
                         f"{q.device}")
    _check(q, k, v, causal, window, "flash_attention_backward")
    B, Sq, H, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o and do must be q's {tuple(q.shape)} {q.dtype}; got "
                         f"{tuple(o.shape)} {o.dtype} and {tuple(do.shape)} {do.dtype}")
    if (lse is None or lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"the backward kernel reads the forward's log-sum-exp, ({B}, {H}, {Sq}) "
                         f"float32 contiguous on {q.device}; got "
                         f"{None if lse is None else (tuple(lse.shape), lse.dtype, lse.device)}")
    _build.check_cuda_tensors(q=q, k=k, v=v, o=o, do=do)
    grads = _launch_backward(q, k, v, o, do, lse, causal=causal, window=window, softcap=softcap)
    launched(flash_attention_backward)
    return grads


class _Flash(torch.autograd.Function):
    """out = forward(q, k, v, ...) (the kernel on the card; the plain version
    in the CPU tests), differentiated by ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, chunk, forward):
        out, lse = forward(q, k, v, causal=causal, window=window, softcap=softcap,
                           return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, softcap=softcap, chunk=chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, do.contiguous(), lse=lse, **ctx.args)
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
    _check(q, k, v, causal, window, "flash_attention")
    _build.check_cuda_tensors(q=q, k=k, v=v)
    if _build.requires_grad(q, k, v):
        out = _Flash.apply(q, k, v, causal, window, softcap, chunk, _launch)
    else:
        out = _launch(q, k, v, causal=causal, window=window, softcap=softcap)
    launched(flash_attention)
    return out


def _check(q, k, v, causal: bool, window: int, name: str) -> None:
    """What the forward and backward kernels take; raises on anything else."""
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
        raise TypeError(f"{name} kernel takes bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in {HEAD_DIMS}, got {hd}")


def _launch(q, k, v, *, causal: bool, window: int, softcap: float, return_lse: bool = False):
    """One forward launch: the output, and with ``return_lse`` also each
    row's log-sum-exp, (B, H, Sq) fp32 (the backward's input)."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse
           else None)
    fn = _build.function("flash_attention", "flash_attention_launch", _ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              None if lse is None else lse.data_ptr(), B, H, K, Sq, Skv, hd,
              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
              hd**-0.5, int(causal), int(window), float(softcap), _build.stream_handle())
    _build.check(code, "flash_attention")
    return (out, lse) if return_lse else out


def _launch_backward(q, k, v, o, do, lse, *, causal: bool, window: int, softcap: float):
    """One call of the backward's C entry: three launches, four where H > K
    (each query head's dK and dV as fp32 parts, then their sum per kv head)."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    plan = backward_plan(B, Sq, Skv, H, K, hd)
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Skv, K, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    stats = torch.empty(plan.stats_shape, dtype=torch.float32, device=q.device)
    parts = ([torch.empty(plan.parts_shape, dtype=torch.float32, device=q.device)
              for _ in range(2)] if plan.parts_shape else [None, None])
    fn = _build.function("flash_attention", "flash_attention_backward_launch", _BWD_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
              lse.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              *(None if t is None else t.data_ptr() for t in parts), B, H, K, Sq, Skv, hd,
              plan.key_tile, plan.query_step, plan.query_tile, plan.key_step,
              plan.stats_rows, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
              *do.stride()[:3],
              hd**-0.5, int(causal), int(window), float(softcap), _build.stream_handle())
    _build.check(code, "flash_attention")
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_backward.launches = 0
