"""RMSNorm wrappers: the plain version for a CPU tensor, the hand-written
Hopper kernel (``csrc/rmsnorm.cu``) for a CUDA tensor.

``rmsnorm(x, scale, eps)`` normalises over the last dim; ``rmsnorm_add(x, r,
scale, eps) -> (s, y)`` adds the residual first (s = x + r in x's dtype) and
normalises s, in one launch. ``rmsnorm.launches`` and
``rmsnorm_add.launches`` count each entry's launches (CPU calls never touch
them). ``norm_plan`` sizes the launch: threads per row, rows per CTA and
16-byte vectors per thread.

Gradients: where grad mode is on and an input requires grad, a CUDA call
goes through an ``autograd.Function`` whose forward is the same kernel
launch and whose backward is ``rmsnorm_backward``: on the card the backward
kernel of the same file (a row pass that keeps each thread's dscale sums in
registers over the rows it walks, then a pass adding the per-CTA sums in a
fixed order: no atomics, repeatable bit for bit), planned by
``norm_backward_plan`` and counted by ``rmsnorm_backward.launches``; on the
CPU the plain fp32 version (``ref.rmsnorm_backward_reference``; the
reference has no backward kernel, XLA differentiates its ``rms_norm``).
Otherwise the wrappers launch directly, as serving does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ..launches import launched
from .ref import rmsnorm_add_reference, rmsnorm_backward_reference, rmsnorm_reference

__all__ = ["rmsnorm", "rmsnorm_add", "rmsnorm_backward", "norm_plan", "norm_backward_plan",
           "NormPlan", "ROW_THREADS", "VECTORS", "ROW_VECTORS", "CTA_THREADS", "BWD_SLOTS"]

ROW_THREADS = (32, 64, 128, 256, 512)  # threads per row the kernel takes (a warp up to a CTA)
VECTORS = (1, 2, 4, 8, 16)  # 16-byte vectors per thread it is built for (csrc/rmsnorm.cu)
ROW_VECTORS = 4  # vectors per thread the plan aims at: a row's loads in few per thread
CTA_THREADS = 128  # the plan fills a CTA with rows up to this many threads
_PTR, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_NORM_ARGS = (_INT, _PTR, _PTR, _PTR, _LL, _INT, ctypes.c_float, _INT, _INT, _INT, _PTR)
_ADD_ARGS = (_INT, _PTR, _PTR, _PTR, _PTR, _PTR, _LL, _INT, ctypes.c_float, _INT, _INT, _INT,
             _PTR)
_BWD_ARGS = (_INT,) + (_PTR,) * 7 + (_LL, _INT, ctypes.c_float, _INT, _INT, _INT, _INT, _PTR)
# the backward's row slots at most (CTAs x rows per CTA), each writing one
# fp32 row of dscale sums: enough CTAs to keep the card's memory busy, and
# scratch of a few MB at the training widths (1,024 x 896 x 4 B = 3.7 MB)
BWD_SLOTS = 1024


class NormPlan(NamedTuple):
    threads_per_row: int
    rows_per_cta: int
    vectors: int  # 16-byte vectors a thread holds (those past the row idle)
    ctas: int


@functools.lru_cache(maxsize=4096)  # a plan per shape: each wrapper asks for one on every call
def norm_plan(rows: int, d: int, elt: int, *, threads_per_row: int | None = None,
              rows_per_cta: int | None = None) -> NormPlan:
    """The fewest threads per row (of ``ROW_THREADS``) that leave each
    thread at most ``ROW_VECTORS`` of the row's 16-byte vectors, else the
    most; then as many rows per CTA as ``CTA_THREADS`` holds. The keywords
    override either choice (the plan's neighbours, to time). Raises for a
    row that is not whole 16-byte vectors or does not fit."""
    if rows < 0 or d < 1 or elt not in (2, 4) or (d * elt) % 16:
        raise ValueError(f"rmsnorm: no plan for {rows} rows of {d} x {elt}-byte elements "
                         "(the row must be whole 16-byte vectors)")
    nvec = d * elt // 16
    tpr = threads_per_row or next(
        (t for t in ROW_THREADS if -(-nvec // t) <= ROW_VECTORS), ROW_THREADS[-1])
    vectors = next((v for v in VECTORS if v * tpr >= nvec), None)
    if tpr not in ROW_THREADS or vectors is None:
        raise ValueError(f"rmsnorm: a row of {d * elt} bytes does not fit {tpr} threads of at "
                         f"most {VECTORS[-1]} 16-byte vectors ({ROW_THREADS} threads per row)")
    per_cta = rows_per_cta or max(1, CTA_THREADS // tpr)
    if per_cta * tpr > ROW_THREADS[-1]:
        raise ValueError(f"rmsnorm: {per_cta} rows of {tpr} threads exceed a CTA of "
                         f"{ROW_THREADS[-1]}")
    return NormPlan(tpr, per_cta, vectors, -(-rows // per_cta))


def norm_backward_plan(rows: int, d: int, elt: int) -> NormPlan:
    """The backward's launch: the forward's row layout (``norm_plan``) on at
    most ``BWD_SLOTS // rows_per_cta`` CTAs, each walking the row groups that
    many apart; ``ctas`` x ``rows_per_cta`` slots of dscale sums."""
    plan = norm_plan(rows, d, elt)
    return plan._replace(ctas=min(plan.ctas, max(1, BWD_SLOTS // plan.rows_per_cta)))


def _check(x: torch.Tensor, scale: torch.Tensor, name: str) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {x.dtype}")
    d = x.shape[-1]
    if scale.dtype != x.dtype or tuple(scale.shape) != (d,) or scale.device != x.device:
        raise ValueError(f"scale must be ({d},) {x.dtype} on {x.device}; got "
                         f"{tuple(scale.shape)} {scale.dtype} on {scale.device}")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError(f"{name} kernel takes contiguous x and scale")


def _launch(x: torch.Tensor, r: torch.Tensor | None, scale: torch.Tensor, eps: float,
            plan: NormPlan):
    """One launch with ``plan`` (the wrapper's, or a neighbour of it to time):
    y, or (s, y) where ``r`` is given."""
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    tail = (rows, d, eps, plan.threads_per_row, plan.rows_per_cta, plan.vectors,
            _build.stream_handle())
    if r is None:
        fn = _build.function("rmsnorm", "rmsnorm_launch", _NORM_ARGS)
        code = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                  *tail)
        _build.check(code, "rmsnorm")
        return out
    s = torch.empty_like(x)
    fn = _build.function("rmsnorm", "rmsnorm_add_launch", _ADD_ARGS)
    code = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), r.data_ptr(), scale.data_ptr(),
              s.data_ptr(), out.data_ptr(), *tail)
    _build.check(code, "rmsnorm")
    return s, out


def _plan(x: torch.Tensor) -> NormPlan:
    d = x.shape[-1]
    return norm_plan(x.numel() // d if d else 0, d, x.element_size())


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, gy: torch.Tensor,
                     eps: float = 1e-6, gs: torch.Tensor | None = None):
    """(dx, dscale) of ``rmsnorm(x, scale, eps)`` given ``gy``; ``gs``, the
    gradient reaching ``x`` directly (``rmsnorm_add``'s s), is added to dx.
    Each in its input's dtype. CPU tensors take the plain fp32 version; CUDA
    tensors the backward kernel, which takes what the forward takes (fp32 or
    bf16, contiguous, rows of whole 16-byte vectors); anything else raises."""
    if x.device.type == "cpu":
        return rmsnorm_backward_reference(x, scale, gy, eps, gs)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_backward runs on the CPU or a CUDA card, not {x.device}")
    _check(x, scale, "rmsnorm_backward")
    for name, t in (("gy", gy), ("gs", gs)):
        if t is not None and (t.dtype != x.dtype or t.shape != x.shape or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be x's {tuple(x.shape)} {x.dtype} on {x.device}, "
                             f"contiguous; got {tuple(t.shape)} {t.dtype} on {t.device}")
    _build.check_cuda_tensors(x=x, scale=scale, gy=gy, **({} if gs is None else {"gs": gs}))
    d = x.shape[-1]
    plan = norm_backward_plan(x.numel() // d if d else 0, d, x.element_size())
    grads = _launch_backward(x, scale, gy, gs, eps, plan)
    launched(rmsnorm_backward)
    return grads


def _launch_backward(x, scale, gy, gs, eps: float, plan: NormPlan):
    """One call of the backward's C entry (the row pass and the dscale sum)."""
    d = x.shape[-1]
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    partial = torch.empty((plan.ctas * plan.rows_per_cta, d), dtype=torch.float32,
                          device=x.device)
    fn = _build.function("rmsnorm", "rmsnorm_backward_launch", _BWD_ARGS)
    code = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), scale.data_ptr(), gy.data_ptr(),
              None if gs is None else gs.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
              partial.data_ptr(), x.numel() // d, d, eps, plan.threads_per_row,
              plan.rows_per_cta, plan.vectors, plan.ctas, _build.stream_handle())
    _build.check(code, "rmsnorm")
    return dx, dscale


class _Norm(torch.autograd.Function):
    """y = forward(x, scale, eps) (the kernel on the card; the plain version
    in the CPU tests), differentiated by ``rmsnorm_backward``."""

    @staticmethod
    def forward(ctx, x, scale, eps, forward):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return forward(x, scale, eps)

    @staticmethod
    def backward(ctx, gy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, gy.contiguous(), ctx.eps)
        return dx, dscale, None, None


class _NormAdd(torch.autograd.Function):
    """(s, y) = forward(x, r, scale, eps), s = x + r, y = rmsnorm(s):
    ds = gs + the norm's backward, which reaches x and r alike."""

    @staticmethod
    def forward(ctx, x, r, scale, eps, forward):
        s, y = forward(x, r, scale, eps)
        ctx.save_for_backward(s, scale)
        ctx.eps = eps
        return s, y

    @staticmethod
    def backward(ctx, gs, gy):
        s, scale = ctx.saved_tensors
        ds, dscale = rmsnorm_backward(s, scale, gy.contiguous(), ctx.eps, gs.contiguous())
        return ds, ds, dscale, None, None


def _kernel_norm(x, scale, eps):
    return _launch(x, None, scale, eps, _plan(x))


def _kernel_norm_add(x, r, scale, eps):
    return _launch(x, r, scale, eps, _plan(x))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * (1 + scale) over the last dim, in fp32."""
    if x.device.type == "cpu":
        return rmsnorm_reference(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on the CPU or a CUDA card, not {x.device}")
    _check(x, scale, "rmsnorm")
    _build.check_cuda_tensors(x=x, scale=scale)
    if _build.requires_grad(x, scale):
        out = _Norm.apply(x, scale, eps, _kernel_norm)
    else:
        out = _kernel_norm(x, scale, eps)
    launched(rmsnorm)
    return out


def rmsnorm_add(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, y): s = x + r rounded to x's dtype (as torch's add), y = rmsnorm(s)
    over the last dim, in one launch."""
    if x.device.type == "cpu":
        return rmsnorm_add_reference(x, r, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_add runs on the CPU or a CUDA card, not {x.device}")
    _check(x, scale, "rmsnorm_add")
    if r.dtype != x.dtype or r.shape != x.shape or r.device != x.device:
        raise ValueError(f"r must match x: {tuple(x.shape)} {x.dtype} on {x.device}; got "
                         f"{tuple(r.shape)} {r.dtype} on {r.device}")
    if not r.is_contiguous():
        raise ValueError("rmsnorm_add kernel takes a contiguous r")
    _build.check_cuda_tensors(x=x, r=r, scale=scale)
    if _build.requires_grad(x, r, scale):
        out = _NormAdd.apply(x, r, scale, eps, _kernel_norm_add)
    else:
        out = _kernel_norm_add(x, r, scale, eps)
    launched(rmsnorm_add)
    return out


rmsnorm.launches = 0
rmsnorm_add.launches = 0
rmsnorm_backward.launches = 0
