"""Selective-scan wrapper: the plain version for CPU tensors, the hand-written
Hopper kernel (``csrc/ssm_scan.cu``) for CUDA tensors.

``ssm_scan(dt, Bc, Cc, u, A, h0=None) -> (y, h_final)`` with dt, u (B, T, D)
bf16 or fp32 of one dtype, contiguous; Bc, Cc (B, T, N) of the same dtype,
read through their strides (the model passes column slices of the ``x_proj``
output, whose rows are dtr + 2N wide) with unit stride on N; A (D, N) fp32;
h0 (B, D, N) fp32 or None for zeros. N is at most ``N_MAX``. Anything else
raises. ``ssm_scan.launches`` counts the kernel's launches (CPU calls never
touch it); the kernel has no backward, so on the card an input that
requires grad under grad mode raises (``_build.refuse_grad``). ``scan_plan``
sizes the kernel's CTAs: lanes per channel, channels per CTA, steps per
staged tile and how y's partial sums are reduced across a channel's lanes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from .ref import ssm_scan_reference

__all__ = ["ssm_scan", "scan_plan", "smem_bytes", "SsmPlan", "N_MAX", "GROUPS", "REDUCTIONS",
           "THREADS", "TILE_T", "FILL_THREADS", "SMEM_LIMIT"]

N_MAX = 16  # a channel's states, padded with zeros to N_MAX (csrc/ssm_scan.cu: STATES)
GROUPS = (4, 8, 16)  # lanes per channel the kernel is built for; each holds N_MAX // G states
# y's reduction across a channel's lanes (csrc/ssm_scan.cu: RED_SHUFFLE,
# RED_SCATTER): log2 G shuffles a step; G steps at a time, reduce-scattered
# by G - 1 shuffles
REDUCTIONS = ("shuffle", "scatter")
THREADS = 128  # per CTA (csrc/ssm_scan.cu: MAX_THREADS), so THREADS // G channels
TILE_T = 64  # steps staged per tile, at most (csrc/ssm_scan.cu: its entry's check)
FILL_THREADS = 128  # threads per SM the plan asks of the grid before it spreads a channel wider
SMEM_LIMIT = 232_448  # shared memory one CTA may take on an H100
_DTYPES = (torch.bfloat16, torch.float32)
_PTR, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = ((_INT,) + (_PTR,) * 8 + (_INT,) * 4 + (_LL,) * 4 + (_INT,) * 6 + (_PTR,))


class SsmPlan(NamedTuple):
    group: int  # lanes per channel, each holding N_MAX // group consecutive states
    channels: int  # THREADS // group per CTA, of one batch row; the last CTA of a row the rest
    tile_t: int  # steps staged in shared memory per tile (a multiple of group for "scatter")
    reduce: str  # one of REDUCTIONS
    smem: int  # bytes of dynamic shared memory
    ctas: int


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(tile_t: int, channels: int, n: int, elt: int) -> int:
    """The kernel's shared memory (csrc/ssm_scan.cu: ``layout``): two raw
    stages of dt, u, B and C as they lie in memory, the tile in fp32 ((dt,
    dt * u) per step and channel, (B, C) per step and state padded to N_MAX),
    and y's staging (one sum per step and channel)."""
    raw = 2 * (2 * _r16(tile_t * channels * elt) + 2 * _r16(tile_t * n * elt))
    fp32 = _r16(tile_t * channels * 8) + tile_t * N_MAX * 8
    return raw + fp32 + _r16(tile_t * channels * 4)


@functools.lru_cache(maxsize=4096)  # a plan per shape: the wrapper asks for one on every call
def scan_plan(b: int, t: int, d: int, n: int, elt: int, n_sm: int, *,
              group: int | None = None, reduce: str | None = None,
              tile_t: int | None = None) -> SsmPlan:
    """CTAs of ``THREADS`` threads for a (b, t, d) scan of n states in
    ``elt``-byte inputs on ``n_sm`` SMs. A channel gets the fewest lanes of
    ``GROUPS`` that give the grid ``FILL_THREADS`` threads per SM (its states
    spread over them), else the most; a tile stages up to ``TILE_T`` steps;
    y is reduce-scattered where T has a group's worth of steps, else reduced
    by shuffles each step. ``group``, ``reduce`` and ``tile_t`` (at most
    ``TILE_T``) override the choice (the plan's neighbours, to time).
    Raises for sizes the kernel does not take."""
    if min(b, d, n_sm) < 1 or t < 0 or not 1 <= n <= N_MAX or elt not in (2, 4) or b > 65535:
        raise ValueError(f"ssm_scan: no plan for B={b} T={t} D={d} N={n} elt={elt} "
                         f"n_sm={n_sm} (1 <= N <= {N_MAX}, B <= 65535, 2- or 4-byte inputs)")
    if group is None:
        group = next((g for g in GROUPS if b * d * g >= n_sm * FILL_THREADS), GROUPS[-1])
    elif group not in GROUPS:
        raise ValueError(f"ssm_scan: a channel takes {GROUPS} lanes, not {group}")
    if reduce is None:
        reduce = "scatter" if t >= group else "shuffle"
    elif reduce not in REDUCTIONS:
        raise ValueError(f"ssm_scan: y is reduced by one of {REDUCTIONS}, not {reduce!r}")
    if tile_t is not None and not 1 <= tile_t <= TILE_T:
        raise ValueError(f"ssm_scan: a tile stages 1 to {TILE_T} steps, not {tile_t}")
    channels = THREADS // group
    tile_t = max(1, min(tile_t or TILE_T, t))
    if reduce == "scatter":  # whole groups of steps; the rows past T are zeros
        tile_t = -(-tile_t // group) * group
    smem = smem_bytes(tile_t, channels, n, elt)
    return SsmPlan(group, channels, tile_t, reduce, smem, b * -(-d // channels))


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(dt, Bc, Cc, u, A, h0) -> None:
    if dt.dtype not in _DTYPES or not dt.dtype == u.dtype == Bc.dtype == Cc.dtype:
        raise TypeError("ssm_scan kernel takes bfloat16 or float32 dt, u, Bc, Cc of one dtype, "
                        f"got {dt.dtype}/{u.dtype}/{Bc.dtype}/{Cc.dtype}")
    if A.dtype != torch.float32 or (h0 is not None and h0.dtype != torch.float32):
        raise TypeError(f"ssm_scan takes float32 A and h0, got {A.dtype}/"
                        f"{None if h0 is None else h0.dtype}")
    if u.dim() != 3 or dt.shape != u.shape:
        raise ValueError(f"dt and u must be (B, T, D) of one shape, got {tuple(dt.shape)} and "
                         f"{tuple(u.shape)}")
    B, T, D = u.shape
    if B > 65535:
        raise ValueError(f"ssm_scan kernel takes at most 65535 batch rows, got {B}")
    if A.dim() != 2 or A.shape[0] != D or not 1 <= A.shape[1] <= N_MAX:
        raise ValueError(f"A must be ({D}, N) with 1 <= N <= {N_MAX}, got {tuple(A.shape)}")
    N = A.shape[1]
    if tuple(Bc.shape) != (B, T, N) or tuple(Cc.shape) != (B, T, N):
        raise ValueError(f"Bc and Cc must be ({B}, {T}, {N}), got {tuple(Bc.shape)} and "
                         f"{tuple(Cc.shape)}")
    if h0 is not None and tuple(h0.shape) != (B, D, N):
        raise ValueError(f"h0 must be ({B}, {D}, {N}), got {tuple(h0.shape)}")
    device = torch.cuda.current_device()
    for name, t in (("dt", dt), ("Bc", Bc), ("Cc", Cc), ("u", u), ("A", A), ("h0", h0)):
        if t is not None and (t.device.type != "cuda" or t.device.index != device):
            raise ValueError(f"{name} is on {t.device}, but the kernel runs on cuda:{device}")
    for name, t in (("dt", dt), ("u", u), ("A", A), ("h0", h0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"ssm_scan kernel takes a contiguous {name}, got strides "
                             f"{t.stride()}")
    for name, t in (("Bc", Bc), ("Cc", Cc)):
        if t.stride(-1) != 1 and N > 1:
            raise ValueError(f"{name} needs unit stride on N, got strides {t.stride()}")


def _async_rows(dt, Bc, Cc, u, plan: SsmPlan) -> bool:
    """Whether every row the kernel stages starts on 16 bytes and spans whole
    16-byte chunks, so that cp.async can copy it (else plain loads): dt and u
    are contiguous (B, T, D), Bc and Cc step through their strides."""
    elt = u.element_size()
    B, T, D = u.shape
    (sbb, sbt, _), (scb, sct, _) = Bc.stride(), Cc.stride()
    # row widths, then the strides of the dims that have more than one row
    sizes = (D, Bc.shape[-1], plan.channels) + (sbb, scb) * (B > 1) + (sbt, sct) * (T > 1)
    return not ((dt.data_ptr() | u.data_ptr() | Bc.data_ptr() | Cc.data_ptr()) % 16
                or any(v * elt % 16 for v in sizes))


def _launch(dt, Bc, Cc, u, A, h0, plan: SsmPlan):
    """One launch of the kernel with ``plan`` (the wrapper's, or a neighbour
    of it to time)."""
    B, T, D = u.shape
    N = A.shape[1]
    y = torch.empty_like(u)
    h_final = torch.empty((B, D, N), dtype=torch.float32, device=u.device)
    fn = _build.function("ssm_scan", "ssm_scan_launch", _ARGTYPES)
    code = fn(_build.DTYPE_CODES[u.dtype], dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
              u.data_ptr(), A.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
              h_final.data_ptr(), B, T, D, N, Bc.stride(0), Bc.stride(1), Cc.stride(0),
              Cc.stride(1), plan.group, plan.channels, plan.tile_t, REDUCTIONS.index(plan.reduce),
              int(_async_rows(dt, Bc, Cc, u, plan)), plan.smem, _build.stream_handle())
    _build.check(code, "ssm_scan")
    return y, h_final


def ssm_scan(dt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor, u: torch.Tensor,
             A: torch.Tensor, h0: torch.Tensor | None = None):
    """h_t = exp(dt_t A) * h_{t-1} + (dt_t u_t) B_t ;  y_t = sum_n h_t[n] C_t[n],
    in fp32 from h0 (zeros when None). Returns (y (B, T, D) in u's dtype,
    h_final (B, D, N) fp32)."""
    if u.device.type == "cpu":
        return ssm_scan_reference(dt, Bc, Cc, u, A, h0)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on the CPU or a CUDA card, not {u.device}")
    _build.refuse_grad("ssm_scan", "ROADMAP B-perf kernel item 5 (a selective-scan backward)",
                       dt, Bc, Cc, u, A, h0)
    _check(dt, Bc, Cc, u, A, h0)
    B, T, D = u.shape
    plan = scan_plan(B, T, D, A.shape[1], u.element_size(), _sm_count(u.device.index))
    out = _launch(dt, Bc, Cc, u, A, h0, plan)
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0
