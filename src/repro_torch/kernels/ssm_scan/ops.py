"""Selective-scan wrapper: the plain version for CPU tensors, the hand-written
Hopper kernel (``csrc/ssm_scan.cu``) for CUDA tensors.

``ssm_scan(dt, Bc, Cc, u, A, h0=None) -> (y, h_final)`` with dt, u (B, T, D)
bf16 or fp32 of one dtype, contiguous; Bc, Cc (B, T, N) of the same dtype,
read through their strides (the model passes column slices of the ``x_proj``
output, whose rows are dtr + 2N wide) with unit stride on N; A (D, N) fp32;
h0 (B, D, N) fp32 or None for zeros. N is at most ``N_MAX``. Anything else
raises. ``ssm_scan.launches`` counts the kernel's launches (CPU calls never
touch it). ``scan_plan`` sizes the kernel's CTAs: lanes per channel,
channels per CTA, steps per staged tile and how y's partial sums are
reduced across a channel's lanes.

On the card, when grad mode is on and an input requires grad, the call goes
through ``_Scan``: the forward kernel also saves the state before every
chunk of ``CHUNK`` steps, and the backward is ``ssm_scan_backward``, the
hand-written backward kernel of the same file (its own ``.launches``):
``BWD_GROUP`` lanes a channel, ``BWD_CHANNELS`` channels a CTA, one chunk in
registers; ``bwd_plan`` gives its shared memory and the dB / dC partials
(one per CTA along D) its second launch adds. On the CPU autograd
differentiates the plain loop; ``ssm_scan_backward`` there is the plain
reverse loop (``ssm_scan_backward_reference``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ..launches import launched
from .ref import ssm_scan_backward_reference, ssm_scan_reference

__all__ = ["ssm_scan", "ssm_scan_backward", "scan_plan", "smem_bytes", "bwd_plan",
           "bwd_smem_bytes", "SsmPlan", "BwdPlan", "N_MAX", "GROUPS", "REDUCTIONS", "THREADS",
           "TILE_T", "FILL_THREADS", "SMEM_LIMIT", "CHUNK", "BWD_GROUP", "BWD_CHANNELS",
           "BWD_FAULTS"]

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
CHUNK = 16  # steps between the states the forward saves for the backward (csrc: CHUNK)
# The backward (csrc/ssm_scan.cu: BWD_G, BWD_CH): lanes per channel, each
# keeping a chunk's a_t h_{t-1} and a_t of its N_MAX // BWD_GROUP states in
# registers (128 registers, 16 warps an SM), and channels per CTA, each CTA
# writing its own dB / dC partial. 4 lanes a channel and thread-block
# clusters summing the CTAs' partials on chip were slower (PERF.md, the
# selective-scan backward's redesign)
BWD_GROUP = 8
BWD_CHANNELS = 32
# planted faults of the C entry, instances of their own for chip_smoke.py's
# gate only (bf16, staged rows): g not carried into one chunk; the last
# warp's dB / dC share left out of a CTA's sum
BWD_FAULTS = {"none": 0, "g dropped at a chunk boundary": 1, "a warp's dB / dC share dropped": 2}
_DTYPES = (torch.bfloat16, torch.float32)
_PTR, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = ((_INT,) + (_PTR,) * 8 + (_INT,) * 4 + (_LL,) * 4 + (_INT,) * 6 + (_PTR,) * 2)
_BWD_ARGTYPES = ((_INT,) + (_PTR,) * 17 + (_INT,) * 4 + (_LL,) * 4 + (_INT,) * 4 + (_PTR,))


class SsmPlan(NamedTuple):
    group: int  # lanes per channel, each holding N_MAX // group consecutive states
    channels: int  # THREADS // group per CTA, of one batch row; the last CTA of a row the rest
    tile_t: int  # steps staged in shared memory per tile (a multiple of group for "scatter")
    reduce: str  # one of REDUCTIONS
    smem: int  # bytes of dynamic shared memory
    ctas: int


class BwdPlan(NamedTuple):
    smem: int  # bytes of dynamic shared memory
    partials: int  # CTAs along D per batch row, BWD_CHANNELS channels each: the dB / dC partials
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


def bwd_smem_bytes(n: int, elt: int) -> int:
    """The backward's shared memory (csrc/ssm_scan.cu: ``bwd_layout``), for
    chunks of CHUNK steps, two of each: the fp32 tile ((dt, dt u, u, dy) per
    channel, B and C per state padded to N_MAX), (ddt, du) per channel and
    each of the ``BWD_GROUP`` warps' dB and dC sums; then a ring of three raw
    stages of dt, u, dy (a row of channels each) and B, C (n each)."""
    tile = CHUNK * (BWD_CHANNELS * 16 + N_MAX * 8)
    sums = BWD_GROUP * CHUNK * 2 * N_MAX * 4
    raw = 3 * _r16(CHUNK * BWD_CHANNELS * elt) + 2 * _r16(CHUNK * n * elt)
    return 2 * (tile + CHUNK * BWD_CHANNELS * 8 + sums) + 3 * raw


def bwd_plan(b: int, d: int, n: int, elt: int) -> BwdPlan:
    """The backward's CTAs for ``b`` batch rows of ``d`` channels with n
    states in ``elt``-byte inputs: ``BWD_CHANNELS`` channels a CTA of one
    batch row (the row's last CTA fewer), each CTA's dB / dC sums a partial
    of its own. Raises for sizes the kernel does not take."""
    if min(b, d) < 1 or not 1 <= n <= N_MAX or elt not in (2, 4) or b > 65535:
        raise ValueError(f"ssm_scan_backward: no plan for B={b} D={d} N={n} elt={elt} "
                         f"(1 <= N <= {N_MAX}, B <= 65535, 2- or 4-byte inputs)")
    partials = -(-d // BWD_CHANNELS)
    return BwdPlan(bwd_smem_bytes(n, elt), partials, b * partials)


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


def _async_rows(dt, Bc, Cc, u, channels: int) -> bool:
    """Whether every row the kernel stages starts on 16 bytes and spans whole
    16-byte chunks, so that cp.async can copy it (else plain loads): dt and u
    are contiguous (B, T, D), a CTA's ``channels`` of them a row, Bc and Cc
    step through their strides."""
    elt = u.element_size()
    B, T, D = u.shape
    (sbb, sbt, _), (scb, sct, _) = Bc.stride(), Cc.stride()
    # row widths, then the strides of the dims that have more than one row
    sizes = (D, Bc.shape[-1], channels) + (sbb, scb) * (B > 1) + (sbt, sct) * (T > 1)
    return not ((dt.data_ptr() | u.data_ptr() | Bc.data_ptr() | Cc.data_ptr()) % 16
                or any(v * elt % 16 for v in sizes))


def _launch(dt, Bc, Cc, u, A, h0, plan: SsmPlan, *, states: bool = False):
    """One launch of the kernel with ``plan`` (the wrapper's, or a neighbour
    of it to time). With ``states`` it also returns the state before every
    chunk of ``CHUNK`` steps, (B, ceil(T / CHUNK), D, N) fp32."""
    B, T, D = u.shape
    N = A.shape[1]
    y = torch.empty_like(u)
    h_final = torch.empty((B, D, N), dtype=torch.float32, device=u.device)
    saved = (torch.empty((B, -(-T // CHUNK), D, N), dtype=torch.float32, device=u.device)
             if states else None)
    fn = _build.function("ssm_scan", "ssm_scan_launch", _ARGTYPES)
    code = fn(_build.DTYPE_CODES[u.dtype], dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
              u.data_ptr(), A.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
              h_final.data_ptr(), B, T, D, N, Bc.stride(0), Bc.stride(1), Cc.stride(0),
              Cc.stride(1), plan.group, plan.channels, plan.tile_t, REDUCTIONS.index(plan.reduce),
              int(_async_rows(dt, Bc, Cc, u, plan.channels)), plan.smem,
              None if saved is None else saved.data_ptr(), _build.stream_handle())
    _build.check(code, "ssm_scan")
    return (y, h_final, saved) if states else (y, h_final)


def _plan(u: torch.Tensor, N: int) -> SsmPlan:
    B, T, D = u.shape
    return scan_plan(B, T, D, N, u.element_size(), _sm_count(u.device.index))


def _bwd_plan(u: torch.Tensor, N: int) -> BwdPlan:
    B, _, D = u.shape
    return bwd_plan(B, D, N, u.element_size())


def _kernel_forward(dt, Bc, Cc, u, A, h0):
    """The forward kernel with the wrapper's plan, saving the chunk states."""
    return _launch(dt, Bc, Cc, u, A, h0, _plan(u, A.shape[1]), states=True)


def _check_backward(dt, Bc, Cc, u, A, h0, dy, dh_final, states) -> None:
    """The backward's inputs beyond the forward's: dy as y (u's dtype and
    shape), dh_final (B, D, N) fp32 or None, the chunk states (B, ceil(T /
    CHUNK), D, N) fp32 or None (the kernel needs them; the plain loop
    recomputes every state); on the card all of them contiguous on the
    inputs' card."""
    B, T, D = u.shape
    N = A.shape[1]
    if dy.dtype != u.dtype or dy.shape != u.shape:
        raise ValueError(f"ssm_scan_backward: dy must be y's {tuple(u.shape)} {u.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    for name, t, shape in (("dh_final", dh_final, (B, D, N)),
                           ("states", states, (B, -(-T // CHUNK), D, N))):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape):
            raise ValueError(f"ssm_scan_backward: {name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if u.device.type != "cuda":
        return
    if states is None:
        raise ValueError("ssm_scan_backward on the card restarts from the forward's chunk "
                         "states; got none")
    device = torch.cuda.current_device()
    for name, t in (("dy", dy), ("dh_final", dh_final), ("states", states)):
        if t is None:
            continue
        if t.device.type != "cuda" or t.device.index != device:
            raise ValueError(f"{name} is on {t.device}, but the kernel runs on cuda:{device}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan_backward takes a contiguous {name}, got strides "
                             f"{t.stride()}")


def _launch_backward(dt, Bc, Cc, u, A, dy, dh_final, states, plan: BwdPlan, fault: int = 0):
    """One call of the backward's C entry (its walk and its sums over CTAs)
    with ``plan``; ``fault`` one of ``BWD_FAULTS`` (chip_smoke.py's planted
    faults)."""
    B, T, D = u.shape
    N = A.shape[1]
    dev = u.device
    ddt, du = torch.empty_like(dt), torch.empty_like(u)
    dBc = torch.empty((B, T, N), dtype=Bc.dtype, device=dev)
    dCc = torch.empty((B, T, N), dtype=Cc.dtype, device=dev)
    dA = torch.empty((D, N), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    part_b, part_c = (torch.empty((plan.partials, B, T, N), dtype=torch.float32, device=dev)
                      for _ in range(2))
    part_a = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    staged = _async_rows(dt, Bc, Cc, u, BWD_CHANNELS) and dy.data_ptr() % 16 == 0
    fn = _build.function("ssm_scan", "ssm_scan_backward_launch", _BWD_ARGTYPES)
    code = fn(_build.DTYPE_CODES[u.dtype], dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
              u.data_ptr(), dy.data_ptr(), A.data_ptr(), states.data_ptr(),
              None if dh_final is None else dh_final.data_ptr(), ddt.data_ptr(), du.data_ptr(),
              dBc.data_ptr(), dCc.data_ptr(), dA.data_ptr(), dh0.data_ptr(), part_b.data_ptr(),
              part_c.data_ptr(), part_a.data_ptr(), B, T, D, N, Bc.stride(0), Bc.stride(1),
              Cc.stride(0), Cc.stride(1), plan.partials, int(staged), plan.smem, fault,
              _build.stream_handle())
    _build.check(code, "ssm_scan")
    return ddt, dBc, dCc, du, dA, dh0


def ssm_scan_backward(dt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor, u: torch.Tensor,
                      A: torch.Tensor, h0: torch.Tensor | None, dy: torch.Tensor,
                      dh_final: torch.Tensor | None = None, states: torch.Tensor | None = None):
    """The scan's gradients (ddt, dBc, dCc, du, dA, dh0) for dy (y's gradient)
    and dh_final (h_final's, None for zeros): ddt, du and dBc, dCc in their
    inputs' dtype, dA and dh0 fp32. On the card from the forward's chunk
    states (``_launch(..., states=True)``; h0 is then in state 0), on the CPU
    by the plain reverse loop. Wrong dtypes, shapes or strides raise."""
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssm_scan_backward runs on the CPU or a CUDA card, not {u.device}")
    if u.device.type == "cuda":
        _check(dt, Bc, Cc, u, A, h0)
    _check_backward(dt, Bc, Cc, u, A, h0, dy, dh_final, states)
    if u.device.type == "cpu":
        return ssm_scan_backward_reference(dt, Bc, Cc, u, A, h0, dy, dh_final)
    out = _launch_backward(dt, Bc, Cc, u, A, dy, dh_final, states, _bwd_plan(u, A.shape[1]))
    launched(ssm_scan_backward)
    return out


ssm_scan_backward.launches = 0


class _Scan(torch.autograd.Function):
    """(y, h_final) = forward(dt, Bc, Cc, u, A, h0) (the kernel on the card;
    the plain version in the CPU tests), which also returns the chunk states;
    differentiated by ``ssm_scan_backward``. Inputs that do not require grad
    get None."""

    @staticmethod
    def forward(ctx, dt, Bc, Cc, u, A, h0, forward):
        y, h_final, states = forward(dt, Bc, Cc, u, A, h0)
        ctx.save_for_backward(dt, Bc, Cc, u, A, h0, states)
        ctx.set_materialize_grads(False)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        dt, Bc, Cc, u, A, h0, states = ctx.saved_tensors
        dy = torch.zeros_like(u) if dy is None else dy.contiguous()
        if dh_final is not None:
            dh_final = dh_final.contiguous()
        grads = ssm_scan_backward(dt, Bc, Cc, u, A, h0, dy, dh_final, states)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad)) + (None,)


def ssm_scan(dt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor, u: torch.Tensor,
             A: torch.Tensor, h0: torch.Tensor | None = None):
    """h_t = exp(dt_t A) * h_{t-1} + (dt_t u_t) B_t ;  y_t = sum_n h_t[n] C_t[n],
    in fp32 from h0 (zeros when None). Returns (y (B, T, D) in u's dtype,
    h_final (B, D, N) fp32)."""
    if u.device.type == "cpu":
        return ssm_scan_reference(dt, Bc, Cc, u, A, h0)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on the CPU or a CUDA card, not {u.device}")
    _check(dt, Bc, Cc, u, A, h0)
    if _build.requires_grad(dt, Bc, Cc, u, A, h0):
        out = _Scan.apply(dt, Bc, Cc, u, A, h0, _kernel_forward)
    else:
        out = _launch(dt, Bc, Cc, u, A, h0, _plan(u, A.shape[1]))
    launched(ssm_scan)
    return out


ssm_scan.launches = 0
