"""Decision-scan wrapper: the plain version for CPU tensors, the hand-written
Hopper kernel (``csrc/decision_scan.cu``) for CUDA tensors.

``decision_scan`` takes contiguous (T, N, E+1) float64 or float32 costs
(column 0 on-device) and an (N,) int32 cohort, and optionally the (N,) int32
choices before its first epoch (``prev``) and that epoch's global index
(``t0``), so that a caller can hand it one epoch at a time. It counts its
kernel launches in ``decision_scan.launches`` (CPU calls never touch it) and
raises on anything the kernel does not take. ``scan_plan`` sizes the
kernel's CTAs (clients each, threads, the shared-memory ring of epochs).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ..launches import launched
from .ref import decision_scan_reference

__all__ = ["decision_scan", "scan_plan", "ScanPlan", "STAGES", "STEPS", "SMEM_LIMIT",
           "MAX_THREADS", "LANE_COLUMNS"]

STAGES = 8  # epochs in the ring (csrc/decision_scan.cu: its instantiations)
STEPS = (1, 4)  # epochs one step reduces at once (csrc/decision_scan.cu: its instantiations)
SMEM_LIMIT = 232_448  # shared memory one CTA may take on an H100
MAX_THREADS = 512  # the kernel's __launch_bounds__
LANE_COLUMNS = 16  # columns one lane scans at most, unless a client has 32 lanes
_DTYPES = (torch.float64, torch.float32)
_PTR, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = (_INT, _PTR, _PTR, _PTR, _PTR, _LL, _LL, _INT, _LL, ctypes.c_double, _INT, _INT, _INT,
             _INT, _INT, _INT, _PTR)


class ScanPlan(NamedTuple):
    step: int  # epochs reduced at once (their argmins interleaved), then gated in order
    clients: int  # contiguous clients per CTA; the last CTA takes the rest
    threads: int  # per CTA: a group of `group` lanes per client, whole warps
    group: int  # lanes per client: a power of two, at most 32
    smem: int  # bytes: one mbarrier per stage, then STAGES epochs of the CTA's costs
    ctas: int


def _ring_bytes(clients: int, e1: int, elt: int) -> int:
    # mbarriers (8 bytes each, rounded to 16), then the stages: the span
    # rounded up to 16 bytes, and 16 more, since the kernel shifts each stage
    # so that shared and global addresses agree modulo 16
    return -(-8 * STAGES // 16) * 16 + STAGES * (-(-clients * e1 * elt // 16) * 16 + 16)


def scan_plan(n_epochs: int, n: int, e1: int, elt: int, n_sm: int) -> ScanPlan:
    """CTAs for T epochs of N clients of E+1 costs of ``elt`` bytes: about
    two CTAs per SM where N allows (so that the grid covers the card), each
    a block of contiguous clients, as many as the block size and the ring's
    shared memory take. A client gets the fewest lanes (a power of two, at
    most 32) that leave each lane ``LANE_COLUMNS`` columns or fewer: fewer
    lanes, fewer shuffles. A step reduces 4 epochs at once where T has 4,
    else one (the closed loop's one-epoch launch pays for no idle rows).
    Raises where one client's ring does not fit."""
    if min(n_epochs, n, e1, n_sm) < 1 or elt not in (4, 8):
        raise ValueError(f"scan_plan needs positive sizes and 4- or 8-byte costs, got "
                         f"T={n_epochs} n={n} e1={e1} elt={elt} n_sm={n_sm}")
    step = STEPS[-1] if n_epochs >= STEPS[-1] else STEPS[0]
    group = min(32, 1 << (-(-e1 // LANE_COLUMNS) - 1).bit_length())
    clients = min(-(-n // (2 * n_sm)), MAX_THREADS // group)
    while clients > 1 and _ring_bytes(clients, e1, elt) > SMEM_LIMIT:
        clients -= 1
    smem = _ring_bytes(clients, e1, elt)
    if smem > SMEM_LIMIT:
        raise ValueError(f"decision_scan: {STAGES} epochs of one client's {e1} costs take "
                         f"{smem} bytes of shared memory, more than {SMEM_LIMIT}")
    threads = -(-clients * group // 32) * 32
    return ScanPlan(step, clients, threads, group, smem, -(-n // clients))


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(costs: torch.Tensor, cohort: torch.Tensor, prev: torch.Tensor | None, stagger: int,
           t0: int) -> None:
    if costs.dtype not in _DTYPES:
        raise TypeError(f"decision_scan takes float64 or float32 costs, got {costs.dtype}")
    if costs.dim() != 3 or costs.shape[2] < 1:
        raise ValueError(f"decision_scan takes (T, N, E+1) costs, got {tuple(costs.shape)}")
    n = costs.shape[1]
    for name, t in (("cohort", cohort), ("prev", prev)):
        if t is None:
            continue
        if t.dtype != torch.int32 or tuple(t.shape) != (n,) or t.device != costs.device:
            raise ValueError(f"{name} must be ({n},) int32 on {costs.device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if stagger < 1:
        raise ValueError(f"stagger must be >= 1, got {stagger}")
    if t0 < 0:
        raise ValueError(f"t0 must be >= 0, got {t0}")
    if prev is not None and n:
        lo, hi = torch.aminmax(prev)
        lo, hi = int(lo), int(hi)
        if lo < -1 or hi >= costs.shape[2] - 1:
            raise ValueError(f"prev must hold ON_DEVICE (-1) or an edge index below "
                             f"{costs.shape[2] - 1}; got {lo}..{hi}")


def decision_scan(costs: torch.Tensor, cohort: torch.Tensor, *, hysteresis: float = 0.0,
                  stagger: int = 1, prev: torch.Tensor | None = None,
                  t0: int = 0) -> torch.Tensor:
    """(T, N) int32 choices (``ON_DEVICE`` = -1 or an edge index) of N clients
    over T epochs: first-argmin over the stacked costs, relative-improvement
    hysteresis against the previous target's current cost, and the cohort
    gate (client i re-decides only when ``cohort[i] == (t0 + t) % stagger``).
    With ``prev=None`` and ``t0=0`` it is the reference's
    ``decision_scan_reference``; ``prev`` must lie in [-1, E)."""
    _check(costs, cohort, prev, stagger, t0)
    if costs.device.type == "cpu":
        return decision_scan_reference(costs, cohort, hysteresis=hysteresis, stagger=stagger,
                                       prev=prev, t0=t0)
    if costs.device.type != "cuda":
        raise ValueError(f"decision_scan runs on the CPU or a CUDA card, not {costs.device}")
    if not (costs.is_contiguous() and cohort.is_contiguous()
            and (prev is None or prev.is_contiguous())):
        raise ValueError(f"decision_scan kernel takes contiguous costs, cohort and prev; got "
                         f"cost strides {costs.stride()}")
    device = torch.cuda.current_device()
    if costs.device.index != device:
        raise ValueError(f"costs on {costs.device}, but the current device is cuda:{device}")
    t_n, n, e1 = costs.shape
    if not t_n * n:  # nothing to decide: no launch
        return torch.empty((t_n, n), dtype=torch.int32, device=costs.device)
    out = _launch(costs, cohort, prev, hysteresis, stagger, t0,
                  scan_plan(t_n, n, e1, costs.element_size(), _sm_count(device)))
    launched(decision_scan)
    return out


def _launch(costs: torch.Tensor, cohort: torch.Tensor, prev: torch.Tensor | None,
            hysteresis: float, stagger: int, t0: int, plan: ScanPlan) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors under ``plan``."""
    t_n, n, e1 = costs.shape
    out = torch.empty((t_n, n), dtype=torch.int32, device=costs.device)
    fn = _build.function("decision_scan", "decision_scan_launch", _ARGTYPES)
    code = fn(_build.DTYPE_CODES[costs.dtype], costs.data_ptr(), cohort.data_ptr(),
              None if prev is None else prev.data_ptr(), out.data_ptr(), t_n, n, e1, int(t0),
              float(hysteresis), int(stagger), plan.group, plan.clients, plan.threads, STAGES,
              plan.step, _build.stream_handle())
    _build.check(code, "decision_scan")
    return out


decision_scan.launches = 0
