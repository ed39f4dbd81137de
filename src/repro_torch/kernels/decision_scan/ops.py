"""Decision-scan wrapper: the plain version for CPU tensors, the hand-written
Hopper kernel (``csrc/decision_scan.cu``) for CUDA tensors.

``decision_scan`` takes contiguous (T, N, E+1) float64 or float32 costs
(column 0 on-device) and an (N,) int32 cohort, and optionally the (N,) int32
choices before its first epoch (``prev``) and that epoch's global index
(``t0``), so that a caller can hand it one epoch at a time. It counts its
kernel launches in ``decision_scan.launches`` (CPU calls never touch it) and
raises on anything the kernel does not take.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import decision_scan_reference

__all__ = ["decision_scan"]

_DTYPES = (torch.float64, torch.float32)
_PTR, _LL = ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = (ctypes.c_int, _PTR, _PTR, _PTR, _PTR, _LL, _LL, ctypes.c_int, _LL, ctypes.c_double,
             ctypes.c_int, _PTR)


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
    out = torch.empty((t_n, n), dtype=torch.int32, device=costs.device)
    fn = _build.function("decision_scan", "decision_scan_launch", _ARGTYPES)
    code = fn(_build.DTYPE_CODES[costs.dtype], costs.data_ptr(), cohort.data_ptr(),
              None if prev is None else prev.data_ptr(), out.data_ptr(), t_n, n, e1, int(t0),
              float(hysteresis), int(stagger), _build.stream_handle())
    _build.check(code, "decision_scan")
    decision_scan.launches += 1
    return out


decision_scan.launches = 0
