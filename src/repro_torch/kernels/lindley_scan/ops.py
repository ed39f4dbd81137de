"""Lindley-scan wrappers: the plain versions for CPU tensors, the hand-written
Hopper kernels (``csrc/lindley_scan.cu``) for CUDA tensors.

``lindley_scan`` is the k = 1 recursion (the Pallas kernel's counterpart);
``lindley_kserver`` the FCFS k-server station with per-row server counts.
Each counts its kernel launches in ``.launches`` (CPU calls never touch it).
Both take contiguous (B, T) float64 or float32 arrivals and services of one
dtype on the current card and raise on anything else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import lindley_kserver_reference, lindley_scan_reference

__all__ = ["lindley_scan", "lindley_kserver", "k_limit", "TILE", "STAGES"]

# the kernels' ring (csrc/lindley_scan.cu): STAGES stages of (32, TILE) tiles,
# for the card tests that probe its edges
TILE, STAGES = 64, 4

_DTYPES = (torch.float64, torch.float32)
_PTR, _LL = ctypes.c_void_p, ctypes.c_longlong
_SCAN_ARGTYPES = (ctypes.c_int, _PTR, _PTR, _PTR, _LL, _LL, _PTR)
_KSERVER_ARGTYPES = (ctypes.c_int, _PTR, _PTR, _PTR, _PTR, _LL, _LL, ctypes.c_int, _PTR)


@functools.cache
def k_limit() -> int:
    """The most servers a row of the k-server kernel may have."""
    return _build.function("lindley_scan", "lindley_kmax", (), ctypes.c_int)()


def _check(name: str, arrivals: torch.Tensor, services: torch.Tensor) -> None:
    if arrivals.device.type != "cuda":
        raise ValueError(f"{name} runs on the CPU or a CUDA card, not {arrivals.device}")
    if arrivals.dtype not in _DTYPES or services.dtype != arrivals.dtype:
        raise TypeError(f"{name} kernel takes float64 or float32 arrivals and services of one "
                        f"dtype, got {arrivals.dtype}/{services.dtype}")
    if arrivals.dim() != 2 or services.shape != arrivals.shape:
        raise ValueError(f"{name} takes (B, T) arrivals and services of one shape, got "
                         f"{tuple(arrivals.shape)} and {tuple(services.shape)}")
    if not (arrivals.is_contiguous() and services.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous (B, T) rows; got strides "
                         f"{arrivals.stride()} and {services.stride()}")
    device = torch.cuda.current_device()
    if arrivals.device.index != device or services.device != arrivals.device:
        raise ValueError(f"{name}: arrivals on {arrivals.device}, services on {services.device}, "
                         f"but the current device is cuda:{device}")


def lindley_scan(arrivals: torch.Tensor, services: torch.Tensor) -> torch.Tensor:
    """Departure times of B independent single-server FCFS stations:
    dep_i = max(arr_i, dep_{i-1}) + svc_i per row, the clock from -inf."""
    if arrivals.device.type == "cpu":
        return lindley_scan_reference(arrivals, services)
    _check("lindley_scan", arrivals, services)
    b, n = arrivals.shape
    out = torch.empty_like(arrivals)
    fn = _build.function("lindley_scan", "lindley_scan_launch", _SCAN_ARGTYPES)
    code = fn(_build.DTYPE_CODES[arrivals.dtype], arrivals.data_ptr(), services.data_ptr(),
              out.data_ptr(), b, n, _build.stream_handle())
    _build.check(code, "lindley_scan")
    lindley_scan.launches += 1
    return out


def lindley_kserver(arrivals: torch.Tensor, services: torch.Tensor, k: torch.Tensor,
                    k_max: int) -> torch.Tensor:
    """Departure times of B FCFS stations with ``k[b]`` servers each (int32,
    at most ``k_max``): every job starts on the first free server of lowest
    index at max(arrival, free time); servers start free at time 0. A row
    with k outside 1..k_max raises: it would run with fewer servers, or with
    none and +inf departures."""
    if k.numel() and (int(k.min()) < 1 or int(k.max()) > k_max):
        raise ValueError(f"every row needs 1..k_max={k_max} servers; got k in "
                         f"{int(k.min())}..{int(k.max())}")
    if arrivals.device.type == "cpu":
        return lindley_kserver_reference(arrivals, services, k, k_max)
    _check("lindley_kserver", arrivals, services)
    b, n = arrivals.shape
    if k.dtype != torch.int32 or tuple(k.shape) != (b,) or not k.is_contiguous() \
            or k.device != arrivals.device:
        raise ValueError(f"k must be contiguous ({b},) int32 on {arrivals.device}; got "
                         f"{tuple(k.shape)} {k.dtype} on {k.device}")
    if not 1 <= k_max <= k_limit():
        raise ValueError(f"k_max={k_max} outside the kernel's 1..{k_limit()} servers per row")
    out = torch.empty_like(arrivals)
    fn = _build.function("lindley_scan", "lindley_kserver_launch", _KSERVER_ARGTYPES)
    code = fn(_build.DTYPE_CODES[arrivals.dtype], arrivals.data_ptr(), services.data_ptr(),
              k.data_ptr(), out.data_ptr(), b, n, int(k_max), _build.stream_handle())
    _build.check(code, "lindley_scan")
    lindley_kserver.launches += 1
    return out


lindley_scan.launches = 0
lindley_kserver.launches = 0
