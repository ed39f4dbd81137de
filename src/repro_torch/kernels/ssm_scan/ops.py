"""Selective-scan wrapper: the plain version for CPU tensors, the hand-written
Hopper kernel (``csrc/ssm_scan.cu``) for CUDA tensors.

``ssm_scan(dt, Bc, Cc, u, A, h0=None) -> (y, h_final)`` with dt, u (B, T, D)
bf16 or fp32 of one dtype, contiguous; Bc, Cc (B, T, N) of the same dtype,
read through their strides (the model passes column slices of the ``x_proj``
output, whose rows are dtr + 2N wide) with unit stride on N; A (D, N) fp32;
h0 (B, D, N) fp32 or None for zeros. N is at most ``N_MAX``. Anything else
raises. ``ssm_scan.launches`` counts the kernel's launches (CPU calls never
touch it).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ssm_scan_reference

__all__ = ["ssm_scan", "N_MAX"]

N_MAX = 16  # states per channel the kernel keeps in registers
_DTYPES = (torch.bfloat16, torch.float32)
_PTR, _LL = ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = ((ctypes.c_int,) + (_PTR,) * 8 + (ctypes.c_int,) * 4 + (_LL,) * 4 + (_PTR,))


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
    B, T, D = u.shape
    N = A.shape[1]
    y = torch.empty_like(u)
    h_final = torch.empty((B, D, N), dtype=torch.float32, device=u.device)
    fn = _build.function("ssm_scan", "ssm_scan_launch", _ARGTYPES)
    code = fn(_build.DTYPE_CODES[u.dtype], dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
              u.data_ptr(), A.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
              h_final.data_ptr(), B, T, D, N, Bc.stride(0), Bc.stride(1), Cc.stride(0),
              Cc.stride(1), _build.stream_handle())
    _build.check(code, "ssm_scan")
    ssm_scan.launches += 1
    return y, h_final


ssm_scan.launches = 0
