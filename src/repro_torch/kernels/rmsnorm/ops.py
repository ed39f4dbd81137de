"""RMSNorm wrapper: the plain version for a CPU tensor, the hand-written
Hopper kernel (``csrc/rmsnorm.cu``) for a CUDA tensor.

``rmsnorm.launches`` counts the kernel's launches (CPU calls never touch it).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import rmsnorm_reference

__all__ = ["rmsnorm"]

_ARGTYPES = (
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * (1 + scale) over the last dim, in fp32."""
    if x.device.type == "cpu":
        return rmsnorm_reference(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on the CPU or a CUDA card, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, got {x.dtype}")
    d = x.shape[-1]
    if scale.dtype != x.dtype or tuple(scale.shape) != (d,) or scale.device != x.device:
        raise ValueError(f"scale must be ({d},) {x.dtype} on {x.device}; got "
                         f"{tuple(scale.shape)} {scale.dtype} on {scale.device}")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("rmsnorm kernel takes contiguous x and scale")
    _build.check_cuda_tensors(x=x, scale=scale)
    out = torch.empty_like(x)
    fn = _build.function("rmsnorm", "rmsnorm_launch", _ARGTYPES)
    code = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), scale.data_ptr(), out.data_ptr(),
              x.numel() // d, d, eps, _build.stream_handle())
    _build.check(code, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
