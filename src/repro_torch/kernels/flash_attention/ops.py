"""Flash-attention wrapper: the plain version for a CPU tensor, the
hand-written Hopper kernel (``csrc/flash_attention.cu``) for a CUDA tensor.

Takes the model's (B, S, heads, hd) layout; the kernel reads it through
strides, so nothing is transposed. Causal and windowed attention take the
queries as the last Sq of the Skv positions (Sq <= Skv); unmasked attention
(an encoder's, or cross-attention) takes any Sq and Skv.
``flash_attention.launches`` counts the kernel's launches (CPU calls never
touch it).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import flash_attention_reference

__all__ = ["flash_attention", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128, 256)  # instantiated in csrc/flash_attention.cu
_ARGTYPES = (
    (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (ctypes.c_longlong,) * 12
    + (ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, K, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
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
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    fn = _build.function("flash_attention", "flash_attention_launch", _ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              B, H, K, Sq, Skv, hd,
              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
              hd**-0.5, int(causal), int(window), float(softcap), _build.stream_handle())
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
