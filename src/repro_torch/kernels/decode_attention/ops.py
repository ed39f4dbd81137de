"""Decode-attention wrapper: the plain version for a CPU tensor, the
hand-written Hopper kernel (``csrc/decode_attention.cu``) for a CUDA tensor.

Takes the model layout: q (B, 1, H, hd) and the (B, S, K, hd) caches, which
the kernel reads through strides (the cache is never copied). Keys at
positions <= pos are attended. ``decode_attention.launches`` counts the
wrapper's kernel launches, one per call (a call runs the split pass and its
combine pass); CPU calls never touch it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import decode_attention_reference

__all__ = ["decode_attention", "HEAD_DIMS", "SMEM_LIMIT"]

HEAD_DIMS = (16, 32, 64, 128, 256)  # instantiated in csrc/decode_attention.cu
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
_ARGTYPES = (
    (ctypes.c_int,) + (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_longlong,) * 8
    + (ctypes.c_float, ctypes.c_float, ctypes.c_void_p)
)


@functools.cache
def _chunk() -> int:
    return _build.function("decode_attention", "decode_attention_chunk", (), ctypes.c_int)()


@functools.cache
def _smem_bytes(G: int, hd: int) -> int:
    return _build.function("decode_attention", "decode_attention_smem",
                           (ctypes.c_int, ctypes.c_int), ctypes.c_longlong)(G, hd)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S, K, hd)
    v_cache: torch.Tensor,
    pos: int,
    *,
    softcap: float = 0.0,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, pos, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on the CPU or a CUDA card, not {q.device}")
    B, one, H, hd = q.shape
    Bk, S, K, hdk = k_cache.shape
    if (one != 1 or tuple(v_cache.shape) != tuple(k_cache.shape) or Bk != B or hdk != hd
            or K == 0 or H % K):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)} are not (B, 1, H, hd), (B, S, K, hd)")
    pos = int(pos)
    if not 0 <= pos:
        raise ValueError(f"pos must be >= 0, got {pos}")
    if q.dtype not in _build.DTYPE_CODES or not q.dtype == k_cache.dtype == v_cache.dtype:
        raise TypeError("decode_attention kernel takes float32 or bfloat16 throughout, got "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    _build.check_cuda_tensors(q=q, k_cache=k_cache, v_cache=v_cache)
    smem = _smem_bytes(H // K, hd)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{H // K} query heads per kv head at head_dim {hd} need {smem} bytes "
                         f"of shared memory, over the {SMEM_LIMIT} a block has")
    n_valid = min(pos + 1, S)
    nsplit = -(-n_valid // _chunk())
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    # partial outputs, maxima and sums of the split pass (layout in the .cu file)
    scratch = torch.empty(B * H * nsplit * (hd + 2), dtype=torch.float32, device=q.device)
    fn = _build.function("decode_attention", "decode_attention_launch", _ARGTYPES)
    code = fn(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
              out.data_ptr(), scratch.data_ptr(), B, H, K, n_valid, hd,
              q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
              hd**-0.5, float(softcap), _build.stream_handle())
    _build.check(code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
