"""Decode-attention wrapper: the plain version for a CPU tensor, the
hand-written Hopper kernel (``csrc/decode_attention.cu``) for a CUDA tensor.

Takes the model layout: q (B, 1, H, hd) and the (B, S, K, hd) caches, which
the kernel reads through strides (the cache is never copied). Keys at
positions <= pos are attended. ``split_plan`` cuts the visible keys into runs
for the kernel's CTAs; a second pass of the same C entry merges the runs.
``decode_attention.launches`` counts the wrapper's calls of that entry, one
per call; CPU calls never touch it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from .ref import decode_attention_reference

__all__ = ["decode_attention", "split_plan", "scratch_floats", "SplitPlan", "HEAD_DIMS",
           "MIN_SPLIT"]

HEAD_DIMS = (16, 32, 64, 128, 256)  # instantiated in csrc/decode_attention.cu
MIN_SPLIT = 32  # keys per run at least (all but a run that holds every key)
_ARGTYPES = (
    (ctypes.c_int,) + (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7 + (ctypes.c_longlong,) * 8
    + (ctypes.c_float, ctypes.c_float, ctypes.c_void_p)
)


class SplitPlan(NamedTuple):
    chunk: int  # keys per run; the last run holds the rest
    nsplit: int  # runs per (b, kv head)


def split_plan(B: int, K: int, n_valid: int, n_sm: int) -> SplitPlan:
    """Runs of keys for the kernel's CTAs: enough runs that B * K * nsplit
    covers ``n_sm`` SMs, each run a multiple of 16 keys (the tensor-core
    tile) and at least ``MIN_SPLIT`` of them, so that every key in
    [0, n_valid) falls in exactly one run."""
    if min(B, K, n_valid, n_sm) < 1:
        raise ValueError(f"split_plan needs positive sizes, got B={B} K={K} "
                         f"n_valid={n_valid} n_sm={n_sm}")
    want = -(-n_sm // (B * K))  # runs per (b, kv head) that fill the card
    if want == 1:  # the (b, kv head) pairs alone fill it: one run each
        return SplitPlan(-(-n_valid // 16) * 16, 1)
    chunk = max(MIN_SPLIT, n_valid // want // 16 * 16)
    return SplitPlan(chunk, -(-n_valid // chunk))


def scratch_floats(B: int, H: int, hd: int, nsplit: int) -> int:
    """float32s of scratch a call needs: each run's unnormalised output, max
    and sum per query head (none when one run holds every key)."""
    return 0 if nsplit == 1 else B * H * nsplit * (hd + 2)


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _launcher():
    return _build.function("decode_attention", "decode_attention_launch", _ARGTYPES)


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
    if (q.dtype not in (torch.float32, torch.bfloat16)
            or not q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError("decode_attention kernel takes float32 or bfloat16 throughout, got "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    _build.check_cuda_tensors(q=q, k_cache=k_cache, v_cache=v_cache)
    n_valid = min(pos + 1, S)
    device = q.device.index
    chunk, nsplit = split_plan(B, K, n_valid, _sm_count(device))
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    scratch = None
    if nsplit > 1:  # the runs' partials (layout in the .cu file), merged by pass 2
        scratch = torch.empty(scratch_floats(B, H, hd, nsplit), dtype=torch.float32,
                              device=q.device)
    code = _launcher()(
        _build.DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        B, H, K, n_valid, chunk, nsplit, hd,
        q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
        hd**-0.5, float(softcap), _build.stream_handle())
    _build.check(code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
