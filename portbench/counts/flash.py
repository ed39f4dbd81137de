"""The flash-attention forward's bound: a frozen copy of the bound
arithmetic the port's card script uses (``max(bytes / 3.35 TB/s, ops /
peak)``), each input byte read once and the output written once."""

from __future__ import annotations

from .peaks import BF16_FLOPS, HBM_BPS

__all__ = ["flash_bytes", "flash_ops", "flash_bound_s"]


def flash_bytes(L: int, H: int, K: int, hd: int, elt: int = 2) -> int:
    """q and the output at H heads, k and v at K heads, L rows each."""
    return elt * (2 * L * H * hd + 2 * L * K * hd)


def flash_ops(L: int, H: int, hd: int, causal: bool = True) -> int:
    """QK^T and PV over the (query, key) pairs the mask keeps: 4 hd a pair a head."""
    pairs = L * (L + 1) // 2 if causal else L * L
    return 4 * H * hd * pairs


def flash_bound_s(L: int, H: int, K: int, hd: int, causal: bool = True) -> float:
    return max(flash_bytes(L, H, K, hd) / HBM_BPS, flash_ops(L, H, hd, causal) / BF16_FLOPS)
