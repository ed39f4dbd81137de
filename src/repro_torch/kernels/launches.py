"""The kernel wrappers' launch counters.

Each wrapper counts the calls that launch its hand-written kernel in its own
``.launches`` through ``launched`` (CPU calls never count). A call made while
the current stream captures a CUDA graph launches nothing: it does not
count, and counts instead in the tally of the innermost ``captured`` block,
which ``replayed`` adds to the counters each time the graph replays. So the
counters count the kernels that run, eagerly or by replay.

``counted()`` is every wrapper with a counter.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import torch

__all__ = ["counted", "launched", "captured", "replayed"]

_TALLIES: list[Counter] = []  # the open ``captured`` blocks' tallies, innermost last


def launched(op) -> None:
    """Count one launch of wrapper ``op``'s kernel: in ``op.launches``, or,
    while the current stream captures, in the innermost capture's tally."""
    if not torch.cuda.is_current_stream_capturing():
        op.launches += 1
    elif _TALLIES:
        _TALLIES[-1][op] += 1


@contextlib.contextmanager
def captured():
    """A tally (wrapper -> launches) of the calls made while the current
    stream captures inside the block: what one replay of the graph runs."""
    tally: Counter = Counter()
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.pop()


def replayed(tally: Counter) -> None:
    """Count one replay of a graph whose capture made ``tally``."""
    for op, n in tally.items():
        op.launches += n


def counted() -> tuple:
    """Every kernel wrapper with a launch counter."""
    from .decision_scan.ops import decision_scan
    from .decode_attention.ops import decode_attention
    from .flash_attention.ops import flash_attention, flash_attention_backward
    from .lindley_scan.ops import lindley_kserver, lindley_scan
    from .rmsnorm.ops import rmsnorm, rmsnorm_add, rmsnorm_backward
    from .ssm_scan.ops import ssm_scan, ssm_scan_backward

    return (rmsnorm, rmsnorm_add, flash_attention, decode_attention, lindley_scan,
            lindley_kserver, decision_scan, ssm_scan, ssm_scan_backward,
            flash_attention_backward, rmsnorm_backward)
