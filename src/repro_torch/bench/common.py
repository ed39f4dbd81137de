"""Shared helpers for the paper-figure benchmarks (the port's copy of
``benchmarks/common.py``).

Every benchmark prints ``name,us_per_call,derived`` CSV rows (harness
contract) where ``derived`` carries the figure's headline quantity (MAPE,
crossover location, ...). Latency predictions are closed-form (microseconds
to evaluate); observations come from the discrete-event simulator.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

__all__ = ["timed", "mape", "emit", "Row"]


def mape(pred, obs) -> float:
    pred = np.asarray(pred, dtype=np.float64)
    obs = np.asarray(obs, dtype=np.float64)
    return float(np.mean(np.abs(pred - obs) / obs) * 100.0)


def timed(fn: Callable, *args, repeat: int = 3, **kw):
    """(result, microseconds-per-call)."""
    fn(*args, **kw)  # warm
    t0 = time.perf_counter()
    for _ in range(repeat):
        out = fn(*args, **kw)
    us = (time.perf_counter() - t0) / repeat * 1e6
    return out, us


def emit(name: str, us: float, derived) -> None:
    print(f"{name},{us:.1f},{derived}")
