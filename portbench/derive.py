"""Quantities the metric readers share, from a finished run
(``window.RunRecord``)."""

from __future__ import annotations

import math

from .counts.flash import flash_bound_s
from .counts.model_flops import decode_flops, prefill_flops
from .counts.peaks import BF16_FLOPS
from .stats import percentile

__all__ = ["event_flops", "mfu_pct", "mean_service_ms", "idle_pct", "flash_roofline_pct",
           "due_to_done_p95_ms", "token_gap_p95_ms", "tokens_per_s"]


def event_flops(model: dict, ev: dict) -> int:
    if ev["phase"] == "prefill":
        return prefill_flops(model, ev["tokens"])
    return decode_flops(model, ev["pos"], ev["occupancy"])


def mfu_pct(run) -> float | None:
    """Useful model FLOPs of the service finished inside the window over what
    the card's bf16 peak does in the window's seconds (in a traced run, the
    window up to its profiled stretch)."""
    evs = run.events_in_window()
    span = run.seconds if run.untraced_s is None else run.untraced_s
    if not evs or span <= 0:
        return None
    return 100.0 * sum(event_flops(run.model, e) for e in evs) / (span * BF16_FLOPS)


def mean_service_ms(run, phase: str) -> float | None:
    """Mean service of the window's events of one phase (the engine's stamps,
    taken after a synchronise), whatever their ``compile`` flag."""
    evs = run.events_in_window(phase)
    if not evs:
        return None
    return 1e3 * sum(e["duration_s"] for e in evs) / len(evs)


def idle_pct(run) -> float | None:
    p = run.profile
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def flash_roofline_pct(run, kernel: str) -> float | None:
    """The flash forward's bound over its device time, summed over every
    launch of the profiled stretch. Each prefill of L tokens launches the
    kernel once per attention layer at (1, L, H on K, hd); a trace whose
    launch count differs reads nothing."""
    p = run.profile
    if not p:
        return None
    m = run.model
    launches = sum(c for name, (c, _) in p["kernels"].items() if kernel in name)
    device_s = sum(s for name, (_, s) in p["kernels"].items() if kernel in name)
    prefills = [e["tokens"] for e in p["events"] if e["phase"] == "prefill"]
    n_attn = sum(mixer == "attn" for mixer, _ in m["layers"])
    if not prefills or device_s <= 0 or launches != n_attn * len(prefills):
        return None
    bound = sum(n_attn * flash_bound_s(L, m["num_heads"], m["num_kv_heads"], m["head_dim"])
                for L in prefills)
    return 100.0 * bound / device_s


def due_to_done_p95_ms(run) -> float | None:
    """Due time to response, p95 over every request attempted; one that never
    finished misses every limit."""
    v = percentile([r.latency_s for r in run.requests], 95)
    return None if v is None or math.isinf(v) else 1e3 * v


def token_gap_p95_ms(run) -> float | None:
    """Gaps between consecutive tokens of a request, p95 over every gap that
    ends inside the window."""
    gaps = [b - a for r in run.requests for a, b in zip(r.stamps, r.stamps[1:])
            if b <= run.seconds]
    v = percentile(gaps, 95)
    return None if v is None else 1e3 * v


def tokens_per_s(run) -> float | None:
    """Output tokens stamped inside the window over its seconds (in a traced
    run, the window up to its profiled stretch)."""
    span = run.seconds if run.untraced_s is None else run.untraced_s
    n = sum(1 for r in run.requests for t in r.stamps if 0.0 <= t <= span)
    return n / span if n and span > 0 else None
