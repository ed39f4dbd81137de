"""The traced run's device profile: ``torch.profiler`` over a steady stretch
of the window (not the whole of it), read from the profiler's own event list.

* busy: the union of the intervals in which an operation (kernel, copy,
  set) ran on the card;
* the stretch: its wall length on the host's clock, taken between two
  synchronised ticks;
* time by device operation, and the idle gaps, each named by the innermost
  host event that was running at its middle (the harness's own spans are
  ``portbench.*`` annotations).
"""

from __future__ import annotations

import heapq
import time

import torch

__all__ = ["Stretch", "summarize", "warm_profiler"]

TOP = 10
SPAN_PREFIX = "portbench."


def _profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def warm_profiler() -> None:
    """Start and stop the profiler once on a tiny kernel, so its set-up
    (CUPTI's) falls into set-up and not into the window."""
    prof = _profile()
    prof.start()
    torch.ones(16, device="cuda").sum()
    torch.cuda.synchronize()
    prof.stop()


class Stretch:
    """Profiles from the first tick at or after ``start_s`` to the first at or
    after ``stop_s`` (window seconds); records which service events ran
    inside."""

    def __init__(self, start_s: float, stop_s: float):
        self.start_s, self.stop_s = start_s, stop_s
        self.prof = None
        self.t_start = self.t_stop = None
        self.events_from = self.events_to = None
        self.start_cost_s = 0.0
        self.start_now = None  # window seconds at which it started

    def __call__(self, now: float, n_events: int) -> None:
        if self.prof is None and self.t_start is None and now >= self.start_s:
            torch.cuda.synchronize()
            t = time.perf_counter()
            self.prof = _profile()
            self.prof.start()
            self.t_start, self.events_from = time.perf_counter(), n_events
            self.start_cost_s = self.t_start - t
            self.start_now = now
        elif self.prof is not None and self.t_stop is None and now >= self.stop_s:
            torch.cuda.synchronize()
            self.t_stop, self.events_to = time.perf_counter(), n_events
            self.prof.stop()


def _union(intervals: list[tuple[int, int]]) -> list[list[int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(host: list, points: list) -> list:
    """For each point (ascending), the name of the latest-starting host event
    that covers it, or None: a sweep with a heap keyed on the start."""
    host = sorted(host)
    heap: list = []
    out, j = [], 0
    for p in points:
        while j < len(host) and host[j][0] <= p:
            heapq.heappush(heap, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def summarize(stretch: Stretch) -> dict | None:
    """busy_s, window_s, time by device operation, idle gaps by host event;
    ``None`` where the trace holds no device operation."""
    if stretch.prof is None or stretch.t_stop is None:
        return None
    events = stretch.prof.profiler.kineto_results.events()
    dev, host = [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        if "CUDA" in str(e.device_type()):
            if e.is_user_annotation() or e.name().startswith(SPAN_PREFIX):
                continue  # the harness's spans, mirrored on the device's timeline
            dev.append((start, start + dur, e.name()))
        else:
            host.append((start, start + dur, e.name()))
    if not dev:
        return None
    by_op: dict[str, list] = {}
    for a, b, name in dev:
        s = by_op.setdefault(name, [0, 0.0])
        s[0] += 1
        s[1] += (b - a) * 1e-9
    merged = _union([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in merged) * 1e-9
    lo = min(min(a for a, _, _ in host), merged[0][0]) if host else merged[0][0]
    hi = max(max(b for _, b, _ in host), merged[-1][1]) if host else merged[-1][1]
    gaps = []
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    by_gap: dict[str, float] = {}
    for (a, b), name in zip(gaps, _innermost(host, [(a + b) // 2 for a, b in gaps])):
        key = name or "(no host event)"
        by_gap[key] = by_gap.get(key, 0.0) + (b - a) * 1e-9
    ops = sorted(((name, s[1]) for name, s in by_op.items()), key=lambda x: -x[1])
    return {
        "busy_s": busy_s,
        "window_s": stretch.t_stop - stretch.t_start,
        "kernels": {name: (s[0], s[1]) for name, s in by_op.items()},
        "device_ops": [[name[:160], sec] for name, sec in ops[:TOP]],
        "idle_gaps": [[name[:160], sec] for name, sec in
                      sorted(by_gap.items(), key=lambda x: -x[1])[:TOP]],
        "events_from": stretch.events_from,
        "events_to": stretch.events_to,
    }
