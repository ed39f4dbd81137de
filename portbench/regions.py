#!/usr/bin/env python3
"""The program's host regions in the benchmark's traced run: the launch calls
of a decode step, and which region holds the host while the card idles.

    python3 portbench/regions.py --workload <cell> --seed <n> --seconds <s>

Makes ``run.py``'s traced run (``--trace 1``) of the cell with a disabled
``repro_torch.obs.Tracer`` handed to the engine after set-up, so that the
program names its host regions (``engine.*``, ``lm.*``) in the profile. The
result line is ``run.py``'s with two more keys. ``program`` holds, for each
user annotation in the profiled stretch (the program's regions and the
harness's ``portbench.*``):

* ``calls`` and ``host_s``: how many closed, and their seconds on the host;
* ``launches``: the CUDA launch calls (``LAUNCH_CALLS``), each counted by its
  midpoint in every annotation that holds it, so a region's count holds its
  children's; ``launches_min`` / ``launches_max`` over its calls;
* ``idle_s``: the seconds in which nothing ran on the card while it was the
  innermost annotation open: ``devtrace``'s idle gaps, over its extent, cut
  at every annotation's edges (``null`` holds the idle time in none).

``region_cost_us`` is the host's cost of one region, entered and left, with
no profiler recording and under one. The profiler slows the host, so every
host time here is the profiled stretch's. No metric of ``BENCHMARK.json``
reads this yet.
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)  # the harness's modules import as portbench.*
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import run as harness  # noqa: E402  (sets the caches' paths first)

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from portbench import devtrace  # noqa: E402
from portbench.cell import load_cell  # noqa: E402

__all__ = ["LAUNCH_CALLS", "attribute", "from_profile", "main"]

# host-side calls that put work on the card's stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")
COST_CALLS = 20000


def _entry() -> dict:
    return {"calls": 0, "host_s": 0.0, "launches": 0, "launches_min": None,
            "launches_max": None, "idle_s": 0.0}


def attribute(annotations: list, launches: list, device: list, lo: int,
              hi: int) -> dict:
    """The module docstring's sums, per annotation name. ``annotations`` are
    (start, end, name), ``launches`` and ``device`` (the card's operations)
    (start, end), all in nanoseconds on one clock; the card is idle in
    [lo, hi] wherever no operation ran."""
    out: dict = {None: _entry()}
    mids = sorted((a + b) // 2 for a, b in launches)
    for a, b, name in annotations:
        e = out.setdefault(name, _entry())
        n = bisect.bisect_right(mids, b) - bisect.bisect_left(mids, a)
        e["calls"] += 1
        e["host_s"] += (b - a) * 1e-9
        e["launches"] += n
        e["launches_min"] = n if e["launches_min"] is None else min(e["launches_min"], n)
        e["launches_max"] = n if e["launches_max"] is None else max(e["launches_max"], n)
    out[None]["launches"] = sum(name is None for name in devtrace._innermost(annotations, mids))
    edges = [lo] + [x for iv in devtrace._union(device) for x in iv] + [hi]
    bounds = sorted({x for a, b, _ in annotations for x in (a, b)})
    pieces = []  # the idle gaps, cut at every annotation's edge inside them
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        cuts = [a] + bounds[bisect.bisect_right(bounds, a):bisect.bisect_left(bounds, b)] + [b]
        pieces += list(zip(cuts, cuts[1:]))
    for (a, b), name in zip(pieces, devtrace._innermost(annotations,
                                                        [(a + b) // 2 for a, b in pieces])):
        out[name]["idle_s"] += (b - a) * 1e-9
    return out


def from_profile(prof) -> dict | None:
    """:func:`attribute` over a finished ``torch.profiler.profile``, on
    ``devtrace.summarize``'s extent and device operations; ``None`` where
    the card ran nothing."""
    annotations, launches, device, host = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        name = e.name()
        if "CUDA" in str(e.device_type()):
            if not (e.is_user_annotation() or name.startswith(devtrace.SPAN_PREFIX)):
                device.append((start, start + dur))
            continue
        host.append((start, start + dur))
        if e.is_user_annotation():
            annotations.append((start, start + dur, name))
        elif name.startswith(LAUNCH_CALLS):
            launches.append((start, start + dur))
    if not device:
        return None
    lo = min([a for a, _ in host] + [a for a, _ in device])
    hi = max([b for _, b in host] + [b for _, b in device])
    return attribute(annotations, launches, device, lo, hi)


def region_cost_us(calls: int = COST_CALLS) -> dict | None:
    """Microseconds a region costs the host, entered and left: with no
    profiler recording, and under one (CPU and CUDA activities); ``None``
    for a program without regions."""
    from repro_torch.obs import Tracer

    region = getattr(Tracer(enabled=False), "region", None)
    if region is None:
        return None

    def loop() -> float:
        t0 = time.perf_counter()
        for _ in range(calls):
            with region("lm.ffn.moe"):
                pass
        return (time.perf_counter() - t0) / calls * 1e6

    off = loop()
    prof = devtrace._profile()
    prof.start()
    on = loop()
    prof.stop()
    return {"off": off, "on": on}


def attach(engine) -> None:
    """Hand the engine a disabled tracer: regions named, no span kept."""
    from repro_torch.obs import Tracer
    engine.tracer = Tracer(enabled=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA card(s)")
        return 2
    torch.set_num_threads(2)
    harness.log(f"[device] {torch.cuda.get_device_name(0)}; name, power limit: "
                f"{harness._power()}")
    found = {}
    summarize = devtrace.summarize

    def summarize_and_attribute(stretch):
        out = summarize(stretch)
        if out is not None:
            found["program"] = from_profile(stretch.prof)
        return out

    devtrace.summarize = summarize_and_attribute
    result = harness.run(cell, seed=args.seed, seconds=args.seconds, trace=True, fault=attach)
    devtrace.summarize = summarize
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"refused: the process holds {bad} (JAX or the JAX package)")
        return 3
    program = found.get("program") or {}
    result["program"] = {("null" if k is None else k): v for k, v in program.items()}
    result["region_cost_us"] = region_cost_us()
    _log(program, result)
    print(json.dumps(result), flush=True)
    return 0


def _log(program: dict, result: dict) -> None:
    enq, sync = program.get("engine.decode.enqueue"), program.get("engine.decode.sync")
    if enq and enq["calls"]:
        harness.log(f"[regions] {enq['calls']} decode steps: {enq['launches'] / enq['calls']:.3f} "
                    f"launch calls a step (min {enq['launches_min']}, max "
                    f"{enq['launches_max']}); enqueue {enq['host_s'] / enq['calls'] * 1e3:.4f} ms"
                    + (f", sync {sync['host_s'] / sync['calls'] * 1e3:.4f} ms a step"
                       if sync and sync["calls"] else ""))
    inside = sum(e["idle_s"] for k, e in program.items() if k is not None)
    named = sum(e["idle_s"] for k, e in program.items()
                if k is not None and not k.startswith(devtrace.SPAN_PREFIX))
    if inside:
        harness.log(f"[regions] idle inside annotations {inside:.6f} s, "
                    f"{100 * named / inside:.3f}% of it in the program's regions; "
                    f"in none {program[None]['idle_s']:.6f} s")
    for k, e in sorted(program.items(), key=lambda x: -x[1]["idle_s"])[:12]:
        harness.log(f"[regions] {k}: idle {e['idle_s']:.6f} s, {e['calls']} calls, host "
                    f"{e['host_s']:.6f} s, {e['launches']} launch calls")
    cost = result["region_cost_us"]
    if cost is not None:
        harness.log(f"[regions] a region costs {cost['off']:.4f} us with no profiler, "
                    f"{cost['on']:.4f} us under one")


if __name__ == "__main__":
    sys.exit(main())
