"""Fleet sweep CLI: evaluate a cartesian scenario grid on the card.

Packs a base scenario (built-in paper operating point, or any
``Scenario.to_dict()`` JSON via ``--scenario``) into a
:class:`repro_torch.fleet.ScenarioBatch`, evaluates every grid point with the
float64 closed forms on ``--device`` (default: the CUDA card), and reports
strategy shares, latency stats, throughput (scenarios/sec), and optionally
batched crossover points. Times are taken after the card has finished.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.fleet_sweep \
      --axis network.bandwidth_Bps=1e5:1e8:256:geom \
      --axis workload.arrival_rate=0.5:30:128 \
      --crossover bandwidth --out experiments/fleet_sweep.json
  PYTHONPATH=src python -m repro_torch.launch.fleet_sweep --device cpu
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.latency import NetworkPath, Tier, Workload
from repro_torch.core.scenario import EdgeSpec, Scenario
from repro_torch.device import resolve_device
from repro_torch.fleet import ScenarioBatch, fleet_analytic, fleet_crossover
from repro_torch.obs import run_manifest

__all__ = ["default_scenario", "parse_axis", "run_sweep", "main"]


def default_scenario() -> Scenario:
    """The paper's headline operating point: InceptionV4 on a TX2-class
    device vs an A2-class edge at 5 Mbps, 2 rps."""
    return Scenario(
        workload=Workload(arrival_rate=2.0, req_bytes=30_000, res_bytes=1_000,
                          name="inceptionv4"),
        device=Tier("tx2", 0.150),
        edges=(EdgeSpec(Tier("a2", 0.028)),),
        network=NetworkPath(5e6 / 8),
        allow_unstable=True,  # sweep grids deliberately cross saturation
        name="fleet-sweep-default",
    )


def parse_axis(spec: str) -> tuple[str, np.ndarray]:
    """``path=lo:hi:n[:geom|lin]`` -> (path, values)."""
    try:
        path, rng = spec.split("=", 1)
        parts = rng.split(":")
        lo, hi, n = float(parts[0]), float(parts[1]), int(parts[2])
        kind = parts[3] if len(parts) > 3 else "lin"
    except (ValueError, IndexError):
        raise SystemExit(
            f"bad --axis {spec!r}: expected path=lo:hi:n[:geom|lin]") from None
    if kind not in ("geom", "lin"):
        raise SystemExit(f"bad --axis {spec!r}: kind must be geom or lin")
    vals = np.geomspace(lo, hi, n) if kind == "geom" else np.linspace(lo, hi, n)
    return path, vals


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sweep(
    base: Scenario,
    axes: dict[str, np.ndarray],
    *,
    crossover_axis: str | None = None,
    repeat: int = 3,
    device=None,
) -> dict:
    dev = resolve_device(device)
    t0 = time.perf_counter()
    batch = ScenarioBatch.from_sweep(base, axes)
    pack_s = time.perf_counter() - t0

    fleet_analytic(batch, device=dev)  # warm: first-call set-up outside the timed region
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(repeat):
        pred = fleet_analytic(batch, device=dev)
    _sync(dev)
    eval_s = (time.perf_counter() - t0) / repeat

    names = pred.strategy_names()
    counts: dict[str, int] = {}
    for n in names:
        counts[n] = counts.get(n, 0) + 1
    best = pred.best_latency
    finite = best[np.isfinite(best)]
    out = {
        "scenario": base.to_dict(),
        "axes": {p: {"n": int(v.size), "lo": float(v.min()), "hi": float(v.max())}
                 for p, v in axes.items()},
        "batch_size": batch.size,
        "device": str(dev),
        "timing": {
            "pack_ms": pack_s * 1e3,
            "eval_ms": eval_s * 1e3,
            "scenarios_per_sec": batch.size / eval_s,
        },
        "strategy_counts": counts,
        "best_latency_s": {
            "finite_frac": float(np.isfinite(best).mean()),
            "min": float(finite.min()) if finite.size else None,
            "median": float(np.median(finite)) if finite.size else None,
            "max": float(finite.max()) if finite.size else None,
        },
    }
    if crossover_axis:
        _sync(dev)
        t0 = time.perf_counter()
        cx = fleet_crossover(batch, crossover_axis, device=dev)
        _sync(dev)
        cx_s = time.perf_counter() - t0
        vals = cx.value[cx.found]
        out["crossover"] = {
            "axis": crossover_axis,
            "solve_ms": cx_s * 1e3,
            "found_frac": float(cx.found.mean()),
            "min": float(vals.min()) if vals.size else None,
            "median": float(np.median(vals)) if vals.size else None,
            "max": float(vals.max()) if vals.size else None,
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--axis", action="append", default=[],
                    help="path=lo:hi:n[:geom|lin]; repeatable")
    ap.add_argument("--scenario", type=Path, default=None,
                    help="Scenario.to_dict() JSON file (default: built-in paper point)")
    ap.add_argument("--crossover", choices=("bandwidth", "arrival_rate"), default=None,
                    help="also solve batched crossovers along this axis")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="where the closed forms run (default: the CUDA card; 'cpu' to run here)")
    ap.add_argument("--out", type=Path, default=None, help="write the report JSON here")
    args = ap.parse_args(argv)

    if args.scenario is not None:
        base = Scenario.from_dict(json.loads(args.scenario.read_text()))
    else:
        base = default_scenario()
    if args.axis:
        axes = dict(parse_axis(s) for s in args.axis)
    else:
        axes = {
            "network.bandwidth_Bps": np.geomspace(1e5, 1e8, 256),
            "workload.arrival_rate": np.linspace(0.5, 30.0, 128),
        }

    report = run_sweep(base, axes, crossover_axis=args.crossover, repeat=args.repeat,
                       device=args.device)
    report["manifest"] = run_manifest(config={
        "axes": {path: len(vals) for path, vals in axes.items()},
        "scenario": str(args.scenario) if args.scenario else "builtin",
        "crossover": args.crossover, "repeat": args.repeat, "device": args.device,
    })
    t = report["timing"]
    print(f"fleet sweep: {report['batch_size']} scenarios on {report['device']} "
          f"(pack {t['pack_ms']:.1f} ms, eval {t['eval_ms']:.2f} ms, "
          f"{t['scenarios_per_sec']/1e6:.2f}M scenarios/s)")
    for name, cnt in sorted(report["strategy_counts"].items()):
        print(f"  {name:12s} wins {cnt:8d} ({cnt/report['batch_size']:6.1%})")
    if args.crossover:
        cx = report["crossover"]
        print(f"  {args.crossover} crossover found for {cx['found_frac']:.1%} "
              f"(median {cx['median']})")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=2))
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
