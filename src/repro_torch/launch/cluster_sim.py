"""Closed-loop cluster CLI: N adaptive clients sharing E edge servers, on
the card.

The exact mode of ``repro.launch.cluster_sim`` (per-client state): solves the
fixed point of the decision->load map under nominal conditions (who lands
where, per-edge utilization, best-response iterations), replays the fleet
through a bandwidth trace with the estimator-lagged adaptive manager per
client scored against every all-clients static policy, and with
``--cross-check`` validates the closed-loop analytic means against the
event-driven simulators. Everything runs on ``--device`` (default: the CUDA
card), the decide steps through the hand-written decision-scan kernel. The
mean-field mode (``--meanfield``) needs ``fleet/meanfield.py``, which is not
ported yet: it exits 2 and says so.

Conditions come from the built-in bandwidth-step walk (``--duration`` /
``--bw-drop``) or from a ``--trace`` JSON spec of step breakpoints; a
malformed trace spec is rejected loudly with exit code 2 before any solve.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.cluster_sim --clients 64 \
      --duration 180 --bw-drop 0.15 --out experiments/CLUSTER.json
  PYTHONPATH=src python -m repro_torch.launch.cluster_sim --cluster spec.json \
      --cross-check
  PYTHONPATH=src python -m repro_torch.launch.cluster_sim --device cpu --clients 16
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from repro_torch.core.latency import NetworkPath, ServiceModel, Tier, Workload
from repro_torch.core.scenario import ClusterSpec, EdgeSpec, Scenario
from repro_torch.fleet import (
    Trace,
    cross_check_equilibrium,
    epoch_times,
    simulate_cluster,
    solve_equilibrium,
    step_signal,
)
from repro_torch.obs import run_manifest

__all__ = [
    "TraceSpecError",
    "default_cluster",
    "load_trace_spec",
    "trace_signals",
    "main",
]

MEANFIELD_NOT_PORTED = (
    "--meanfield needs fleet/meanfield.py (solve_meanfield_equilibrium, "
    "simulate_meanfield), which ROADMAP A3 ports after tail_vec/euler_vec; the "
    "exact mode runs without it")


class TraceSpecError(ValueError):
    """A ``--trace`` JSON spec that cannot mean anything: the CLI prints the
    message and exits 2 rather than guessing."""


def default_cluster(n_clients: int = 64) -> ClusterSpec:
    """The acceptance-criteria cluster: N Orin-class clients at 2 rps each
    contending for four heterogeneous edge tiers over a 20 Mbit path. Sized
    so no single edge can absorb the whole fleet (every all-on-one-edge
    static saturates) while the equilibrium spreads load at moderate
    utilization."""
    base = Scenario(
        workload=Workload(arrival_rate=2.0, req_bytes=30_000, res_bytes=1_000,
                          name="inceptionv4"),
        device=Tier("orin", 0.045),
        edges=(
            EdgeSpec(Tier("a2", 0.028)),
            EdgeSpec(Tier("a100", 0.008)),
            EdgeSpec(Tier("t4-llm", 0.020, service_model=ServiceModel.EXPONENTIAL)),
            EdgeSpec(Tier("edge-mixed", 0.015, service_model=ServiceModel.GENERAL,
                          service_var=0.25 * 0.015**2)),
        ),
        network=NetworkPath(20e6 / 8),
        name="cluster-default-base",
    )
    return ClusterSpec(base=base, n_clients=n_clients,
                       name=f"cluster-{n_clients}x{len(base.edges)}")


# -- trace specs --------------------------------------------------------------

_TRACE_KEYS = ("duration_s", "epoch_s", "bandwidth_Bps", "arrival_rate",
               "edge_bg_rate")


def _breakpoints(field: str, val, *, positive: bool) -> list[tuple[float, float]]:
    if not isinstance(val, list) or not val:
        raise TraceSpecError(
            f"{field} must be a non-empty list of [time, value] breakpoints, "
            f"got {val!r}")
    out = []
    for i, p in enumerate(val):
        ok = (isinstance(p, (list, tuple)) and len(p) == 2 and
              all(isinstance(x, (int, float)) and not isinstance(x, bool)
                  for x in p))
        if not ok:
            raise TraceSpecError(
                f"{field}[{i}] must be a [time, value] number pair, got {p!r}")
        t, v = float(p[0]), float(p[1])
        if t < 0:
            raise TraceSpecError(f"{field}[{i}] time must be non-negative, got {t}")
        if positive and v <= 0:
            raise TraceSpecError(f"{field}[{i}] value must be positive, got {v}")
        if v < 0:
            raise TraceSpecError(f"{field}[{i}] value must be non-negative, got {v}")
        out.append((t, v))
    if any(b[0] < a[0] for a, b in zip(out, out[1:])):
        raise TraceSpecError(f"{field} breakpoints must be sorted by time")
    return out


def load_trace_spec(path: Path) -> dict:
    """Parse and validate a ``--trace`` JSON spec.

    Schema (times in seconds, piecewise-constant step breakpoints)::

        {"duration_s": 180.0, "epoch_s": 1.0,
         "bandwidth_Bps": [[0, 2.5e6], [60, 4e5], [120, 2.5e6]],
         "arrival_rate": [[0, 2.0]],              # optional, default: spec's
         "edge_bg_rate": {"1": [[0, 0], [60, 50]]}}  # optional, per edge

    Every way the spec can be malformed — unknown keys, non-numeric or
    unsorted breakpoints, non-positive bandwidth, bad edge keys — raises
    :class:`TraceSpecError` naming the offending field; nothing is silently
    coerced or defaulted."""
    try:
        doc = json.loads(path.read_text())
    except OSError as err:
        raise TraceSpecError(f"cannot read {path}: {err}") from None
    except json.JSONDecodeError as err:
        raise TraceSpecError(f"{path} is not valid JSON: {err}") from None
    if not isinstance(doc, dict):
        raise TraceSpecError(
            f"trace spec must be a JSON object, got {type(doc).__name__}")
    unknown = sorted(set(doc) - set(_TRACE_KEYS))
    if unknown:
        raise TraceSpecError(
            f"unknown trace spec key(s) {', '.join(map(repr, unknown))} "
            f"(known: {', '.join(_TRACE_KEYS)})")
    for key in ("duration_s", "epoch_s"):
        v = doc.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v <= 0:
            raise TraceSpecError(f"{key} must be a positive number, got {v!r}")
    if doc["duration_s"] < 2 * doc["epoch_s"]:
        raise TraceSpecError(
            f"duration_s={doc['duration_s']} must cover at least two "
            f"epoch_s={doc['epoch_s']} epochs")
    if "bandwidth_Bps" not in doc:
        raise TraceSpecError("bandwidth_Bps breakpoints are required")
    spec = {"duration_s": float(doc["duration_s"]),
            "epoch_s": float(doc["epoch_s"]),
            "bandwidth_Bps": _breakpoints("bandwidth_Bps", doc["bandwidth_Bps"],
                                          positive=True)}
    if "arrival_rate" in doc:
        spec["arrival_rate"] = _breakpoints("arrival_rate", doc["arrival_rate"],
                                            positive=True)
    if "edge_bg_rate" in doc:
        bg = doc["edge_bg_rate"]
        if not isinstance(bg, dict):
            raise TraceSpecError(
                f"edge_bg_rate must be an object mapping edge index -> "
                f"breakpoints, got {type(bg).__name__}")
        norm = {}
        for k, pts in bg.items():
            try:
                j = int(k)
            except (TypeError, ValueError):
                raise TraceSpecError(
                    f"edge_bg_rate key {k!r} is not an edge index") from None
            norm[j] = _breakpoints(f"edge_bg_rate[{k}]", pts, positive=False)
        spec["edge_bg_rate"] = norm
    return spec


def trace_signals(
    ts: dict, n_edges: int, default_arrival: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Validated trace spec -> (times, bandwidth, arrival, edge_bg) signals.

    ``bandwidth`` and ``arrival`` are (T,) base signals (mean-field mode
    folds per-class scales in afterwards); ``edge_bg`` is (T, E). An edge
    index outside the spec's pool is a :class:`TraceSpecError` — the check
    needs the scenario, so it lives here rather than in the parser."""
    times = epoch_times(ts["duration_s"], ts["epoch_s"])
    bw = step_signal(times, ts["bandwidth_Bps"])
    lam = step_signal(times, ts.get("arrival_rate",
                                    [(0.0, float(default_arrival))]))
    exo = np.zeros((len(times), n_edges))
    for j, pts in ts.get("edge_bg_rate", {}).items():
        if not 0 <= j < n_edges:
            raise TraceSpecError(
                f"edge_bg_rate index {j} out of range for {n_edges} edges")
        exo[:, j] = step_signal(times, pts)
    return times, bw, lam, exo


def _default_trace_spec(args, bw0: float) -> dict:
    """The built-in §5-style walk: bandwidth drops to ``--bw-drop`` x for
    the middle third of the trace."""
    third = args.duration / 3
    return {"duration_s": args.duration, "epoch_s": args.epoch_s,
            "bandwidth_Bps": [(0.0, bw0), (third, bw0 * args.bw_drop),
                              (2 * third, bw0)]}


def _write_report(out: Path | None, report: dict, args=None) -> None:
    if out:
        if "manifest" not in report:
            seed = getattr(args, "seed", None)
            config = None
            if args is not None:
                config = {"mode": report.get("mode"),
                          "clients": getattr(args, "clients", None),
                          "duration": getattr(args, "duration", None)}
            report["manifest"] = run_manifest(seed=seed, config=config)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2))
        print(f"wrote {out}")


# -- exact mode ---------------------------------------------------------------


def _run_exact(args, ts: dict | None) -> int:
    if args.cluster is not None:
        spec = ClusterSpec.from_dict(json.loads(args.cluster.read_text()))
    else:
        spec = default_cluster(args.clients)
    n, e = spec.n_clients, spec.n_edges
    bw0 = float(np.asarray(spec.base.network.bandwidth_Bps))
    if ts is None:
        ts = _default_trace_spec(args, bw0)
    times, bw, lam, exo = trace_signals(ts, e, spec.base.workload.arrival_rate)
    trace = Trace(times=times, bandwidth_Bps=bw, arrival_rate=lam,
                  edge_bg_rate=exo)

    # -- equilibrium under nominal conditions ---------------------------------
    t0 = time.perf_counter()
    eq = solve_equilibrium(spec, max_iter=args.max_iter or 20, device=args.device)
    eq_s = time.perf_counter() - t0
    print(f"{spec.name}: {n} clients x {e} edges")
    print(f"equilibrium: {'converged' if eq.converged else 'NOT CONVERGED'} in "
          f"{eq.iterations} iterations ({eq_s*1e3:.0f} ms"
          f"{', damped after oscillation' if eq.oscillation else ''})")
    for tgt, cnt in eq.counts().items():
        if cnt:
            print(f"  {tgt:12s} {cnt:4d} clients")
    print("  edge rho: " + "  ".join(f"{r:.3f}" for r in eq.rho_edges))
    print(f"  mean latency {eq.mean_latency_s*1e3:.2f} ms")

    # -- closed-loop replay on the trace --------------------------------------
    policies = ("adaptive", "on_device") + tuple(f"edge[{j}]" for j in range(e))
    res = simulate_cluster(spec, trace, policies=policies, seed=args.seed,
                           stagger=args.stagger, hysteresis=args.hysteresis,
                           device=args.device)
    # warm throughput: the kernel is built and loaded now, time a second pass
    t0 = time.perf_counter()
    simulate_cluster(spec, trace, policies=("adaptive",), seed=args.seed,
                     stagger=args.stagger, hysteresis=args.hysteresis,
                     device=args.device)
    rate = res.client_epochs / (time.perf_counter() - t0)
    print(f"closed loop: {res.client_epochs} client-epochs "
          f"({rate/1e3:.0f}k client-epochs/s warm)")
    for name, p in res.policies.items():
        print(f"  {name:12s} mean {p.mean_latency_s*1e3:9.2f} ms  "
              f"offload {p.offload_frac:5.1%}  saturated {p.saturated_epochs}")
    print(f"adaptive beats every static: {res.adaptive_wins}")

    report = {
        "spec": spec.to_dict(),
        "mode": "exact",
        "device": args.device,
        "equilibrium": {
            "iterations": eq.iterations,
            "converged": eq.converged,
            "oscillation": eq.oscillation,
            "counts": eq.counts(),
            "rho_edges": eq.rho_edges.tolist(),
            "mean_latency_s": eq.mean_latency_s,
            "solve_s": eq_s,
        },
        "replay": {
            "client_epochs": res.client_epochs,
            "client_epochs_per_sec": rate,
            "adaptive_wins": res.adaptive_wins,
            "policies": {
                name: {
                    "mean_latency_s": p.mean_latency_s,
                    "offload_frac": p.offload_frac,
                    "saturated_epochs": p.saturated_epochs,
                    "switches": p.switches,
                }
                for name, p in res.policies.items()
            },
        },
    }

    rc = 0 if (eq.converged and res.adaptive_wins) else 1
    if args.cross_check:
        t0 = time.perf_counter()
        cc = cross_check_equilibrium(spec, eq, n=args.check_n, seed=args.seed,
                                     device=args.device)
        cc["elapsed_s"] = time.perf_counter() - t0
        report["cross_check"] = cc
        print(f"cross-check ({cc['elapsed_s']:.1f} s):")
        for g in cc["groups"]:
            print(f"  {g['target']:12s} n={g['n_clients']:3d} rho={g['rho']:.3f} "
                  f"analytic {g['analytic_s']*1e3:7.2f} ms vs sim "
                  f"{g['sim_mean_s']*1e3:7.2f} ms -> {g['mape_pct']:.2f}% MAPE")
        gated_max = cc["gated_max_mape_pct"]
        print(f"  gated max MAPE {gated_max:.2f}%"
              if gated_max is not None else "  no gated groups")
        if gated_max is not None and gated_max > 5.0:
            rc = 1

    _write_report(args.out, report, args)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cluster", type=Path, default=None,
                    help="spec JSON: ClusterSpec.to_dict(); default: the built-in "
                         "fleet sized by --clients")
    ap.add_argument("--meanfield", action="store_true",
                    help="mean-field mode (not ported yet: exits 2)")
    ap.add_argument("--clients", type=int, default=64,
                    help="fleet size for the built-in spec (default 64)")
    ap.add_argument("--duration", type=float, default=180.0,
                    help="trace duration in seconds (default 180)")
    ap.add_argument("--epoch-s", type=float, default=1.0,
                    help="decision epoch length (default 1.0)")
    ap.add_argument("--bw-drop", type=float, default=0.15,
                    help="bandwidth multiplier for the middle third of the "
                         "trace (default 0.15; 1.0 = constant conditions)")
    ap.add_argument("--trace", type=Path, default=None,
                    help="JSON trace spec of step breakpoints (see "
                         "load_trace_spec; overrides --duration/--epoch-s/"
                         "--bw-drop); malformed specs exit 2")
    ap.add_argument("--stagger", type=int, default=8,
                    help="decision cohorts (desynchronized control epochs; "
                         "default 8, 1 = fully synchronous)")
    ap.add_argument("--hysteresis", type=float, default=0.0,
                    help="relative-improvement switching threshold (default 0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-iter", type=int, default=None,
                    help="equilibrium best-response iteration cap (default 20)")
    ap.add_argument("--cross-check", action="store_true",
                    help="validate the equilibrium against the event-driven "
                         "simulators (slower)")
    ap.add_argument("--check-n", type=int, default=120_000,
                    help="simulated jobs per cross-check group (default 120000)")
    ap.add_argument("--device", default="cuda",
                    help="where the cluster runs (default: the CUDA card; 'cpu' to run here)")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the full report JSON here")
    args = ap.parse_args(argv)

    if args.meanfield:
        print(f"error: {MEANFIELD_NOT_PORTED}", file=sys.stderr)
        return 2
    try:
        ts = load_trace_spec(args.trace) if args.trace is not None else None
        return _run_exact(args, ts)
    except TraceSpecError as err:
        print(f"error: bad trace spec: {err}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
