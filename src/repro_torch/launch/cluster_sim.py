"""Closed-loop cluster CLI: N adaptive clients sharing E edge servers, on
the card.

Runs the §6-style closed-loop questions from one command, in two modes:

  * **exact** (default) — per-client state. Solves the fixed point of the
    decision->load map under nominal conditions (who lands where, per-edge
    utilization, best-response iterations), replays the fleet through a
    bandwidth trace with the estimator-lagged adaptive manager per client
    scored against every all-clients static policy, and with
    ``--cross-check`` validates the closed-loop analytic means against the
    event-driven simulators;
  * **mean-field** (``--meanfield``) — class-aggregated offload fractions,
    O(C * E^2) per epoch regardless of N. Solves the damped Wardrop fixed
    point, prices every all-static fleet at the equilibrium's congestion,
    replays the fraction state through the trace, and with ``--cross-check``
    gates the mean-field solver against the exact one on a count-scaled copy.

Everything runs on ``--device`` (default: the CUDA card), the exact decide
steps through the hand-written decision-scan kernel.

Conditions come from the built-in bandwidth-step walk (``--duration`` /
``--bw-drop``) or from a ``--trace`` JSON spec of step breakpoints; a
malformed trace spec is rejected loudly with exit code 2 before any solve.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.cluster_sim --clients 64 \
      --duration 180 --bw-drop 0.15 --out experiments/CLUSTER.json
  PYTHONPATH=src python -m repro_torch.launch.cluster_sim --cluster spec.json \
      --cross-check
  PYTHONPATH=src python -m repro_torch.launch.cluster_sim --meanfield \
      --clients 1000000 --out experiments/MF.json
  PYTHONPATH=src python -m repro_torch.launch.cluster_sim --device cpu --clients 16
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

from repro_torch.core.latency import NetworkPath, ServiceModel, Tier, Workload
from repro_torch.core.scenario import (
    ClientClass,
    ClusterSpec,
    EdgeSpec,
    MeanFieldSpec,
    Scenario,
)
from repro_torch.fleet import (
    Trace,
    TraceBatch,
    cross_check_equilibrium,
    cross_check_meanfield,
    epoch_times,
    simulate_cluster,
    simulate_meanfield,
    solve_equilibrium,
    solve_meanfield_equilibrium,
    static_fractions,
    step_signal,
)
from repro_torch.obs import run_manifest

__all__ = [
    "TraceSpecError",
    "default_cluster",
    "default_meanfield",
    "load_trace_spec",
    "trace_signals",
    "main",
]

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


def default_meanfield(n_clients: int = 100_000) -> MeanFieldSpec:
    """The built-in mean-field fleet: three bandwidth/rate classes over
    three pooled accelerator tiers on a 20 Mbit path.

    Results are fire-and-forget (``res_bytes=0``): the model prices the
    return path as one queue at the edge's AGGREGATE rate over the client's
    bandwidth, which caps any pooled edge at bandwidth/res_bytes regardless
    of accelerator count — fire-and-forget is the regime where pooling at
    this scale is meaningful.

    Pool sizes scale with ``n_clients`` (the mean-field limit is scale-free,
    so per-edge utilization at the fixed point is size-invariant above the
    25k-client provisioning floor): the reference point is 128/256/256
    accelerators per pool at 100k clients."""
    if n_clients < 4:
        raise ValueError(f"need at least 4 clients for the 3-class default "
                         f"mix, got {n_clients}")
    pool = max(n_clients, 25_000) / 100_000.0
    base = Scenario(
        workload=Workload(arrival_rate=0.05, req_bytes=30_000, res_bytes=0,
                          name="mf-cli"),
        device=Tier("orin", 0.045),
        edges=(
            EdgeSpec(Tier("a100-pool", 0.008, parallelism_k=128.0 * pool)),
            EdgeSpec(Tier("a2-pool", 0.028, parallelism_k=256.0 * pool)),
            EdgeSpec(Tier("t4-pool", 0.020, parallelism_k=256.0 * pool,
                          service_model=ServiceModel.EXPONENTIAL)),
        ),
        network=NetworkPath(20e6 / 8),
        name="meanfield-default-base",
    )
    steady, light = n_clients // 2, n_clients // 4
    classes = (
        ClientClass(n_clients=steady, arrival_scale=1.0, name="steady"),
        ClientClass(n_clients=light, arrival_scale=0.5, name="light"),
        ClientClass(n_clients=n_clients - steady - light, arrival_scale=2.0,
                    bandwidth_scale=0.5, name="heavy"),
    )
    return MeanFieldSpec(base=base, classes=classes,
                         name=f"meanfield-{n_clients}x{len(base.edges)}")


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


# -- mean-field mode ----------------------------------------------------------


def _gate_sized(spec: MeanFieldSpec, cap: int = 256) -> MeanFieldSpec:
    """Count-scaled copy for the exact cross-check: solver agreement is
    checked on at most ``cap`` clients with the same class mix; a spec
    already at or under the cap is used as-is."""
    if spec.n_total <= cap:
        return spec
    k = spec.n_total / cap
    classes = tuple(replace(c, n_clients=max(1, round(c.n_clients / k)))
                    for c in spec.classes)
    return MeanFieldSpec(base=spec.base, classes=classes, name=f"{spec.name}-gate{cap}")


def _run_meanfield(args, ts: dict | None) -> int:
    if args.cluster is not None:
        spec = MeanFieldSpec.from_dict(json.loads(args.cluster.read_text()))
    else:
        spec = default_meanfield(args.clients)
    c_n, e_n = spec.n_classes, spec.n_edges
    bw0 = float(np.asarray(spec.base.network.bandwidth_Bps))
    if ts is None:
        ts = _default_trace_spec(args, bw0)
    times, bw, lam, exo = trace_signals(ts, e_n, spec.base.workload.arrival_rate)
    # trace columns are per CLASS: the base signals with each class's
    # bandwidth/arrival scale folded in
    traces = TraceBatch(
        times=times,
        bandwidth_Bps=bw[:, None] * np.array([c.bandwidth_scale for c in spec.classes]),
        arrival_rate=lam[:, None] * np.array([c.arrival_scale for c in spec.classes]),
        edge_bg_rate=exo,
    )

    # -- Wardrop fixed point under nominal conditions -------------------------
    t0 = time.perf_counter()
    eq = solve_meanfield_equilibrium(spec, max_iter=args.max_iter or 500, device=args.device)
    eq_s = time.perf_counter() - t0
    print(f"{spec.name}: {spec.n_total} clients in {c_n} classes x {e_n} edges (mean-field)")
    print(f"equilibrium: {'converged' if eq.converged else 'NOT CONVERGED'} in "
          f"{eq.iterations} iterations ({eq_s*1e3:.0f} ms, regret {eq.regret_pct:.2f}%)")
    for tgt, cnt in eq.expected_counts().items():
        if cnt > 0.5:
            print(f"  {tgt:12s} {cnt:12.1f} expected clients")
    print("  edge rho: " + "  ".join(f"{r:.3f}" for r in eq.rho_edges))
    print(f"  mean latency {eq.mean_latency_s*1e3:.2f} ms")

    # every all-static fleet priced at the fixed point's congestion: the
    # count-weighted staying cost of the one-hot fraction state. At a Wardrop
    # equilibrium every class sits on its cheapest target, so the adaptive
    # mean must undercut every static price — a self-consistency gate, not a
    # counterfactual replay (a static fleet would also induce different load).
    w = spec.class_counts() / spec.n_total
    prices = {}
    for pname in ("on_device",) + tuple(f"edge[{j}]" for j in range(e_n)):
        f = static_fractions(pname, c_n, e_n)
        prices[pname] = float(np.sum(w * np.sum(f * eq.class_latency_s, axis=1)))
    adaptive_wins = bool(all(eq.mean_latency_s <= p * (1 + 1e-9) for p in prices.values()))
    print("static deviation prices at equilibrium congestion:")
    for pname, p in prices.items():
        print(f"  {pname:12s} {p*1e3:9.2f} ms")
    print(f"adaptive undercuts every static price: {adaptive_wins}")

    # -- mean-field replay on the trace (a warm second pass is timed) ---------
    res = simulate_meanfield(spec, traces, switch_fraction=1.0 / args.stagger, device=args.device)
    t0 = time.perf_counter()
    res = simulate_meanfield(spec, traces, switch_fraction=1.0 / args.stagger, device=args.device)
    rate = res.client_epochs / (time.perf_counter() - t0)
    off = res.offload_frac
    print(f"mean-field replay: {res.client_epochs} client-epochs ({rate:.3e} client-epochs/s warm)")
    print(f"  mean latency {res.mean_latency_s*1e3:9.2f} ms  "
          f"offload {off.min():5.1%}..{off.max():5.1%}  "
          f"saturated class-epochs {res.saturated_epochs}")

    report = {
        "spec": spec.to_dict(),
        "mode": "meanfield",
        "device": args.device,
        "equilibrium": {
            "iterations": eq.iterations,
            "converged": eq.converged,
            "regret_pct": eq.regret_pct,
            "expected_counts": eq.expected_counts(),
            "rho_edges": eq.rho_edges.tolist(),
            "mean_latency_s": eq.mean_latency_s,
            "offload_frac": eq.offload_frac,
            "solve_s": eq_s,
        },
        "static_prices_s": prices,
        "adaptive_wins": adaptive_wins,
        "replay": {
            "epochs": res.n_epochs,
            "client_epochs": res.client_epochs,
            "client_epochs_per_sec": rate,
            "mean_latency_s": res.mean_latency_s,
            "offload_frac_min": float(off.min()),
            "offload_frac_max": float(off.max()),
            "saturated_epochs": res.saturated_epochs,
            "peak_rho_edges": res.rho_edges.max(axis=0).tolist(),
        },
    }

    rc = 0 if (eq.converged and adaptive_wins) else 1
    if args.cross_check:
        small = _gate_sized(spec)
        t0 = time.perf_counter()
        cc = cross_check_meanfield(small, device=args.device)
        cc_s = time.perf_counter() - t0
        gated = cc["gated_max_mape_pct"]
        conv = bool(cc["meanfield_converged"] and cc["exact_converged"])
        print(f"cross-check vs exact solver on {small.n_total} clients ({cc_s:.1f} s): "
              + (f"gated max MAPE {gated:.2f}%" if gated is not None else "no gated rows")
              + ("" if conv else "  [a solver did not converge]"))
        report["cross_check"] = {
            "spec": small.name,
            "n_total": small.n_total,
            "elapsed_s": cc_s,
            "gated_max_mape_pct": gated,
            "gated_mean_mape_pct": cc["gated_mean_mape_pct"],
            "converged": conv,
        }
        if not conv or (gated is not None and gated > 5.0):
            rc = 1

    _write_report(args.out, report, args)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cluster", type=Path, default=None,
                    help="spec JSON: ClusterSpec.to_dict() (exact mode) or "
                         "MeanFieldSpec.to_dict() (--meanfield); default: the built-in "
                         "fleet sized by --clients")
    ap.add_argument("--meanfield", action="store_true",
                    help="mean-field mode: class-aggregated offload fractions, "
                         "O(classes x edges^2) per epoch regardless of fleet size")
    ap.add_argument("--clients", type=int, default=64,
                    help="fleet size for the built-in spec (default 64 exact; try "
                         "100000..1000000 with --meanfield — the built-in pools scale "
                         "with the population)")
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
                         "default 8, 1 = fully synchronous; in mean-field mode "
                         "1/stagger of each class re-decides per epoch)")
    ap.add_argument("--hysteresis", type=float, default=0.0,
                    help="relative-improvement switching threshold "
                         "(default 0; exact mode only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-iter", type=int, default=None,
                    help="equilibrium best-response iteration cap (default 20 exact; "
                         "500 for the mean-field solver's damped fixed point)")
    ap.add_argument("--cross-check", action="store_true",
                    help="exact mode: validate the equilibrium against the "
                         "event-driven simulators (slower); mean-field mode: gate "
                         "the mean-field solver against the exact one on a "
                         "count-scaled copy")
    ap.add_argument("--check-n", type=int, default=120_000,
                    help="simulated jobs per cross-check group (default 120000; "
                         "exact mode only)")
    ap.add_argument("--device", default="cuda",
                    help="where the cluster runs (default: the CUDA card; 'cpu' to run here)")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the full report JSON here")
    args = ap.parse_args(argv)

    try:
        ts = load_trace_spec(args.trace) if args.trace is not None else None
        if args.meanfield:
            return _run_meanfield(args, ts)
        return _run_exact(args, ts)
    except TraceSpecError as err:
        print(f"error: bad trace spec: {err}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
