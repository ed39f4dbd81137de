"""Fleet-sizing CLI: minimum deployment meeting a p99 SLO for N clients, on
the card.

Inverts the closed-loop model: instead of predicting latency for a given
fleet, search the smallest ``(n_edges, accelerator tier, bandwidth)`` whose
decision equilibrium keeps every client's p99 within budget.  Feasibility of
each candidate is one :func:`repro_torch.fleet.solve_equilibrium` on
``--device`` (default: the CUDA card) with clients best-responding on exact
Euler-inverted quantiles; the search is monotone bisection per axis (see
:mod:`repro_torch.plan.provision`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.provision --clients 48 --slo-ms 120
  PYTHONPATH=src python -m repro_torch.launch.provision --space space.json \
      --clients 64 --slo-ms 150 --check-minimal --out PLAN.json
  PYTHONPATH=src python -m repro_torch.launch.provision --device cpu
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from repro_torch.core.latency import NetworkPath, Tier, Workload
from repro_torch.core.scenario import EdgeSpec, Scenario
from repro_torch.fleet import solve_equilibrium
from repro_torch.obs import run_manifest
from repro_torch.plan import ProvisionSpace, provision

__all__ = ["default_space", "main"]


def default_space() -> ProvisionSpace:
    """The README's worked example: CPU-bound clients (80 ms on-device, so a
    120 ms p99 budget forces offloading) choosing over a three-rung
    accelerator ladder and a 5..40 Mbit shared uplink."""
    base = Scenario(
        workload=Workload(arrival_rate=4.0, req_bytes=30_000, res_bytes=1_000,
                          name="inceptionv4"),
        device=Tier("cpu-only", 0.08),
        edges=(EdgeSpec(Tier("edge", 0.02)),),
        network=NetworkPath(20e6 / 8),
        name="provision-default-base",
    )
    return ProvisionSpace(
        base=base,
        tiers=(Tier("t4", 0.020), Tier("a2", 0.012), Tier("a100", 0.006)),
        max_edges=8,
        bandwidths_Bps=(5e6 / 8, 10e6 / 8, 20e6 / 8, 40e6 / 8),
        name="provision-default",
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--space", type=Path, default=None,
                    help="ProvisionSpace.to_dict() JSON (default: built-in "
                         "3-tier ladder, up to 8 edges, 5..40 Mbit)")
    ap.add_argument("--clients", type=int, default=48,
                    help="fleet size N to provision for (default 48)")
    ap.add_argument("--slo-ms", type=float, default=120.0,
                    help="p-quantile latency budget in ms (default 120)")
    ap.add_argument("--q", type=float, default=0.99,
                    help="SLO quantile (default 0.99)")
    ap.add_argument("--tail-method", default="euler",
                    choices=("euler", "asymptote"),
                    help="quantile engine for feasibility (default euler)")
    ap.add_argument("--max-iter", type=int, default=20,
                    help="equilibrium best-response iteration cap (default 20)")
    ap.add_argument("--check-minimal", action="store_true",
                    help="re-probe the three single-resource decrements and "
                         "assert each violates the SLO (slower)")
    ap.add_argument("--device", default="cuda",
                    help="where the equilibria are solved (default: the CUDA card; "
                         "'cpu' to run here)")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the plan JSON here")
    args = ap.parse_args(argv)

    if args.space is not None:
        space = ProvisionSpace.from_dict(json.loads(args.space.read_text()))
    else:
        space = default_space()
    slo_s = args.slo_ms / 1e3

    print(f"{space.name}: N={args.clients} clients, p{args.q * 100:g} <= "
          f"{args.slo_ms:g} ms ({args.tail_method} tails)")
    print(f"  search space: 1..{space.max_edges} edges x "
          f"{len(space.tiers)} tiers ({', '.join(t.name for t in space.tiers)}) x "
          f"{len(space.bandwidths_Bps)} bandwidths "
          f"({', '.join(f'{b * 8 / 1e6:g}' for b in space.bandwidths_Bps)} Mbit)")

    t0 = time.perf_counter()
    plan = provision(space, args.clients, slo_s, q=args.q,
                     tail_method=args.tail_method, max_iter=args.max_iter,
                     device=args.device)
    solve_s = time.perf_counter() - t0

    if plan is None:
        grid = space.max_edges * len(space.tiers) * len(space.bandwidths_Bps)
        print(f"INFEASIBLE: even {space.max_edges}x {space.tiers[-1].name} at "
              f"{space.bandwidths_Bps[-1] * 8 / 1e6:g} Mbit misses the budget "
              f"({solve_s:.1f} s)")
        print(f"  (searched by bisection; exhaustive grid would be {grid} "
              "equilibrium solves)")
        return 1

    print(f"plan ({solve_s:.1f} s, {plan.evaluations} equilibrium solves):")
    print(f"  {plan.n_edges} x {plan.tier.name} "
          f"(s_edge {plan.tier.service_time_s * 1e3:g} ms) @ "
          f"{plan.bandwidth_Bps * 8 / 1e6:g} Mbit")
    print(f"  worst-client p{plan.q * 100:g} {plan.max_latency_s * 1e3:.1f} ms "
          f"(slack {plan.slack_s * 1e3:.1f} ms), "
          f"mean {plan.mean_latency_s * 1e3:.1f} ms")
    for tgt, cnt in plan.counts.items():
        if cnt:
            print(f"  {tgt:12s} {cnt:4d} clients")
    print("  edge rho: " + "  ".join(f"{r:.3f}" for r in plan.rho_edges))

    rc = 0
    if args.check_minimal:
        def infeasible(n_edges, ti, bi, label):
            spec = space.cluster_spec(n_edges, ti, bi, args.clients)
            eq = solve_equilibrium(spec, max_iter=args.max_iter,
                                   slo_quantile=args.q,
                                   tail_method=plan.tail_method, device=args.device)
            ok = not eq.meets_slo(slo_s)
            print(f"  {label:24s} {'violates SLO (minimal)' if ok else 'STILL FEASIBLE'}")
            return ok

        print("minimality probes:")
        probes = []
        if plan.n_edges > 1:
            probes.append(infeasible(plan.n_edges - 1, len(space.tiers) - 1,
                                     len(space.bandwidths_Bps) - 1,
                                     f"{plan.n_edges - 1} edges (best rest)"))
        if plan.tier_index > 0:
            probes.append(infeasible(plan.n_edges, plan.tier_index - 1,
                                     len(space.bandwidths_Bps) - 1,
                                     f"tier {space.tiers[plan.tier_index - 1].name}"))
        if plan.bandwidth_index > 0:
            bw = space.bandwidths_Bps[plan.bandwidth_index - 1]
            probes.append(infeasible(plan.n_edges, plan.tier_index,
                                     plan.bandwidth_index - 1,
                                     f"{bw * 8 / 1e6:g} Mbit"))
        if not probes:
            print("  plan is the cheapest corner of the space; nothing to probe")
        elif not all(probes):
            rc = 1

    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        report = {"space": space.to_dict(), "plan": plan.to_dict(),
                  "solve_s": solve_s, "device": args.device,
                  "manifest": run_manifest(config={
                      "clients": args.clients, "slo_ms": args.slo_ms,
                      "q": args.q})}
        args.out.write_text(json.dumps(report, indent=2))
        print(f"wrote {args.out}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
