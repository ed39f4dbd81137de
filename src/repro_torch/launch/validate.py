"""Model-validation CLI: differential fidelity report over the golden corpus,
on the card.

Pushes every golden-corpus scenario through all four evaluation paths
(scalar/vectorized closed forms, scalar/batched simulators) and writes
``VALIDATION.json`` — the repo's analogue of the paper's observed-vs-predicted
latency table (§4.3: 2.2% mean MAPE, 91.5% within ±5%). Exit status is the
gate: nonzero when any of the five sub-gates fail — scalar-vs-vectorized
agreement (means and tail quantiles), the golden pins, the
analytic-vs-simulated MAPE budget, the tail-percentile budget, or the
mean-field-vs-exact equilibrium solver agreement.

The gate itself lives in ``repro_torch.exp.payloads.run_validate``; this CLI
is a thin shim over it. The batched paths run on ``--device`` (default: the
CUDA card): the batched closed forms and tails, the Lindley-scan simulator,
and the exact equilibria of the mean-field gate through the decision scan.
The report lands under ``results/`` by default. The port reads the pinned
corpus fixture and never writes it, so the reference's ``--regenerate`` has
no twin here.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.validate                  # full gate
  PYTHONPATH=src python -m repro_torch.launch.validate --smoke          # tier-1 subset
  PYTHONPATH=src python -m repro_torch.launch.validate --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.validate --out results/VALIDATION.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.exp.payloads import run_validate
from repro_torch.validate import (
    DEFAULT_MAPE_BUDGET_PCT,
    DEFAULT_SEED,
    DEFAULT_TAIL_BUDGET_PCT,
    DEFAULT_TAIL_PCT,
)

__all__ = ["main"]


def _print_report(rep, elapsed_s: float) -> None:
    d = rep.to_dict()
    vec = d["scalar_vs_vec"]
    gold = d["golden"]
    gate = d["mape_gate"]
    print(f"validated {d['config']['n_entries']} scenarios in {elapsed_s:.1f}s "
          f"on {d['config']['device']}")
    print(f"  scalar vs vectorized analytic: max rel err {vec['max_rel_err']:.2e} "
          f"(tol {vec['tol']:.0e}) -> {'PASS' if vec['passed'] else 'FAIL'}")
    if gold["max_rel_err"] is not None:
        print(f"  golden totals pin:             max rel err {gold['max_rel_err']:.2e} "
              f"(tol {gold['tol']:.0e}) -> {'PASS' if gold['passed'] else 'FAIL'}")
    if gate["n"] == 0:
        print("  analytic vs simulated (gated): not exercised (no simulated "
              "gated entries)")
    else:
        print(f"  analytic vs simulated (gated): mean MAPE {gate['mean_pct']:.2f}% "
              f"over {gate['n']} scenarios (budget {gate['budget_pct']:.1f}%, "
              f"max {gate['max_pct']:.2f}%, {gate['within_5_frac']:.0%} within ±5%) "
              f"-> {'PASS' if gate['passed'] else 'FAIL'}")
    tvec = d["scalar_vs_vec_tail"]
    print(f"  scalar vs vectorized tail:     max rel err {tvec['max_rel_err']:.2e} "
          f"(tol {tvec['tol']:.0e}) -> {'PASS' if tvec['passed'] else 'FAIL'}")
    ev = d["tail_euler_vec"]
    if ev["max_rel_err"] is None:
        print("  batched exact euler inversion: not exercised (no entries at "
              f"rho <= {ev['rho_max']:.2f})")
    else:
        print(f"  batched exact euler inversion: max rel err {ev['max_rel_err']:.2e} "
              f"over {ev['n_entries']} entries at rho <= {ev['rho_max']:.2f} "
              f"(tol {ev['tol']:.0e}) -> {'PASS' if ev['passed'] else 'FAIL'}")
    mf = d["meanfield_gate"]
    if mf is None:
        print("  mean-field vs exact solver:    skipped")
    elif not mf["converged"]:
        print("  mean-field vs exact solver:    FAIL (a solver did not converge)")
    else:
        print(f"  mean-field vs exact solver:    max gated MAPE "
              f"{mf['gated_max_mape_pct']:.2f}% over {mf['n_specs']} fleets "
              f"(budget {mf['budget_pct']:.1f}%) "
              f"-> {'PASS' if mf['passed'] else 'FAIL'}")
    tg = d["tail_gate"]
    if tg["n"] == 0:
        print(f"  analytic p{tg['tail_pct']:.0f} vs simulated:     not exercised "
              "(no tail-gated entries)")
    else:
        print(f"  analytic p{tg['tail_pct']:.0f} vs simulated:     mean MAPE "
              f"{tg['mean_pct']:.2f}% over {tg['n']} scenarios "
              f"(budget {tg['budget_pct']:.1f}%, max {tg['max_pct']:.2f}%) "
              f"-> {'PASS' if tg['passed'] else 'FAIL'}")
    print("  per-band MAPE (all simulated entries):")
    for band, s in d["bands"].items():
        print(f"    {band:8s} n={s['n']:2d} mean {s['mean_pct']:6.2f}%  "
              f"max {s['max_pct']:6.2f}%  ±5% {s['within_5_frac']:.0%}")
    print("  per-regime MAPE:")
    for regime, s in d["regimes"].items():
        print(f"    {regime:22s} n={s['n']:2d} mean {s['mean_pct']:6.2f}%  "
              f"max {s['max_pct']:6.2f}%")
    if d["sim_cross"]:
        print(f"  scalar vs batched simulator:   mean MAPE "
              f"{d['sim_cross']['mean_mape_pct']:.2f}% over "
              f"{int(d['sim_cross']['n_entries'])} entries")
    print(f"overall: {'PASS' if rep.passed else 'FAIL'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--corpus", type=Path, default=None,
                    help="corpus fixture JSON (default: tests/golden/corpus_v1.json, "
                         "regenerated in-memory when missing)")
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED,
                    help="simulation seed")
    ap.add_argument("--smoke", action="store_true",
                    help="fast tier-1 subset with short simulations")
    ap.add_argument("--n", type=int, default=None,
                    help="base simulated jobs per scenario (default 120000; 20000 with --smoke)")
    ap.add_argument("--max-n-factor", type=float, default=None,
                    help="cap on the near-saturation n multiplier (default 6; 2 with --smoke)")
    ap.add_argument("--budget", type=float, default=DEFAULT_MAPE_BUDGET_PCT,
                    help="MAPE gate budget in percent (default 5.0)")
    ap.add_argument("--tail-pct", type=float, default=DEFAULT_TAIL_PCT,
                    help="latency percentile for the tail gate (default 99)")
    ap.add_argument("--tail-budget", type=float, default=DEFAULT_TAIL_BUDGET_PCT,
                    help="tail-percentile gate budget in percent (default 10.0)")
    ap.add_argument("--bootstrap", type=int, default=200,
                    help="bootstrap replicates per simulated mean")
    ap.add_argument("--no-sim", action="store_true",
                    help="skip simulation (analytic agreement + golden pins only)")
    ap.add_argument("--device", default="cuda",
                    help="where the batched paths run (default: the CUDA card; "
                         "'cpu' to run here)")
    ap.add_argument("--out", type=Path, default=Path("results/VALIDATION.json"),
                    help="fidelity report path (default results/VALIDATION.json)")
    args = ap.parse_args(argv)

    rep, d = run_validate(
        seed=args.seed,
        smoke=args.smoke,
        corpus=args.corpus,
        base_n=args.n,
        max_n_factor=args.max_n_factor,
        budget_pct=args.budget,
        tail_pct=args.tail_pct,
        tail_budget_pct=args.tail_budget,
        bootstrap=args.bootstrap,
        simulate=not args.no_sim,
        device=args.device,
    )
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(d, indent=2))
    _print_report(rep, d["corpus"]["elapsed_s"])
    print(f"wrote {args.out}")
    return 0 if rep.passed else 1


if __name__ == "__main__":
    raise SystemExit(main())
