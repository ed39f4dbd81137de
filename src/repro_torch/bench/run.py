"""Benchmark harness of the port: one runner per bench family.

One entrypoint executes every bench (or a ``--only`` subset), prints the
``name,us_per_call,derived`` CSV contract to stdout, and writes each family's
JSON artifact under ``--out``:

  * ``paper_figures`` -> BENCH_paper_figures.json (per-figure headline
    numbers; host numpy, no device)

Every BENCH_*.json gets a ``manifest`` block stamped in
(``repro_torch.obs.run_manifest``: seed-free provenance — git sha, config
hash, package versions; no timestamps).

An unknown ``--only`` family is an error (exit 2, known families listed), so
a typo can never silently run nothing. The reference's other families, its
registry (``exp/spec.py``) and ``launch/reproduce.py`` have no twin yet.

Usage:
  PYTHONPATH=src python -m repro_torch.bench.run --only paper_figures --out DIR
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def run_paper_figures(out_dir: Path) -> dict:
    from repro_torch.obs import run_manifest

    from . import paper_figures as F

    report = {
        "fig2_mape_pct": F.fig2_workload_characteristics(),
        "fig3_mape_pct": F.fig3_complex_models(),
        "fig4_crossovers_mbps": F.fig4_bandwidth_crossovers(),
        "fig5a_split_mape_pct": F.fig5a_split_processing(),
        "fig5b_offload_wins": F.fig5b_request_rate(),
        "fig5c_crossover_m": F.fig5c_multitenancy(),
        "fig6_strategies": F.fig6_network_adaptation(),
        "fig7_targets": F.fig7_multitenant_adaptation(),
        "model_accuracy": F.model_accuracy_suite(),
    }
    doc = {**report, "manifest": run_manifest()}
    (out_dir / "BENCH_paper_figures.json").write_text(json.dumps(doc, indent=2))
    return report


#: family -> runner
BENCHES = {"paper_figures": run_paper_figures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    # families are validated by hand (not argparse choices) so an unknown
    # name exits nonzero with the known ones listed
    ap.add_argument("--only", action="append", metavar="FAMILY",
                    help="run only these bench families (repeatable and/or "
                         "comma-separated; default all; "
                         f"known: {', '.join(sorted(BENCHES))})")
    ap.add_argument("--out", type=Path, default=Path("experiments/bench"),
                    help="directory for JSON artifacts")
    args = ap.parse_args(argv)

    # accept --only a,b alongside repeated --only a --only b; empty segments
    # from stray commas are dropped so "a,,b" and "a," don't become families
    selected = [n.strip() for item in (args.only or [])
                for n in item.split(",") if n.strip()]
    if args.only and not selected:
        print(f"error: --only given but no family names parsed "
              f"(known: {', '.join(sorted(BENCHES))})", file=sys.stderr)
        return 2
    unknown = [n for n in selected if n not in BENCHES]
    if unknown:
        print(f"error: unknown bench famil{'y' if len(unknown) == 1 else 'ies'} "
              f"{', '.join(repr(n) for n in unknown)} "
              f"(known: {', '.join(sorted(BENCHES))})", file=sys.stderr)
        return 2

    names = selected or list(BENCHES)
    args.out.mkdir(parents=True, exist_ok=True)
    print("name,us_per_call,derived")
    for name in names:
        BENCHES[name](args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
