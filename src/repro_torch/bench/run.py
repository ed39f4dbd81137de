"""Benchmark harness of the port: one registered runner per bench family
(the twin of the reference's ``benchmarks/run.py``).

One entrypoint executes every bench (or a ``--only`` subset), prints the
``name,us_per_call,derived`` CSV contract to stdout, and writes each family's
JSON artifact under ``--out``:

  * ``paper_figures`` -> BENCH_paper_figures.json (per-figure headline
    numbers; host numpy, no device)
  * ``fleet``         -> BENCH_fleet.json (scalar-vs-batched throughput;
                         the batched simulation is the Lindley kernel)
  * ``cluster``       -> BENCH_cluster.json (closed-loop client-epochs/s +
                         equilibrium iterations; the decision-scan kernel)
  * ``meanfield``     -> BENCH_meanfield.json (million-client diurnal-day
                         throughput + mean-field-vs-exact gated MAPE)
  * ``validate``      -> BENCH_validate.json (fidelity-gate cost + headline MAPE)
  * ``tail``          -> BENCH_tail.json (sojourn-quantile throughput +
                         asymptote-vs-Euler gap + station_pass speedup)
  * ``kernels``       -> BENCH_kernels.json (each hand-written kernel's time
                         per call + its max-abs error against the plain version)
  * ``measure``       -> BENCH_measure.json (engine tokens/s, harness
                         requests/s, fit wall time, measured-gate MAPE)
  * ``obs``           -> BENCH_obs.json (tracer-disabled overhead gate,
                         enabled-tracer tokens/s, audit rows/s + re-sum gate)
  * ``plan``          -> BENCH_plan.json (provisioning-solver wall time,
                         equilibrium solves vs grid size, plan picked)
  * ``roofline``      -> CSV rows from dry-run artifacts, when present

Every family but the figure suite and roofline runs on ``--device``
(default ``cuda``: the card; ``cpu`` to run here), and a run that selects
one of them raises where there is no card. Every BENCH_*.json gets a
``manifest`` block stamped in (``repro_torch.obs.run_manifest``: seed-free
provenance — git sha, config hash, package versions; no timestamps).

An unknown ``--only`` family is an error (exit 2, known families listed), so
a typo can never silently run nothing. The family list is not declared here:
``BENCHES`` derives from the port's one experiment registry
(``repro_torch.exp.spec``), so this CLI, ``repro_torch.launch.reproduce``
and the regression gate can never disagree about what exists.

Usage:
  PYTHONPATH=src python -m repro_torch.bench.run --out experiments/bench
  PYTHONPATH=src python -m repro_torch.bench.run --device cpu --only plan,validate --out DIR
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


def run_roofline(out_dir: Path) -> dict:
    # roofline table from the reports ``launch/roofline_run.py`` wrote, if present
    roof = Path("experiments/roofline")
    if roof.is_dir() and any(roof.glob("*.json")):
        from .roofline_report import print_roofline_rows

        print_roofline_rows(roof)
    return {}


def _family_runner(payload: str):
    """A ``fn(out_dir, device=None) -> report`` wrapper over a registry
    payload, resolved lazily so importing this module stays cheap (and so
    the registry's ``repro_torch.bench.run:*`` payloads don't import-cycle at
    module load). The device reaches only payloads that take one."""
    def run(out_dir: Path, device=None) -> dict:
        from repro_torch.exp.runner import call_payload, resolve_payload

        return call_payload(resolve_payload(payload), out_dir, seed=0, config={},
                            device=device)
    return run


def _benches() -> dict:
    from repro_torch.exp.spec import bench_family_specs

    return {family: _family_runner(spec.payload)
            for family, spec in bench_family_specs().items()}


#: family -> runner, derived from the ONE experiment registry
#: (``repro_torch.exp.spec``): a family added there is runnable here,
#: reproducible via ``repro_torch.launch.reproduce``, and checked for
#: registry completeness by tests/test_torch_exp.py
BENCHES = _benches()


def stamp_manifests(out_dir: Path) -> None:
    """Attach the run-provenance manifest to every BENCH_*.json artifact."""
    from repro_torch.obs import run_manifest

    manifest = run_manifest()
    for path in sorted(out_dir.glob("BENCH_*.json")):
        doc = json.loads(path.read_text())
        doc["manifest"] = manifest
        path.write_text(json.dumps(doc, indent=2))


def _needs_device(names) -> bool:
    from repro_torch.exp.spec import bench_family_specs
    from repro_torch.exp.runner import resolve_payload, takes_device

    specs = bench_family_specs()
    return any(takes_device(resolve_payload(specs[n].payload)) for n in names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    # families are validated by hand (not argparse choices) so an unknown
    # name exits nonzero with the registry listed, in registry order
    ap.add_argument("--only", action="append", metavar="FAMILY",
                    help="run only these bench families (repeatable and/or "
                         "comma-separated; default all; "
                         f"known: {', '.join(BENCHES)})")
    ap.add_argument("--out", type=Path, default=Path("experiments/bench"),
                    help="directory for JSON artifacts")
    ap.add_argument("--device", default="cuda",
                    help="where the families run (default: the CUDA card; 'cpu' to run "
                         "here); the figure suite and roofline are host code")
    args = ap.parse_args(argv)

    # accept --only a,b alongside repeated --only a --only b; empty segments
    # from stray commas are dropped so "a,,b" and "a," don't become families
    selected = [n.strip() for item in (args.only or [])
                for n in item.split(",") if n.strip()]
    if args.only and not selected:
        print(f"error: --only given but no family names parsed "
              f"(known: {', '.join(BENCHES)})", file=sys.stderr)
        return 2
    unknown = [n for n in selected if n not in BENCHES]
    if unknown:
        print(f"error: unknown bench famil{'y' if len(unknown) == 1 else 'ies'} "
              f"{', '.join(repr(n) for n in unknown)} "
              f"(known: {', '.join(BENCHES)})", file=sys.stderr)
        return 2

    names = selected or list(BENCHES)
    device = None
    if _needs_device(names):
        from repro_torch.device import resolve_device

        device = resolve_device(args.device)  # no card and no --device cpu: raises
    args.out.mkdir(parents=True, exist_ok=True)
    print("name,us_per_call,derived")
    for name in names:
        BENCHES[name](args.out, device=device)
    stamp_manifests(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
