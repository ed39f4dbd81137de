"""One-command reproduction of every artifact the port knows how to make
(the twin of the reference's ``launch/reproduce.py``).

Replays the port's experiment registry (``repro_torch.exp.spec``) through the
manifest runner, on ``--device`` (default ``cuda``: the card; ``cpu`` to run
here): every bench family, validate regime, the measured smoke profile, the
closed-loop cluster replay, and the paper figures, each into an isolated
``results/<exp-id>/<run-id>/`` directory (provenance manifest + metrics with
cross-seed bootstrap CIs + summary). Completed runs are skipped on rerun —
an immediate second ``--all`` is a no-op — and ``REPRODUCTION.md`` compares
the fresh headline numbers against the port's committed baselines
(``src/repro_torch/bench/baselines``). Exit status is the gate: 0 when every
gate held, 1 when any experiment's own gate fails, any run errors, or any
portable headline regresses beyond tolerance, 2 on a bad selection.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.reproduce --all --seeds 3
  PYTHONPATH=src python -m repro_torch.launch.reproduce --only validate-smoke,bench-kernels
  PYTHONPATH=src python -m repro_torch.launch.reproduce --only bench-plan --device cpu
  PYTHONPATH=src python -m repro_torch.launch.reproduce --list
  PYTHONPATH=src python -m repro_torch.launch.reproduce --diff results_a results_b
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.bench.check_regression import (
    HEADLINES,
    compare,
    default_baseline_dir,
    manifest_notes,
)
from repro_torch.exp.runner import device_key, diff_results, run_experiment
from repro_torch.exp.spec import ExperimentError, registry
from repro_torch.obs import run_manifest

__all__ = ["main"]

#: the paper's observed-vs-predicted headline (§4.3) our validate regimes
#: are the analogue of
PAPER_MAPE_PCT = 2.2


def _parse_only(items: list[str] | None) -> list[str]:
    return [n.strip() for item in (items or [])
            for n in item.split(",") if n.strip()]


def _list_registry(reg) -> None:
    width = max(len(e) for e in reg)
    for spec in reg.values():
        seeds = "seed-sensitive" if spec.seed_sensitive else "pinned seeds"
        print(f"{spec.exp_id:{width}s}  {spec.kind:16s} {seeds:14s} "
              f"{spec.description.split(chr(10))[0]}")


def _headline_rows(results, results_root: Path, baselines: Path | None,
                   machine_matched: bool):
    """(rows, gated_regressions, notes) vs committed baselines, restricted to
    the headline families this invocation actually produced. Headline
    comparison is skipped (empty) when nothing produced has headlines."""
    families = sorted({out for r in results if not r.get("error")
                       for out in r["spec"].outputs if out in HEADLINES})
    if not families:
        return [], 0, []
    base = default_baseline_dir() if baselines is None else baselines
    rows, regressions = compare(results_root, base,
                                machine_matched=machine_matched,
                                families=families)
    notes = manifest_notes(results_root, base, families=families)
    return rows, regressions, notes


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _report_md(results, rows, regressions, notes, results_root: Path,
               where: dict) -> str:
    prov = run_manifest()
    git = prov.get("git", {})
    pkgs = ", ".join(f"{k} {v}" for k, v in prov.get("packages", {}).items())
    device = where["device"] + (f" ({where['card']})" if "card" in where else "")
    lines = [
        "# Reproduction report",
        "",
        "Regenerated by `python -m repro_torch.launch.reproduce`; every artifact",
        f"lives under `{results_root}/<exp-id>/<run-id>/` with its manifest,",
        "metrics (cross-seed bootstrap CIs), and summary.",
        "",
        f"- git: `{git.get('sha')}` (dirty: {git.get('dirty')})",
        f"- python: {prov.get('python')} on {prov.get('platform')}",
        f"- packages: {pkgs}",
        f"- device: {device}",
        "",
        "## Experiments",
        "",
        "| experiment | kind | seeds | status | verdict |",
        "|---|---|---|---|---|",
    ]
    for r in results:
        spec = r["spec"]
        if r.get("error"):
            lines.append(f"| `{spec.exp_id}` | {spec.kind} | - | error | "
                         f"FAIL ({r['error']}) |")
            continue
        res = r["result"]
        status = "skipped (complete)" if res.skipped else "ran"
        verdict = "PASS" if res.passed else "FAIL"
        lines.append(f"| `{spec.exp_id}` | {spec.kind} | {list(res.seeds)} | "
                     f"{status} | {verdict} |")
    lines.append("")

    mape = _validate_headline(results)
    if mape is not None:
        lines += [
            "## Paper headline",
            "",
            f"The paper reports {PAPER_MAPE_PCT}% mean MAPE between modeled "
            "and observed latencies (§4.3); this run's differential gate "
            f"measured **{mape:.2f}%** mean MAPE on the gated corpus "
            "(budget 5.0%).",
            "",
        ]

    if rows:
        lines += [
            "## Fresh headlines vs committed baselines",
            "",
            "| family | metric | baseline | fresh | delta | status |",
            "|---|---|---|---|---|---|",
        ]
        for r in rows:
            delta = "-" if r["delta_pct"] is None else f"{r['delta_pct']:+.1f}%"
            lines.append(f"| {r['family']} | `{r['metric']}` | "
                         f"{_fmt(r['baseline'])} | {_fmt(r['fresh'])} | "
                         f"{delta} | {r['status']} |")
        lines.append("")
        if notes:
            lines += ["Baseline provenance differs from this run "
                      "(informational):", ""]
            lines += [f"- {n}" for n in notes]
            lines.append("")

    failed = [r["spec"].exp_id for r in results
              if r.get("error") or not r["result"].passed]
    lines += ["## Verdict", ""]
    if failed or regressions:
        parts = []
        if failed:
            parts.append(f"gate failure(s): {', '.join(failed)}")
        if regressions:
            parts.append(f"{regressions} headline regression(s)")
        lines.append(f"**FAIL** — {'; '.join(parts)}.")
    else:
        lines.append("**PASS** — every gate held and no portable headline "
                     "regressed.")
    lines.append("")
    return "\n".join(lines)


def _validate_headline(results) -> float | None:
    """Mean gated MAPE from the widest validate regime that ran, if any."""
    for exp_id in ("validate-full", "validate-smoke"):
        for r in results:
            if r.get("error") or r["spec"].exp_id != exp_id:
                continue
            agg = r["result"].metrics.get("aggregate", {})
            entry = agg.get("gate_mean_mape_pct")
            if entry is not None:
                return float(entry["mean"])
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--all", action="store_true",
                    help="reproduce every experiment in the registry")
    ap.add_argument("--only", action="append", metavar="EXP",
                    help="reproduce only these experiment ids (repeatable "
                         "and/or comma-separated)")
    ap.add_argument("--seeds", type=int, default=None, metavar="N",
                    help="run seed-sensitive experiments with seeds 0..N-1 "
                         "(bench families pin their own seeds and run once)")
    ap.add_argument("--results", type=Path, default=Path("results"),
                    help="results root (default results/)")
    ap.add_argument("--force", action="store_true",
                    help="re-run even completed runs")
    ap.add_argument("--list", action="store_true",
                    help="list the experiment registry and exit")
    ap.add_argument("--diff", nargs=2, type=Path, metavar=("A", "B"),
                    help="byte-stability diff of two results trees (masking "
                         "only spec-declared volatile fields) and exit")
    ap.add_argument("--report", type=Path, default=Path("REPRODUCTION.md"),
                    help="reproduction report path (default REPRODUCTION.md)")
    ap.add_argument("--baselines", type=Path, default=None,
                    help="baseline dir for the headline comparison "
                         "(default src/repro_torch/bench/baselines)")
    ap.add_argument("--machine-matched", action="store_true",
                    help="also gate machine-bound headline throughputs")
    ap.add_argument("--device", default="cuda",
                    help="where the experiments run (default: the CUDA card; 'cpu' to "
                         "run here)")
    args = ap.parse_args(argv)

    reg = registry()

    if args.list:
        _list_registry(reg)
        return 0
    if args.diff:
        diffs = diff_results(args.diff[0], args.diff[1], reg)
        for d in diffs:
            print(d)
        print("results trees byte-stable (volatile fields masked)" if not diffs
              else f"{len(diffs)} difference(s)")
        return 1 if diffs else 0

    selected = _parse_only(args.only)
    if args.only and not selected:
        print(f"error: --only given but no experiment ids parsed "
              f"(known: {', '.join(reg)})", file=sys.stderr)
        return 2
    unknown = [n for n in selected if n not in reg]
    if unknown:
        print(f"error: unknown experiment(s) "
              f"{', '.join(repr(n) for n in unknown)} "
              f"(known: {', '.join(reg)})", file=sys.stderr)
        return 2
    if not args.all and not selected:
        print("error: nothing to do — pass --all, --only, --list, or --diff",
              file=sys.stderr)
        return 2

    specs = list(reg.values()) if args.all else [reg[n] for n in selected]
    seeds = tuple(range(args.seeds)) if args.seeds is not None else None
    if seeds == ():
        print("error: --seeds must be >= 1", file=sys.stderr)
        return 2

    where = device_key(args.device)  # no card and no --device cpu: raises
    results = []
    for spec in specs:
        print(f"== {spec.exp_id} ({spec.kind})", flush=True)
        try:
            res = run_experiment(spec, results_root=args.results,
                                 seeds=seeds, force=args.force,
                                 device=args.device)
        except ExperimentError as e:
            print(f"   ERROR: {e}", file=sys.stderr)
            results.append({"spec": spec, "error": str(e)})
            continue
        status = "skipped (already complete)" if res.skipped else "ran"
        print(f"   {status}: {res.run_dir} -> "
              f"{'PASS' if res.passed else 'FAIL'}", flush=True)
        results.append({"spec": spec, "result": res})

    rows, regressions, notes = _headline_rows(
        results, args.results, args.baselines, args.machine_matched)
    report = _report_md(results, rows, regressions, notes, args.results, where)
    args.report.parent.mkdir(parents=True, exist_ok=True)
    args.report.write_text(report)
    print(f"wrote {args.report}")

    failed = [r["spec"].exp_id for r in results
              if r.get("error") or not r["result"].passed]
    if failed:
        print(f"gate failure(s): {', '.join(failed)}", file=sys.stderr)
    if regressions:
        print(f"{regressions} headline regression(s) vs baselines",
              file=sys.stderr)
    return 1 if failed or regressions else 0


if __name__ == "__main__":
    raise SystemExit(main())
