"""Bench regression gate of the port: fresh ``BENCH_*.json`` vs committed
baselines (the twin of the reference's ``benchmarks/check_regression.py``).

Each bench family's JSON artifact carries a few *headline* metrics — the
numbers a perf or model regression would move. This tool compares a freshly
produced artifact directory against the port's own baselines, committed
under ``src/repro_torch/bench/baselines/`` (the reference's are not the
port's: a bf16 flash error sits ~1e4 times above the reference's float32
one), prints a delta table, and exits nonzero when any
headline regresses beyond its tolerance:

  * ``higher``-is-better metrics (throughputs) regress when
    ``fresh < baseline * (1 - tol)``;
  * ``lower``-is-better metrics (MAPE, iteration counts) regress when
    ``fresh > baseline * (1 + tol)``.

Improvements never fail the gate (refresh the baselines when they stick).

Absolute wall-clock throughputs (client-epochs/s, scenarios/s) are tagged
``machine_bound``: they are gated only under ``--machine-matched``, i.e. when
the fresh run and the baselines come from the same machine class — committed
baselines travel with the repo, CI runners don't match the machine that
recorded them, and a 2-3x hardware gap would otherwise fail every PR. In the
default (portable) mode they still appear in the delta table as ``info``
rows; the machine-insensitive headlines (speedups, MAPE, iteration counts,
model means) are always gated.

``--fresh`` accepts either a flat artifact directory (``repro_torch.bench.run
--out``) or a ``results/`` tree produced by ``repro_torch.launch.reproduce`` —
artifacts are found by name wherever they sit (``results/<exp-id>/<run-id>/
seed-<s>/BENCH_*.json``); with several runs of one family the newest wins.

Usage:
  PYTHONPATH=src python -m repro_torch.bench.check_regression --fresh artifacts
  PYTHONPATH=src python -m repro_torch.bench.check_regression --fresh results
  PYTHONPATH=src python -m repro_torch.bench.check_regression --fresh artifacts --machine-matched
  PYTHONPATH=src python -m repro_torch.bench.check_regression --fresh artifacts --update-baselines
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

DEFAULT_TOLERANCE = 0.30

# family artifact -> {dotted metric path: (direction, tolerance or None,
# machine_bound)}. tolerance None = the run's default; machine_bound metrics
# (absolute wall-clock rates) gate only under --machine-matched. The 45%
# machine-matched tolerance still trips on a synthetic 2x slowdown.
HEADLINES: dict[str, dict[str, tuple[str, float | None, bool]]] = {
    "BENCH_fleet.json": {
        "analytic.vec_scenarios_per_sec": ("higher", 0.45, True),
        "analytic.speedup": ("higher", None, False),
        "crossover.speedup": ("higher", None, False),
        "simulation.vec_jobs_per_sec": ("higher", 0.45, True),
        "simulation.vec_vs_scalar_mean_gap": ("lower", None, False),
    },
    "BENCH_cluster.json": {
        "closed_loop.client_epochs_per_sec": ("higher", 0.45, True),
        "closed_loop.adaptive_mean_latency_s": ("lower", None, False),
        "equilibrium.iterations": ("lower", None, False),
    },
    "BENCH_validate.json": {
        "smoke_gate_mean_mape_pct": ("lower", None, False),
    },
    "BENCH_meanfield.json": {
        "diurnal.client_epochs_per_sec": ("higher", 0.45, True),
        # deterministic model headlines: the diurnal day's fleet mean and the
        # fixed-point iteration count must not creep; any saturated
        # class-epoch at all is a model drift (the day is sized stable)
        "diurnal.mean_latency_s": ("lower", None, False),
        "diurnal.saturated_epochs": ("lower", 0.0, False),
        "equilibrium.iterations": ("lower", None, False),
        "cross_check.gated_max_mape_pct": ("lower", None, False),
    },
    "BENCH_tail.json": {
        "vec_euler_rows_per_sec": ("higher", 0.45, True),
        "euler_vec_rows_per_s": ("higher", 0.45, True),
        # acceptance rides on <= 10x; both sides timed in the same run, so
        # the ratio is machine-insensitive and gated portably
        "euler_vec_slowdown_vs_asym": ("lower", None, False),
        # ~1e-11 in practice (identical scalar/vec trajectories); 9.0 trips
        # on an order-of-magnitude error growth without float-jitter flakes
        "euler_vec_vs_scalar_max_err": ("lower", 9.0, False),
        "asym_vs_euler_p99_mean_gap_pct": ("lower", None, False),
        "station_pass_speedup": ("higher", None, False),
    },
    "BENCH_paper_figures.json": {
        "fig2_mape_pct": ("lower", None, False),
        "fig3_mape_pct": ("lower", None, False),
    },
    "BENCH_measure.json": {
        "engine.tokens_per_sec": ("higher", 0.45, True),
        "harness.requests_per_sec": ("higher", 0.45, True),
        "fit.wall_ms": ("lower", 0.45, True),
        # seeded simulated clock -> deterministic MAPE: gated portably
        "gate.mean_mape_pct": ("lower", None, False),
        "gate.p99_mape_pct": ("lower", None, False),
    },
    "BENCH_obs.json": {
        # pass-flags (1.0 = pass) gated at zero tolerance: observability must
        # stay free when disabled (<=5% engine overhead) and every audited
        # decision's terms must re-sum to its totals within 1e-9
        "tracer.overhead_gate_pass": ("higher", 0.0, False),
        "audit.resum_gate_pass": ("higher", 0.0, False),
        "tracer.tokens_per_sec_enabled": ("higher", 0.45, True),
        "audit.rows_per_sec": ("higher", 0.45, True),
    },
    "BENCH_plan.json": {
        "solver.wall_s": ("lower", 0.45, True),
        # deterministic search-cost and model-output headlines: more
        # equilibrium solves or a bigger minimal fleet = solver or model drift
        "solver.evaluations": ("lower", 0.0, False),
        "plan.n_edges": ("lower", 0.0, False),
        "plan.max_latency_ms": ("lower", None, False),
    },
    # each hand-written kernel vs its plain version (on the CPU the plain
    # version itself, so ERR_FLOOR); 9.0 = an order-of-magnitude error
    # growth trips the gate without flaking on cross-platform BLAS jitter
    "BENCH_kernels.json": {
        "flash_attention.max_abs_err": ("lower", 9.0, False),
        "decode_attention.max_abs_err": ("lower", 9.0, False),
        "ssm_scan.max_abs_err": ("lower", 9.0, False),
        "rmsnorm.max_abs_err": ("lower", 9.0, False),
        "lindley_scan.max_abs_err": ("lower", 9.0, False),
        # integer choice trajectories: any mismatch at all is a drift
        "decision_scan.max_abs_err": ("lower", 0.0, False),
    },
}


def resolve(doc: dict, path: str):
    """Dotted-path lookup; None when any segment is missing."""
    cur = doc
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def default_baseline_dir() -> Path:
    return Path(__file__).resolve().parent / "baselines"


def resolve_artifact(root: Path, fname: str) -> Path | None:
    """Locate a family artifact under ``root``: the flat layout first, then
    anywhere in a nested ``results/`` tree (newest mtime wins when a family
    appears in several runs). None when absent entirely."""
    direct = root / fname
    if direct.exists():
        return direct
    nested = [p for p in root.rglob(fname) if p.is_file()]
    if not nested:
        return None
    return max(nested, key=lambda p: p.stat().st_mtime)


def compare(
    fresh_dir: Path,
    baseline_dir: Path,
    *,
    tolerance: float = DEFAULT_TOLERANCE,
    machine_matched: bool = False,
    families: list[str] | None = None,
) -> tuple[list[dict], int]:
    """(rows, n_regressions) over every headline family.

    Missing data is loud on BOTH sides: a family with a committed baseline
    but no fresh artifact (a renamed file, a family dropped from the CI
    ``--only`` list), a family produced fresh with no baseline, and a metric
    absent from either side all count as regressions — silent shrinkage of
    the gate is exactly what this tool exists to catch. Only a family absent
    from both directories is skipped (not part of this comparison at all; a
    deliberate partial run should point ``--fresh`` at a directory holding
    just the families it wants compared AND baselined, or restrict the
    comparison with ``families``). ``machine_matched`` additionally gates the
    machine-bound (absolute wall-clock) headlines; otherwise those are
    informational rows. ``families`` restricts the comparison to those
    artifact filenames (for declared partial runs, e.g. ``reproduce
    --only``); None compares every headline family."""
    rows: list[dict] = []
    regressions = 0
    for fname, metrics in sorted(HEADLINES.items()):
        if families is not None and fname not in families:
            continue
        fresh_path = resolve_artifact(fresh_dir, fname)
        base_path = resolve_artifact(baseline_dir, fname)
        if fresh_path is None and base_path is None:
            continue
        fresh = json.loads(fresh_path.read_text()) if fresh_path else {}
        base = json.loads(base_path.read_text()) if base_path else {}
        for metric, (direction, tol, machine_bound) in metrics.items():
            tol = tolerance if tol is None else tol
            gated = machine_matched or not machine_bound
            f_val = resolve(fresh, metric)
            b_val = resolve(base, metric)
            if f_val is None or b_val is None:
                rows.append({
                    "family": fname, "metric": metric, "baseline": b_val,
                    "fresh": f_val, "delta_pct": None, "tol_pct": tol * 100,
                    "status": "MISSING",
                })
                regressions += 1
                continue
            f_val, b_val = float(f_val), float(b_val)
            delta = (f_val - b_val) / b_val * 100.0 if b_val != 0 else float("inf")
            if direction == "higher":
                bad = f_val < b_val * (1.0 - tol)
            else:
                bad = f_val > b_val * (1.0 + tol)
            if bad and gated:
                regressions += 1
                status = "REGRESSED"
            elif not gated:
                status = "info(slower)" if bad else "info"
            else:
                status = "ok"
            rows.append({
                "family": fname, "metric": metric, "baseline": b_val,
                "fresh": f_val, "delta_pct": delta, "tol_pct": tol * 100,
                "status": status,
            })
    return rows, regressions


def manifest_notes(fresh_dir: Path, baseline_dir: Path,
                   families: list[str] | None = None) -> list[str]:
    """Informational provenance-drift notes: for every compared family whose
    fresh artifact AND baseline both carry a ``manifest`` block, report what
    differs (git sha, package versions, platform). Purely informational —
    the gates above fire regardless; this just says when a delta may be
    explained by baselines recorded under different provenance."""
    from repro_torch.obs import manifest_delta

    notes: list[str] = []
    for fname in sorted(HEADLINES):
        if families is not None and fname not in families:
            continue
        fresh_path = resolve_artifact(fresh_dir, fname)
        base_path = resolve_artifact(baseline_dir, fname)
        if fresh_path is None or base_path is None:
            continue
        try:
            fm = json.loads(fresh_path.read_text()).get("manifest")
            bm = json.loads(base_path.read_text()).get("manifest")
        except (OSError, json.JSONDecodeError):
            continue
        for delta in manifest_delta(bm, fm):
            notes.append(f"{fname}: {delta}")
    return notes


def print_table(rows: list[dict]) -> None:
    if not rows:
        print("no comparable BENCH_*.json families found")
        return
    print(f"{'family':26s} {'metric':42s} {'baseline':>12s} {'fresh':>12s} "
          f"{'delta':>8s} {'tol':>6s}  status")
    for r in rows:
        base = "-" if r["baseline"] is None else f"{r['baseline']:.4g}"
        fresh = "-" if r["fresh"] is None else f"{r['fresh']:.4g}"
        delta = "-" if r["delta_pct"] is None else f"{r['delta_pct']:+.1f}%"
        print(f"{r['family']:26s} {r['metric']:42s} {base:>12s} {fresh:>12s} "
              f"{delta:>8s} {r['tol_pct']:5.0f}%  {r['status']}")


# manifest fields that survive into a committed baseline: portable run
# identity only. git sha, python/platform, and package versions are bound to
# the machine that recorded the baseline and would otherwise emit perpetual
# informational drift notes on every foreign rerun.
_PORTABLE_MANIFEST_KEYS = ("manifest_version", "seed", "config_sha256")


def _strip_manifest(doc: dict) -> dict:
    m = doc.get("manifest")
    if isinstance(m, dict):
        doc = dict(doc)
        doc["manifest"] = {k: m[k] for k in _PORTABLE_MANIFEST_KEYS if k in m}
    return doc


def update_baselines(fresh_dir: Path, baseline_dir: Path) -> list[str]:
    """Copy every known family artifact from ``fresh_dir`` into the baseline
    directory (whole files, so future headline additions have data), with the
    machine/git-bound manifest fields stripped down to
    ``_PORTABLE_MANIFEST_KEYS`` — committed baselines travel with the repo
    and must not pin the provenance of whoever last refreshed them."""
    baseline_dir.mkdir(parents=True, exist_ok=True)
    copied = []
    for fname in HEADLINES:
        src = resolve_artifact(fresh_dir, fname)
        if src is not None:
            doc = _strip_manifest(json.loads(src.read_text()))
            (baseline_dir / fname).write_text(json.dumps(doc, indent=2) + "\n")
            copied.append(fname)
    return copied


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fresh", type=Path, default=Path("artifacts"),
                    help="directory with freshly produced BENCH_*.json")
    ap.add_argument("--baselines", type=Path, default=default_baseline_dir(),
                    help="committed baseline directory (default "
                         "src/repro_torch/bench/baselines)")
    ap.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                    help="default relative tolerance (default 0.30 = ±30%%); "
                         "per-metric overrides in HEADLINES still apply")
    ap.add_argument("--machine-matched", action="store_true",
                    help="also gate the absolute wall-clock throughputs (use "
                         "when baselines were recorded on this machine class)")
    ap.add_argument("--update-baselines", action="store_true",
                    help="replace the baselines with the fresh artifacts and exit")
    args = ap.parse_args(argv)

    if not args.fresh.is_dir():
        print(f"error: fresh artifact directory {args.fresh} does not exist",
              file=sys.stderr)
        return 2
    if args.update_baselines:
        copied = update_baselines(args.fresh, args.baselines)
        if not copied:
            print(f"error: no known BENCH_*.json in {args.fresh}", file=sys.stderr)
            return 2
        print(f"updated baselines: {', '.join(copied)} -> {args.baselines}")
        return 0

    rows, regressions = compare(args.fresh, args.baselines,
                                tolerance=args.tolerance,
                                machine_matched=args.machine_matched)
    print_table(rows)
    notes = manifest_notes(args.fresh, args.baselines)
    if notes:
        print("\nbaseline provenance differs from this run (informational):")
        for note in notes:
            print(f"  {note}")
    if not rows:
        print("error: nothing compared — wrong --fresh directory?", file=sys.stderr)
        return 2
    if regressions:
        print(f"\n{regressions} headline metric(s) regressed beyond tolerance",
              file=sys.stderr)
        return 1
    print(f"\nall {len(rows)} headline metrics within tolerance")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
