"""Tail-latency layer benchmark of the port: what do sojourn quantiles cost,
and how far apart are the two methods? (The twin of the reference's
``benchmarks/tail_bench.py``.)

Times the scalar Abate-Whitt path (``Scenario.analytic_tail``, host numpy)
over the full golden corpus, the batched quantiles (``fleet_tail``, both
methods, on ``device``: default the card) over a bandwidth x arrival-rate
sweep, and the vectorized-vs-loop ``station_pass`` k=1 speedup the validate
gate rides on. ``derived`` carries the model
headline next to each perf number — the asymptote-vs-Euler p99 gap and the
p99-vs-mean crossover shift — so a perf regression AND a model regression
both show up in the same row history.

Where a path's dominant pole is shared (another within ``POLE_GAP_REL``),
the port's asymptote takes the Euler path (ROADMAP C7) where the
reference's is wrong (C2), so ``asym_vs_euler_p99_mean_gap_pct`` parts from
the reference's on those corpus entries on purpose.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from repro_torch.core import NetworkPath, Scenario, Tier, Workload
from repro_torch.core.latency import ServiceModel
from repro_torch.core.scenario import EdgeSpec, analytic_tail
from repro_torch.core.simulation import _station_pass_k1_loop, station_pass
from repro_torch.device import resolve_device
from repro_torch.fleet import ScenarioBatch, fleet_tail
from repro_torch.validate import generate_corpus

from .common import emit, timed

Q = 0.99
SWEEP_B = 64  # bandwidth points
SWEEP_LAM = 32  # arrival-rate points


def _example_scenario() -> Scenario:
    return Scenario(
        workload=Workload(8.0, 50_000, 4_000),
        device=Tier("dev", 0.05, service_model=ServiceModel.DETERMINISTIC),
        network=NetworkPath(2.5e6),
        edges=(EdgeSpec(Tier("edge", 0.018, service_model=ServiceModel.EXPONENTIAL)),),
    )


def tail_rows(out_dir: Path | None = None, device=None) -> dict:
    dev = resolve_device(device)
    entries = generate_corpus(0, device=dev)
    scns = [e.scenario for e in entries]

    # -- scalar Euler quantiles over the full corpus --------------------------
    t0 = time.perf_counter()
    scalar_tails = [analytic_tail(s, Q) for s in scns]
    us_scalar = (time.perf_counter() - t0) * 1e6
    emit("tail_scalar_p99_corpus", us_scalar, f"{len(scns)}_scenarios")

    # -- batched quantiles over a 2-axis sweep --------------------------------
    base = _example_scenario()
    batch = ScenarioBatch.from_sweep(base, {
        "network.bandwidth_Bps": np.geomspace(2.5e5, 2.5e7, SWEEP_B),
        "workload.arrival_rate": np.linspace(1.0, 16.0, SWEEP_LAM),
    })
    rows = batch.size
    _, us_euler = timed(fleet_tail, batch, Q, method="euler", device=dev)
    _, us_asym = timed(fleet_tail, batch, Q, method="asymptote", device=dev)
    euler_rps = rows / (us_euler / 1e6)
    asym_rps = rows / (us_asym / 1e6)
    slowdown = asym_rps / euler_rps
    emit("tail_vec_euler", us_euler, f"{euler_rps:.0f}_rows_per_s")
    emit("tail_vec_asymptote", us_asym, f"{asym_rps:.0f}_rows_per_s")
    emit("tail_euler_vs_asym_slowdown", 0.0, f"{slowdown:.2f}x_acceptance_le_10x")

    # -- batched exact euler vs scalar euler over the corpus ------------------
    # the differential harness gates this at 1e-8 per entry; the bench tracks
    # the actual ceiling (~1e-11: both sides run the identical trajectory)
    cbatch = ScenarioBatch.from_scenarios(scns)
    cpred = fleet_tail(cbatch, Q, method="euler", device=dev)
    errs = []
    for i, te in enumerate(scalar_tails):
        vt = cpred.totals(i)
        for k, v in te.items():
            if np.isfinite(v) and np.isfinite(vt[k]):
                errs.append(abs(v - vt[k]) / max(abs(v), abs(vt[k]), 1e-300))
            elif np.isfinite(v) != np.isfinite(vt[k]):
                errs.append(float("inf"))
    euler_vec_err = float(np.max(errs))
    emit("tail_euler_vec_vs_scalar", 0.0, f"{euler_vec_err:.1e}_max_rel_err")

    # -- asymptote-vs-Euler p99 gap over the corpus (model headline) ----------
    gaps = []
    for s, te in zip(scns, scalar_tails):
        ta = analytic_tail(s, Q, method="asymptote")
        for k, v in te.items():
            if np.isfinite(v) and np.isfinite(ta[k]) and v > 0:
                gaps.append(abs(ta[k] - v) / v * 100.0)
    gap_pct = float(np.mean(gaps))
    emit("tail_asym_vs_euler_gap", 0.0, f"{gap_pct:.2f}pct_mean_p99_gap")

    # -- p99 vs mean crossover shift (the new result class) -------------------
    cm = base.crossovers("bandwidth")
    cq = base.crossovers("bandwidth", quantile=Q)
    ratio = float(cq.value / cm.value)
    emit("tail_p99_crossover_shift", 0.0, f"{ratio:.3f}x_mean_crossover")

    # -- vectorized station_pass k=1 vs the old Python loop -------------------
    rng = np.random.default_rng(0)
    n = 100_000
    arr = np.cumsum(rng.exponential(0.1, size=n))
    svc = rng.exponential(0.08, size=n)
    _, us_loop = timed(_station_pass_k1_loop, arr, svc)
    _, us_vec = timed(station_pass, arr, svc, 1)
    speedup = us_loop / us_vec
    emit("tail_station_pass_k1_100k", us_vec, f"{speedup:.0f}x_vs_loop")

    report = {
        "corpus_entries": len(scns),
        "q": Q,
        "scalar_us_per_scenario": us_scalar / len(scns),
        "sweep_rows": rows,
        "vec_euler_rows_per_sec": euler_rps,
        "euler_vec_rows_per_s": euler_rps,
        "vec_asym_rows_per_sec": asym_rps,
        "euler_vec_slowdown_vs_asym": float(slowdown),
        "euler_vec_vs_scalar_max_err": euler_vec_err,
        "asym_vs_euler_p99_mean_gap_pct": gap_pct,
        "p99_over_mean_crossover_ratio": ratio,
        "station_pass_speedup": float(speedup),
    }
    if out_dir is not None:
        (Path(out_dir) / "BENCH_tail.json").write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    tail_rows(Path("."))
