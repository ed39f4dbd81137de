"""Fleet-engine benchmark of the port: scalar vs batched scenario evaluation
(the twin of the reference's ``benchmarks/fleet_bench.py``).

Times the three fleet paths, on ``device`` (default: the card), against their
scalar ``repro_torch.core`` counterparts (host numpy) on the same specs and
emits CSV rows plus a ``BENCH_fleet.json`` artifact:

  * ``fleet_analytic`` over a 131072-scenario cartesian grid vs a scalar
    ``scenario.analytic()`` loop (per-scenario cost extrapolated from a
    subsample — the scalar loop over the full grid would take minutes);
  * ``fleet_crossover`` batched bisection vs scalar ``crossovers()``;
  * ``simulate_fleet`` batched Lindley scan (one hand-written kernel launch
    per station) vs scalar ``simulate()`` (jobs/second, identical tandem
    spec). The batched draws come from torch's generator, so
    ``vec_vs_scalar_mean_gap`` is a sampled number, not the reference's.

Every batched result returns to the host as numpy, so the timed calls end
with the device's work done.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from repro_torch.core.latency import NetworkPath, Tier, Workload
from repro_torch.core.scenario import EdgeSpec, Scenario, analytic, crossovers, simulate
from repro_torch.device import resolve_device
from repro_torch.fleet import ScenarioBatch, fleet_analytic, fleet_crossover, simulate_fleet

from .common import emit

GRID_BW = 512
GRID_LAM = 256
SCALAR_SAMPLE = 256
SIM_BATCH = 256
SIM_JOBS = 4_096
CX_BATCH = 4_096
CX_SCALAR = 32


def _base() -> Scenario:
    return Scenario(
        workload=Workload(2.0, 30_000, 1_000, name="inceptionv4"),
        device=Tier("tx2", 0.150),
        edges=(EdgeSpec(Tier("a2", 0.028)),),
        network=NetworkPath(5e6 / 8),
        allow_unstable=True,  # the grid deliberately crosses saturation
        name="fleet-bench",
    )


def fleet_rows(out_dir: Path | None = None, device=None) -> dict:
    dev = resolve_device(device)
    base = _base()
    axes = {
        "network.bandwidth_Bps": np.geomspace(1e5, 1e8, GRID_BW),
        "workload.arrival_rate": np.linspace(0.5, 30.0, GRID_LAM),
    }

    # -- analytic: vectorized full grid ---------------------------------------
    t0 = time.perf_counter()
    batch = ScenarioBatch.from_sweep(base, axes)
    pack_s = time.perf_counter() - t0
    fleet_analytic(batch, device=dev)  # warm
    t0 = time.perf_counter()
    for _ in range(3):
        fleet_analytic(batch, device=dev)
    vec_s = (time.perf_counter() - t0) / 3
    vec_rate = batch.size / vec_s

    # -- analytic: scalar loop on a subsample, extrapolated --------------------
    rng = np.random.default_rng(0)
    bw_idx = rng.integers(0, GRID_BW, SCALAR_SAMPLE)
    lam_idx = rng.integers(0, GRID_LAM, SCALAR_SAMPLE)
    sample = [
        base.replaced("network.bandwidth_Bps", float(axes["network.bandwidth_Bps"][i]))
        .replaced("workload.arrival_rate", float(axes["workload.arrival_rate"][j]))
        for i, j in zip(bw_idx, lam_idx)
    ]
    t0 = time.perf_counter()
    for scn in sample:
        analytic(scn)
    scalar_s = (time.perf_counter() - t0) / SCALAR_SAMPLE
    scalar_rate = 1.0 / scalar_s
    emit("fleet_analytic_vec", vec_s / batch.size * 1e6,
         f"scenarios_per_sec={vec_rate:.3e};batch={batch.size};pack_ms={pack_s*1e3:.1f}")
    emit("fleet_analytic_scalar", scalar_s * 1e6,
         f"scenarios_per_sec={scalar_rate:.3e};speedup_vec={vec_rate/scalar_rate:.1f}x")

    # -- crossover: batched bisection vs scalar solver -------------------------
    cx_axes = {"workload.arrival_rate": np.linspace(0.5, 30.0, CX_BATCH)}
    cx_batch = ScenarioBatch.from_sweep(base, cx_axes)
    fleet_crossover(cx_batch, "bandwidth", device=dev)  # warm
    t0 = time.perf_counter()
    cx = fleet_crossover(cx_batch, "bandwidth", device=dev)
    cx_vec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for scn in base.sweep("workload.arrival_rate", np.linspace(0.5, 30.0, CX_SCALAR)):
        crossovers(scn, "bandwidth")
    cx_scalar_s = (time.perf_counter() - t0) / CX_SCALAR
    cx_vec_rate = cx_batch.size / cx_vec_s
    cx_scalar_rate = 1.0 / cx_scalar_s
    emit("fleet_crossover_vec", cx_vec_s / cx_batch.size * 1e6,
         f"crossovers_per_sec={cx_vec_rate:.3e};found_frac={cx.found.mean():.3f}")
    emit("fleet_crossover_scalar", cx_scalar_s * 1e6,
         f"crossovers_per_sec={cx_scalar_rate:.3e};speedup_vec={cx_vec_rate/cx_scalar_rate:.1f}x")

    # -- simulation: batched Lindley scan vs scalar tandem ---------------------
    sim_batch = ScenarioBatch.from_scenarios([base] * SIM_BATCH)
    simulate_fleet(sim_batch, "edge[0]", n=SIM_JOBS, seed=0, device=dev)  # warm
    t0 = time.perf_counter()
    res = simulate_fleet(sim_batch, "edge[0]", n=SIM_JOBS, seed=1, device=dev)
    sim_vec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scalar_sim = simulate(base, "edge[0]", n=SIM_JOBS, seed=1)
    sim_scalar_s = time.perf_counter() - t0
    vec_jobs = SIM_BATCH * SIM_JOBS / sim_vec_s
    scalar_jobs = SIM_JOBS / sim_scalar_s
    sim_gap = abs(float(np.mean(res.mean)) - scalar_sim.mean) / scalar_sim.mean
    emit("fleet_sim_vec", sim_vec_s / SIM_BATCH * 1e6,
         f"jobs_per_sec={vec_jobs:.3e};batch={SIM_BATCH}x{SIM_JOBS}")
    emit("fleet_sim_scalar", sim_scalar_s * 1e6,
         f"jobs_per_sec={scalar_jobs:.3e};speedup_vec={vec_jobs/scalar_jobs:.1f}x;mean_gap={sim_gap:.3f}")

    report = {
        "analytic": {
            "batch": batch.size,
            "pack_ms": pack_s * 1e3,
            "vec_scenarios_per_sec": vec_rate,
            "scalar_scenarios_per_sec": scalar_rate,
            "speedup": vec_rate / scalar_rate,
        },
        "crossover": {
            "batch": cx_batch.size,
            "vec_crossovers_per_sec": cx_vec_rate,
            "scalar_crossovers_per_sec": cx_scalar_rate,
            "speedup": cx_vec_rate / cx_scalar_rate,
            "found_frac": float(cx.found.mean()),
        },
        "simulation": {
            "batch": SIM_BATCH,
            "jobs_per_scenario": SIM_JOBS,
            "vec_jobs_per_sec": vec_jobs,
            "scalar_jobs_per_sec": scalar_jobs,
            "speedup": vec_jobs / scalar_jobs,
            "vec_vs_scalar_mean_gap": sim_gap,
        },
    }
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "BENCH_fleet.json").write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    fleet_rows(Path("experiments/bench"))
