"""Provisioning-solver benchmark of the port: what does inverting the fleet
model cost? (The twin of the reference's ``benchmarks/plan_bench.py``.)

Runs the README's worked fleet-sizing example (N clients, p99 budget, a
3-tier accelerator ladder x 8 edges x 4 bandwidths) through
``repro_torch.plan.provision`` on ``device`` (default: the card; each
equilibrium step one decision-scan launch) with exact euler tails and
records both the cost
(wall time, equilibrium solves spent) and the *answer* (edges/tier/bandwidth
picked, worst-client p99) — so a solver perf regression and a model-output
drift both land in the same row history. ``evaluations`` vs the exhaustive
grid size is the headline: the per-axis bisection should stay logarithmic.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from repro_torch.device import resolve_device
from repro_torch.launch.provision import default_space
from repro_torch.plan import provision

from .common import emit

N_CLIENTS = 48
SLO_S = 0.120
Q = 0.99


def plan_rows(out_dir: Path | None = None, device=None) -> dict:
    dev = resolve_device(device)
    space = default_space()
    grid = space.max_edges * len(space.tiers) * len(space.bandwidths_Bps)

    t0 = time.perf_counter()
    plan = provision(space, N_CLIENTS, SLO_S, q=Q, tail_method="euler", device=dev)
    wall_s = time.perf_counter() - t0
    if plan is None:
        raise RuntimeError("bench space must be feasible")

    emit("plan_provision_48c", wall_s * 1e6,
         f"{plan.evaluations}_of_{grid}_grid_solves")
    emit("plan_provision_result", 0.0,
         f"{plan.n_edges}x_{plan.tier.name}_{plan.bandwidth_Bps * 8 / 1e6:.0f}Mbit")
    emit("plan_provision_p99", 0.0,
         f"{plan.max_latency_s * 1e3:.1f}ms_budget_{SLO_S * 1e3:.0f}ms")

    report = {
        "n_clients": N_CLIENTS,
        "slo_ms": SLO_S * 1e3,
        "q": Q,
        "grid_size": grid,
        "solver": {
            "wall_s": wall_s,
            "evaluations": plan.evaluations,
            "grid_over_evals": grid / plan.evaluations,
        },
        "plan": {
            "n_edges": plan.n_edges,
            "tier": plan.tier.name,
            "tier_index": plan.tier_index,
            "bandwidth_Mbit": plan.bandwidth_Bps * 8 / 1e6,
            "max_latency_ms": plan.max_latency_s * 1e3,
            "mean_latency_ms": plan.mean_latency_s * 1e3,
        },
    }
    if out_dir is not None:
        (Path(out_dir) / "BENCH_plan.json").write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    plan_rows(Path("."))
