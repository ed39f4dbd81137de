"""Closed-loop cluster benchmark of the port: decisions/s at fleet scale +
equilibrium cost (the twin of the reference's ``benchmarks/cluster_bench.py``).

Times the two ``repro_torch.fleet.cluster`` hot paths, on ``device``
(default: the card), on the acceptance-criteria 64-client/4-edge cluster and
emits CSV rows plus a ``BENCH_cluster.json`` artifact:

  * ``cluster_closed_loop`` — the decision-scan kernel (one launch an
    epoch) + batched analytic
    scoring over a 2000-epoch bandwidth-step trace (headline:
    client-epochs/s, acceptance floor 100k/s on CPU), with the adaptive
    policy scored against every all-clients static on the same trace;
  * ``cluster_equilibrium`` — the fixed-point solver (headline: best-response
    iterations to convergence, a model-behaviour metric that must not creep).

The closed loop's Poisson arrival counts come from torch's generator (the
reference's ``jax.random`` chain cannot be replayed), so the closed loop's
latencies are sampled numbers; the equilibrium is deterministic.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.fleet import make_trace, simulate_cluster, solve_equilibrium, step_signal
from repro_torch.launch.cluster_sim import default_cluster

from .common import emit

N_CLIENTS = 64
EPOCHS = 2_000
STAGGER = 8
BW_DROP = 0.15


def cluster_rows(out_dir: Path | None = None, device=None) -> dict:
    dev = resolve_device(device)
    spec = default_cluster(N_CLIENTS)
    bw0 = float(np.asarray(spec.base.network.bandwidth_Bps))
    third = EPOCHS / 3
    trace = make_trace(
        float(EPOCHS), 1.0,
        bandwidth_Bps=lambda t: step_signal(
            t, [(0, bw0), (third, bw0 * BW_DROP), (2 * third, bw0)]),
        arrival_rate=spec.base.workload.arrival_rate,
    )
    policies = ("adaptive", "on_device") + tuple(
        f"edge[{j}]" for j in range(spec.n_edges))

    # full run (builds + scores every policy), then a warm adaptive-only
    # pass for the throughput headline
    res = simulate_cluster(spec, trace, policies=policies, stagger=STAGGER, seed=0,
                           device=dev)
    t0 = time.perf_counter()
    simulate_cluster(spec, trace, policies=("adaptive",), stagger=STAGGER, seed=1,
                     device=dev)
    loop_s = time.perf_counter() - t0
    rate = res.client_epochs / loop_s
    emit("cluster_closed_loop", loop_s / res.client_epochs * 1e6,
         f"client_epochs_per_sec={rate:.3e};clients={spec.n_clients};epochs={EPOCHS}")

    solve_equilibrium(spec, device=dev)  # warm
    t0 = time.perf_counter()
    eq = solve_equilibrium(spec, device=dev)
    eq_s = time.perf_counter() - t0
    emit("cluster_equilibrium", eq_s * 1e6,
         f"iterations={eq.iterations};converged={eq.converged};"
         f"mean_latency_ms={eq.mean_latency_s*1e3:.2f}")

    report = {
        "closed_loop": {
            "clients": spec.n_clients,
            "edges": spec.n_edges,
            "epochs": EPOCHS,
            "stagger": STAGGER,
            "client_epochs": res.client_epochs,
            "client_epochs_per_sec": rate,
            "adaptive_mean_latency_s": res.policies["adaptive"].mean_latency_s,
            "adaptive_wins": res.adaptive_wins,
            "saturated_epochs": res.policies["adaptive"].saturated_epochs,
            "policy_means_s": {
                name: p.mean_latency_s for name, p in res.policies.items()
            },
        },
        "equilibrium": {
            "iterations": eq.iterations,
            "converged": eq.converged,
            "oscillation": eq.oscillation,
            "solve_ms": eq_s * 1e3,
            "mean_latency_s": eq.mean_latency_s,
            "rho_edges": eq.rho_edges.tolist(),
            "counts": eq.counts(),
        },
    }
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "BENCH_cluster.json").write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    cluster_rows(Path("experiments/bench"))
