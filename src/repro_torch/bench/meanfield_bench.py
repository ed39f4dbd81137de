"""Mean-field fleet benchmark of the port: a million-client diurnal day in
seconds (the twin of the reference's ``benchmarks/meanfield_bench.py``).

The point of ``repro_torch.fleet.meanfield`` is that closed-loop cost is
O(C * E^2) per epoch — independent of N — so a fleet three orders of
magnitude past the exact simulator's reach prices a full day in seconds.
Every solve runs on ``device`` (default: the card). This bench pins that
claim and emits ``BENCH_meanfield.json``:

  * ``meanfield_day`` — a 1,000,000-client, 4-class, 4-edge fleet through a
    1440-epoch diurnal day (daytime bandwidth squeeze + MMPP flash-crowd
    churn on the arrival and exogenous-load sides). Headline:
    client-epochs/s (machine-bound) — the acceptance criterion is the whole
    day end-to-end in minutes, and warm it runs in seconds;
  * ``meanfield_equilibrium`` — the damped Wardrop fixed point on the same
    million-client spec (headline: iterations to converge, a model-behaviour
    metric that must not creep);
  * ``meanfield_cross_check`` — the mean-field-vs-exact agreement on the
    validation harness's fixed small fleet (headline: gated max MAPE, the
    portable model-fidelity number).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from repro_torch.core import (
    ClientClass,
    EdgeSpec,
    MeanFieldSpec,
    NetworkPath,
    Scenario,
    ServiceModel,
    Tier,
    Workload,
)
from repro_torch.device import resolve_device
from repro_torch.fleet import (
    TraceBatch,
    cross_check_meanfield,
    mmpp_signal,
    simulate_meanfield,
    solve_meanfield_equilibrium,
    step_signal,
)
from repro_torch.validate import meanfield_gate_specs

from .common import emit

N_CLIENTS = 1_000_000
EPOCHS = 1_440  # one day at 60 s epochs
EPOCH_S = 60.0
DAY_S = EPOCHS * EPOCH_S
BW0_BPS = 2.5e6  # 20 Mbit shared path
BW_DAYTIME = 0.4  # daytime congestion squeezes the uplink to 40%


def meanfield_day_spec() -> MeanFieldSpec:
    """The million-client fleet: four bandwidth/rate classes over four
    pooled accelerator tiers sized so the aggregate ~55 krps fleet keeps
    every edge inside the stable region at full bandwidth.

    Results are not returned: the model prices the return path as one queue
    at the edge's AGGREGATE rate over the client's bandwidth (the paper's
    single-path serialization), which caps any edge at bw/res_bytes — a few
    krps — regardless of accelerator pool size. Fire-and-forget is the
    regime where pooling to this scale is meaningful."""
    base = Scenario(
        workload=Workload(arrival_rate=0.05, req_bytes=30_000, res_bytes=0,
                          name="mf-bench"),
        device=Tier("orin", 0.045),
        network=NetworkPath(BW0_BPS),
        edges=(
            EdgeSpec(Tier("a100", 0.008, parallelism_k=1024.0)),
            EdgeSpec(Tier("a2", 0.028, parallelism_k=2048.0)),
            EdgeSpec(Tier("t4", 0.020, parallelism_k=2048.0,
                          service_model=ServiceModel.EXPONENTIAL)),
            EdgeSpec(Tier("mixed", 0.015, parallelism_k=1024.0,
                          service_model=ServiceModel.GENERAL,
                          service_var=0.25 * 0.015 * 0.015)),
        ),
        name="mf-bench-base",
    )
    classes = (
        ClientClass(n_clients=400_000, arrival_scale=1.0, name="steady"),
        ClientClass(n_clients=300_000, arrival_scale=0.5, name="light"),
        ClientClass(n_clients=200_000, arrival_scale=2.0, bandwidth_scale=0.5,
                    name="heavy"),
        ClientClass(n_clients=100_000, arrival_scale=1.5, bandwidth_scale=0.25,
                    name="cellular"),
    )
    return MeanFieldSpec(base=base, classes=classes, name="mf-million")


def diurnal_traces(spec: MeanFieldSpec) -> TraceBatch:
    """Per-class day: a daytime bandwidth squeeze for everyone, MMPP burst
    churn on the heavy class's arrival rate, and an MMPP flash crowd of
    exogenous load on the fastest edge."""
    times = np.arange(0.0, DAY_S, EPOCH_S)
    squeeze = step_signal(times, [(0.0, 1.0), (DAY_S / 3, BW_DAYTIME),
                                  (2 * DAY_S / 3, 1.0)])
    bw0 = spec.bandwidth_Bps()  # (C,) class scales folded in
    bw = bw0[None, :] * squeeze[:, None]
    lam = np.broadcast_to(spec.arrival_rates(),
                          (len(times), spec.n_classes)).copy()
    heavy = [c.name for c in spec.classes].index("heavy")
    lam[:, heavy] *= mmpp_signal(times, 1.0, 1.5, p_up=0.05, p_down=0.2,
                                 seed=11)
    exo = np.zeros((len(times), spec.n_edges))
    exo[:, 0] = mmpp_signal(times, 0.0, 20_000.0, p_up=0.03, p_down=0.25,
                            seed=13)
    return TraceBatch(times=times, bandwidth_Bps=bw, arrival_rate=lam,
                      edge_bg_rate=exo)


def meanfield_rows(out_dir: Path | None = None, device=None) -> dict:
    dev = resolve_device(device)
    spec = meanfield_day_spec()
    traces = diurnal_traces(spec)

    # full day once to warm up, then a warm pass for the throughput headline
    res = simulate_meanfield(spec, traces, device=dev)
    t0 = time.perf_counter()
    res = simulate_meanfield(spec, traces, device=dev)
    day_s = time.perf_counter() - t0
    rate = res.client_epochs / day_s
    off = res.offload_frac
    emit("meanfield_day", day_s / res.n_epochs * 1e6,
         f"client_epochs_per_sec={rate:.3e};clients={spec.n_total};"
         f"epochs={res.n_epochs}")

    solve_meanfield_equilibrium(spec, device=dev)  # warm
    t0 = time.perf_counter()
    mf = solve_meanfield_equilibrium(spec, device=dev)
    eq_s = time.perf_counter() - t0
    emit("meanfield_equilibrium", eq_s * 1e6,
         f"iterations={mf.iterations};converged={mf.converged};"
         f"offload_frac={mf.offload_frac:.3f}")

    t0 = time.perf_counter()
    check = cross_check_meanfield(meanfield_gate_specs()[0], device=dev)
    check_s = time.perf_counter() - t0
    emit("meanfield_cross_check", check_s * 1e6,
         f"gated_max_mape_pct={check['gated_max_mape_pct']:.3f}")

    report = {
        "diurnal": {
            "n_clients": spec.n_total,
            "classes": spec.n_classes,
            "edges": spec.n_edges,
            "epochs": res.n_epochs,
            "epoch_s": EPOCH_S,
            "client_epochs": res.client_epochs,
            "wall_s": day_s,
            "client_epochs_per_sec": rate,
            "mean_latency_s": res.mean_latency_s,
            "offload_frac_min": float(off.min()),
            "offload_frac_max": float(off.max()),
            "saturated_epochs": res.saturated_epochs,
            "peak_rho_edges": res.rho_edges.max(axis=0).tolist(),
        },
        "equilibrium": {
            "iterations": mf.iterations,
            "converged": mf.converged,
            "regret_pct": mf.regret_pct,
            "solve_ms": eq_s * 1e3,
            "mean_latency_s": mf.mean_latency_s,
            "offload_frac": mf.offload_frac,
            "rho_edges": mf.rho_edges.tolist(),
        },
        "cross_check": {
            "spec": meanfield_gate_specs()[0].name,
            "wall_ms": check_s * 1e3,
            "gated_max_mape_pct": check["gated_max_mape_pct"],
            "gated_mean_mape_pct": check["gated_mean_mape_pct"],
            "converged": bool(check["meanfield_converged"]
                              and check["exact_converged"]),
        },
    }
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "BENCH_meanfield.json").write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    meanfield_rows(Path("experiments/bench"))
