"""Observability-cost benchmarks of the port: tracer overhead, audit
throughput (the twin of the reference's ``benchmarks/obs_bench.py``).

``BENCH_obs.json`` headline groups, the engine on ``device`` (default: the
card):

  * ``tracer.*`` — real-engine decode throughput with observability OFF
    (``tracer=None``), with a DISABLED tracer attached, and with tracing
    fully ON. The portable gate is ``tracer.overhead_gate_pass``: the
    disabled-tracer cost (one predicate per emission site) must stay within
    ``OVERHEAD_BUDGET_PCT`` of the tracer-free throughput — observability
    must be free when off. Absolute tokens/s rows are machine-bound.
  * ``audit.*`` — decision-audit throughput (fully decomposed
    ``AdaptiveOffloadManager.step`` rows/s, machine-bound) and the term
    re-sum invariant over every audited row (``resum_gate_pass``, portable:
    the audit must never tell a story the decision didn't follow).

All three tracer modes run on ONE warmed engine (tracer swapped between
repeats) so the comparison never pays warm-up noise, and each mode takes its
best-of-``REPEATS`` throughput to de-noise shared CI runners. The engine is
host-bound, so ``overhead_gate_pass`` depends on the host's timing noise.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from .common import emit

SMOKE_ARCH = "starcoder2_3b"
SMOKE_SEED = 0
N_REQUESTS = 12
REPEATS = 5
OVERHEAD_BUDGET_PCT = 5.0
AUDIT_EPOCHS = 2000
RESUM_TOL = 1e-9


def _drain_tokens_per_sec(eng, cfg, rng) -> tuple[float, int]:
    """Submit a fresh burst and drain it; returns (tokens/s, tokens)."""
    import numpy as np

    from repro_torch.serving.engine import Request

    for rid in range(N_REQUESTS):
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, size=8).astype(np.int32),
            max_new_tokens=8))
    t0 = time.perf_counter()
    eng.drain()
    wall = time.perf_counter() - t0
    n_tokens = sum(len(r.tokens_out) for r in eng.completed)
    eng.completed.clear()
    eng.service_log.clear()
    return n_tokens / wall, n_tokens


def _tracer_overhead(dev) -> dict:
    import numpy as np

    from repro_torch.obs import Tracer

    from .measure_bench import smoke_engine

    eng, cfg = smoke_engine(dev)
    # one untimed drain: the very first drain after warmup still runs ~40%
    # slower (allocator/dispatch caches), which would bias whichever mode
    # goes first
    _drain_tokens_per_sec(eng, cfg, np.random.default_rng(SMOKE_SEED))

    modes = {"none": None, "disabled": Tracer(enabled=False),
             "enabled": Tracer()}
    best: dict[str, float] = {}
    n_spans = 0
    for _ in range(REPEATS):
        # interleave the modes every repeat so machine noise (thermal, sibling
        # jobs) lands on all three alike instead of biasing one
        for mode, tracer in modes.items():
            eng.tracer = tracer
            eng._trace = tracer is not None and tracer.enabled
            rng = np.random.default_rng(SMOKE_SEED)
            tps, _ = _drain_tokens_per_sec(eng, cfg, rng)
            best[mode] = max(best.get(mode, 0.0), tps)
    n_spans = len(modes["enabled"].spans)
    if modes["disabled"].spans:
        raise RuntimeError("disabled tracer recorded spans")

    disabled_overhead = (best["none"] - best["disabled"]) / best["none"] * 100.0
    enabled_overhead = (best["none"] - best["enabled"]) / best["none"] * 100.0
    return {
        "tokens_per_sec_none": best["none"],
        "tokens_per_sec_disabled": best["disabled"],
        "tokens_per_sec_enabled": best["enabled"],
        "disabled_overhead_pct": disabled_overhead,
        "enabled_overhead_pct": enabled_overhead,
        "overhead_budget_pct": OVERHEAD_BUDGET_PCT,
        "overhead_gate_pass": float(disabled_overhead <= OVERHEAD_BUDGET_PCT),
        "n_spans_enabled": n_spans,
    }


def _audit_throughput() -> dict:
    from repro_torch.core import EdgeSpec, NetworkPath, Scenario, ServiceModel, Tier, Workload
    from repro_torch.obs import AuditLog

    scn = Scenario(
        workload=Workload(arrival_rate=8.0, req_bytes=200_000, res_bytes=40_000),
        device=Tier("device", 0.080, service_model=ServiceModel.EXPONENTIAL),
        edges=(
            EdgeSpec(Tier("edge0", 0.010, service_model=ServiceModel.EXPONENTIAL)),
            EdgeSpec(Tier("edge1", 0.012, service_model=ServiceModel.EXPONENTIAL)),
        ),
        network=NetworkPath(bandwidth_Bps=2.5e6),
        name="obs-bench",
    )
    auditor = AuditLog()
    mgr = scn.manager(auditor=auditor)
    edges = [e.to_state(scn.workload) for e in scn.edges]
    snapshot = {
        "workload": scn.workload,
        "lam_dev": scn.workload.arrival_rate,
        "edges": edges,
    }
    t0 = time.perf_counter()
    for i in range(AUDIT_EPOCHS):
        # sweep the bandwidth through the crossover so the audited decisions
        # (and the terms behind them) actually vary across rows
        snapshot["bandwidth_Bps"] = 2.5e6 * (0.2 + 1.8 * (i % 50) / 49.0)
        mgr.step(float(i), snapshot)
    wall = time.perf_counter() - t0
    err = auditor.max_resum_error()
    return {
        "rows_per_sec": len(auditor) / wall,
        "n_rows": len(auditor),
        "max_resum_error": err,
        "resum_tol": RESUM_TOL,
        "resum_gate_pass": float(err <= RESUM_TOL),
    }


def obs_rows(out_dir: Path, device=None) -> dict:
    from repro_torch.device import resolve_device

    tracer = _tracer_overhead(resolve_device(device))
    emit("obs_tracer", 0.0,
         f"disabled_overhead_pct={tracer['disabled_overhead_pct']:.2f} "
         f"gate_pass={tracer['overhead_gate_pass']:.0f}")

    audit = _audit_throughput()
    emit("obs_audit", 0.0,
         f"rows_per_sec={audit['rows_per_sec']:.0f} "
         f"max_resum_error={audit['max_resum_error']:.1e}")

    report = {
        "tracer": tracer,
        "audit": audit,
        "config": {"arch": SMOKE_ARCH, "seed": SMOKE_SEED,
                   "n_requests": N_REQUESTS, "repeats": REPEATS,
                   "audit_epochs": AUDIT_EPOCHS},
    }
    (out_dir / "BENCH_obs.json").write_text(json.dumps(report, indent=2))
    return report
