"""Measurement-subsystem benchmarks of the port: engine throughput, harness
rate, fit cost (the twin of the reference's ``benchmarks/measure_bench.py``).

Four headline groups in ``BENCH_measure.json``, the engine on ``device``
(default: the card, where it runs in bfloat16 as the harness does):

  * ``engine.tokens_per_sec`` — real wall-clock decode throughput of the
    reduced smoke config through the engine (machine-bound; random weights
    from a torch seed, not the reference's ``jax.random`` ones);
  * ``harness.requests_per_sec`` — end-to-end profiling throughput of the
    simulated-clock harness, i.e. how fast CI can produce a trace
    (machine-bound);
  * ``fit.wall_ms`` — distribution-fitting cost on that trace (machine-bound);
  * ``gate.mean_mape_pct`` / ``gate.p99_mape_pct`` — the measured-gate
    headline numbers on the seeded smoke profile. The simulated clock makes
    these *deterministic*: any drift is a model or engine change, not noise,
    so they are gated in portable mode like the other MAPE headlines. The
    weights never reach a simulated trace, so these equal the reference's.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from .common import emit

SMOKE_ARCH = "starcoder2_3b"
SMOKE_REQUESTS = 120
SMOKE_SEED = 0


def smoke_engine(dev):
    """The reduced smoke config's engine on ``dev`` (a resolved device), warmed
    for 8-token prompts; ``(engine, cfg)``. On the card the model runs in
    bfloat16, the dtype the flash kernel takes, as ``run_harness`` does."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import Engine, ServeConfig

    cfg = get_config(SMOKE_ARCH).reduced(seq_chunk=8)
    if dev.type == "cuda":
        cfg = replace(cfg, dtype="bfloat16")
    model = LM(cfg, device=dev, seed=SMOKE_SEED)
    eng = Engine(cfg, model, ServeConfig(slots=2, max_seq=64), device=dev)
    eng.warmup([8])
    return eng, cfg


def _engine_tokens_per_sec(dev) -> dict:
    """Wall-clock tokens/s of the real engine on the reduced smoke config."""
    import numpy as np

    from repro_torch.serving.engine import Request

    eng, cfg = smoke_engine(dev)
    rng = np.random.default_rng(SMOKE_SEED)
    for rid in range(12):
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(0, cfg.vocab_size, size=8)
                           .astype(np.int32),
                           max_new_tokens=8))
    t0 = time.perf_counter()
    eng.drain()
    wall = time.perf_counter() - t0
    n_tokens = sum(len(r.tokens_out) for r in eng.completed)
    return {"tokens_per_sec": n_tokens / wall, "n_tokens": n_tokens,
            "wall_s": wall}


def measure_rows(out_dir: Path, device=None) -> dict:
    from repro_torch.device import resolve_device
    from repro_torch.measure import HarnessConfig, build_profile, fit_trace, run_harness
    from repro_torch.validate.measured import run_measured_gate

    dev = resolve_device(device)
    engine = _engine_tokens_per_sec(dev)
    emit("measure_engine", engine["wall_s"] * 1e6,
         f"tokens_per_sec={engine['tokens_per_sec']:.1f}")

    hc = HarnessConfig(arch=SMOKE_ARCH, n_requests=SMOKE_REQUESTS, seed=SMOKE_SEED)
    t0 = time.perf_counter()
    trace = run_harness(hc, device=dev)
    harness_wall = time.perf_counter() - t0
    harness = {"requests_per_sec": len(trace.requests) / harness_wall,
               "n_requests": len(trace.requests), "wall_s": harness_wall}
    emit("measure_harness", harness_wall * 1e6,
         f"requests_per_sec={harness['requests_per_sec']:.1f}")

    t0 = time.perf_counter()
    fit_trace(trace, seed=SMOKE_SEED)
    fit_wall_ms = (time.perf_counter() - t0) * 1e3
    emit("measure_fit", fit_wall_ms * 1e3, f"wall_ms={fit_wall_ms:.1f}")

    profile = build_profile(trace, seed=SMOKE_SEED)
    rep = run_measured_gate(profile, device=dev)
    gate = {"mean_mape_pct": rep.mean_mape_pct, "p99_mape_pct": rep.p99_mape_pct,
            "rho": rep.rho, "passed": rep.passed}
    emit("measure_gate", 0.0,
         f"mean_mape_pct={rep.mean_mape_pct:.3f} p99_mape_pct={rep.p99_mape_pct:.3f}")

    report = {
        "engine": engine,
        "harness": harness,
        "fit": {"wall_ms": fit_wall_ms},
        "gate": gate,
        "config": {"arch": SMOKE_ARCH, "n_requests": SMOKE_REQUESTS,
                   "seed": SMOKE_SEED, "clock": "simulated"},
    }
    (out_dir / "BENCH_measure.json").write_text(json.dumps(report, indent=2))
    return report
