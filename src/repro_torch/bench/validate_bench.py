"""Validation-harness benchmark of the port: what does the fidelity gate
cost? (The twin of the reference's ``benchmarks/validate_bench.py``.)

Times the differential pipeline's stages on the smoke subset of the golden
corpus — analytic cross-check (scalar + batched over the whole corpus),
batched simulation, and the end-to-end smoke gate, the batched paths on
``device`` (default: the card) — and emits CSV rows plus a
``BENCH_validate.json`` artifact. ``derived`` carries the fidelity headline
(the gated mean MAPE), so a perf regression AND a model regression both show
up in the same row history. The gate's simulations draw from torch's
generator, so that MAPE is a sampled number, not the reference's.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from repro_torch.device import resolve_device
from repro_torch.fleet import ScenarioBatch, fleet_analytic
from repro_torch.validate import generate_corpus, run_differential, smoke_subset

from .common import emit, timed

SMOKE_N = 20_000


def validate_rows(out_dir: Path | None = None, device=None) -> dict:
    dev = resolve_device(device)
    entries = generate_corpus(0, device=dev)
    smoke = smoke_subset(entries)

    # -- analytic cross-check over the FULL corpus ----------------------------
    scns = [e.scenario for e in entries]
    batch = ScenarioBatch.from_scenarios(scns)
    _, us_vec = timed(fleet_analytic, batch, device=dev)
    t0 = time.perf_counter()
    for s in scns:
        s.analytic()
    us_scalar = (time.perf_counter() - t0) * 1e6
    emit("validate_analytic_vec_corpus", us_vec, f"{len(entries)}_scenarios")
    emit("validate_analytic_scalar_corpus", us_scalar, f"{len(entries)}_scenarios")

    # -- the tier-1 smoke gate end to end ------------------------------------
    t0 = time.perf_counter()
    rep = run_differential(smoke, base_n=SMOKE_N, max_n_factor=2.0,
                           bootstrap=100, sim_cross_count=0, device=dev)
    gate_s = time.perf_counter() - t0
    emit("validate_smoke_gate", gate_s * 1e6,
         f"mean_mape_{rep.gate.mean_pct:.2f}pct")

    report = {
        "corpus_entries": len(entries),
        "smoke_entries": len(smoke),
        "analytic_vec_us": us_vec,
        "analytic_scalar_us": us_scalar,
        "smoke_gate_s": gate_s,
        "smoke_gate_mean_mape_pct": rep.gate.mean_pct,
        "smoke_gate_passed": rep.passed,
    }
    if out_dir is not None:
        (Path(out_dir) / "BENCH_validate.json").write_text(
            json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    validate_rows(Path("."))
