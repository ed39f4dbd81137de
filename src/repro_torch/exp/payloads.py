"""Experiment payloads that don't live in the bench package (the twin of the
reference's ``exp/payloads.py``).

Each payload is a plain callable the runner resolves from a spec's dotted
``payload`` string and calls as ``fn(out_dir, seed=..., config=...,
device=...)`` (kwargs the signature doesn't declare are dropped;
``device=None`` means the card). A payload writes its declared artifacts
into ``out_dir`` and returns a flat-ish metrics dict; boolean ``passed`` /
``*_passed`` / ``*_gate_pass`` leaves feed the runner's gate verdict.

``run_validate`` is also the engine behind ``python -m
repro_torch.launch.validate``: the CLI is a shim over this function, as the
reference's is over its twin, so the registry and the CLI can never disagree
about what a validate regime runs.
"""

from __future__ import annotations

import json
from pathlib import Path
from time import perf_counter
from typing import Mapping

from repro_torch.obs import run_manifest

__all__ = [
    "run_validate",
    "validate_payload",
    "measured_payload",
    "cluster_sim_payload",
]


def run_validate(
    *,
    seed: int | None = None,
    smoke: bool = False,
    corpus: Path | None = None,
    base_n: int | None = None,
    max_n_factor: float | None = None,
    budget_pct: float | None = None,
    tail_pct: float | None = None,
    tail_budget_pct: float | None = None,
    bootstrap: int = 200,
    simulate: bool = True,
    sim_cross_count: int | None = None,
    device=None,
):
    """Run one differential-validation regime on ``device`` (default: the
    card); ``(report, artifact_doc)``.

    The artifact doc is exactly what ``launch.validate`` writes to
    ``VALIDATION.json``: the fidelity report plus corpus metadata and the
    run-provenance manifest.
    """
    from repro_torch.validate import (
        DEFAULT_MAPE_BUDGET_PCT,
        DEFAULT_SEED,
        DEFAULT_TAIL_BUDGET_PCT,
        DEFAULT_TAIL_PCT,
        load_corpus,
        run_differential,
        smoke_subset,
    )

    seed = DEFAULT_SEED if seed is None else int(seed)
    budget_pct = DEFAULT_MAPE_BUDGET_PCT if budget_pct is None else budget_pct
    tail_pct = DEFAULT_TAIL_PCT if tail_pct is None else tail_pct
    tail_budget_pct = DEFAULT_TAIL_BUDGET_PCT if tail_budget_pct is None \
        else tail_budget_pct

    entries, meta = load_corpus(corpus)
    expected = meta.get("expected_totals")
    if smoke:
        entries = smoke_subset(entries)
    base_n = base_n if base_n is not None else (20_000 if smoke else 120_000)
    max_factor = max_n_factor if max_n_factor is not None else \
        (2.0 if smoke else 6.0)
    cross = sim_cross_count if sim_cross_count is not None else \
        (2 if smoke else 3)

    t0 = perf_counter()
    rep = run_differential(
        entries,
        expected_totals=expected,
        base_n=base_n,
        max_n_factor=max_factor,
        seed=seed,
        mape_budget_pct=budget_pct,
        bootstrap=bootstrap,
        simulate=simulate,
        sim_cross_count=cross,
        tail_pct=tail_pct,
        tail_budget_pct=tail_budget_pct,
        device=device,
    )
    elapsed = perf_counter() - t0

    doc = rep.to_dict()
    doc["corpus"] = {"path": meta.get("path"), "seed": meta.get("seed"),
                     "smoke": smoke, "elapsed_s": elapsed}
    doc["manifest"] = run_manifest(seed=seed, config={
        "smoke": smoke, "base_n": base_n, "max_n_factor": max_factor,
        "budget_pct": budget_pct, "tail_pct": tail_pct,
        "tail_budget_pct": tail_budget_pct,
    })
    return rep, doc


def validate_payload(out_dir: Path, seed: int, config: Mapping, device=None) -> dict:
    """A validate regime as a declared experiment -> ``VALIDATION.json``."""
    cfg = dict(config)
    cfg.pop("family", None)
    if cfg.pop("no_sim", False):
        cfg["simulate"] = False
    rep, doc = run_validate(seed=seed, device=device, **cfg)
    (Path(out_dir) / "VALIDATION.json").write_text(json.dumps(doc, indent=2))
    gate = doc["mape_gate"]
    tail = doc["tail_gate"]
    return {
        "passed": bool(rep.passed),
        "n_entries": doc["config"]["n_entries"],
        "gate_mean_mape_pct": gate["mean_pct"],
        "gate_within_5_frac": gate["within_5_frac"],
        "tail_mean_mape_pct": tail["mean_pct"],
        "elapsed_s": elapsed_of(doc),
    }


def elapsed_of(doc: Mapping) -> float:
    return float(doc["corpus"]["elapsed_s"])


def measured_payload(out_dir: Path, seed: int, config: Mapping, device=None) -> dict:
    """Hardware-in-the-loop profile + measured gate as an experiment, the
    engine on ``device`` (default: the card).

    Writes ``PROFILE_<arch>.json`` (the fitted MeasuredProfile; byte-stable
    per seed on the simulated clock, whatever the device) and
    ``VALIDATION_measured.json`` (the analytic-vs-observed gate report).
    A budget the config does not give is the gate's default (the spec's
    15% / 35%); the reference passes ``None`` there and fails (ROADMAP C13).
    """
    from repro_torch.measure import HarnessConfig, build_profile, run_harness
    from repro_torch.obs import run_manifest
    from repro_torch.validate.measured import (
        DEFAULT_MEASURED_BUDGET_PCT,
        DEFAULT_MEASURED_TAIL_BUDGET_PCT,
        run_measured_gate,
    )

    out_dir = Path(out_dir)
    cfg = dict(config)
    hc = HarnessConfig(
        arch=str(cfg.get("arch", "starcoder2_3b")),
        slots=int(cfg.get("slots", 1)),
        reduced=bool(cfg.get("reduced", True)),
        clock=str(cfg.get("clock", "simulated")),
        seed=int(seed),
        n_requests=int(cfg.get("requests", 240)),
        target_rho=float(cfg.get("target_rho", 0.45)),
    )
    trace = run_harness(hc, device=device)
    profile = build_profile(trace, seed=int(seed),
                            manifest=run_manifest(seed=int(seed),
                                                  config=hc.to_dict()))
    profile.save(out_dir / f"PROFILE_{profile.arch}.json")

    rep = run_measured_gate(
        profile,
        budget_pct=float(cfg.get("mean_budget_pct", DEFAULT_MEASURED_BUDGET_PCT)),
        tail_budget_pct=float(cfg.get("tail_budget_pct", DEFAULT_MEASURED_TAIL_BUDGET_PCT)),
        device=device)
    d = rep.to_dict()
    d["manifest"] = dict(profile.manifest)
    (out_dir / "VALIDATION_measured.json").write_text(
        json.dumps(d, indent=2) + "\n")
    return {
        "passed": bool(rep.passed),
        "mean_mape_pct": d["mean"]["mape_pct"],
        "p99_mape_pct": d["tail"]["mape_pct"],
        "rho": rep.rho,
        "n_requests": rep.n_requests,
    }


def cluster_sim_payload(out_dir: Path, seed: int, config: Mapping, device=None) -> dict:
    """Closed-loop cluster replay through the real CLI -> ``CLUSTER.json``.

    Routes through ``repro_torch.launch.cluster_sim.main`` (with ``--device``)
    so the experiment exercises the same argument parsing, gating, and
    report assembly users get — its exit code is the gate (equilibrium
    converged AND the adaptive fleet beats every static policy).
    """
    from repro_torch.device import resolve_device
    from repro_torch.launch.cluster_sim import main as cluster_main

    cfg = dict(config)
    out = Path(out_dir) / "CLUSTER.json"
    argv = ["--clients", str(int(cfg.get("clients", 24))),
            "--duration", str(float(cfg.get("duration", 60.0))),
            "--seed", str(int(seed)),
            "--device", str(resolve_device(device)),
            "--out", str(out)]
    if cfg.get("meanfield"):
        argv.append("--meanfield")
    if cfg.get("cross_check"):
        argv.append("--cross-check")
    rc = cluster_main(argv)
    metrics = {"passed": rc == 0, "exit_code": rc}
    if out.exists():
        doc = json.loads(out.read_text())
        metrics.update({
            "equilibrium_iterations": doc["equilibrium"]["iterations"],
            "mean_latency_s": doc["equilibrium"]["mean_latency_s"],
            "adaptive_wins": doc.get("adaptive_wins",
                                     doc.get("replay", {}).get("adaptive_wins")),
        })
    return metrics
