"""Experiment payloads that don't live in a benchmarks package.

``run_validate`` is the engine behind ``python -m repro_torch.launch.validate``:
the CLI is a shim over this function, as the reference's is over its twin,
so the two entry points can never disagree about what a validate regime runs.
"""

from __future__ import annotations

from pathlib import Path
from time import perf_counter

from repro_torch.obs import run_manifest

__all__ = ["run_validate"]


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
