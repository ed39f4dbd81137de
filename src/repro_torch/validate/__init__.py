"""Differential model validation of the port: golden corpus, error metrics,
and the five gates (scalar vs batched closed forms, golden pins, analytic vs
simulated MAPE, tail quantiles, mean field vs the exact solver).

  * :mod:`corpus` — the golden scenario corpus, read from the fixture under
    ``tests/golden/`` (the port never writes it);
  * :mod:`metrics` — MAPE, per-regime error tables, block-bootstrap CIs;
  * :mod:`differential` — the cross-path runner and the fidelity report
    behind ``python -m repro_torch.launch.validate``;
  * :mod:`measured` — analytic mean/p99 against the latencies the port's
    serving engine delivered (paper §5), behind ``python -m
    repro_torch.launch.measure validate``.
"""

from .corpus import (
    BAND_ORDER,
    CORPUS_VERSION,
    DEFAULT_SEED,
    CorpusEntry,
    RHO_BANDS,
    bottleneck_rho,
    corpus_to_dict,
    default_fixture_path,
    generate_corpus,
    load_corpus,
    rho_band,
)
from .differential import (
    DEFAULT_EULER_VEC_TOL,
    DEFAULT_GOLDEN_TOL,
    DEFAULT_MAPE_BUDGET_PCT,
    DEFAULT_MEANFIELD_BUDGET_PCT,
    DEFAULT_TAIL_BUDGET_PCT,
    DEFAULT_TAIL_PCT,
    DEFAULT_VEC_TOL,
    EULER_VEC_RHO_MAX,
    EntryReport,
    ValidationReport,
    meanfield_gate_specs,
    run_differential,
    run_meanfield_gate,
    smoke_subset,
    tail_gated,
)
from .measured import (
    DEFAULT_MEASURED_BUDGET_PCT,
    DEFAULT_MEASURED_TAIL_BUDGET_PCT,
    MEASURED_VEC_TOL,
    MeasuredGateReport,
    measured_scenario,
    run_measured_gate,
)
from .metrics import (
    BootstrapCI,
    ErrorStats,
    bootstrap_mean_ci,
    error_stats,
    error_table,
    mape,
)

__all__ = [k for k in dir() if not k.startswith("_")]
