"""Differential model validation of the port: golden corpus, error metrics,
and gates 1–3 (scalar vs batched closed forms, golden pins, analytic vs
simulated MAPE).

  * :mod:`corpus` — the golden scenario corpus, read from the fixture under
    ``tests/golden/`` (the port never writes it);
  * :mod:`metrics` — MAPE, per-regime error tables, block-bootstrap CIs;
  * :mod:`differential` — the cross-path runner and its report.
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
    DEFAULT_GOLDEN_TOL,
    DEFAULT_MAPE_BUDGET_PCT,
    DEFAULT_VEC_TOL,
    GATES,
    NOT_PORTED,
    EntryReport,
    ValidationReport,
    run_differential,
    smoke_subset,
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
