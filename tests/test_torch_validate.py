"""The port's differential validation (gates 1–3) on the CPU, against the JAX
package's corpus, metrics and closed forms.

Gate budgets are the reference's: scalar vs batched closed forms <= 1e-6
relative, golden pins <= 1e-9, analytic vs simulated <= 5% mean MAPE over
the gated entries. Gate 3 here runs the smoke subset at 4,096 jobs per entry
(the reference's tier-1 smoke uses 20,000; ``chip_smoke.py`` runs those sizes
on the card), which the statistical gate still resolves: the smoke entries
sit at rho <= 0.6.
"""

import json

import numpy as np
import pytest
import torch

from repro.validate import bootstrap_mean_ci as j_bootstrap_mean_ci
from repro.validate import corpus_to_dict as j_corpus_to_dict
from repro.validate import error_stats as j_error_stats
from repro.validate import error_table as j_error_table
from repro.validate import load_corpus as j_load_corpus
from repro.validate import mape as j_mape
from repro_torch.validate import (
    BAND_ORDER,
    GATES,
    NOT_PORTED,
    bootstrap_mean_ci,
    bottleneck_rho,
    corpus_to_dict,
    error_stats,
    error_table,
    generate_corpus,
    load_corpus,
    mape,
    run_differential,
    smoke_subset,
)
from repro_torch.validate.differential import _rel_err, _sim_n_for

SMOKE_N = 4096


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, restored after (see test_torch_fleet)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus():
    return load_corpus()


def test_corpus_is_the_reference_fixture(corpus):
    entries, meta = corpus
    j_entries, j_meta = j_load_corpus()
    assert corpus_to_dict(entries, seed=meta["seed"]) == j_corpus_to_dict(
        j_entries, seed=j_meta["seed"])
    assert meta["expected_totals"] == j_meta["expected_totals"]
    for e in entries:
        assert e.rho == pytest.approx(bottleneck_rho(e.scenario, e.strategy))


def test_generator_names_the_unported_regimes():
    # the cluster entries solve on the given device; the mean-field entries
    # after them are the regime still to port
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        generate_corpus(0, device="cpu")


def test_metrics_equal_the_reference():
    rng = np.random.default_rng(0)
    x = rng.exponential(1.0, 3000)
    errs = list(rng.uniform(0, 12, 20))
    assert mape(1.05, 1.0) == j_mape(1.05, 1.0)
    assert np.isinf(mape(np.inf, 1.0))
    assert error_stats(errs).to_dict() == j_error_stats(errs).to_dict()
    keyed = [(str(rng.choice(BAND_ORDER)), float(e)) for e in errs]
    got, want = error_table(keyed, order=BAND_ORDER), j_error_table(keyed, order=BAND_ORDER)
    assert list(got) == list(want)
    assert all(got[k].to_dict() == want[k].to_dict() for k in got)
    assert bootstrap_mean_ci(x, n_boot=50, seed=3).to_dict() == \
        j_bootstrap_mean_ci(x, n_boot=50, seed=3).to_dict()


def test_rel_err_one_sided_inf_is_loud():
    assert _rel_err(np.inf, np.inf) == 0.0
    assert _rel_err(np.inf, 1.0) == np.inf
    assert _rel_err(1.0, np.inf) == np.inf
    assert _rel_err(np.nan, 1.0) == np.inf
    assert _rel_err(2.0, 1.0) == pytest.approx(0.5)


def test_sim_n_tiers_match_the_reference():
    from repro.validate.differential import _sim_n_for as j_sim_n_for
    for rho in (0.1, 0.5, 0.75, 0.8, 0.88, 0.9, 0.95, 0.99):
        for base_n, factor in ((20_000, 2.0), (120_000, 6.0)):
            assert _sim_n_for(rho, base_n, factor) == j_sim_n_for(rho, base_n, factor)


def test_analytic_gates_on_the_full_corpus(corpus):
    """Gates 1 and 2 over every corpus entry, no simulation."""
    entries, meta = corpus
    rep = run_differential(entries, expected_totals=meta["expected_totals"], simulate=False,
                           device="cpu")
    assert rep.vec_max_rel_err <= 1e-6
    assert all(r.vec_rel_err <= 1e-6 for r in rep.entries)
    assert rep.golden_max_rel_err <= 1e-9
    assert rep.gate.n == 0 and rep.passed


def test_smoke_gates_1_to_3(corpus):
    entries, meta = corpus
    sub = smoke_subset(entries)
    assert 5 <= len(sub) <= 12
    rep = run_differential(sub, expected_totals=meta["expected_totals"], base_n=SMOKE_N,
                           max_n_factor=1.0, bootstrap=100, sim_cross_count=2, device="cpu")
    assert rep.vec_passed and rep.golden_passed and rep.gate_passed and rep.passed
    assert rep.gate.n == len(sub)
    assert rep.gate.mean_pct <= 5.0
    backends = {r.sim_backend for r in rep.entries}
    assert backends == {"fleet", "scalar"}  # the multi-tenant entry takes the scalar path
    for r in rep.entries:
        assert r.sim_n == SMOKE_N
        assert r.sim_ci is not None and r.sim_ci.lo <= r.sim_mean_s <= r.sim_ci.hi
    assert rep.sim_cross["max_mape_pct"] < 10.0  # the two simulators saw the same queues


def test_report_marks_the_unported_blocks(corpus):
    entries, meta = corpus
    rep = run_differential(entries[:3], expected_totals=meta["expected_totals"],
                           simulate=False, device="cpu")
    d = json.loads(json.dumps(rep.to_dict()))
    assert d["passed"] is True and d["covers"] == list(GATES)
    for name in NOT_PORTED:
        assert d[name] == {"ported": False}
    assert set(GATES) <= set(d) and len(d["entries"]) == 3


def test_gate_budget_is_enforced(corpus):
    entries, meta = corpus
    sub = smoke_subset(entries)[:2]
    rep = run_differential(sub, base_n=1000, max_n_factor=1.0, bootstrap=10,
                           sim_cross_count=0, mape_budget_pct=1e-9, device="cpu")
    assert rep.gate.n == 2 and not rep.gate_passed and not rep.passed
    moved = {e.name: {k: v * (1 + 1e-6) for k, v in meta["expected_totals"][e.name].items()}
             for e in sub}
    pinned = run_differential(sub, expected_totals=moved, simulate=False, device="cpu")
    assert not pinned.golden_passed and not pinned.passed  # a 1e-6 drift fails the pin
