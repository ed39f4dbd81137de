"""The port's mean-field fleet (``fleet/meanfield.py``) on the CPU against
the JAX package's, on the reference's own gate specs
(``repro.validate.differential.meanfield_gate_specs``, rebuilt in the port
from their dicts).

The reference's x64 paths run through the ``x64`` fixture (a scoped
``jax.enable_x64(True)`` in place of ``jax.experimental.enable_x64``, gone
in JAX 0.9.0: ROADMAP C1).

Tolerance: 1e-9 relative on fractions, latencies, utilisations and the
cross-check's numbers, with iteration counts and convergence exact. Both
sides run the same float64 closed forms and the same damped best-response
arithmetic; XLA and torch may round a pow/log/exp an ulp apart, and the
best-response sum over targets may associate differently. The SLO mode is
held on the asymptote: none of the gate fleets' paths shares its dominant
pole at its fixed point, so the reference's asymptote applies there
(ROADMAP C2, C7). The heavy fleet's replay does pass through one: at epoch
7 of the bandwidth step its slow edge's processing wait pole lies 0.5% from
the request NIC's, where the reference's asymptote is 41% off the Euler
quantile and the port takes the Euler path, so its SLO replay is held on the
mixed fleet only.
"""

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.fleet import meanfield as j_meanfield
from repro.fleet import traces as j_traces
from repro.validate.differential import meanfield_gate_specs as j_gate_specs
from repro_torch.core.scenario import MeanFieldSpec
from repro_torch.fleet import (
    TraceBatch,
    cross_check_meanfield,
    simulate_meanfield,
    solve_meanfield_equilibrium,
    traces,
)
from repro_torch.validate import meanfield_gate_specs

RTOL = 1e-9


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, restored after (see test_torch_fleet)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture
def x64(monkeypatch):
    """The reference's ``jax.experimental.enable_x64()`` for this test only."""
    monkeypatch.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True),
                        raising=False)


def _pairs():
    return [(MeanFieldSpec.from_dict(j.to_dict()), j) for j in j_gate_specs()]


def test_gate_specs_equal_the_reference():
    assert [s.to_dict() for s in meanfield_gate_specs()] == \
        [s.to_dict() for s in j_gate_specs()]


@pytest.mark.parametrize("spec_i", [0, 1])
@pytest.mark.parametrize("slo_quantile", [None, 0.99])
def test_equilibrium_equals_the_reference(x64, spec_i, slo_quantile):
    spec, jspec = _pairs()[spec_i]
    got = solve_meanfield_equilibrium(spec, slo_quantile=slo_quantile, device="cpu")
    want = j_meanfield.solve_meanfield_equilibrium(jspec, slo_quantile=slo_quantile)
    assert (got.iterations, got.converged) == (want.iterations, want.converged)
    assert got.converged
    for name in ("fractions", "latency_s", "class_latency_s", "cost_s", "edge_loads",
                 "rho_edges"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=RTOL,
                                   atol=1e-15, err_msg=name)
    assert got.regret_pct <= 1e-3
    assert got.expected_counts() == pytest.approx(want.expected_counts(), rel=RTOL)
    assert got.mean_latency_s == pytest.approx(want.mean_latency_s, rel=RTOL)
    assert got.offload_frac == pytest.approx(want.offload_frac, rel=RTOL)


def test_bandwidth_overrides_and_short_solves_equal_the_reference(x64):
    spec, jspec = _pairs()[0]
    per_class = np.array([2.5e6, 1e6, 4e5])
    for kw in ({"bandwidth_Bps": 1.5e6}, {"bandwidth_Bps": per_class},
               {"exo_rates": np.array([4.0, 0.0])}, {"max_iter": 3, "damping": 0.8}):
        got = solve_meanfield_equilibrium(spec, device="cpu", **kw)
        want = j_meanfield.solve_meanfield_equilibrium(jspec, **kw)
        assert (got.iterations, got.converged) == (want.iterations, want.converged)
        np.testing.assert_allclose(got.fractions, want.fractions, rtol=RTOL, atol=1e-15)
        np.testing.assert_allclose(got.latency_s, want.latency_s, rtol=RTOL)
        np.testing.assert_allclose(got.bandwidth_Bps, want.bandwidth_Bps, rtol=0)


def _class_traces(mod, spec, duration=60.0):
    """Per-class columns: a drifting rate and a bandwidth step, each class's
    scales folded in."""
    tr = mod.make_trace(duration, 1.0,
                        arrival_rate=lambda t: mod.drift_signal(t, 2.0, 3.0, jitter=0.05, seed=2),
                        bandwidth_Bps=lambda t: mod.step_signal(
                            t, [(0, 2.5e6), (duration / 3, 4e5), (2 * duration / 3, 2.5e6)]))
    return mod.TraceBatch(
        times=tr.times,
        bandwidth_Bps=tr.bandwidth_Bps[:, None] * np.array(
            [c.bandwidth_scale for c in spec.classes]),
        arrival_rate=tr.arrival_rate[:, None] * np.array(
            [c.arrival_scale for c in spec.classes]),
        edge_bg_rate=np.zeros((len(tr.times), spec.n_edges)),
    )


@pytest.mark.parametrize("slo_quantile", [None, 0.99])
def test_simulate_meanfield_trajectories_equal_the_reference(x64, slo_quantile):
    for spec, jspec in _pairs()[:1 if slo_quantile else 2]:
        got = simulate_meanfield(spec, _class_traces(traces, spec), switch_fraction=0.25,
                                 slo_quantile=slo_quantile, device="cpu")
        want = j_meanfield.simulate_meanfield(jspec, _class_traces(j_traces, jspec),
                                              switch_fraction=0.25, slo_quantile=slo_quantile)
        for name in ("fractions", "edge_loads", "rho_edges", "latency_s"):
            np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=RTOL,
                                       atol=1e-15, err_msg=name)
        assert got.saturated_epochs == want.saturated_epochs
        assert got.client_epochs == spec.n_total * 60
        np.testing.assert_allclose(got.offload_frac, want.offload_frac, rtol=RTOL, atol=1e-15)
        assert got.mean_latency_s == pytest.approx(want.mean_latency_s, rel=RTOL)


def test_cross_check_equals_the_reference(x64):
    for spec, jspec in _pairs():
        got = cross_check_meanfield(spec, device="cpu")
        want = j_meanfield.cross_check_meanfield(jspec)
        assert set(got) == set(want)
        assert (got["meanfield_converged"], got["exact_converged"]) == (True, True)
        for key in ("classes", "edges"):
            assert len(got[key]) == len(want[key])
            for g, w in zip(got[key], want[key]):
                assert set(g) == set(w)
                for k, v in w.items():
                    if isinstance(v, float):
                        assert g[k] == pytest.approx(v, rel=RTOL, abs=1e-15), (key, k)
                    else:
                        assert g[k] == v, (key, k)
        for k in ("gated_mean_mape_pct", "gated_max_mape_pct"):
            assert got[k] == pytest.approx(want[k], rel=RTOL)
        assert got["gated_max_mape_pct"] <= 5.0
        assert got["config"] == want["config"]


def test_refusals():
    spec, _ = _pairs()[0]
    tb = TraceBatch.from_trace(traces.make_trace(10.0, 1.0, bandwidth_Bps=2.5e6,
                                                 arrival_rate=2.0), spec.n_classes)
    with pytest.raises(ValueError, match="damping"):
        solve_meanfield_equilibrium(spec, damping=0.0, device="cpu")
    with pytest.raises(ValueError, match="slo_quantile"):
        solve_meanfield_equilibrium(spec, slo_quantile=1.0, device="cpu")
    with pytest.raises(Exception, match="bandwidth_Bps"):
        solve_meanfield_equilibrium(spec, bandwidth_Bps=np.ones(5), device="cpu")
    with pytest.raises(Exception, match="exo_rates"):
        solve_meanfield_equilibrium(spec, exo_rates=np.ones(3), device="cpu")
    with pytest.raises(Exception, match="class columns"):
        simulate_meanfield(spec, TraceBatch.from_trace(
            traces.make_trace(10.0, 1.0, bandwidth_Bps=2.5e6, arrival_rate=2.0), 2),
            device="cpu")
    with pytest.raises(ValueError, match="switch_fraction"):
        simulate_meanfield(spec, tb, switch_fraction=1.5, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            solve_meanfield_equilibrium(spec)
