"""The port's closed-loop cluster path on the CPU against the JAX package's:
traces, policies and the scalar replay, the decision-scan plain version, the
cluster's prediction, closed loop, equilibrium and cross-check, the corpus'
cluster entries, and the cluster CLI.

Inputs are made from numpy seeds and handed to both packages; where the
reference draws its own Poisson counts (``cluster._poisson_counts``, a
``jax.random`` chain torch cannot replay), the test draws them through the
reference and hands the port the same counts. The reference's x64 paths run
through the ``x64`` fixture (a scoped ``jax.enable_x64(True)`` in place of
``jax.experimental.enable_x64``, gone in JAX 0.9.0), as in
``tests/test_torch_fleet.py``.

Tolerances, each with its reason:
  * traces, policies, the scalar replay (SLO mode included) and induced
    scenarios: exact (the same numpy arithmetic), but for the SLO replay's
    three ``C9_EPOCHS`` (ROADMAP C9), where the port's quantile is held to be
    a root of its CDF instead;
  * the decision-scan plain version against the reference's ``impl="xla"``
    and ``impl="interpret"`` paths and against hand-iterated ``_decide_vec``
    with the cohort gate: exact (compares and one multiply per decision);
  * ``predict_decisions``/``predict_terms``: choices exact, terms 1e-9
    relative (the same float64 formulas; XLA and torch may round an ulp
    apart);
  * ``simulate_cluster`` on the reference's counts: choices exact; estimators
    and loads 1e-12 relative (a client-axis sum may associate differently);
    latencies 1e-9 (the closed forms, as above);
  * ``solve_equilibrium``: choices, iterations, convergence and oscillation
    exact, latencies 1e-9;
  * ``cross_check_equilibrium``: analytic column 1e-9, the offload groups'
    simulated means exact (the scalar numpy simulator, same seeds); the
    on-device group, simulated from torch's draws, held by the 5% gate;
  * the corpus' cluster entries: equal to the reference's and to
    ``tests/golden/corpus_v1.json``.
"""

import json

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scenario import ClusterSpec as JClusterSpec
from repro.fleet import cluster as jc
from repro.fleet import policy as j_policy
from repro.fleet.replay import replay as j_replay
from repro.fleet import traces as j_traces
from repro.kernels.decision_scan.ops import decision_scan as j_decision_scan
from repro.launch import cluster_sim as j_cluster_sim
from repro.validate import corpus as j_corpus
from repro_torch.core.scenario import ClusterSpec, Scenario
from repro_torch.fleet import (
    Trace,
    TraceBatch,
    cross_check_equilibrium,
    induced_scenario,
    policy,
    predict_decisions,
    predict_terms,
    replay,
    simulate_cluster,
    solve_equilibrium,
    traces,
)
from repro_torch.kernels.decision_scan.ops import decision_scan
from repro_torch.launch import cluster_sim
from repro_torch.validate import corpus

CLOSED_FORM_RTOL = 1e-9
SUM_RTOL = 1e-12


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


def _spec_pair(jspec: JClusterSpec) -> tuple[ClusterSpec, JClusterSpec]:
    return ClusterSpec.from_dict(jspec.to_dict()), jspec


def _default_pair(n: int):
    return _spec_pair(j_cluster_sim.default_cluster(n))


def _small_pair(n: int = 5):
    """n clients on three edges: a dedicated A2, an exponential T4, and a
    general-service edge with a background tenant."""
    from repro.core import EdgeSpec, NetworkPath, ServiceModel, TenantStream, Tier, Workload
    from repro.core.scenario import Scenario as JScenario

    base = JScenario(
        workload=Workload(2.0, 30_000, 1_000, name="inceptionv4"),
        device=Tier("orin", 0.045),
        edges=(
            EdgeSpec(Tier("a2", 0.028)),
            EdgeSpec(Tier("t4", 0.020, service_model=ServiceModel.EXPONENTIAL)),
            EdgeSpec(Tier("mt", 0.015, service_model=ServiceModel.GENERAL,
                          service_var=0.3 * 0.015**2),
                     background=(TenantStream(6.0, 0.015),)),
        ),
        network=NetworkPath(20e6 / 8),
    )
    return _spec_pair(JClusterSpec(base=base, n_clients=n,
                                   arrival_scale=tuple(np.linspace(0.6, 1.6, n)),
                                   name="small"))


def _trace_pair(duration=60.0, drop=0.15, edges=0, seed=3):
    """The same step-bandwidth trace through each package's generators, with
    seeded churn on ``edges`` exogenous background columns."""
    def build(mod):
        third = duration / 3
        return mod.make_trace(
            duration, 1.0,
            bandwidth_Bps=lambda t: mod.step_signal(
                t, [(0, 2.5e6), (third, 2.5e6 * drop), (2 * third, 2.5e6)]),
            arrival_rate=lambda t: mod.drift_signal(t, 2.0, 2.4, jitter=0.05, seed=seed),
            edge_bg_rate=[lambda t, j=j: mod.mmpp_signal(t, 0.0, 8.0 + j, seed=seed + j)
                          for j in range(edges)],
        )
    return build(traces), build(j_traces)


def _reference_counts(seed, tb, dt):
    with jax.enable_x64(True):
        return np.asarray(jc._poisson_counts(seed, jnp.asarray(tb.arrival_rate),
                                             jnp.float64(dt)))


# ---------------------------------------------------------------------------
# traces, policies, the scalar replay
# ---------------------------------------------------------------------------


def test_traces_equal_the_reference():
    t = np.arange(0.0, 200.0, 1.0)
    for seed in (0, 7):
        np.testing.assert_array_equal(traces.drift_signal(t, 1.0, 5.0, jitter=0.2, seed=seed),
                                      j_traces.drift_signal(t, 1.0, 5.0, jitter=0.2, seed=seed))
        np.testing.assert_array_equal(traces.mmpp_signal(t, 2.0, 30.0, seed=seed),
                                      j_traces.mmpp_signal(t, 2.0, 30.0, seed=seed))
    pts = [(0, 20.0), (40, 2.0), (60, 20.0)]
    np.testing.assert_array_equal(traces.step_signal(t, pts), j_traces.step_signal(t, pts))
    np.testing.assert_array_equal(traces.epoch_times(30.0, 0.5), j_traces.epoch_times(30.0, 0.5))
    got, want = _trace_pair(edges=2)
    for name in ("times", "bandwidth_Bps", "arrival_rate", "edge_bg_rate"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    gb, wb = TraceBatch.from_trace(got, 4), j_traces.TraceBatch.from_trace(want, 4)
    other = traces.make_trace(60.0, 1.0, bandwidth_Bps=1e6, arrival_rate=3.0,
                              edge_bg_rate=got.edge_bg_rate.T)
    stacked = TraceBatch.from_traces([got, other])
    for name in ("bandwidth_Bps", "arrival_rate", "edge_bg_rate"):
        np.testing.assert_array_equal(getattr(gb, name), getattr(wb, name))
    assert stacked.n_clients == 2 and stacked.epoch_s == 1.0
    with pytest.raises(ValueError, match="exogenous"):
        TraceBatch.from_traces([got, traces.make_trace(60.0, 1.0, bandwidth_Bps=1e6,
                                                       arrival_rate=3.0)])
    with pytest.raises(ValueError, match="bandwidth"):
        Trace(times=t[:5], bandwidth_Bps=np.zeros(5), arrival_rate=np.ones(5),
              edge_bg_rate=np.zeros(5))


def test_policy_helpers_equal_the_reference():
    spec, jspec = _small_pair()
    scn, jscn = spec.base, jspec.base
    for name in ("on_device", "edge[0]", "edge[2]"):
        assert policy.parse_policy(name, 3) == j_policy.parse_policy(name, 3)
        np.testing.assert_array_equal(policy.static_fractions(name, 2, 3),
                                      j_policy.static_fractions(name, 2, 3))
    with pytest.raises(Exception, match="policies"):
        policy.parse_policy("edge[7]", 3)
    templates = [policy.bg_template(scn, j) for j in range(3)]
    assert templates == [j_policy.bg_template(jscn, j) for j in range(3)]
    rates = np.array([0.0, 3.0, 12.0])
    for tgt in (-1, 0, 1, 2):
        for q in (None, 0.9):
            kw = dict(slo_quantile=q)
            assert policy.true_latency(scn, tgt, 4e5, 2.5, rates, templates, **kw) == \
                j_policy.true_latency(jscn, tgt, 4e5, 2.5, rates, templates, **kw)
    lat = np.array([0.1, np.inf, 40.0, np.nan])
    got, want = policy.clamp_saturation(lat, 30.0), j_policy.clamp_saturation(lat, 30.0)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == 3


# The SLO replay's scored quantiles where the port's Euler search keeps a
# converged Newton iterate on the bracket's end and the reference's strict
# safeguard does not (ROADMAP C9): (policy, epoch) -> the reference's CDF
# error there, None where the reference lands within float noise of the root.
C9_EPOCHS = {("edge[2]", 34): None, ("edge[2]", 59): -4.4e-10,
             ("adaptive", 59): -4.4e-10}


@pytest.mark.parametrize("slo_quantile", [None, 0.95])
def test_replay_equals_the_reference(slo_quantile, monkeypatch):
    """Bit for bit, except the SLO replay's ``C9_EPOCHS``, where the port's
    quantile is held to be a root of its CDF (|F(t) - q| <= 1e-12) and the
    reference's to its C9 midpoint or to 4 ulp of the port's."""
    from repro_torch.core import tail as T

    scored = {}
    real = policy.sojourn_quantile

    def spy(sts, q, **k):
        t = real(sts, q, **k)
        scored[float(t)] = (tuple(sts), q)
        return t

    monkeypatch.setattr(policy, "sojourn_quantile", spy)
    spec, jspec = _small_pair(1)
    tr, jtr = _trace_pair(edges=3)
    kw = dict(policies=("adaptive", "on_device", "edge[0]", "edge[2]"), seed=11,
              slo_quantile=slo_quantile)
    got, want = replay(spec.base, tr, **kw), j_replay(jspec.base, jtr, **kw)
    assert list(got.policies) == list(want.policies)
    apart = {}
    for name in got.policies:
        a, b = got.policies[name], want.policies[name]
        apart.update({(name, int(i)): (a.latencies_s[i], b.latencies_s[i])
                      for i in np.flatnonzero(a.latencies_s != b.latencies_s)})
        assert a.targets == b.targets and a.saturated_epochs == b.saturated_epochs
    assert set(apart) == (set(C9_EPOCHS) if slo_quantile else set())
    for key, (t_port, t_ref) in apart.items():
        sts, q = scored[float(t_port)]
        assert abs(float(T.sojourn_cdf(sts, t_port)) - q) <= 1e-12
        if C9_EPOCHS[key] is None:
            assert abs(t_port - t_ref) <= 4 * np.spacing(t_ref)
        else:
            assert float(T.sojourn_cdf(sts, t_ref)) - q == pytest.approx(C9_EPOCHS[key],
                                                                        rel=0.05)
    for name in ("est_bandwidth_Bps", "est_arrival_rate", "est_edge_bg_rate"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert [d.edge_index for d in got.decisions] == [d.edge_index for d in want.decisions]
    assert got.adaptive_wins == want.adaptive_wins


def test_replay_same_seed_same_run():
    """tests/test_determinism.py's replay contract, on the port."""
    spec, _ = _small_pair(1)
    tr, _ = _trace_pair(edges=3)
    a, b, c = (replay(spec.base, tr, seed=s) for s in (11, 11, 12))
    for name in a.policies:
        np.testing.assert_array_equal(a.policies[name].latencies_s, b.policies[name].latencies_s)
        assert a.policies[name].targets == b.policies[name].targets
    np.testing.assert_array_equal(a.est_arrival_rate, b.est_arrival_rate)
    assert [d.edge_index for d in a.decisions] == [d.edge_index for d in b.decisions]
    assert not np.array_equal(a.est_arrival_rate, c.est_arrival_rate)


# ---------------------------------------------------------------------------
# the decision scan's plain version
# ---------------------------------------------------------------------------


def _costs(T, N, E1, dtype, seed=4):
    """Exponential costs with all-+inf rows, a +inf column, a NaN and an
    exact tie (the reference's ``tests/test_kernels.py`` helper, extended)."""
    c = np.random.default_rng(seed).exponential(0.05, (T, N, E1)).astype(dtype)
    c[2, : N // 2] = np.inf
    c[3, :, E1 - 1] = np.inf
    c[4, 2 % N, E1 // 2] = np.nan
    c[5, 1 % N, :] = 0.07
    return c


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("stagger,h", [(1, 0.0), (3, 0.15), (4, 0.3)])
def test_decision_scan_plain_equals_reference_xla_and_interpret(dtype, stagger, h):
    T, N, E1 = 37, 13, 4
    c = _costs(T, N, E1, dtype)
    cohort = (np.arange(N) % stagger).astype(np.int32)
    got = decision_scan(torch.from_numpy(c), torch.from_numpy(cohort), hysteresis=h,
                        stagger=stagger).numpy()
    with jax.enable_x64(True):
        args = (jnp.asarray(c), jnp.asarray(cohort))
        kw = dict(hysteresis=h, stagger=stagger)
        xla = np.asarray(j_decision_scan(*args, impl="xla", **kw))
        interp = np.asarray(j_decision_scan(*args, impl="interpret", blk_n=8, blk_t=16, **kw))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, interp)
    assert (got == -1).any() and (got >= 0).any()


@pytest.mark.parametrize("stagger,h", [(1, 0.15), (3, 0.3)])
def test_decision_scan_one_epoch_entry_equals_decide_vec(stagger, h):
    """The closed loop's entry (T = 1, ``prev`` and ``t0``) against the
    reference's ``_decide_vec`` plus the cohort gate, iterated by hand; the
    chained one-epoch calls equal one call over every epoch."""
    T, N = 25, 6
    c = _costs(T, N, 4, np.float64)
    cohort = (np.arange(N) % stagger).astype(np.int32)
    ct = torch.from_numpy(c)
    prev, port = torch.full((N,), -1, dtype=torch.int32), []
    with jax.enable_x64(True):
        jprev, manual = jnp.full(N, -1, jnp.int32), []
        for t in range(T):
            decided = jc._decide_vec(jnp.asarray(c[t, :, 0]), jnp.asarray(c[t, :, 1:]), jprev,
                                     jnp.float64(h), jnp.bool_(t >= stagger))
            jprev = jnp.where(jnp.asarray(cohort) == t % stagger, decided, jprev)
            manual.append(np.asarray(jprev))
            prev = decision_scan(ct[t:t + 1], torch.from_numpy(cohort), hysteresis=h,
                                 stagger=stagger, prev=prev, t0=t)[0]
            port.append(prev.numpy())
    np.testing.assert_array_equal(np.stack(port), np.stack(manual))
    whole = decision_scan(ct, torch.from_numpy(cohort), hysteresis=h, stagger=stagger)
    np.testing.assert_array_equal(whole.numpy(), np.stack(port))


def test_decision_scan_refusals():
    c = torch.from_numpy(_costs(8, 5, 3, np.float64))
    co = torch.zeros(5, dtype=torch.int32)
    bad = [(TypeError, lambda: decision_scan(c.to(torch.float16), co)),
           (TypeError, lambda: decision_scan(c.to(torch.int64), co)),
           (ValueError, lambda: decision_scan(c[0], co)),
           (ValueError, lambda: decision_scan(c[:, :, :0], co)),
           (ValueError, lambda: decision_scan(c, co.long())),
           (ValueError, lambda: decision_scan(c, co[:4])),
           (ValueError, lambda: decision_scan(c, co, stagger=0)),
           (ValueError, lambda: decision_scan(c, co, t0=-1)),
           (ValueError, lambda: decision_scan(c, co, prev=torch.full((5,), 2, dtype=torch.int32))),
           (ValueError, lambda: decision_scan(c, co, prev=torch.full((5,), -2, dtype=torch.int32))),
           (ValueError, lambda: decision_scan(c.to("meta"), co.to("meta")))]
    for exc, call in bad:
        with pytest.raises(exc):
            call()
    assert decision_scan.launches == 0  # CPU calls never count


# ---------------------------------------------------------------------------
# the cluster
# ---------------------------------------------------------------------------


def test_predict_decisions_and_terms_equal_the_reference(x64):
    spec, jspec = _default_pair(8)
    rng = np.random.default_rng(5)
    lam = rng.uniform(0.0, 3.0, 8)
    lam[2] = 0.0  # an idle estimator falls back to the spec rate
    bw = rng.uniform(3e5, 3e6, 8)
    endo = rng.uniform(0.0, 60.0, (8, 4))
    exo = rng.uniform(0.0, 5.0, 4)
    prev = rng.integers(-1, 4, 8)
    for kw in ({}, {"prev_choice": prev, "hysteresis": 0.2}):
        got = predict_decisions(spec, lam, bw, endo, exo, device="cpu", **kw)
        want = jc.predict_decisions(jspec, lam, bw, endo, exo, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=CLOSED_FORM_RTOL)
        np.testing.assert_allclose(got[2], want[2], rtol=CLOSED_FORM_RTOL)
    got, want = predict_terms(spec, lam, bw, endo, exo, device="cpu"), \
        jc.predict_terms(jspec, lam, bw, endo, exo)
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=CLOSED_FORM_RTOL, err_msg=k)
    with pytest.raises(Exception, match="n_clients"):
        predict_decisions(spec, lam[:3], bw, endo, exo, device="cpu")


def _assert_cluster_close(got, want):
    assert list(got.policies) == list(want.policies)
    for name in got.policies:
        a, b = got.policies[name], want.policies[name]
        np.testing.assert_array_equal(a.choices, b.choices, err_msg=name)
        np.testing.assert_allclose(a.latencies_s, b.latencies_s, rtol=CLOSED_FORM_RTOL,
                                   err_msg=name)
        np.testing.assert_allclose(a.edge_loads, b.edge_loads, rtol=SUM_RTOL, atol=0,
                                   err_msg=name)
        assert a.saturated_epochs == b.saturated_epochs
    for name in ("est_bandwidth_Bps", "est_arrival_rate", "est_exo_rate"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=SUM_RTOL,
                                   atol=0, err_msg=name)
    np.testing.assert_allclose(got.est_endo_rate, want.est_endo_rate, rtol=SUM_RTOL,
                               atol=1e-15)


@pytest.mark.parametrize("stagger,h,shards", [(1, 0.0, 1), (3, 0.2, 1), (1, 0.2, 2),
                                              (3, 0.0, 2)])
def test_simulate_cluster_on_reference_counts(x64, stagger, h, shards):
    spec, jspec = _small_pair(5)
    tr, jtr = _trace_pair(40.0, drop=0.3, edges=3)
    kw = dict(policies=("adaptive", "on_device", "edge[1]", "edge[2]"), seed=7,
              stagger=stagger, hysteresis=h, shards=shards)
    want = jc.simulate_cluster(jspec, jtr, **kw)
    n_req = _reference_counts(7, j_traces.TraceBatch.from_trace(jtr, 5), jtr.epoch_s)
    got = simulate_cluster(spec, tr, n_req=n_req, device="cpu", **kw)
    _assert_cluster_close(got, want)
    assert got.policies["adaptive"].offload_frac > 0 and got.policies["adaptive"].switches > 0


def test_simulate_cluster_acceptance_64x4_on_reference_counts(x64):
    """The reference's acceptance run: 120-epoch step trace, stagger 8, seed 1,
    every static policy; adaptive beats every static with no saturated epoch."""
    spec, jspec = _default_pair(64)

    def build(mod):
        return mod.make_trace(120.0, 1.0, arrival_rate=2.0, bandwidth_Bps=lambda t: (
            mod.step_signal(t, [(0, 2.5e6), (40, 2.5e6 * 0.15), (80, 2.5e6)])))

    pols = ("adaptive", "on_device") + tuple(f"edge[{j}]" for j in range(4))
    want = jc.simulate_cluster(jspec, build(j_traces), policies=pols, stagger=8, seed=1)
    n_req = _reference_counts(1, j_traces.TraceBatch.from_trace(build(j_traces), 64), 1.0)
    got = simulate_cluster(spec, build(traces), policies=pols, stagger=8, seed=1, n_req=n_req,
                           device="cpu")
    _assert_cluster_close(got, want)
    assert got.adaptive_wins and got.policies["adaptive"].saturated_epochs == 0


def test_slo_acceptance_64x4_adaptive_wins_equals_the_reference(x64, monkeypatch):
    """The acceptance run in SLO mode (p99 by the asymptote), as the tails
    phase of ``chip_smoke.py`` drives it: adaptive does not beat on-device
    in the reference either, and the port says the same. The statics are
    exact. The adaptive choices part from the reference's from epoch 89 on,
    where predicted paths share a dominant pole within ``POLE_GAP_REL`` and
    the port resolves them on the Euler path (ROADMAP C7); with that rule
    off, the port's choices are the reference's."""
    from repro_torch.fleet import tail_vec

    spec, jspec = _default_pair(64)

    def build(mod):
        return mod.make_trace(120.0, 1.0, arrival_rate=2.0, bandwidth_Bps=lambda t: (
            mod.step_signal(t, [(0, 2.5e6), (40, 2.5e6 * 0.15), (80, 2.5e6)])))

    pols = ("adaptive", "on_device") + tuple(f"edge[{j}]" for j in range(4))
    slo = dict(slo_quantile=0.99, tail_method="asymptote", stagger=8, seed=1)
    want = jc.simulate_cluster(jspec, build(j_traces), policies=pols, **slo)
    n_req = _reference_counts(1, j_traces.TraceBatch.from_trace(build(j_traces), 64), 1.0)
    got = simulate_cluster(spec, build(traces), policies=pols, n_req=n_req, device="cpu", **slo)
    assert got.adaptive_wins == want.adaptive_wins is False
    for name in pols[1:]:
        a, b = got.policies[name], want.policies[name]
        np.testing.assert_array_equal(a.choices, b.choices)
        np.testing.assert_allclose(a.latencies_s, b.latencies_s, rtol=CLOSED_FORM_RTOL)
    a, b = got.policies["adaptive"], want.policies["adaptive"]
    apart = np.asarray(a.choices) != np.asarray(b.choices)
    assert apart.any() and not apart[:89].any()
    assert a.saturated_epochs == b.saturated_epochs == 0

    monkeypatch.setattr(tail_vec, "POLE_GAP_REL", -1.0)
    off = simulate_cluster(spec, build(traces), policies=("adaptive",), n_req=n_req,
                           device="cpu", **slo)
    np.testing.assert_array_equal(off.policies["adaptive"].choices, b.choices)
    np.testing.assert_allclose(off.policies["adaptive"].latencies_s, b.latencies_s,
                               rtol=CLOSED_FORM_RTOL)


def test_simulate_cluster_draws_its_own_counts():
    spec, _ = _default_pair(16)
    tr, _ = _trace_pair(30.0)
    a, b = (simulate_cluster(spec, tr, policies=("adaptive",), seed=4, device="cpu")
            for _ in range(2))
    np.testing.assert_array_equal(a.est_arrival_rate, b.est_arrival_rate)
    c = simulate_cluster(spec, tr, policies=("adaptive",), seed=5, device="cpu")
    assert not np.array_equal(a.est_arrival_rate, c.est_arrival_rate)
    p = a.policies["adaptive"]
    for t in (0, 15, 29):
        assert p.edge_loads[t].sum() == pytest.approx(tr.arrival_rate[t] * (p.choices[t] >= 0).sum())


def test_rate_estimates_are_true_divisions_of_window_sums():
    """The sliding-window arrival estimate divides each window's count sum by
    window * dt (a device tensor, so CUDA divides too, where a Python scalar
    would make it multiply by the reciprocal); the CPU result equals numpy's
    division bit for bit, and the reciprocal product differs, so the check
    can tell the two apart."""
    spec, _ = _default_pair(16)
    tr, _ = _trace_pair(30.0)
    window = 3
    n_req = np.random.default_rng(11).poisson(2.0, (tr.n_epochs, 16)).astype(np.float64)
    got = simulate_cluster(spec, tr, policies=("adaptive",), n_req=n_req,
                           rate_window_epochs=window, device="cpu").est_arrival_rate
    ring = np.zeros((16, window))
    want = np.empty_like(n_req)
    for t in range(tr.n_epochs):
        ring[:, t % window] = n_req[t]
        want[t] = ring.sum(axis=1) / (window * tr.epoch_s)
    want = np.where(want > 0, want, 2.0)  # the spec rate where a window saw nothing
    np.testing.assert_array_equal(got, want)
    reciprocal = np.where(want > 0, ring.sum(axis=1) * (1.0 / (window * tr.epoch_s)), 2.0)
    assert not np.array_equal(want[-1], reciprocal)


def test_solve_equilibrium_and_induced_scenarios_equal_the_reference(x64):
    spec, jspec = _default_pair(64)
    got, want = solve_equilibrium(spec, device="cpu"), jc.solve_equilibrium(jspec)
    np.testing.assert_array_equal(got.choices, want.choices)
    assert (got.iterations, got.converged, got.oscillation) == \
        (want.iterations, want.converged, want.oscillation)
    assert got.converged and got.iterations <= 20 and np.all(got.rho_edges <= 0.9)
    assert len([c for c in got.counts().values() if c]) >= 2
    np.testing.assert_allclose(got.latency_s, want.latency_s, rtol=CLOSED_FORM_RTOL)
    np.testing.assert_allclose(got.rho_edges, want.rho_edges, rtol=CLOSED_FORM_RTOL)
    np.testing.assert_array_equal(got.edge_loads, want.edge_loads)
    assert got.counts() == want.counts()
    for i in (0, 31, 63):
        assert induced_scenario(spec, got.choices, i, allow_unstable=True).to_dict() == \
            jc.induced_scenario(jspec, want.choices, i, allow_unstable=True).to_dict()
    short, jshort = solve_equilibrium(spec, max_iter=1, device="cpu"), \
        jc.solve_equilibrium(jspec, max_iter=1)
    assert short.iterations == 1 and not short.converged
    np.testing.assert_array_equal(short.choices, jshort.choices)


def test_synchronous_steps_launch_the_decision_scan(monkeypatch):
    """One decision-scan call per synchronous best-response step and per
    closed-loop epoch; the damped sweep takes host argmins."""
    from repro_torch.fleet import cluster as pc

    calls = []
    real = pc.decision_scan
    monkeypatch.setattr(pc, "decision_scan", lambda *a, **k: calls.append(k) or real(*a, **k))
    spec, _ = _default_pair(64)
    eq = solve_equilibrium(spec, max_iter=2, device="cpu")
    assert not eq.oscillation and len(calls) == 2
    assert all(k.get("hysteresis", 0.0) == 0.0 and k.get("t0", 0) == 0 for k in calls)
    calls.clear()
    tr, _ = _trace_pair(30.0)
    simulate_cluster(spec, tr, policies=("adaptive", "on_device"), stagger=8, device="cpu")
    assert [k["t0"] for k in calls] == list(range(30))


def test_cross_check_equilibrium(x64):
    """A fleet whose four clients on a 3.2 Mbit/s path stay on the device and
    whose eight on 20 Mbit/s offload: the offload group runs the scalar
    simulator in both packages (exact), the on-device group runs the port's
    batched simulator on torch's draws (the 5% gate)."""
    spec, jspec = _default_pair(12)
    kw = dict(bandwidth_Bps=np.array([4e5] * 4 + [2.5e6] * 8))
    eq, jeq = solve_equilibrium(spec, device="cpu", **kw), jc.solve_equilibrium(jspec, **kw)
    np.testing.assert_array_equal(eq.choices, jeq.choices)
    got = cross_check_equilibrium(spec, eq, n=6_000, seed=2, device="cpu")
    want = jc.cross_check_equilibrium(jspec, jeq, n=6_000, seed=2)
    assert [g["target"] for g in got["groups"]] == [g["target"] for g in want["groups"]]
    targets = {g["target"] for g in got["groups"]}
    assert "on_device" in targets and len(targets) >= 2
    for g, w in zip(got["groups"], want["groups"]):
        assert (g["n_clients"], g["arrival_rate"], g["gated"]) == \
            (w["n_clients"], w["arrival_rate"], w["gated"])
        assert g["rho"] == pytest.approx(w["rho"], rel=CLOSED_FORM_RTOL)
        assert g["analytic_s"] == pytest.approx(w["analytic_s"], rel=CLOSED_FORM_RTOL)
        if g["target"] == "on_device":
            assert g["mape_pct"] <= 5.0
        else:
            assert g["sim_mean_s"] == w["sim_mean_s"]
    assert got["gated_max_mape_pct"] <= 5.0


def _shared_rows(st) -> np.ndarray:
    """Per row of stacked station fields: does its dominant pole have a
    candidate within POLE_GAP_REL (the rows the port resolves on the Euler
    path, ROADMAP C7)?"""
    from repro_torch.core import tail as T

    keys = ("lam", "wkind", "wmean", "wvar", "fkind", "fmean", "fvar")
    flat = {k: st[k].reshape(-1, st[k].shape[-1]).numpy() for k in keys}
    out = []
    for i in range(flat["lam"].shape[0]):
        sts = [T.Station(*(flat[k][i, s].item() for k in keys))
               for s in range(flat["lam"].shape[1])]
        cands = [(T._wait_pole(x), j, True) for j, x in enumerate(sts)] + [
            (1.0 / x.fmean if x.fkind == T.KIND_EXP and x.fmean > 0 else np.inf, j, False)
            for j, x in enumerate(sts)]
        out.append(np.isfinite(min(c[0] for c in cands)) and T.shares_dominant_pole(cands))
    return np.array(out).reshape(st["lam"].shape[:-1])


def test_slo_quantile_is_not_ported_yet(x64, monkeypatch):
    """The SLO mode (once refused here) against the reference: one epoch of
    predictions on estimates that put two (client, edge) paths on a shared
    dominant pole. Choices exact; q-quantiles 1e-9 against the reference
    where the pole stands alone, and 1e-6 against the port's scalar tail on
    every path (the shared ones on the Euler path, ROADMAP C7), the device
    column on the scalar's own M/D/1 evaluation."""
    from repro_torch.core import tail as T
    from repro_torch.fleet import cluster as pc

    spec, jspec = _default_pair(8)
    rng = np.random.default_rng(5)
    lam = rng.uniform(0.5, 3.0, 8)
    bw = rng.uniform(3e5, 3e6, 8)
    endo = rng.uniform(0.0, 60.0, (8, 4))
    exo = rng.uniform(0.0, 5.0, 4)
    prev = rng.integers(-1, 4, 8)
    seen = []
    real = pc.sojourn_quantile_vec
    monkeypatch.setattr(pc, "sojourn_quantile_vec",
                        lambda st, *a, **k: seen.append(st) or real(st, *a, **k))
    for kw, method in (({}, "asymptote"), ({"prev_choice": prev, "hysteresis": 0.2}, "euler")):
        seen.clear()
        got = predict_decisions(spec, lam, bw, endo, exo, slo_quantile=0.99,
                                tail_method=method, device="cpu", **kw)
        want = jc.predict_decisions(jspec, lam, bw, endo, exo, slo_quantile=0.99,
                                    tail_method=method, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=CLOSED_FORM_RTOL)
        shared = _shared_rows(seen[1])
        assert shared.sum() == 2
        stable = np.isfinite(want[2])
        sep = ~shared & stable if method == "asymptote" else stable
        np.testing.assert_allclose(got[2][sep], want[2][sep], rtol=CLOSED_FORM_RTOL)
        st = {k: v.numpy() for k, v in seen[1].items()}
        for n, e in zip(*np.nonzero(stable)):
            sts = [T.Station(*(st[k][n, e, i].item() for k in st)) for i in range(3)]
            assert got[2][n, e] == pytest.approx(
                T.sojourn_quantile(sts, 0.99, method=method), rel=1e-6)
    with pytest.raises(ValueError, match="slo_quantile"):
        predict_decisions(spec, lam, bw, endo, exo, slo_quantile=1.5, device="cpu")
    with pytest.raises(ValueError, match="tail_method"):
        solve_equilibrium(spec, slo_quantile=0.9, tail_method="exact", device="cpu")


@pytest.mark.parametrize("method", ["asymptote", "euler"])
def test_slo_simulate_cluster_and_equilibrium_equal_the_reference(x64, method):
    """SLO-mode closed loop on the reference's counts (stagger 3, hysteresis
    0.2, every static) and the 64 x 4 SLO equilibrium: choices, iterations
    and convergence exact, quantiles 1e-9."""
    spec, jspec = _default_pair(8)
    tr, jtr = _trace_pair(40.0, drop=0.3)
    kw = dict(policies=("adaptive", "on_device", "edge[0]", "edge[2]", "edge[3]"), seed=7,
              stagger=3, hysteresis=0.2, slo_quantile=0.99, tail_method=method)
    want = jc.simulate_cluster(jspec, jtr, **kw)
    n_req = _reference_counts(7, j_traces.TraceBatch.from_trace(jtr, 8), jtr.epoch_s)
    got = simulate_cluster(spec, tr, n_req=n_req, device="cpu", **kw)
    _assert_cluster_close(got, want)
    assert got.policies["adaptive"].switches > 0
    spec, jspec = _default_pair(64)
    got = solve_equilibrium(spec, slo_quantile=0.99, tail_method=method, device="cpu")
    want = jc.solve_equilibrium(jspec, slo_quantile=0.99, tail_method=method)
    np.testing.assert_array_equal(got.choices, want.choices)
    assert (got.iterations, got.converged, got.oscillation) == \
        (want.iterations, want.converged, want.oscillation)
    assert got.converged
    np.testing.assert_allclose(got.latency_s, want.latency_s, rtol=CLOSED_FORM_RTOL)
    np.testing.assert_allclose(got.rho_edges, want.rho_edges, rtol=CLOSED_FORM_RTOL)
    assert got.meets_slo(got.max_latency_s) and not got.meets_slo(0.9 * got.max_latency_s)


def test_slo_scoring_of_the_chosen_target_equals_the_full_table():
    """The SLO scoring evaluates each client-epoch's quantile at the target
    it chose only; every value equals that entry of the full (T, N, E+1)
    quantile table, bit for bit."""
    from repro_torch.fleet import cluster as pc

    spec, _ = _small_pair(5)
    tr, _ = _trace_pair(12.0, edges=3)
    cst = pc._as_tensors(pc._spec_arrays(spec), "cpu")
    tb = TraceBatch.from_trace(tr, 5)
    lam, bw = pc._f64(tb.arrival_rate, "cpu"), pc._f64(tb.bandwidth_Bps, "cpu")
    exo = pc._f64(tb.edge_bg_rate, "cpu")
    choices = torch.as_tensor(np.random.default_rng(2).integers(-1, 3, lam.shape),
                              dtype=torch.int32)
    for method in ("asymptote", "euler"):
        t_dev, t_edge, endo = pc._latency_tables_tail(cst, lam, bw, exo, choices, 0.95, method)
        table = torch.cat([t_dev[..., None], t_edge], dim=2)
        want = torch.take_along_dim(table, (choices.long() + 1)[..., None], dim=2)[..., 0]
        lat, loads = pc._score_assignment(cst, lam, bw, exo, choices, 0.95, method)
        np.testing.assert_array_equal(lat, want.numpy())
        np.testing.assert_array_equal(loads, endo.numpy())


def test_simulate_cluster_refusals():
    spec, _ = _small_pair(4)
    tr, _ = _trace_pair(20.0)
    with pytest.raises(Exception, match="traces"):
        simulate_cluster(spec, TraceBatch.from_trace(tr, 3), device="cpu")
    for kw in ({"stagger": 0}, {"stagger": 5}, {"shards": 0}, {"shards": 5},
               {"rate_window_epochs": 0}, {"n_req": np.zeros((3, 4))}):
        with pytest.raises(ValueError):
            simulate_cluster(spec, tr, device="cpu", **kw)
    with pytest.raises(Exception, match="policies"):
        simulate_cluster(spec, tr, policies=("edge[9]",), device="cpu")


def test_cluster_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CUDA default is exercised by test_torch_cuda")
    spec, _ = _small_pair(2)
    tr, _ = _trace_pair(20.0)
    for call in (lambda: simulate_cluster(spec, tr), lambda: solve_equilibrium(spec),
                 lambda: predict_decisions(spec, [2.0, 2.0], [1e6, 1e6], np.zeros((2, 3)),
                                           np.zeros(3)),
                 lambda: cluster_sim.main(["--clients", "4", "--duration", "10"])):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


# ---------------------------------------------------------------------------
# the corpus' cluster entries and the CLI
# ---------------------------------------------------------------------------


def test_generate_corpus_cluster_entries_equal_the_fixture(x64):
    """The pinned corpus' equilibrium entries (two cluster, two mean-field),
    and the port's builders of them, solved through the port's solvers,
    against the reference's builders on the same draws. The whole corpus is
    regenerated against the fixture in ``tests/test_torch_validate.py``."""
    entries, _ = corpus.load_corpus()
    regimes = [e.regime for e in entries]
    assert regimes.count("cluster-equilibrium") == 2
    assert regimes.count("meanfield-equilibrium") == 2
    for build, j_build, args in ((corpus._cluster_entry, j_corpus._cluster_entry, (8, 0.7)),
                                 (corpus._meanfield_entry, j_corpus._meanfield_entry, (0.6,))):
        a = build(np.random.default_rng(9), *args, device="cpu")
        b = j_build(np.random.default_rng(9), *args)
        assert a.to_dict() == b.to_dict()


def test_cluster_sim_cli_writes_the_reference_report(x64, tmp_path, capsys):
    argv = ["--clients", "16", "--duration", "45"]
    out, jout = tmp_path / "port.json", tmp_path / "ref.json"
    assert cluster_sim.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    assert "client-epochs/s" in capsys.readouterr().out
    assert j_cluster_sim.main(argv + ["--out", str(jout)]) == 0
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    for block in ("equilibrium", "replay"):
        assert set(got[block]) == set(want[block])
    assert got["equilibrium"]["counts"] == want["equilibrium"]["counts"]
    assert got["replay"]["client_epochs"] == 16 * 45 and got["replay"]["adaptive_wins"]
    assert set(got["replay"]["policies"]) == set(want["replay"]["policies"])


def test_cluster_sim_meanfield_cli_writes_the_reference_report(x64, tmp_path, capsys):
    """``--meanfield`` at 10,000 clients over a 30 s walk, with the cross-check
    on the count-scaled copy: the reference report's keys (plus the device),
    the same fixed point and verdicts."""
    argv = ["--meanfield", "--clients", "10000", "--duration", "30", "--cross-check"]
    out, jout = tmp_path / "port.json", tmp_path / "ref.json"
    assert cluster_sim.default_meanfield(10_000).to_dict() == \
        j_cluster_sim.default_meanfield(10_000).to_dict()
    assert cluster_sim.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    assert "adaptive undercuts every static price: True" in capsys.readouterr().out
    assert j_cluster_sim.main(argv + ["--out", str(jout)]) == 0
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    for block in ("equilibrium", "replay", "cross_check"):
        assert set(got[block]) == set(want[block])
    for key in ("iterations", "converged"):
        assert got["equilibrium"][key] == want["equilibrium"][key]
    assert got["equilibrium"]["expected_counts"] == pytest.approx(
        want["equilibrium"]["expected_counts"], rel=1e-9)
    assert got["static_prices_s"] == pytest.approx(want["static_prices_s"], rel=1e-9)
    assert got["adaptive_wins"] and want["adaptive_wins"]
    assert got["replay"]["client_epochs"] == want["replay"]["client_epochs"] == 10_000 * 30
    assert got["replay"]["mean_latency_s"] == pytest.approx(
        want["replay"]["mean_latency_s"], rel=1e-9)
    assert got["cross_check"]["gated_max_mape_pct"] == pytest.approx(
        want["cross_check"]["gated_max_mape_pct"], rel=1e-9)


def test_cluster_sim_cli_refusals(tmp_path, capsys):
    bad = tmp_path / "t.json"
    bad.write_text(json.dumps({"duration_s": 30.0, "epoch_s": 1.0, "bogus": 1}))
    for mode in ([], ["--meanfield"]):
        assert cluster_sim.main(mode + ["--trace", str(bad), "--device", "cpu"]) == 2
        assert "unknown trace spec key" in capsys.readouterr().err
