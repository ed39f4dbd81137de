"""The paper's own models in the port (``repro_torch.core.{queueing, split,
service_time, predictor}``) against the JAX package's, on the same seeded
inputs.

Tolerances and why:
- queueing, split, service time: bit equality. The port copies the
  reference's plain-Python / numpy arithmetic operation for operation, so
  every closed form (saturated ones too: ``inf``), the split plan's argmin,
  its sweep, the profile statistics and the golden-section fit of k agree
  exactly, and both raise on the same bad inputs.
- the predictor, both sides started from the reference's initial weights
  (``models.convert.predictor_params_from_jax``) on the same minibatch
  indices: float32 on the CPU. The per-step losses over the first 50 steps
  within 1e-6 relative (measured 2.1e-7: XLA's and torch's matmuls sum in
  other orders and XLA evaluates tanh by its own approximation, a few float32
  ulps a step); the held-out predictions after the reference test's
  2,500-step fit within 4e-5 relative (measured 4.4e-6: those ulps drift over
  2,500 Adam steps). GELU's exact erf form in place of the tanh form that
  ``jax.nn.gelu`` uses moves the first 50 losses far past 1e-6.
"""

import math
import types

import jax
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.predictor as ref_pred
from repro.core import latency as ref_lat
from repro.core import queueing as ref_q
from repro.core import service_time as ref_st
from repro.core import split as ref_split
import repro_torch.core as port_core
import repro_torch.core.predictor as port_pred
from repro_torch.core import latency as port_lat
from repro_torch.core import queueing as port_q
from repro_torch.core import service_time as port_st
from repro_torch.core import split as port_split
from repro_torch.fleet.analytic_vec import mmk_wait_erlang_vec
from repro_torch.models.convert import predictor_params_from_jax

LOSS_RTOL = 1e-6
PRED_RTOL = 4e-5
FIT_STEPS, FIT_LR, N_TRAIN = 2500, 3e-3, 448


def outcome(fn, *args, **kw):
    """The value, or the type of the exception raised."""
    try:
        return fn(*args, **kw)
    except (ValueError, IndexError) as exc:
        return type(exc)


def same(a, b) -> bool:
    """Bit equality that counts NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


# ---------------------------------------------------------------------------
# queueing: every form on a seeded grid that crosses saturation


def queue_grid(seed=0, n=300):
    """(lam, mu, k, var_a, var_s) rows: rho from 0 to 1.6, exact saturation,
    lam = 0, negative lam, integer and fractional k, negative variances."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        mu = float(10 ** rng.uniform(-1, 3))
        k = float(rng.choice([1.0, 2.0, 3.0, 4.0, 7.0, 0.5, 2.5]))
        lam = float(rng.uniform(0.0, 1.6) * k * mu)
        rows.append((lam, mu, k, float(rng.uniform(0, 2) / mu**2), float(rng.uniform(0, 2) / mu**2)))
    rows += [(0.0, 5.0, 1.0, 0.1, 0.1), (5.0, 5.0, 1.0, 0.0, 0.0), (8.0, 4.0, 2.0, 0.0, 0.0),
             (-1.0, 5.0, 1.0, 0.0, 0.0), (1.0, 0.0, 1.0, 0.0, 0.0), (1.0, 5.0, 0.0, 0.0, 0.0),
             (1.0, 5.0, 1.0, -0.1, 0.1), (1.0, 5.0, 1.0, 0.1, -0.1),
             (5.0 - 1e-13, 5.0, 1.0, 0.0, 0.0)]
    return rows


QUEUE_FORMS = {
    "utilisation": lambda q, lam, mu, k, va, vs: q.utilisation(lam, mu, k),
    "mm1_wait": lambda q, lam, mu, k, va, vs: q.mm1_wait(lam, mu),
    "mm1_response": lambda q, lam, mu, k, va, vs: q.mm1_response(lam, mu),
    "md1_wait": lambda q, lam, mu, k, va, vs: q.md1_wait(lam, mu),
    "md1_wait_aggregated": lambda q, lam, mu, k, va, vs: q.md1_wait_aggregated(lam, mu, k),
    "mm1_wait_aggregated": lambda q, lam, mu, k, va, vs: q.mm1_wait_aggregated(lam, mu, k),
    "mg1_wait": lambda q, lam, mu, k, va, vs: q.mg1_wait(lam, mu, vs),
    "gg1_wait_upper_bound": lambda q, lam, mu, k, va, vs: q.gg1_wait_upper_bound(lam, mu, va, vs),
    "mmk_wait_erlang": lambda q, lam, mu, k, va, vs: q.mmk_wait_erlang(lam, mu, k),
    "mdk_wait_approx": lambda q, lam, mu, k, va, vs: q.mdk_wait_approx(lam, mu, k),
}


@pytest.mark.parametrize("form", sorted(QUEUE_FORMS))
def test_queueing_form_bit_equal(form):
    fn = QUEUE_FORMS[form]
    saturated = finite = 0
    for row in queue_grid():
        a, b = outcome(fn, ref_q, *row), outcome(fn, port_q, *row)
        assert same(a, b), (form, row, a, b)
        saturated += a == math.inf
        finite += isinstance(a, float) and math.isfinite(a)
    assert finite > 50 and (form == "utilisation" or saturated > 50)


def test_queue_stats_equal():
    rng = np.random.default_rng(1)
    for _ in range(50):
        args = tuple(float(v) for v in rng.uniform(0.01, 3.0, 6))
        a, b = ref_q.QueueStats(*args), port_q.QueueStats(*args)
        assert (a.response, a.stable) == (b.response, b.stable)


def test_batched_erlang_c_matches_the_port_scalar():
    """The batched M/M/k of ``fleet.analytic_vec`` against the scalar oracle
    it is scored against, now in the port: 1e-9 relative (the reference's
    budget: the batched form sums its terms in log space). Rows within 1e-12
    below saturation are left out: the scalar counts them saturated (its
    ``_EPS`` margin), the batched form does not, in both packages alike."""
    rows = [(lam, mu, int(k)) for lam, mu, k, _, _ in queue_grid()
            if k >= 1 and k == int(k) and not k * mu - 1e-12 <= lam < k * mu]
    lam, mu, k = (np.array(c, dtype=np.float64) for c in zip(*rows))
    got = mmk_wait_erlang_vec(lam, mu, k, device="cpu")
    want = np.array([port_q.mmk_wait_erlang(*row) for row in rows])
    assert np.array_equal(np.isinf(got), np.isinf(want)) and np.isinf(want).sum() > 50
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9, atol=1e-12)


def test_core_exports_the_reference_names():
    assert set(port_core.__all__) == set(ref_core.__all__)
    assert port_core.mm1_wait is port_q.mm1_wait  # the scalar form, as in the reference


# ---------------------------------------------------------------------------
# split: the tandem model, the planner's argmin and sweep


def split_inputs(rng):
    """(workload, device, edge, network) from one seeded draw, built once from
    each package's core.latency."""
    lam = float(rng.uniform(0.5, 30.0))
    dreq, dres = (float(v) for v in rng.uniform(1e3, 3e5, 2))
    s_dev, s_edge = float(rng.uniform(0.005, 0.08)), float(rng.uniform(0.001, 0.03))
    k = float(rng.choice([1.0, 2.0, 4.0]))
    model = str(rng.choice(["DETERMINISTIC", "EXPONENTIAL"]))
    bw = float(10 ** rng.uniform(5, 8))

    def make(m):
        sm = getattr(m.ServiceModel, model)
        return (m.Workload(lam, dreq, dres), m.Tier("dev", s_dev, service_model=sm),
                m.Tier("edge", s_edge, parallelism_k=k, service_model=sm), m.NetworkPath(bw))

    return make(ref_lat), make(port_lat)


def test_split_latency_bit_equal():
    rng = np.random.default_rng(2)
    saturated = 0
    for i in range(200):
        (wl_r, d_r, e_r, n_r), (wl_p, d_p, e_p, n_p) = split_inputs(rng)
        dev_s, edge_s = float(rng.uniform(0, 0.05)) * (i % 5 != 0), float(rng.uniform(0, 0.02)) * (
            i % 7 != 0)
        inter = float(rng.uniform(0, 2e5)) * (i % 3 != 0)
        lam_edge = None if i % 2 else float(rng.uniform(0.5, 60.0))
        sp_r = ref_split.SplitPoint(dev_s, edge_s, inter, index=i)
        sp_p = port_split.SplitPoint(dev_s, edge_s, inter, index=i)
        a = ref_split.split_latency(wl_r, d_r, e_r, n_r, sp_r, edge_arrival_rate=lam_edge)
        b = port_split.split_latency(wl_p, d_p, e_p, n_p, sp_p, edge_arrival_rate=lam_edge)
        assert same(float(a), float(b))
        saturated += not math.isfinite(float(a))
        ba = ref_split.split_latency(wl_r, d_r, e_r, n_r, sp_r, edge_arrival_rate=lam_edge,
                                     breakdown=True)
        bb = port_split.split_latency(wl_p, d_p, e_p, n_p, sp_p, edge_arrival_rate=lam_edge,
                                      breakdown=True)
        assert same(float(ba.total), float(bb.total))
        assert list(ba.terms) == list(bb.terms)
        for k in ba.terms:
            assert same(float(ba.terms[k]), float(bb.terms[k])), k
    assert 0 < saturated < 200


def planner_inputs(seed):
    rng = np.random.default_rng(seed)
    (wl_r, d_r, e_r, n_r), (wl_p, d_p, e_p, n_p) = split_inputs(rng)
    L = int(rng.integers(1, 12))
    prof = [(float(rng.uniform(1e-4, 1e-2)), float(rng.uniform(1e-5, 4e-3)),
             float(rng.uniform(1e3, 4e5))) for _ in range(L)]
    planners = (ref_split.SplitPlanner([ref_split.LayerProfile(*p) for p in prof], wl_r),
                port_split.SplitPlanner([port_split.LayerProfile(*p) for p in prof], wl_p))
    return planners, (d_r, e_r, n_r), (d_p, e_p, n_p), L


@pytest.mark.parametrize("seed", range(6))
def test_split_planner_plan_and_sweep_equal(seed):
    (pr, pp), args_r, args_p, L = planner_inputs(seed)
    for lam_edge in (None, 3.0):
        a, b = pr.plan(*args_r, edge_arrival_rate=lam_edge), pp.plan(*args_p,
                                                                     edge_arrival_rate=lam_edge)
        assert (a.index, a.latency_s, a.strategy) == (b.index, b.latency_s, b.strategy)
        assert (a.point.dev_service_s, a.point.edge_service_s, a.point.inter_bytes,
                a.point.index) == (b.point.dev_service_s, b.point.edge_service_s,
                                   b.point.inter_bytes, b.point.index)
        sa = pr.sweep(*args_r, edge_arrival_rate=lam_edge)
        sb = pp.sweep(*args_p, edge_arrival_rate=lam_edge)
        assert sa.shape == sb.shape == (L + 1,) and np.array_equal(sa, sb, equal_nan=True)
    for idx in (-1, L + 1):
        assert outcome(pr.candidate, idx) is outcome(pp.candidate, idx) is IndexError


# ---------------------------------------------------------------------------
# service time: profile, roofline, the fitted parallelism k


def test_from_profile_and_roofline_equal():
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 500):
        samples = list(rng.lognormal(-4.0, 0.5, n))
        a, b = ref_st.from_profile(samples), port_st.from_profile(samples)
        assert (a.mean_s, a.var_s, a.n_samples, a.source) == (b.mean_s, b.var_s, b.n_samples,
                                                             b.source)
        ta, tb = a.as_tier("t", k=2.5), b.as_tier("t", k=2.5)
        assert (ta.name, ta.service_time_s, ta.parallelism_k, ta.service_model.value,
                ta.service_var) == (tb.name, tb.service_time_s, tb.parallelism_k,
                                    tb.service_model.value, tb.service_var)
    assert outcome(ref_st.from_profile, []) is outcome(port_st.from_profile, []) is ValueError
    for _ in range(100):
        fl, by, coll = (float(v) for v in 10 ** rng.uniform(6, 15, 3))
        kw = dict(peak_flops=float(10 ** rng.uniform(12, 15)), hbm_bw=float(10 ** rng.uniform(11, 13)),
                  collective_s=coll * 1e-15, efficiency=float(rng.uniform(0.05, 1.0)))
        a, b = ref_st.from_roofline(fl, by, **kw), port_st.from_roofline(fl, by, **kw)
        assert (a.mean_s, a.var_s, a.n_samples, a.source) == (b.mean_s, b.var_s, b.n_samples,
                                                             b.source)
    for bad in (dict(peak_flops=0.0, hbm_bw=1.0), dict(peak_flops=1.0, hbm_bw=-1.0),
                dict(peak_flops=1.0, hbm_bw=1.0, efficiency=0.0),
                dict(peak_flops=1.0, hbm_bw=1.0, efficiency=1.5)):
        assert outcome(ref_st.from_roofline, 1.0, 1.0, **bad) is outcome(
            port_st.from_roofline, 1.0, 1.0, **bad) is ValueError


@pytest.mark.parametrize("model", ["DETERMINISTIC", "EXPONENTIAL"])
@pytest.mark.parametrize("seed", range(3))
def test_fit_parallelism_bit_equal(model, seed):
    rng = np.random.default_rng(10 + seed)
    s = float(rng.uniform(0.005, 0.05))
    k_true = float(rng.uniform(1.0, 6.0))
    lam = np.linspace(0.1, 0.95 * k_true / s, int(rng.integers(3, 12)))
    tier = ref_lat.Tier("x", s, parallelism_k=k_true, service_model=getattr(ref_lat.ServiceModel,
                                                                             model))
    obs = (np.asarray(ref_lat.proc_wait(tier, lam)) + s) * (1 + 0.02 * rng.normal(size=lam.size))
    a = ref_st.fit_parallelism(list(lam), list(obs), s,
                               service_model=getattr(ref_lat.ServiceModel, model))
    b = port_st.fit_parallelism(list(lam), list(obs), s,
                                service_model=getattr(port_lat.ServiceModel, model))
    assert a == b and abs(a - k_true) < 0.5 * k_true
    # a grid the fit cannot satisfy (every k saturates somewhere) and bad input
    far = [1e4, 2e4]
    assert ref_st.fit_parallelism(far, [1.0, 1.0], s, iters=5) == port_st.fit_parallelism(
        far, [1.0, 1.0], s, iters=5)
    assert outcome(ref_st.fit_parallelism, [1.0], [], s) is outcome(
        port_st.fit_parallelism, [1.0], [], s) is ValueError


# ---------------------------------------------------------------------------
# the learned predictor


def roofline_law(seed=0, n=512):
    """The reference test's synthetic law (tests/test_system.py), with the
    H100's data-sheet peaks in it: latency = max(FLOPs / peak, bytes / HBM
    rate) with 5% noise."""
    rng = np.random.default_rng(seed)
    flops = 10 ** rng.uniform(9, 13, n)
    pbytes = 10 ** rng.uniform(6, 10, n)
    abytes = 10 ** rng.uniform(6, 9, n)
    batch = rng.integers(1, 64, n)
    seq = rng.integers(64, 4096, n)
    lat = np.maximum(flops / 989e12, pbytes / 3.35e12) * (1 + 0.05 * rng.normal(size=n))
    lat = np.abs(lat) + 1e-6
    X = np.stack([ref_pred.workload_features(f, p, a, b, s)
                  for f, p, a, b, s in zip(flops, pbytes, abytes, batch, seq)])
    return X, lat


def ref_init(seed=0):
    return [{k: np.asarray(v) for k, v in layer.items()}
            for layer in ref_pred.LatencyPredictor(seed=seed).params]


def fit_recording(monkeypatch, module, make, X, y, steps, loss_of):
    """Fit ``make()`` for ``steps`` steps, recording each step's loss through
    a spy on the module's ``_loss``."""
    losses = []
    orig = module._loss

    def spy(*args):
        val = orig(*args)
        loss_of(val, losses)
        return val

    monkeypatch.setattr(module, "_loss", spy)
    pred = make()
    final = pred.fit(X, y, steps=steps, lr=FIT_LR)
    monkeypatch.setattr(module, "_loss", orig)
    return pred, final, np.array(losses)


def ref_loss(val, out):
    jax.debug.callback(lambda v: out.append(float(v)), val)


def port_loss(val, out):
    out.append(float(val.detach()))


def port_from_ref_init():
    p = port_pred.LatencyPredictor(seed=0, device="cpu")
    p.load_state_dict(predictor_params_from_jax(ref_init()))
    return p


@pytest.fixture(scope="module")
def fitted():
    """Both predictors fitted the reference test's way from the reference's
    init, with their per-step losses."""
    X, lat = roofline_law()
    mp = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = fit_recording(mp, ref_pred, lambda: ref_pred.LatencyPredictor(seed=0),
                            X[:N_TRAIN], lat[:N_TRAIN], FIT_STEPS, ref_loss)
        port = fit_recording(mp, port_pred, port_from_ref_init, X[:N_TRAIN], lat[:N_TRAIN],
                             FIT_STEPS, port_loss)
    finally:
        torch.set_num_threads(threads)
        mp.undo()
    return X, lat, ref, port


def test_predictor_losses_track_the_reference(fitted):
    _, _, (_, ref_final, ref_l), (_, port_final, port_l) = fitted
    assert ref_l.shape == port_l.shape == (FIT_STEPS,)
    np.testing.assert_allclose(port_l[:50], ref_l[:50], rtol=LOSS_RTOL, atol=0)
    assert port_final == pytest.approx(ref_final, rel=1e-3)  # the last step, after 2,500


def test_predictor_predictions_track_the_reference(fitted):
    X, lat, (ref, _, _), (port, _, _) = fitted
    held = X[N_TRAIN:]
    a, b = ref.predict(held), port.predict(held)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (512 - N_TRAIN,)
    np.testing.assert_allclose(b, a, rtol=PRED_RTOL, atol=0)
    one_a, one_b = ref.predict(held[0]), port.predict(held[0])
    assert type(one_a) is type(one_b) is np.float32
    assert one_b == pytest.approx(one_a, rel=PRED_RTOL)
    assert ref.mape(held, lat[N_TRAIN:]) < 25.0 and port.mape(held, lat[N_TRAIN:]) < 25.0


def test_exact_gelu_would_break_the_loss_tolerance(fitted, monkeypatch):
    """The reference's GELU is jax.nn.gelu's tanh form; the exact erf form
    parts from it in the first steps by far more than LOSS_RTOL."""
    X, lat, (_, _, ref_l), _ = fitted
    exact = types.SimpleNamespace(gelu=lambda x, approximate="none": torch.nn.functional.gelu(x))
    monkeypatch.setattr(port_pred, "F", exact)
    _, _, erf_l = fit_recording(monkeypatch, port_pred, port_from_ref_init, X[:N_TRAIN],
                                lat[:N_TRAIN], 50, port_loss)
    rel = np.abs(erf_l - ref_l[:50]) / np.abs(ref_l[:50])
    assert rel.max() > 100 * LOSS_RTOL, rel.max()


def test_minibatch_indices_are_the_reference_draws():
    for n, steps, batch, seed in ((448, 30, 256, 0), (100, 7, 256, 3), (5, 4, 2, 9), (9, 0, 4, 1)):
        rng = np.random.default_rng(seed)
        expect = [rng.integers(0, n, size=min(batch, n)) for _ in range(steps)]
        got = port_pred.minibatch_indices(n, steps, batch, seed)
        assert got.shape == (steps, min(batch, n))
        assert all(np.array_equal(g, e) for g, e in zip(got, expect))


def test_workload_features_bit_equal():
    rng = np.random.default_rng(4)
    for _ in range(50):
        f, p, a = (float(v) for v in 10 ** rng.uniform(-1, 15, 3))
        b, s = int(rng.integers(0, 64)), int(rng.integers(0, 8192))
        x, y = ref_pred.workload_features(f, p, a, b, s), port_pred.workload_features(f, p, a, b, s)
        assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)


def test_predictor_init_is_he_normal_from_its_seed():
    a = port_pred.LatencyPredictor(seed=0, device="cpu")
    b = port_pred.LatencyPredictor(seed=0, device="cpu")
    c = port_pred.LatencyPredictor(seed=1, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.w[0], c.w[0])
    big = port_pred.LatencyPredictor(n_features=400, hidden=(300,), seed=0, device="cpu")
    assert big.w[0].dtype == torch.float32 and big.w[0].shape == (400, 300)
    assert float(big.w[0].detach().std()) == pytest.approx(math.sqrt(2.0 / 400), rel=0.02)
    assert all(not bias.detach().any() for bias in big.b)
    assert sorted(a.state_dict()) == sorted(predictor_params_from_jax(ref_init()))


def test_predictor_refuses_what_the_reference_refuses():
    p = port_pred.LatencyPredictor(device="cpu")
    with pytest.raises(RuntimeError, match="not fitted"):
        p.predict(np.zeros(5, np.float32))
    with pytest.raises(ValueError):
        p.fit(np.zeros((4, 5)), np.ones(3))


def test_predictor_without_a_card_raises_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_pred.LatencyPredictor()
    assert port_pred.LatencyPredictor(device="cpu").device.type == "cpu"
