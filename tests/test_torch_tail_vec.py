"""The port's batched tails (``fleet/euler_vec.py``, ``fleet/tail_vec.py``) on
the CPU, against the JAX package's batched tails and the port's own scalar
tail layer.

Station fields are drawn from numpy seeds and handed to both packages. The
reference's x64 paths run under a scoped ``jax.enable_x64(True)`` (its
``jax.experimental.enable_x64`` is gone in JAX 0.9.0: ROADMAP C1).

Tolerances, each with its reason:
  * ``cdf_pdf_vec`` and ``quantile_euler_vec`` against the reference: 1e-10
    relative. Both sides evaluate the same complex128 contour sums; XLA,
    torch and numpy round a complex product or quotient an ulp apart, and
    the Euler sum of 27 terms of size up to e^{A/2} ~ 1e4 scales that to
    ~1e-12 of a CDF value. The quantile trajectory is the same, so its
    result moves by the same order.
  * ``fleet_tail`` against the reference on the corpus: 1e-8 (the harness's
    tail-euler-vec contract), ``best_edge`` equal. Only stations whose
    dominant pole stands alone: on a pole shared within ``POLE_GAP_REL`` the
    reference's asymptote is wrong (ROADMAP C2-C4) and the port resolves the
    quantile on the Euler path instead (C7).
  * ``fleet_tail`` against the port's scalar ``analytic_tail`` on every corpus
    entry and on the shared-pole cases: 1e-8 for Euler (the same trajectory),
    1e-6 for the asymptote (the differential harness's batched-vs-scalar
    budget; separated poles agree to ~1e-14, shared ones take the Euler path
    on both sides).
"""

import math

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import ScenarioBatch as JScenarioBatch
from repro.fleet import euler_vec as j_euler_vec
from repro.fleet import tail_vec as j_tail_vec
from repro.validate import load_corpus as j_load_corpus
from repro_torch.core import tail as T
from repro_torch.core.latency import NetworkPath, ServiceModel, Tier, Workload
from repro_torch.core.scenario import EdgeSpec, Scenario, analytic_tail, tail_stations
from repro_torch.fleet import ScenarioBatch, fleet_tail
from repro_torch.fleet import euler_vec, tail_vec
from repro_torch.validate import load_corpus

KEYS = tail_vec.STATION_KEYS
VS_REFERENCE_RTOL = 1e-10
EULER_RTOL = 1e-8
ASYMPTOTE_RTOL = 1e-6


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


def _draw_stations(seed: int, rows: int, n_slots: int, kinds=(0, 1, 2), nic=False) -> dict:
    """(rows, n_slots) station fields: service means 10-200 ms, k of 1 or 2,
    utilisations 0.05-0.85, gamma cv^2 0.1-2 (the wait variance unscaled,
    as ``proc_station`` keeps it). ``nic`` makes slots 0 and 2 of a tandem
    NIC stations: exponential, ``wmean == fmean``."""
    rng = np.random.default_rng(seed)
    shape = (rows, n_slots)
    kind = rng.choice(np.asarray(kinds, dtype=np.int64), shape)
    fmean = rng.uniform(0.01, 0.2, shape)
    k = rng.choice([1.0, 2.0], shape)
    if nic:
        kind[:, [0, 2]] = T.KIND_EXP
        k[:, [0, 2]] = 1.0
    wmean = fmean / k
    lam = rng.uniform(0.05, 0.85, shape) / wmean
    var = np.where(kind == T.KIND_GAMMA, rng.uniform(0.1, 2.0, shape) * fmean**2, 0.0)
    return {"lam": lam, "wkind": kind, "wmean": wmean, "wvar": var, "fkind": kind,
            "fmean": fmean, "fvar": var}


def _torch(st: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in st.items()}


def _scalar_rows(st: dict) -> list[list[T.Station]]:
    rows, n_slots = st["lam"].shape
    return [[T.Station(*(float(st[k][i, s]) if k[1:] != "kind" else int(st[k][i, s])
                         for k in KEYS)) for s in range(n_slots)] for i in range(rows)]


def _shared(stations: list[T.Station]) -> bool:
    """Does the row's dominant pole have a candidate within POLE_GAP_REL?"""
    cands = [(T._wait_pole(st), i, True) for i, st in enumerate(stations)] + [
        (1.0 / st.fmean if st.fkind == T.KIND_EXP and st.fmean > 0 else math.inf, i, False)
        for i, st in enumerate(stations)]
    return math.isfinite(min(c[0] for c in cands)) and T.shares_dominant_pole(cands)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    both_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
    return np.where(both_inf, 0.0, np.abs(a - b) / np.maximum(np.abs(b), 1e-300))


# ---------------------------------------------------------------------------
# the Euler inversion against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_slots,hints", [(1, None), (1, ("det",)), (3, None),
                                           (3, ("nic", None, "nic"))])
def test_cdf_pdf_and_quantile_equal_the_reference(n_slots, hints):
    kinds = (0, 1, 2) if hints is None else (0,)
    st = _draw_stations(7 + n_slots, 64, n_slots, kinds, nic=hints is not None and n_slots == 3)
    mean = euler_vec._sojourn_mean_vec(_torch(st)).numpy()
    t = mean * np.random.default_rng(3).uniform(0.5, 4.0, mean.shape)
    got_cdf, got_pdf = euler_vec.cdf_pdf_vec(_torch(st), torch.as_tensor(t), hints)
    got_q = euler_vec.quantile_euler_vec(_torch(st), 0.99, hints)
    with jax.enable_x64(True):
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        want_cdf, want_pdf = j_euler_vec.cdf_pdf_vec(jst, jnp.asarray(t), hints)
        want_q = j_euler_vec.quantile_euler_vec(jst, 0.99, hints)
        want_cdf, want_pdf, want_q = (np.asarray(a) for a in (want_cdf, want_pdf, want_q))
    assert 0.2 < np.median(want_cdf) < 1.0
    np.testing.assert_allclose(got_cdf.numpy(), want_cdf, rtol=VS_REFERENCE_RTOL)
    # the density is clipped at 0 where inversion noise dips negative: 1e-10
    # of the largest density of the draw, where it sits near that floor
    np.testing.assert_allclose(got_pdf.numpy(), want_pdf, rtol=VS_REFERENCE_RTOL,
                               atol=VS_REFERENCE_RTOL * want_pdf.max())
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=VS_REFERENCE_RTOL)


def test_quantile_equals_the_scalar_trajectory_on_every_kind():
    st = _draw_stations(11, 48, 3)
    got = euler_vec.quantile_euler_vec(_torch(st), 0.95).numpy()
    want = [T._quantile_euler(row, 0.95) for row in _scalar_rows(st)]
    assert _rel(got, want).max() <= EULER_RTOL


@pytest.mark.parametrize("method", ["euler", "asymptote"])
def test_sojourn_quantile_vec_equals_the_port_scalar(method):
    st = _draw_stations(13, 96, 3)
    rows = _scalar_rows(st)
    got = tail_vec.sojourn_quantile_vec(_torch(st), 0.99, method=method).numpy()
    want = [T.sojourn_quantile(row, 0.99, method=method) for row in rows]
    tol = EULER_RTOL if method == "euler" else ASYMPTOTE_RTOL
    assert _rel(got, want).max() <= tol
    separated = np.array([not _shared(row) for row in rows])
    assert separated.sum() >= 48  # most random tandems: the reference's arithmetic applies
    if method == "asymptote":
        with jax.enable_x64(True):
            jst = {k: jnp.asarray(v) for k, v in st.items()}
            ref = np.asarray(j_tail_vec.sojourn_quantile_vec(jst, 0.99, method=method))
        assert _rel(got[separated], ref[separated]).max() <= VS_REFERENCE_RTOL


# the C2 falsifying cases (ROADMAP C2, tests/test_torch_tail.py): identical
# tandem stations share a double pole
C2_STATIONS = {
    "md1_lam1_mean05_x2": [T.proc_station(1.0, T.KIND_DET, 0.5, 0.0)] * 2,
    "det_rho04375_x2": [T.proc_station(0.4375, T.KIND_DET, 1.0, 0.0)] * 2,
}


@pytest.mark.parametrize("name", sorted(C2_STATIONS))
@pytest.mark.parametrize("q", [0.9, 0.99, T.EULER_Q_MAX, 1.0 - 1e-7])
def test_shared_poles_take_the_euler_path_as_the_scalar_does(name, q):
    """Up to ``EULER_Q_MAX`` the two Euler trajectories agree to 1e-8. Past
    it (where the scalar keeps a shared pole on the Euler path too) 1 - q
    nears the inversion's ~1e-8 noise floor, the quantile is an estimate and
    the two agree to the asymptote's 1e-6 budget."""
    sts = C2_STATIONS[name]
    st = {k: torch.tensor([[getattr(s, k) for s in sts]],
                          dtype=torch.int64 if k[1:] == "kind" else torch.float64)
          for k in KEYS}
    assert _shared(sts)
    got = float(tail_vec.sojourn_quantile_vec(st, q, method="asymptote")[0])
    want = T.sojourn_quantile(sts, q, method="asymptote")
    tol = EULER_RTOL if q <= T.EULER_Q_MAX else ASYMPTOTE_RTOL
    assert math.isfinite(got) and abs(got - want) <= tol * want


# ---------------------------------------------------------------------------
# fleet_tail over ScenarioBatch columns
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus_batches():
    entries, _ = load_corpus()
    j_entries, _ = j_load_corpus()
    return (entries, ScenarioBatch.from_scenarios([e.scenario for e in entries]),
            JScenarioBatch.from_scenarios([e.scenario for e in j_entries]))


def _c2_scenarios() -> list[Scenario]:
    """Offload paths whose two NIC stations are identical (request and result
    of equal size, no background): their wait poles coincide, and on a thin
    pipe they are the dominant ones — the C2 shape in a scenario."""
    out = []
    for bw in (4e5, 6e5):
        out.append(Scenario(
            workload=Workload(arrival_rate=2.0, req_bytes=80_000, res_bytes=80_000, name="c2"),
            device=Tier("slow", 0.4),
            edges=(EdgeSpec(Tier("fast", 0.01)),),
            network=NetworkPath(bw),
            name=f"c2-shared-nic-{bw:g}",
        ))
    return out


@pytest.mark.parametrize("method", ["euler", "asymptote"])
def test_fleet_tail_equals_the_reference_where_poles_stand_apart(corpus_batches, method, x64):
    entries, batch, jbatch = corpus_batches
    got = fleet_tail(batch, 0.99, method=method, device="cpu")
    want = j_tail_vec.fleet_tail(jbatch, 0.99, method=method)
    np.testing.assert_array_equal(got.best_edge, want.best_edge)
    checked = total = 0
    for i, e in enumerate(entries):
        for j, strategy in enumerate(["on_device"] + [f"edge[{k}]" for k in
                                                      range(len(e.scenario.edges))]):
            total += 1
            if _shared(list(tail_stations(e.scenario, strategy))):
                continue
            g = got.t_dev[i] if j == 0 else got.t_edge[i, j - 1]
            w = want.t_dev[i] if j == 0 else want.t_edge[i, j - 1]
            assert _rel(g, w) <= EULER_RTOL, (e.name, strategy, g, w)
            checked += 1
    assert checked == total  # no corpus path shares its dominant pole


@pytest.mark.parametrize("method", ["euler", "asymptote"])
def test_fleet_tail_equals_the_port_scalar_on_the_corpus_and_c2(corpus_batches, method):
    entries, _, _ = corpus_batches
    scenarios = [e.scenario for e in entries] + _c2_scenarios()
    got = fleet_tail(ScenarioBatch.from_scenarios(scenarios), 0.99, method=method,
                     device="cpu")
    tol = EULER_RTOL if method == "euler" else ASYMPTOTE_RTOL
    for i, scn in enumerate(scenarios):
        want = analytic_tail(scn, 0.99, method=method)
        for k, v in want.items():
            assert _rel(got.totals(i)[k], v) <= tol, (scn.name, k, got.totals(i)[k], v)
    c2 = scenarios[-1]
    assert _shared(list(tail_stations(c2, "edge[0]")))  # the C2 shape is exercised
    assert got.strategy_names()[-1] in ("on_device", "edge[0]")


def test_fleet_tail_mm1_exact_unstable_inf_and_refusals():
    mm1 = Scenario(
        workload=Workload(arrival_rate=4.0, req_bytes=1_000, res_bytes=0, name="mm1"),
        device=Tier("exp", 0.1, service_model=ServiceModel.EXPONENTIAL),
        edges=(EdgeSpec(Tier("e", 0.05)),),
        network=NetworkPath(1e6),
        name="mm1",
    )
    hot = Scenario(
        workload=Workload(arrival_rate=12.0, req_bytes=1_000, res_bytes=0, name="hot"),
        device=Tier("exp", 0.1, service_model=ServiceModel.EXPONENTIAL),
        edges=(EdgeSpec(Tier("e", 0.05)),),
        network=NetworkPath(1e6),
        allow_unstable=True,
        name="hot",
    )
    batch = ScenarioBatch.from_scenarios([mm1, hot])
    for method in ("euler", "asymptote"):
        p = fleet_tail(batch, 0.99, method=method, device="cpu")
        assert p.t_dev[0] == pytest.approx(-math.log(0.01) / (10.0 - 4.0), rel=1e-15)
        assert math.isinf(p.t_dev[1]) and math.isfinite(p.t_edge[1, 0])
        assert list(p.best_edge) == [0, 0] and p.size == 2
    with pytest.raises(ValueError, match="quantile"):
        fleet_tail(batch, 1.0, device="cpu")
    with pytest.raises(ValueError, match="method"):
        fleet_tail(batch, 0.99, method="exact", device="cpu")
    with pytest.raises(ValueError, match="method"):
        tail_vec.sojourn_quantile_vec(_torch(_draw_stations(0, 2, 1)), 0.9, method="exact")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            fleet_tail(batch, 0.99)



def test_a_converged_newton_iterate_stays():
    """ROADMAP C9, on a row of the fleet sweep's grid (an M/D/1 edge at rho
    0.39 between two fast NICs): the Newton phase converges and CDF(t) - q
    lands on 0.0 exactly in the scalar and on 4e-14 in the batched path. The
    reference's strict safeguard then rejects the step, which lands on an end
    of the bracket, and jumps to the midpoint of a bracket 3.4e-6 s wide; the
    port keeps the converged iterate on both paths, which then agree to float
    noise, and its quantile is a root of the inverted CDF."""
    from repro.core import tail as JT
    from repro.core.scenario import tail_stations as j_tail_stations
    from repro.launch import fleet_sweep as j_fleet_sweep
    from repro_torch.launch import fleet_sweep

    row = {"workload.arrival_rate": 14.035294117647059,
           "network.bandwidth_Bps": 11655642.101912595}
    scn, jscn = fleet_sweep.default_scenario(), j_fleet_sweep.default_scenario()
    for path, value in row.items():
        scn, jscn = scn.replaced(path, value), jscn.replaced(path, value)
    sts = list(tail_stations(scn, "edge[0]"))
    port = T.sojourn_quantile(sts, 0.99)
    batched = fleet_tail(ScenarioBatch.from_scenarios([scn]), 0.99, device="cpu").t_edge[0, 0]
    ref = JT.sojourn_quantile(list(j_tail_stations(jscn, "edge[0]")), 0.99)
    assert _rel(batched, port) <= EULER_RTOL
    assert abs(float(T.sojourn_cdf(sts, port)) - 0.99) <= 1e-12
    assert abs(float(T.sojourn_cdf(sts, ref)) - 0.99) > 1e-7  # the midpoint, for the record
    assert 1e-6 < _rel(ref, port) < 1e-4
