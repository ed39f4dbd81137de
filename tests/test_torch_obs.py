"""The port's ``obs`` (tracer, metrics, audits, manifest delta, report) and
its hooks in the engine, the harness, the replay and the closed-loop cluster,
on the CPU against the JAX package's.

Both packages get the same calls on the same inputs, drawn from numpy seeds.
Tolerances, each with its reason:
  * tracer and audit JSONL, the Chrome export, metrics ``render()`` and the
    report's text: equal bytes (the same pure-Python code over the same
    floats; the audits come from the port's numpy ``core``, the reference's
    numpy copy of the same formulas);
  * histogram percentiles: exact (the same log buckets);
  * the harness's engine trace on the simulated clock: equal bytes (every
    stamp is the timer's seeded draw; no token value reaches a span);
  * the closed-loop cluster's decide spans and ``audit_cluster`` rows:
    ``epoch``, ``t``, ``dur``, ``offloaded``, ``on_device``, the chosen targets
    and the row keys exact; latencies and terms ``CLOSED_FORM_RTOL`` = 1e-9
    relative (the closed forms in float64; XLA and torch may round an ulp
    apart, as ``tests/test_torch_cluster.py`` holds them). Each audit log
    passes ``verify()`` at its 1e-9 re-sum budget.
The reference's cluster runs in x64 through the ``x64`` fixture (a scoped
``jax.enable_x64(True)`` in place of ``jax.experimental.enable_x64``, gone in
JAX 0.9.0: ROADMAP C1), and the port's run is handed the reference's own
Poisson counts (``cluster._poisson_counts``), as in
``tests/test_torch_cluster.py``.
"""

import json
import math

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.core import EdgeSpec as JEdgeSpec
from repro.core import NetworkPath as JNetworkPath
from repro.core import Scenario as JScenario
from repro.core import ServiceModel as JServiceModel
from repro.core import TenantStream as JTenantStream
from repro.core import Tier as JTier
from repro.core import Workload as JWorkload
from repro.core.scenario import ClusterSpec as JClusterSpec
from repro.fleet import cluster as jc
from repro.fleet import traces as j_traces
from repro.fleet.replay import replay as j_replay
from repro.measure import HarnessConfig as JHarnessConfig
from repro.measure import run_harness as j_run_harness
from repro.serving.gateway import OffloadGateway as JOffloadGateway
import repro_torch.obs as pobs
from repro_torch.core import Scenario
from repro_torch.core.scenario import ClusterSpec
from repro_torch.fleet import cluster as pc
from repro_torch.fleet import replay, simulate_cluster, traces
from repro_torch.measure import HarnessConfig, run_harness
from repro_torch.serving.gateway import OffloadGateway

CLOSED_FORM_RTOL = 1e-9


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


def test_exports_are_the_references():
    assert pobs.__all__ == jobs.__all__
    from repro.obs import audit as ja
    from repro.obs import tracer as jt
    from repro_torch.obs import audit as pa
    from repro_torch.obs import tracer as pt

    assert pt.CATEGORIES == jt.CATEGORIES
    assert (pa.DEVICE_TERMS, pa.EDGE_TERMS) == (ja.DEVICE_TERMS, ja.EDGE_TERMS)
    assert pobs.Histogram.GROWTH == jobs.Histogram.GROWTH


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def _populate(tr, seed: int) -> None:
    """Seeded spans and instants on a few tracks, with every attribute kind
    a producer passes (int, float, str, bool, numpy scalars, non-finite)."""
    rng = np.random.default_rng(seed)
    tracks = ["engine", "edge[0]", "req[3]", "gateway"]
    for i in range(40):
        t = float(rng.uniform(0.0, 10.0))
        kind = int(rng.integers(0, 4))
        track = tracks[int(rng.integers(0, len(tracks)))]
        if kind == 0:
            tr.instant(t=t, name="respond", cat="respond", track=track, rid=i,
                       latency_s=float(rng.exponential(0.1)), tokens=int(rng.integers(1, 9)))
        elif kind == 1:
            tr.span(t=t, dur=float(rng.exponential(0.02)), name="decode", cat="decode",
                    track=track, occupancy=np.int64(rng.integers(1, 5)), compile=bool(i % 2))
        elif kind == 2:
            tr.span(t=np.float64(t), dur=float(rng.exponential(0.01)), name="transfer:request",
                    cat="transfer", track=track, bytes=int(rng.integers(1, 10**6)),
                    bandwidth_Bps=np.float64(rng.uniform(1e5, 1e7)))
        else:
            tr.instant(t=t, name="decide", cat="decide", track=track, epoch=i,
                       target="on_device" if i % 3 else "edge[1]",
                       predicted_latency_s=[float("inf"), float("nan"), -float("inf"),
                                            float(rng.uniform(0, 1))][i % 4])


@pytest.mark.parametrize("seed", [0, 1])
def test_tracer_exports_equal_the_references(seed, tmp_path):
    got, want = pobs.Tracer(), jobs.Tracer()
    _populate(got, seed)
    _populate(want, seed)
    text = got.to_jsonl()
    assert text == want.to_jsonl() and len(got) == len(want) == 40
    assert got.to_chrome() == want.to_chrome()
    assert got.tracks() == want.tracks()
    for cat in ("decide", "decode", "respond", "transfer"):
        assert [s.to_dict() for s in got.by_cat(cat)] == [s.to_dict() for s in want.by_cat(cat)]
    # the files, byte for byte, and each package reads the other's JSONL back
    got.write_chrome(tmp_path / "p.json")
    want.write_chrome(tmp_path / "j.json")
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert pobs.Tracer.from_jsonl(want.to_jsonl()).to_jsonl() == text
    assert jobs.Tracer.from_jsonl(text).to_jsonl() == text
    back = pobs.Tracer.read_jsonl(got.write_jsonl(tmp_path / "p.jsonl"))
    assert back.to_jsonl() == text


def test_disabled_tracer_records_nothing():
    got, want = pobs.Tracer(enabled=False), jobs.Tracer(enabled=False)
    _populate(got, 0)
    _populate(want, 0)
    assert len(got) == len(want) == 0 and got.to_jsonl() == ""
    assert got.to_chrome() == want.to_chrome() == {"traceEvents": [], "displayTimeUnit": "ms"}


def test_merge_sorts_by_start_time_as_the_reference():
    def build(mod, seed):
        a, b = mod.Tracer(), mod.Tracer()
        _populate(a, seed)
        _populate(b, seed + 10)
        b.span(t=a.spans[0].t, dur=0.5, name="tie", cat="c", track="t")  # stable on ties
        return mod.merge([a, b])

    got, want = build(pobs, 3), build(jobs, 3)
    assert got.to_jsonl() == want.to_jsonl()
    ts = [s.t for s in got.spans]
    assert ts == sorted(ts)


def test_nonfinite_attrs_are_canonicalised():
    got, want = pobs.Tracer(), jobs.Tracer()
    for tr in (got, want):
        tr.instant(name="x", cat="c", t=0.0, track="t", val=float("inf"), low=-float("inf"),
                   bad=float("nan"), n=np.int64(3), f=np.float64(0.25), ok=np.bool_(True))
    assert dict(got.spans[0].attrs) == {"val": "inf", "low": "-inf", "bad": "nan", "n": 3,
                                        "f": 0.25, "ok": True}
    assert got.to_jsonl() == want.to_jsonl()
    assert pobs.Tracer.from_jsonl(got.to_jsonl()).to_jsonl() == got.to_jsonl()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _samples(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "lognormal":
        return rng.lognormal(-3.0, 1.0, 700)
    if kind == "with_zeros":
        v = rng.exponential(0.05, 300)
        v[rng.random(300) < 0.2] = 0.0
        return v
    return np.geomspace(1e-4, 10.0, 257)


@pytest.mark.parametrize("kind,seed", [("lognormal", 0), ("with_zeros", 1), ("geom", 2)])
def test_histogram_equals_the_references(kind, seed):
    got, want = pobs.Histogram(), jobs.Histogram()
    for v in _samples(kind, seed):
        got.record(float(v))
        want.record(float(v))
    for name in ("count", "sum", "mean", "min", "max", "p50", "p99"):
        assert getattr(got, name) == getattr(want, name), name
    for q in np.linspace(0.01, 0.99, 37):
        assert got.percentile(float(q)) == want.percentile(float(q))
    for bad in (0.0, 1.0, -0.5):
        with pytest.raises(ValueError):
            got.percentile(bad)
    for bad in (float("inf"), float("nan")):
        with pytest.raises(ValueError):
            got.record(bad)
    empty = pobs.Histogram()
    assert (empty.mean, empty.min, empty.max, empty.p99) == (0.0, 0.0, 0.0, 0.0)


def _fill_registry(reg, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for i in range(25):
        reg.counter(f"c.{i % 3}").inc(int(rng.integers(0, 4)))
        reg.gauge(f"g.{i % 4}").set(float(rng.normal(0.0, 1e6)))
        reg.histogram(f"h.{i % 2}").record(float(rng.exponential(0.01)))
    reg.gauge("g.unset")  # created, never set


def test_counter_gauge_and_registry_equal_the_references():
    got, want = pobs.MetricsRegistry(), jobs.MetricsRegistry()
    _fill_registry(got, 5)
    _fill_registry(want, 5)
    assert got.snapshot() == want.snapshot()
    assert got.render() == want.render()
    assert got.render(prefix="x.") == want.render(prefix="x.")
    assert got.counter("c.0") is got.counter("c.0")
    with pytest.raises(ValueError):
        got.counter("c.0").inc(-1)
    with pytest.raises(ValueError):
        got.gauge("g.0").set(float("nan"))
    assert pobs.MetricsRegistry().render() == ""


# ---------------------------------------------------------------------------
# audits: the manager's sweeps, the gateway, the replay, the cluster
# ---------------------------------------------------------------------------


def _scn_pair(model="EXPONENTIAL", k=1.0, var=0.0, *, return_results=True):
    """obs-test's two-edge scenario in each package (``tests/test_obs.py``)."""
    jm = getattr(JServiceModel, model)
    jscn = JScenario(
        workload=JWorkload(arrival_rate=10.0, req_bytes=25_000, res_bytes=2_000),
        device=JTier("dev", 0.035, service_model=JServiceModel.DETERMINISTIC),
        edges=(
            JEdgeSpec(JTier("e0", 0.008, parallelism_k=k, service_model=jm, service_var=var)),
            JEdgeSpec(JTier("e1", 0.012, parallelism_k=k, service_model=jm, service_var=var),
                      background=(JTenantStream(6.0, 0.01, 2e-5),)),
        ),
        network=JNetworkPath(bandwidth_Bps=2.5e6),
        return_results=return_results,
        name="obs-test",
    )
    return Scenario.from_dict(jscn.to_dict()), jscn


def _metrics(scn, bw):
    return {"workload": scn.workload, "lam_dev": scn.workload.arrival_rate,
            "bandwidth_Bps": bw, "edges": [e.to_state(scn.workload) for e in scn.edges]}


SWEEPS = {
    "mean-hysteresis": (dict(hysteresis=0.1), "EXPONENTIAL", True),
    "mean-general-k4": (dict(), "GENERAL", True),
    "mean-no-results": (dict(), "DETERMINISTIC", False),
    "slo-p99-asymptote": (dict(slo_quantile=0.99, tail_method="asymptote"), "EXPONENTIAL", True),
}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_manager_sweep_audits_equal_the_references(case):
    """A bandwidth sweep through the crossover (dead link included): the
    audit JSONL, decide spans and flips equal the reference's."""
    kw, model, rr = SWEEPS[case]
    k, var = (4.0, 2.5e-5) if model == "GENERAL" else (1.0, 0.0)
    scn, jscn = _scn_pair(model, k, var, return_results=rr)
    logs, spans = [], []
    for s in (scn, jscn):
        mod = pobs if s is scn else jobs
        auditor, tracer = mod.AuditLog(), mod.Tracer()
        mgr = s.manager(auditor=auditor, tracer=tracer, **kw)
        for i in range(40):
            bw = 0.0 if i == 7 else 2.5e6 * (0.1 + 1.9 * (i % 20) / 19.0)
            mgr.step(float(i), _metrics(s, bw))
        logs.append(auditor)
        spans.append(tracer)
    got, want = logs
    assert got.to_jsonl() == want.to_jsonl()
    assert spans[0].to_jsonl() == spans[1].to_jsonl()
    assert got.verify() == want.verify() and got.verify() <= 1e-9
    assert [(a.epoch, b.epoch) for a, b in got.flips()] == \
        [(a.epoch, b.epoch) for a, b in want.flips()] and got.flips()
    assert math.isinf(got.rows[7].totals["edge[0]"])


def test_verify_raises_on_cooked_books():
    scn, _ = _scn_pair()
    auditor = pobs.AuditLog()
    scn.manager(auditor=auditor).step(0.0, _metrics(scn, 2.5e6))
    row = auditor.rows[0]
    for bad in ({"term_totals": {k: v + 1e-6 for k, v in row.term_totals.items()}},
                {"totals": {k: v * (1 + 1e-6) for k, v in row.totals.items()}}):
        cooked = pobs.AuditLog()
        cooked.rows.append(pobs.DecisionAudit(**{**row.__dict__, **bad}))
        with pytest.raises(pobs.ResumError, match="re-sum error"):
            cooked.verify()
    assert issubclass(pobs.ResumError, AssertionError)


def test_audit_jsonl_round_trip_keeps_inf_across_packages(tmp_path):
    scn, jscn = _scn_pair()
    texts = []
    for s, mod in ((scn, pobs), (jscn, jobs)):
        auditor = mod.AuditLog()
        mgr = s.manager(auditor=auditor)
        mgr.step(0.0, _metrics(s, 0.0))
        mgr.step(1.0, _metrics(s, 2.5e6))
        texts.append(auditor.to_jsonl())
    assert texts[0] == texts[1]
    back = pobs.AuditLog.from_jsonl(texts[1])
    assert back.to_jsonl() == texts[0]
    assert math.isinf(back.rows[0].totals["edge[0]"]) and back.verify() <= 1e-9
    path = back.write_jsonl(tmp_path / "audit.jsonl")
    assert pobs.AuditLog.read_jsonl(path).to_jsonl() == texts[0]
    assert jobs.AuditLog.read_jsonl(path).to_jsonl() == texts[0]
    assert [r.source for r in back] == ["manager"] * 2 and len(back) == 2


def _gateway_run(cls, scn, obs, *, hysteresis=0.0):
    auditor, tracer, metrics = obs.AuditLog(), obs.Tracer(), obs.MetricsRegistry()
    gw = cls.from_scenario(scn, epoch_s=1.0, auditor=auditor, tracer=tracer, metrics=metrics,
                           hysteresis=hysteresis)
    rng = np.random.default_rng(9)
    t = 0.0
    for epoch in range(12):
        for _ in range(3):
            gw.observe_bandwidth(float(rng.uniform(0.2e6, 3e6)))
        for _ in range(int(rng.integers(5, 15))):
            t += float(rng.exponential(0.1))
            gw.observe_arrival(t)
        gw.decide(now=float(epoch + 1))
    return gw, auditor, tracer, metrics


@pytest.mark.parametrize("hysteresis", [0.0, 0.2])
def test_gateway_audits_spans_and_metrics_equal_the_references(hysteresis):
    scn, jscn = _scn_pair()
    got = _gateway_run(OffloadGateway, scn, pobs, hysteresis=hysteresis)
    want = _gateway_run(JOffloadGateway, jscn, jobs, hysteresis=hysteresis)
    assert got[1].to_jsonl() == want[1].to_jsonl()
    assert got[2].to_jsonl() == want[2].to_jsonl()
    assert got[3].render() == want[3].render()
    assert got[0].switches == want[0].switches
    assert all(r.source == "gateway" for r in got[1]) and got[1].verify() <= 1e-9
    assert {s.cat for s in got[2].spans} == {"decide", "transfer"}


@pytest.mark.parametrize("pass_manager", [False, True])
def test_replay_audits_and_spans_equal_the_references(pass_manager):
    scn, jscn = _scn_pair()
    times = np.arange(16, dtype=float)
    bw = np.where((times >= 5) & (times < 11), 0.25e6, 2.5e6)
    bg = np.random.default_rng(4).uniform(0.0, 8.0, size=(16, 2))
    out = []
    for s, mod, rep, tmod in ((scn, pobs, replay, traces), (jscn, jobs, j_replay, j_traces)):
        trace = tmod.Trace(times=times, bandwidth_Bps=bw, arrival_rate=np.full(16, 10.0),
                           edge_bg_rate=bg)
        auditor, tracer = mod.AuditLog(), mod.Tracer()
        kw = dict(manager=s.manager(hysteresis=0.05)) if pass_manager else {}
        res = rep(s, trace, seed=2, auditor=auditor, tracer=tracer, **kw)
        out.append((res, auditor, tracer))
    (got, ga, gt), (want, wa, wt) = out
    assert ga.to_jsonl() == wa.to_jsonl()
    assert gt.to_jsonl() == wt.to_jsonl()
    assert [r.edge_index for r in ga] == list(got.policies["adaptive"].targets)
    assert got.policies["adaptive"].targets == want.policies["adaptive"].targets
    # a passed manager keeps its own source name; the default one audits as "replay"
    assert {r.source for r in ga} == {"manager" if pass_manager else "replay"}
    assert len(gt.by_cat("respond")) == len(gt.by_cat("decide")) == 16
    assert ga.verify() <= 1e-9


def _cluster_pair(n=5):
    base = JScenario(
        workload=JWorkload(2.0, 30_000, 1_000, name="inceptionv4"),
        device=JTier("orin", 0.045),
        edges=(
            JEdgeSpec(JTier("a2", 0.028)),
            JEdgeSpec(JTier("t4", 0.020, service_model=JServiceModel.EXPONENTIAL)),
            JEdgeSpec(JTier("mt", 0.015, service_model=JServiceModel.GENERAL,
                            service_var=0.3 * 0.015**2),
                      background=(JTenantStream(6.0, 0.015),)),
        ),
        network=JNetworkPath(20e6 / 8),
    )
    jspec = JClusterSpec(base=base, n_clients=n, arrival_scale=tuple(np.linspace(0.6, 1.6, n)),
                         name="obs-cluster")
    return ClusterSpec.from_dict(jspec.to_dict()), jspec


def _cluster_trace(mod, epochs=30):
    third = epochs / 3
    return mod.make_trace(
        float(epochs), 1.0,
        bandwidth_Bps=lambda t: mod.step_signal(t, [(0, 2.5e6), (third, 0.3e6),
                                                    (2 * third, 2.5e6)]),
        arrival_rate=lambda t: mod.drift_signal(t, 2.0, 2.4, jitter=0.05, seed=3),
        edge_bg_rate=[lambda t, j=j: mod.mmpp_signal(t, 0.0, 8.0 + j, seed=3 + j)
                      for j in range(3)])


def _reference_counts(seed, jtr, n):
    tb = j_traces.TraceBatch.from_trace(jtr, n)
    with jax.enable_x64(True):
        return np.asarray(jc._poisson_counts(seed, jnp.asarray(tb.arrival_rate),
                                             jnp.float64(jtr.epoch_s)))


@pytest.fixture(scope="module")
def cluster_runs():
    """The 5-client / 3-edge closed loop (stagger 3, hysteresis 0.1) through
    each package on the reference's own counts, each with a tracer, plus the
    port's run without one (decision-scan calls counted on both)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False)
        spec, jspec = _cluster_pair()
        tr, jtr = _cluster_trace(traces), _cluster_trace(j_traces)
        kw = dict(policies=("adaptive", "on_device", "edge[1]"), seed=7, stagger=3,
                  hysteresis=0.1)
        jtracer = jobs.Tracer()
        want = jc.simulate_cluster(jspec, jtr, tracer=jtracer, **kw)
        n_req = _reference_counts(7, jtr, spec.n_clients)
        calls = []
        real = pc.decision_scan
        mp.setattr(pc, "decision_scan", lambda *a, **k: calls.append(1) or real(*a, **k))
        tracer = pobs.Tracer()
        got = simulate_cluster(spec, tr, n_req=n_req, device="cpu", tracer=tracer, **kw)
        n_traced = len(calls)
        plain = simulate_cluster(spec, tr, n_req=n_req, device="cpu", **kw)
        n_plain = len(calls) - n_traced
    return dict(spec=spec, jspec=jspec, got=got, want=want, plain=plain, tracer=tracer,
                jtracer=jtracer, launches=(n_traced, n_plain))


def test_cluster_decide_spans_equal_the_references(cluster_runs):
    r = cluster_runs
    got, want = r["tracer"].spans, r["jtracer"].spans
    choices = r["got"].policies["adaptive"].choices
    assert len(got) == len(want) == choices.shape[0] == 30
    for i, (a, b) in enumerate(zip(got, want)):
        da, db = dict(a.attrs), dict(b.attrs)
        assert (a.t, a.dur, a.name, a.cat, a.track) == (b.t, b.dur, b.name, b.cat, b.track)
        assert (da["epoch"], da["offloaded"], da["on_device"]) == \
            (db["epoch"], db["offloaded"], db["on_device"]) == \
            (i, int((choices[i] >= 0).sum()), int((choices[i] < 0).sum()))
        assert da["mean_latency_s"] == pytest.approx(db["mean_latency_s"], rel=CLOSED_FORM_RTOL)
    assert {s.cat for s in got} == {"decide"} and len({dict(s.attrs)["offloaded"]
                                                       for s in got}) > 1


def test_cluster_tracer_changes_no_result_and_no_launch(cluster_runs):
    got, plain = cluster_runs["got"], cluster_runs["plain"]
    n_traced, n_plain = cluster_runs["launches"]
    assert n_traced == n_plain == 30
    for name in got.policies:
        a, b = got.policies[name], plain.policies[name]
        np.testing.assert_array_equal(a.choices, b.choices)
        np.testing.assert_array_equal(a.latencies_s, b.latencies_s)
        np.testing.assert_array_equal(a.edge_loads, b.edge_loads)
    for name in ("est_bandwidth_Bps", "est_arrival_rate", "est_endo_rate", "est_exo_rate"):
        np.testing.assert_array_equal(getattr(got, name), getattr(plain, name))


def _assert_audits_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.epoch, a.time_s, a.source, a.chosen, a.edge_index, a.decision_metric) == \
            (b.epoch, b.time_s, b.source, b.chosen, b.edge_index, b.decision_metric)
        assert a.totals.keys() == b.totals.keys() and a.terms.keys() == b.terms.keys()
        for s in a.totals:
            assert a.totals[s] == pytest.approx(b.totals[s], rel=CLOSED_FORM_RTOL)
            assert a.term_totals[s] == pytest.approx(b.term_totals[s], rel=CLOSED_FORM_RTOL)
            assert a.terms[s].keys() == b.terms[s].keys()
            for k in a.terms[s]:
                assert a.terms[s][k] == pytest.approx(b.terms[s][k], rel=CLOSED_FORM_RTOL,
                                                      abs=0), (s, k)
        assert a.predicted_latency_s == pytest.approx(b.predicted_latency_s,
                                                      rel=CLOSED_FORM_RTOL)
        assert a.snapshot.keys() == b.snapshot.keys()
        assert a.snapshot["lam_dev"] == pytest.approx(b.snapshot["lam_dev"], rel=1e-12)


@pytest.mark.parametrize("subset", [None, ([1, 3, 17, 29], [0, 4])])
def test_audit_cluster_equals_the_references(cluster_runs, x64, subset):
    kw = {} if subset is None else dict(epochs=subset[0], clients=subset[1])
    got = pobs.audit_cluster(cluster_runs["got"], device="cpu", **kw)
    want = jobs.audit_cluster(cluster_runs["want"], **kw)
    _assert_audits_close(got, want)
    choices = cluster_runs["got"].policies["adaptive"].choices
    epochs = range(30) if subset is None else subset[0]
    clients = range(5) if subset is None else subset[1]
    assert len(got) == len(epochs) * len(clients)
    assert [r.edge_index for r in got] == [int(choices[t, i]) for t in epochs for i in clients]
    assert {r.source for r in got} == {f"cluster[{i}]" for i in clients}
    assert got.verify() <= 1e-9 and want.verify() <= 1e-9


def test_audit_cluster_defaults_to_the_card(cluster_runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pobs.audit_cluster(cluster_runs["got"], epochs=[0], clients=[0])


# ---------------------------------------------------------------------------
# manifest delta and the report's text
# ---------------------------------------------------------------------------


def _manifest_cases():
    a = {"manifest_version": 1, "seed": 0, "config_sha256": None,
         "git": {"sha": "abc", "dirty": False}, "python": "3.12.0",
         "platform": "Linux-x86_64", "packages": {"torch": "2.13.0", "numpy": "2.0.2"}}
    b = json.loads(json.dumps(a))
    b["packages"]["torch"] = "2.14.0"
    b["git"] = {"sha": "def", "dirty": True}
    c = {k: v for k, v in a.items() if k not in ("git", "platform")}
    c["python"] = "3.11.9"
    c["seed"] = 5
    return [(a, a), (a, b), (b, a), (a, c), (None, a), (a, {}), ({"packages": 1},
                                                                  {"packages": {"x": 1}})]


@pytest.mark.parametrize("case", range(7))
def test_manifest_delta_equals_the_references(case):
    a, b = _manifest_cases()[case]
    assert pobs.manifest_delta(a, b) == jobs.manifest_delta(a, b)


def test_manifest_delta_on_run_manifests():
    m = pobs.run_manifest(seed=3, config={"a": 1})
    assert pobs.manifest_delta(m, m) == []
    other = json.loads(json.dumps(m))
    other["packages"]["torch"] = "0.0.0"
    assert any("torch" in note for note in pobs.manifest_delta(m, other))


def _flip_logs():
    scn, jscn = _scn_pair()
    out = []
    for s, mod in ((scn, pobs), (jscn, jobs)):
        auditor = mod.AuditLog()
        mgr = s.manager(auditor=auditor, hysteresis=0.3)
        for i, bw in enumerate([2.5e6, 2.5e6, 0.2e6, 0.9e6, 0.0, 3e6, 0.5e6, 2.5e6]):
            mgr.step(float(i), _metrics(s, bw))
        out.append(auditor)
    return out


def test_format_decision_and_explain_flip_equal_the_references():
    got, want = _flip_logs()
    assert [pobs.format_decision(r) for r in got] == [jobs.format_decision(r) for r in want]
    gf, wf = got.flips(), want.flips()
    assert len(gf) == len(wf) >= 2
    assert [pobs.explain_flip(*f) for f in gf] == [jobs.explain_flip(*f) for f in wf]
    # a row without a bandwidth renders the reference's placeholder
    row = pobs.DecisionAudit(**{**got.rows[0].__dict__, "snapshot": {}})
    jrow = jobs.DecisionAudit(**{**want.rows[0].__dict__, "snapshot": {}})
    assert pobs.format_decision(row) == jobs.format_decision(jrow)


def test_render_report_equals_the_references():
    got_a, want_a = _flip_logs()
    trs, regs = [], []
    for mod in (pobs, jobs):
        tr = mod.Tracer()
        _populate(tr, 7)
        reg = mod.MetricsRegistry()
        _fill_registry(reg, 7)
        trs.append(tr)
        regs.append(reg)
    assert pobs.render_report(tracer=trs[0], audit=got_a, metrics=regs[0], title="T") == \
        jobs.render_report(tracer=trs[1], audit=want_a, metrics=regs[1], title="T")
    assert pobs.render_report() == jobs.render_report()
    assert pobs.render_report(audit=got_a) == jobs.render_report(audit=want_a)


# ---------------------------------------------------------------------------
# the engine's spans through the measurement harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slots", [1, 2])
def test_harness_trace_equals_the_references_byte_for_byte(slots):
    kw = dict(arch="starcoder2_3b", slots=slots, seed=0, n_requests=10, clock="simulated")
    got, want = pobs.Tracer(), jobs.Tracer()
    trace = run_harness(HarnessConfig(**kw), device="cpu", tracer=got)
    j_run_harness(JHarnessConfig(**kw), tracer=want)
    assert got.to_jsonl() == want.to_jsonl()
    assert got.to_chrome() == want.to_chrome()
    # 3 spans per request (queue, prefill, respond) plus 1 per decode step
    n_decode = sum(e[1] == "decode" for e in trace.events)
    assert len(got) == 3 * len(trace.requests) + n_decode
    assert [len(got.by_cat(c)) for c in ("queue", "prefill", "respond", "decode")] == \
        [len(trace.requests)] * 3 + [n_decode]
    # the tracer changes nothing the harness records
    assert run_harness(HarnessConfig(**kw), device="cpu").to_dict() == trace.to_dict()


def test_disabled_tracer_in_the_engine_records_nothing():
    kw = dict(arch="starcoder2_3b", slots=2, seed=1, n_requests=6, clock="simulated")
    off = pobs.Tracer(enabled=False)
    a = run_harness(HarnessConfig(**kw), device="cpu", tracer=off)
    assert len(off) == 0
    assert a.to_dict() == run_harness(HarnessConfig(**kw), device="cpu").to_dict()
