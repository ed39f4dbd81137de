"""The port's offload gateway (``serving/gateway.py``, Algorithm 1 in the
serving stack) and the launchers that drive it (``launch/serve.py``'s gateway
half, ``launch/obs_report.py``), on the CPU against the JAX package's.

Both packages get the same scenario, the same seeded telemetry and the same
calls. Tolerances, each with its reason:
  * ``EdgeHandle`` fields, ``state()`` and every ``Decision`` of the two
    gateways: exact (the same numpy arithmetic over the same floats);
  * the gateway against the port's batched cluster decision path
    (``predict_decisions`` on the CPU): choices exact, totals 1e-9 relative
    (float64 closed forms in torch against numpy's, an ulp apart at most);
  * the two serve CLIs, their engines' profiled service stubbed to the same
    constant: the ``[gateway]`` lines (one per epoch and the switch count)
    and ``[metrics]`` lines equal, string for string (the ``[serve]`` lines
    differ by design: the engines differ);
  * ``obs_report --demo --device cpu``: ``trace.jsonl``, ``trace.chrome.json``,
    ``audit.jsonl`` and ``report.md`` equal the reference's byte for byte;
    ``manifest.json`` records each package's own environment.
The reference's ``test_rate_only_report_prices_load_at_own_service_moments``
(``tests/test_gateway_multiedge.py``) fails under JAX 0.9.0 only because it
calls the reference's ``predict_decisions`` (ROADMAP C1); its twin here holds
the two gateways together and the port's gateway against the port's
``predict_decisions``.
"""

import numpy as np
import pytest
import torch

import repro.launch.obs_report as j_obs_report
import repro.launch.serve as j_serve
from repro.core import EdgeSpec as JEdgeSpec
from repro.core import NetworkPath as JNetworkPath
from repro.core import Scenario as JScenario
from repro.core import ServiceModel as JServiceModel
from repro.core import TenantStream as JTenantStream
from repro.core import Tier as JTier
from repro.core import Workload as JWorkload
from repro.core.scenario import implied_service_var as j_implied_service_var
from repro.serving.engine import Engine as JEngine
from repro.serving.gateway import EdgeHandle as JEdgeHandle
from repro.serving.gateway import OffloadGateway as JOffloadGateway
from repro_torch.core import ON_DEVICE, ClusterSpec, Scenario
from repro_torch.core.scenario import implied_service_var
from repro_torch.fleet import predict_decisions
from repro_torch.launch import obs_report, serve
from repro_torch.serving.engine import Engine
from repro_torch.serving.gateway import EdgeHandle, OffloadGateway

CLOSED_FORM_RTOL = 1e-9
ARTIFACTS = ("trace.jsonl", "trace.chrome.json", "audit.jsonl", "report.md")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, restored after (see test_torch_fleet)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _scn_pair(**kw):
    """``tests/test_gateway_multiedge.py``'s three-edge scenario (plus a
    background tenant on the T4 when ``tenants``) in each package."""
    tenants = kw.pop("tenants", False)
    jscn = JScenario(
        workload=JWorkload(2.0, 30_000, 1_000, name="inceptionv4"),
        device=JTier("orin", 0.045),
        edges=(
            JEdgeSpec(JTier("a2", 0.028)),
            JEdgeSpec(JTier("a100", 0.008)),
            JEdgeSpec(JTier("t4", 0.020, service_model=JServiceModel.EXPONENTIAL),
                      background=((JTenantStream(5.0, 0.01, 4e-5), JTenantStream(3.0, 0.03))
                                  if tenants else ())),
        ),
        network=JNetworkPath(20e6 / 8),
        **kw,
    )
    return Scenario.from_dict(jscn.to_dict()), jscn


HANDLE_FIELDS = ("name", "service_mean_s", "parallelism_k", "service_var_s", "background_rate",
                 "background_service_s", "background_service_var", "bandwidth_Bps")


def _fields(h) -> tuple:
    return tuple(getattr(h, f) for f in HANDLE_FIELDS)


@pytest.mark.parametrize("tenants", [False, True])
def test_edge_handle_from_spec_equals_the_references(tenants):
    scn, jscn = _scn_pair(tenants=tenants)
    for e, je in zip(scn.edges, jscn.edges):
        h, jh = EdgeHandle.from_spec(e), JEdgeHandle.from_spec(je)
        assert _fields(h) == _fields(jh)
        assert h.state().__dict__ == jh.state().__dict__


def _load_reports(h, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for i in range(12):
        rate = float(rng.uniform(0.0, 40.0))
        if i % 3 == 0:
            h.observe_load(rate)  # rate only: the template holds
        elif i % 3 == 1:
            h.observe_load(rate, float(rng.uniform(0.005, 0.05)))
        else:
            h.observe_load(rate, float(rng.uniform(0.005, 0.05)), float(rng.uniform(0, 1e-4)))
        for t in np.sort(rng.uniform(i, i + 1, int(rng.integers(0, 20)))):
            h.arrivals.record(float(t))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_observe_load_ewma_and_state_moments_equal_the_references(seed):
    scn, jscn = _scn_pair(tenants=True)
    for e, je in zip(scn.edges, jscn.edges):
        h, jh = EdgeHandle.from_spec(e), JEdgeHandle.from_spec(je)
        _load_reports(h, seed)
        _load_reports(jh, seed)
        assert _fields(h) == _fields(jh)
        for mine in (None, 0.012):
            assert h.state(mine).__dict__ == jh.state(mine).__dict__
    # a hand-built handle (no moments) prices a rate-only report at its own
    h, jh = EdgeHandle("e", service_mean_s=0.02, service_var_s=4e-4), \
        JEdgeHandle("e", service_mean_s=0.02, service_var_s=4e-4)
    for x in (h, jh):
        x.observe_load(10.0)
        x.observe_load(20.0)
    assert _fields(h) == _fields(jh)
    assert (h.background_rate, h.background_service_s, h.background_service_var) == \
        (15.0, 0.02, 4e-4)


@pytest.mark.parametrize("report", [(-1.0,), (5.0, 0.0), (5.0, -0.01), (5.0, None, -1e-3)])
def test_observe_load_refuses_what_the_reference_refuses(report):
    for cls in (EdgeHandle, JEdgeHandle):
        h = cls(name="e", service_mean_s=0.02)
        with pytest.raises(ValueError):
            h.observe_load(*report)
        assert h.background_rate == 0.0  # nothing was recorded


def _report_cluster_loads(gw, scn, endo, *, moments=True) -> None:
    """The edge reports its full aggregate (the other clients plus a stream
    like ours), with the cluster's mixture template (each package's own
    ``implied_service_var``) or, ``moments=False``, the rate only."""
    lam = scn.workload.arrival_rate
    var = implied_service_var if isinstance(scn, Scenario) else j_implied_service_var
    for j, h in enumerate(gw.edges):
        tier = scn.edges[j].tier
        if moments:
            h.observe_load(endo[j] + lam, tier.service_time_s, var(tier))
        else:
            h.observe_load(endo[j] + lam)


ENDO = [(0.0, 0.0, 0.0), (0.0, 80.0, 0.0), (20.0, 80.0, 30.0), (30.0, 100.0, 40.0)]


def _decisions_agree(d, jd):
    assert (d.edge_index, d.strategy, d.epoch) == (jd.edge_index, jd.strategy, jd.epoch)
    assert (d.t_dev, d.t_edges, d.predicted_latency_s) == \
        (jd.t_dev, jd.t_edges, jd.predicted_latency_s)


@pytest.mark.parametrize("moments", [True, False], ids=["with-moments", "rate-only"])
@pytest.mark.parametrize("endo", ENDO)
def test_multi_edge_choice_equals_the_reference_and_the_cluster_path(endo, moments):
    """The two gateways decide alike, and the port's gateway agrees with the
    port's batched cluster decision on the same per-edge view (the rate-only
    case is the reference's C1-blocked test, here without JAX's
    ``predict_decisions``)."""
    scn, jscn = _scn_pair()
    gw, jgw = OffloadGateway.from_scenario(scn), JOffloadGateway.from_scenario(jscn)
    _report_cluster_loads(gw, scn, endo, moments=moments)
    _report_cluster_loads(jgw, jscn, endo, moments=moments)
    d, jd = gw.decide(now=1.0), jgw.decide(now=1.0)
    _decisions_agree(d, jd)
    spec = ClusterSpec(base=scn, n_clients=1, name="gw-coherence")
    choice, t_dev, t_edge = predict_decisions(
        spec, [scn.workload.arrival_rate], [float(np.asarray(scn.network.bandwidth_Bps))],
        [list(endo)], [0.0, 0.0, 0.0], device="cpu")
    assert d.edge_index == choice[0]
    assert d.t_dev == pytest.approx(float(t_dev[0]), rel=CLOSED_FORM_RTOL)
    for j in range(len(scn.edges)):
        assert d.t_edges[j] == pytest.approx(float(t_edge[0, j]), rel=CLOSED_FORM_RTOL)


def test_all_edges_saturated_degrades_to_on_device():
    scn, jscn = _scn_pair()
    gw, jgw = OffloadGateway.from_scenario(scn), JOffloadGateway.from_scenario(jscn)
    for g, s in ((gw, scn), (jgw, jscn)):
        _report_cluster_loads(g, s, (60.0, 140.0, 80.0))
    for epoch in range(1, 5):
        d, jd = gw.decide(now=float(epoch)), jgw.decide(now=float(epoch))
        _decisions_agree(d, jd)
        assert d.edge_index == ON_DEVICE and np.isfinite(d.t_dev)
        assert all(not np.isfinite(t) for t in d.t_edges)


@pytest.mark.parametrize("return_results", [True, False])
def test_from_scenario_and_epochs_equal_the_references(return_results):
    """A seeded run of bandwidth observations, arrivals and load reports:
    every decision, the switches, the redispatches of ``check_deadline``
    (default and a custom timeout) equal the reference's."""
    scn, jscn = _scn_pair(tenants=True, return_results=return_results)
    timeout = lambda p: 3.0 * p + 0.01  # noqa: E731
    out = []
    for cls, s in ((OffloadGateway, scn), (JOffloadGateway, jscn)):
        gw = cls.from_scenario(s, hysteresis=0.1)
        gw2 = cls.from_scenario(s, deadline_timeout=timeout)
        rng = np.random.default_rng(21)
        t, marks = 0.0, []
        for epoch in range(20):
            gw.observe_bandwidth(float(rng.choice([2.5e6, 1.2e6, 0.2e6, 0.05e6])))
            for _ in range(int(rng.integers(0, 12))):
                t += float(rng.exponential(0.08))
                gw.observe_arrival(t)
            if epoch % 4 == 0:
                for h in gw.edges:
                    h.observe_load(float(rng.uniform(0.0, 60.0)))
            gw.decide(now=float(epoch + 1))
            for _ in range(5):
                pred, el = float(rng.exponential(0.05)), float(rng.exponential(0.2))
                marks.append((gw.check_deadline(pred, el), gw2.check_deadline(pred, el)))
        out.append((gw, gw2, marks))
    (gw, gw2, marks), (jgw, jgw2, jmarks) = out
    assert gw.manager.return_results is return_results
    assert gw.bandwidth.value == jgw.bandwidth.value
    for d, jd in zip(gw.decisions, jgw.decisions, strict=True):
        _decisions_agree(d, jd)
    assert gw.switches == jgw.switches > 0
    assert marks == jmarks and any(m[0] for m in marks) and any(not m[1] for m in marks)
    assert (gw.redispatches, gw2.redispatches) == (jgw.redispatches, jgw2.redispatches)


# ---------------------------------------------------------------------------
# the serve CLI's gateway half
# ---------------------------------------------------------------------------


def _tagged(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith(("[gateway]", "[metrics]"))]


def test_serve_cli_runs_the_gateway_half(capsys):
    engine, gw = serve.run(["--reduced", "--device", "cpu", "--requests", "3", "--max-new",
                            "2", "--schedule", "20,10,2,20,1"])
    assert len(engine.completed) == 3
    auditor = gw.manager.auditor
    assert len(gw.decisions) == len(auditor) == 5
    assert auditor.verify() <= 1e-9
    for row in auditor:  # each epoch's choice is the argmin of its audited totals
        assert row.totals[row.chosen] == min(row.totals.values())
    s_dev, _ = engine.observed_service_stats()
    assert gw.device.service_time_s == s_dev and gw.edges[0].service_mean_s == s_dev / 8
    lines = _tagged(capsys.readouterr().out)
    assert len([ln for ln in lines if " epoch " in ln]) == 5
    assert f"[gateway] switches={gw.switches}" in lines
    assert gw.metrics.snapshot()["counters"]["gateway.decisions"] == 5


@pytest.mark.parametrize("schedule", ["20,10,2,20", "5,0.5,40,3,3,12"])
def test_serve_cli_gateway_lines_equal_the_references(schedule, monkeypatch, capsys):
    """Both engines' profiled service stubbed to one constant: the lines the
    gateway prints are the reference's, string for string."""
    stats = lambda self: (0.020, 1e-5)  # noqa: E731
    monkeypatch.setattr(Engine, "observed_service_stats", stats)
    monkeypatch.setattr(JEngine, "observed_service_stats", stats)
    argv = ["--requests", "2", "--max-new", "2", "--rps", "12", "--schedule", schedule]
    assert j_serve.main(argv) == 0
    want = _tagged(capsys.readouterr().out)
    assert serve.main(argv + ["--reduced", "--device", "cpu"]) == 0
    got = _tagged(capsys.readouterr().out)
    assert got == want and len(got) > len(schedule.split(","))


def test_serve_cli_refuses_a_bad_schedule():
    with pytest.raises(SystemExit):
        serve.run(["--reduced", "--device", "cpu", "--requests", "1", "--schedule", "20,x"])


# ---------------------------------------------------------------------------
# the obs_report CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", [True, False], ids=["demo", "no-engine"])
def test_obs_report_demo_artifacts_equal_the_references(engine, tmp_path, capsys):
    flags = [] if engine else ["--no-engine"]
    assert j_obs_report.main(["--demo", "--out-dir", str(tmp_path / "ref"), "--requests", "6"]
                             + flags) == 0
    assert obs_report.main(["--demo", "--device", "cpu", "--out-dir", str(tmp_path / "port"),
                            "--requests", "6"] + flags) == 0
    for name in ARTIFACTS:
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "ref" / name).read_bytes(), name
        assert got
    out = capsys.readouterr().out
    assert f"wrote {tmp_path / 'port' / 'manifest.json'}" in out
    cats = {ln.split('"cat":"')[1].split('"')[0]
            for ln in (tmp_path / "port" / "trace.jsonl").read_text().splitlines()}
    assert cats == ({"decide", "transfer", "queue", "prefill", "decode", "respond"} if engine
                    else {"decide", "transfer"})


def test_obs_report_render_mode_equals_the_references(tmp_path, capsys):
    j_obs_report.main(["--demo", "--out-dir", str(tmp_path / "demo"), "--no-engine"])
    src = ["--trace", str(tmp_path / "demo" / "trace.jsonl"),
           "--audit", str(tmp_path / "demo" / "audit.jsonl"), "--title", "Same"]
    j_obs_report.main(src + ["--out", str(tmp_path / "ref.md")])
    obs_report.main(src + ["--out", str(tmp_path / "port.md")])
    assert (tmp_path / "port.md").read_text() == (tmp_path / "ref.md").read_text()
    capsys.readouterr()
    assert obs_report.main(src) == 0
    assert capsys.readouterr().out == (tmp_path / "ref.md").read_text() + "\n"
    with pytest.raises(SystemExit):
        obs_report.main([])


def test_no_card_the_demo_and_serve_raise_and_nothing_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        obs_report.main(["--demo", "--out-dir", str(tmp_path / "d")])
    assert not (tmp_path / "d").exists()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.run(["--reduced", "--requests", "1"])
    # the gateway-only demo and render mode touch no device
    assert obs_report.main(["--demo", "--no-engine", "--out-dir", str(tmp_path / "g")]) == 0
    assert obs_report.main(["--audit", str(tmp_path / "g" / "audit.jsonl"),
                            "--out", str(tmp_path / "r.md")]) == 0
