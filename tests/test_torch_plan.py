"""The port's provisioning solver (``plan/provision.py``) and its CLI on the
CPU, against the JAX package's on the cases of ``tests/test_plan.py``.

The reference's x64 paths run through the ``x64`` fixture (ROADMAP C1).

Tolerances: the plan's choices (edge count, tier, bandwidth, counts,
iterations, evaluations) exact; its latencies and utilisations 1e-9
relative. Every feasibility probe is an SLO-mode equilibrium solved by the
same best-response steps on both sides, its quantiles the same float64 tail
closed forms, which XLA and torch round an ulp apart (the Euler inversion
~1e-12 of a quantile).
"""

import json

import jax
import jax.experimental
import pytest
import torch

from repro.core.latency import NetworkPath as JNetworkPath
from repro.core.latency import Tier as JTier
from repro.core.latency import Workload as JWorkload
from repro.core.scenario import EdgeSpec as JEdgeSpec
from repro.core.scenario import Scenario as JScenario
from repro.launch import provision as j_provision_cli
from repro.plan import ProvisionSpace as JProvisionSpace
from repro.plan import provision as j_provision
from repro_torch.core.scenario import ScenarioError
from repro_torch.launch import provision as provision_cli
from repro_torch.plan import ProvisionPlan, ProvisionSpace, provision

RTOL = 1e-9
FLOATS = ("max_latency_s", "mean_latency_s")
Q = 0.99


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


def _j_space() -> JProvisionSpace:
    """tests/test_plan.py's space: two tiers, up to 3 edges, two bandwidths."""
    base = JScenario(
        workload=JWorkload(arrival_rate=4.0, req_bytes=30_000, res_bytes=1_000, name="plan-wl"),
        device=JTier("cpu-only", 0.08),
        edges=(JEdgeSpec(JTier("edge", 0.04)),),
        network=JNetworkPath(2.0e6),
        name="plan-base",
    )
    return JProvisionSpace(base=base, tiers=(JTier("slow", 0.040), JTier("fast", 0.015)),
                           max_edges=3, bandwidths_Bps=(1.0e6, 2.0e6), name="plan-space")


@pytest.fixture(scope="module")
def spaces():
    jspace = _j_space()
    return ProvisionSpace.from_dict(jspace.to_dict()), jspace


def assert_same_plan(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        if k in FLOATS:
            assert got[k] == pytest.approx(v, rel=RTOL), k
        elif k == "rho_edges":
            assert got[k] == pytest.approx(v, rel=RTOL), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("n_clients,slo_s,method", [
    (4, 0.16, "asymptote"),  # test_agrees_with_brute_force_grid
    (8, 0.10, "asymptote"),  # test_plan_is_component_wise_minimal
    (8, 0.16, "asymptote"),  # test_monotone_in_budget
    (4, 10.0, "asymptote"),  # test_trivial_budget_returns_cheapest_corner
    (4, 1e-3, "asymptote"),  # test_impossible_budget_returns_none
    (4, 0.16, "euler"),  # test_euler_engine_end_to_end
])
def test_provision_gives_the_reference_plan(x64, spaces, n_clients, slo_s, method):
    space, jspace = spaces
    got = provision(space, n_clients, slo_s, q=Q, tail_method=method, device="cpu")
    want = j_provision(jspace, n_clients, slo_s, q=Q, tail_method=method)
    if want is None:
        assert got is None
        return
    assert_same_plan(got.to_dict(), want.to_dict())
    assert got.slack_s >= 0.0 and sum(got.counts.values()) == n_clients


def test_plan_and_space_round_trip_through_json(spaces):
    space, jspace = spaces
    assert ProvisionSpace.from_dict(json.loads(json.dumps(space.to_dict()))) == space
    assert space.to_dict() == jspace.to_dict()
    assert space.cluster_spec(2, 1, 0, 4).to_dict() == jspace.cluster_spec(2, 1, 0, 4).to_dict()
    plan = provision(space, 4, 0.16, q=Q, tail_method="asymptote", device="cpu")
    assert ProvisionPlan.from_dict(json.loads(json.dumps(plan.to_dict()))) == plan
    d = plan.to_dict()
    del d["n_edges"]
    with pytest.raises(ScenarioError):
        ProvisionPlan.from_dict(d)
    with pytest.raises(ScenarioError, match="slowest to fastest"):
        ProvisionSpace(base=space.base, tiers=tuple(reversed(space.tiers)), max_edges=2,
                       bandwidths_Bps=(1e6,))
    for bad in ({"n_clients": 0}, {"slo_s": 0.0}, {"q": 1.0}):
        kw = {"n_clients": 4, "slo_s": 0.1, "q": Q} | bad
        with pytest.raises(ScenarioError):
            provision(space, kw["n_clients"], kw["slo_s"], q=kw["q"], device="cpu")


def test_provision_cli_writes_the_reference_plan(x64, tmp_path, capsys):
    """The CLI at its default space with 8 clients (the default 48 solves the
    same way, only longer) and a 60 ms budget, with the minimality probes."""
    argv = ["--clients", "8", "--slo-ms", "60", "--check-minimal"]
    out, jout = tmp_path / "port.json", tmp_path / "ref.json"
    assert provision_cli.default_space().to_dict() == j_provision_cli.default_space().to_dict()
    assert provision_cli.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    assert "violates SLO (minimal)" in capsys.readouterr().out
    assert j_provision_cli.main(argv + ["--out", str(jout)]) == 0
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    assert got["space"] == want["space"]
    assert_same_plan(got["plan"], want["plan"])
