"""The port's fleet path on the CPU against the JAX package's: batch packing,
the float64 closed forms and crossovers, the Lindley-scan plain versions, the
batched simulator, and the fleet-sweep CLI.

Inputs are drawn from numpy seeds and handed to both packages; where the
reference draws its own random numbers, the test reproduces its key splits
and hands the port the same draws. The reference's x64 paths run through the
``x64`` fixture below, which restores ``jax.experimental.enable_x64`` (gone
in JAX 0.9.0) for one test only, as a scoped ``jax.enable_x64(True)``.

Tolerances, each with its reason:
  * closed forms and crossovers: 1e-9 relative (float64 on both sides, the
    same formulas; XLA and torch may round a pow/log/exp by an ulp and the
    bisection compounds it over 200 steps);
  * k = 1 Lindley scans: exact (one max and one add per job, no reassociation);
  * k-server scan vs ``station_pass``: 1e-12 relative (the heap and the
    argmin pick servers with equal free times in different orders, and the
    reference's k = 1 rows use a cumsum identity, not the recursion);
  * the simulator on the reference's draws: 1e-12 relative (arrival times are
    cumulative sums, which XLA and torch may associate differently);
  * the simulator on its own draws: a statistical gate, mean MAPE <= 5%
    against the closed forms, as the reference's differential gate 3.
"""

import ast
import json
from dataclasses import replace
from pathlib import Path

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.latency import NetworkPath as JNetworkPath
from repro.core.latency import ServiceModel as JServiceModel
from repro.core.latency import Tier as JTier
from repro.core.latency import Workload as JWorkload
from repro.core.multitenant import TenantStream as JTenantStream
from repro.core.queueing import mmk_wait_erlang
from repro.core.scenario import EdgeSpec as JEdgeSpec
from repro.core.scenario import Scenario as JScenario
from repro.core.simulation import station_pass
from repro.fleet import ScenarioBatch as JScenarioBatch
from repro.fleet import analytic_vec as j_analytic_vec
from repro.fleet import sim_vec as j_sim_vec
from repro.kernels.lindley_scan.ops import lindley_scan as jax_lindley_scan
from repro.kernels.lindley_scan.ref import lindley_scan_reference as jax_lindley_reference
from repro.launch import fleet_sweep as j_fleet_sweep
from repro_torch.core.multitenant import TenantStream
from repro_torch.core.scenario import Scenario
from repro_torch.fleet import (
    ScenarioBatch,
    fleet_analytic,
    fleet_crossover,
    lindley_station,
    md1_wait_vec,
    mg1_wait_vec,
    mm1_wait_vec,
    mmk_wait_erlang_vec,
    simulate_fleet,
)
from repro_torch.kernels.lindley_scan.ops import lindley_kserver, lindley_scan
from repro_torch.launch import fleet_sweep

ROOT = Path(__file__).resolve().parent.parent
CLOSED_FORM_RTOL = 1e-9
SIM_RTOL = 1e-12


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the tier-1 suite runs several xdist
    workers at once, and torch's default pool (one thread per core in each
    of them) would crowd the CPU that other files' wall-clock tests measure."""
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


def _scenario_pair(rng: np.random.Generator, *, edges: int = 2, background: bool = True,
                   rho_max: float = 1.3, ks=(1.0, 1.0, 2.0, 3.5)):
    """One random operating point as (port Scenario, reference Scenario): the
    same spec, built through each package's own classes; every tier's k is
    drawn from ``ks`` and its utilization from (0.05, rho_max)."""
    from repro_torch.core.latency import NetworkPath, ServiceModel, Tier, Workload
    from repro_torch.core.multitenant import TenantStream
    from repro_torch.core.scenario import EdgeSpec

    models = ("md1", "mm1", "mg1")
    lam = float(rng.uniform(0.5, 8.0))

    def tier(name, rho):
        k = float(rng.choice(ks))
        s = rho * k / lam
        m = str(rng.choice(models))
        var = float((s * rng.uniform(0.2, 1.5)) ** 2) if m == "mg1" else 0.0
        return dict(name=name, service_time_s=s, parallelism_k=k, service_model=m,
                    service_var=var)

    dev = tier("dev", float(rng.uniform(0.05, rho_max)))
    edge_specs = []
    for j in range(edges):
        e = tier(f"edge{j}", float(rng.uniform(0.05, rho_max)))
        bw = float(rng.choice([np.nan, rng.uniform(2e5, 5e6)]))
        bg = []
        if background and rng.uniform() < 0.4:
            for i in range(int(rng.integers(1, 3))):
                bg.append(dict(arrival_rate=float(rng.uniform(0.2, 2.0)),
                               service_mean_s=e["service_time_s"] * (1 + 0.2 * i),
                               service_var=float((e["service_time_s"] / 4) ** 2)))
        edge_specs.append((e, bw, bg))
    req, res = float(rng.uniform(5e3, 2e5)), float(rng.uniform(0, 5e3))
    bw = float(rng.uniform(1e5, 2e7))
    ret = bool(rng.uniform() < 0.8)

    def build(Tier_, SM, EdgeSpec_, TS, Workload_, NetworkPath_, Scenario_):
        def t(d):
            return Tier_(d["name"], d["service_time_s"], parallelism_k=d["parallelism_k"],
                         service_model=SM(d["service_model"]), service_var=d["service_var"])
        return Scenario_(
            workload=Workload_(lam, req, res),
            device=t(dev),
            edges=tuple(EdgeSpec_(t(e), bandwidth_Bps=None if np.isnan(b) else b,
                                  background=tuple(TS(**x) for x in g))
                        for e, b, g in edge_specs),
            network=NetworkPath_(bw),
            return_results=ret,
            allow_unstable=True,
        )

    port = build(Tier, ServiceModel, EdgeSpec, TenantStream, Workload, NetworkPath, Scenario)
    ref = build(JTier, JServiceModel, JEdgeSpec, JTenantStream, JWorkload, JNetworkPath,
                JScenario)
    return port, ref


def _pairs(seed: int, n: int, **kw):
    rng = np.random.default_rng(seed)
    return list(zip(*[_scenario_pair(rng, **kw) for _ in range(n)]))


def assert_close_inf(got, want, rtol):
    """Equal infinities (rho >= 1) and NaNs in the same places, else rtol."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0)


# ---------------------------------------------------------------------------
# the numpy core copies and the batch
# ---------------------------------------------------------------------------


CORE = ROOT / "src" / "repro_torch" / "core"


def _top_imports(path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
            [node.module or ""] if isinstance(node, ast.ImportFrom) else []
        out |= {n.split(".")[0] for n in names}
    return out


@pytest.mark.parametrize("path", sorted(CORE.glob("*.py")), ids=lambda p: p.name)
def test_core_copies_import_no_torch(path):
    """The core copies stay numpy-only, like the reference they copy: torch
    appears exactly where the reference imports jax (only the latency
    predictor, a JAX MLP whose twin is a torch MLP trained on the card)."""
    ref = ROOT / "src" / "repro" / "core" / path.name
    assert ("torch" in _top_imports(path)) == ("jax" in _top_imports(ref)), path.name


def test_scalar_analytic_equals_reference():
    """The copied scalar closed forms (gate 1's oracle) are the reference's."""
    ports, refs = _pairs(0, 40)
    for p, r in zip(ports, refs):
        assert p.to_dict() == r.to_dict()
        assert p.analytic().totals() == r.analytic().totals()


def test_from_sweep_matches_reference_and_grid_order():
    base_p, base_r = _pairs(1, 1, edges=2, background=True)
    base_p, base_r = base_p[0], base_r[0]
    axes = {"workload.arrival_rate": [0.5, 1.0, 2.0],
            "network.bandwidth_Bps": [1e5, 1e6],
            "edges[1].tier.service_time_s": [0.01, 0.02]}
    port = ScenarioBatch.from_sweep(base_p, axes)
    ref = JScenarioBatch.from_sweep(base_r, axes)
    grid = ScenarioBatch.from_scenarios(base_p.grid(axes))
    for name, arr in port.arrays().items():
        np.testing.assert_array_equal(arr, ref.arrays()[name], err_msg=name)
        np.testing.assert_array_equal(arr, grid.arrays()[name], err_msg=name)


# ---------------------------------------------------------------------------
# closed forms
# ---------------------------------------------------------------------------


def test_fleet_analytic_matches_reference_and_scalar(x64):
    ports, refs = _pairs(2, 60, edges=3)
    pred = fleet_analytic(ScenarioBatch.from_scenarios(ports), device="cpu")
    want = j_analytic_vec.fleet_analytic(JScenarioBatch.from_scenarios(refs))
    assert np.isinf(pred.t_dev).any() and np.isfinite(pred.t_dev).any()  # rho >= 1 covered
    assert_close_inf(pred.t_dev, want.t_dev, CLOSED_FORM_RTOL)
    assert_close_inf(pred.t_edge, want.t_edge, CLOSED_FORM_RTOL)
    np.testing.assert_array_equal(pred.best_edge, want.best_edge)
    for i, scn in enumerate(ports):
        tot = scn.analytic().totals()
        got = pred.totals(i)
        assert_close_inf([got[k] for k in tot], list(tot.values()), CLOSED_FORM_RTOL)
    assert pred.strategy_names() == [
        "on_device" if j < 0 else f"edge[{j}]" for j in want.best_edge.tolist()]


@pytest.mark.parametrize("axis", ["bandwidth", "arrival_rate"])
def test_fleet_crossover_matches_reference(x64, axis):
    ports, refs = _pairs(4, 24, edges=1, rho_max=0.9)
    got = fleet_crossover(ScenarioBatch.from_scenarios(ports), axis, device="cpu")
    want = j_analytic_vec.fleet_crossover(JScenarioBatch.from_scenarios(refs), axis)
    assert want.found.any() and not want.found.all()
    np.testing.assert_array_equal(got.found, want.found)
    np.testing.assert_array_equal(got.offload_wins_above[got.found],
                                  want.offload_wins_above[want.found])
    assert_close_inf(got.value, want.value, CLOSED_FORM_RTOL)
    assert_close_inf(got.hi, want.hi, CLOSED_FORM_RTOL)
    np.testing.assert_array_equal(got.lo, want.lo)


def test_fleet_crossover_agrees_with_scalar_solver():
    ports, _ = _pairs(5, 8, edges=1, background=False, rho_max=0.8)
    got = fleet_crossover(ScenarioBatch.from_scenarios(ports), "bandwidth", device="cpu")
    for i, scn in enumerate(ports):
        cx = scn.crossovers("bandwidth")
        if cx.value is None or not np.isfinite(cx.value):
            assert not got.found[i]
        else:
            assert got.found[i]
            assert got.value[i] == pytest.approx(cx.value, rel=1e-6)  # scalar bisects to 1e-9


def test_wait_formulas_match_reference(x64):
    rng = np.random.default_rng(6)
    lam, mu = rng.uniform(0.1, 10, 200), rng.uniform(0.1, 10, 200)
    var, k = rng.uniform(0, 2, 200), rng.integers(1, 6, 200).astype(np.float64)
    t = [torch.as_tensor(a, dtype=torch.float64) for a in (lam, mu, var, k)]
    with jax.experimental.enable_x64():
        j = [jnp.asarray(a) for a in (lam, mu, var, k)]
        want = {"mm1": np.asarray(j_analytic_vec.mm1_wait_vec(j[0], j[1])),
                "md1": np.asarray(j_analytic_vec.md1_wait_vec(j[0], j[1], j[3])),
                "mg1": np.asarray(j_analytic_vec.mg1_wait_vec(j[0], j[1], j[2], j[3]))}
    assert_close_inf(mm1_wait_vec(t[0], t[1]).numpy(), want["mm1"], CLOSED_FORM_RTOL)
    assert_close_inf(md1_wait_vec(t[0], t[1], t[3]).numpy(), want["md1"], CLOSED_FORM_RTOL)
    assert_close_inf(mg1_wait_vec(t[0], t[1], t[2], t[3]).numpy(), want["mg1"],
                     CLOSED_FORM_RTOL)


def test_erlang_c_matches_reference_and_scalar(x64):
    rng = np.random.default_rng(7)
    k = rng.integers(1, 12, 100).astype(np.float64)
    mu = rng.uniform(0.5, 5.0, 100)
    lam = rng.uniform(0.0, 1.2, 100) * k * mu  # rho up to 1.2: unstable rows are inf
    lam[:3] = 0.0
    got = mmk_wait_erlang_vec(lam, mu, k, device="cpu")
    assert_close_inf(got, j_analytic_vec.mmk_wait_erlang_vec(lam, mu, k), CLOSED_FORM_RTOL)
    scalar = [mmk_wait_erlang(a, b, int(c)) for a, b, c in zip(lam, mu, k)]
    assert_close_inf(got, scalar, CLOSED_FORM_RTOL)
    with pytest.raises(ValueError, match="max_k"):
        mmk_wait_erlang_vec(1.0, 1.0, 70, device="cpu")


# ---------------------------------------------------------------------------
# Lindley scans (the kernels' plain versions)
# ---------------------------------------------------------------------------


LINDLEY_CASES = {
    "B=1": (1, 300, "exp"),
    "ragged B and T": (13, 700, "exp"),  # neither a multiple of the (8, 512) blocks
    "zero services": (5, 64, "zero"),
    "arrival ties": (6, 200, "ties"),
}


def _lindley_inputs(B, T, kind, seed=0):
    rng = np.random.default_rng(seed)
    inter = rng.exponential(1.0, (B, T))
    if kind == "ties":
        inter[:, ::3] = 0.0  # every third job arrives with the one before it
    arr = np.cumsum(inter, axis=1)
    svc = np.zeros((B, T)) if kind == "zero" else rng.exponential(0.9, (B, T))
    return arr, svc


@pytest.mark.parametrize("case", list(LINDLEY_CASES))
def test_lindley_plain_is_bit_exact_to_reference_and_pallas(x64, case):
    arr, svc = _lindley_inputs(*LINDLEY_CASES[case])
    got = lindley_scan(torch.from_numpy(arr), torch.from_numpy(svc)).numpy()
    with jax.experimental.enable_x64():
        ja, js = jnp.asarray(arr), jnp.asarray(svc)
        ref = np.asarray(jax_lindley_reference(ja, js))
        pallas = np.asarray(jax_lindley_scan(ja, js, impl="interpret"))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)


def test_lindley_plain_float32():
    arr, svc = _lindley_inputs(9, 150, "exp")
    got = lindley_scan(torch.from_numpy(arr).float(), torch.from_numpy(svc).float())
    want = jax_lindley_reference(jnp.asarray(arr, jnp.float32), jnp.asarray(svc, jnp.float32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k_max", [8, 11])
def test_kserver_plain_matches_station_pass(k_max):
    rng = np.random.default_rng(k_max)
    B, T = 16, 1500
    arr = np.cumsum(rng.exponential(0.2, (B, T)), axis=1)
    svc = rng.exponential(0.9, (B, T))
    k = rng.integers(1, 9, B)  # mixed k up to 8
    got = lindley_kserver(torch.from_numpy(arr), torch.from_numpy(svc),
                          torch.from_numpy(k.astype(np.int32)), k_max).numpy()
    want = np.stack([station_pass(arr[i], svc[i], int(k[i])) for i in range(B)])
    np.testing.assert_allclose(got, want, rtol=SIM_RTOL, atol=0)


def test_kserver_plain_matches_reference_scan(x64):
    rng = np.random.default_rng(3)
    B, T = 10, 600
    arr = np.cumsum(rng.exponential(0.3, (B, T)), axis=1)
    svc = rng.exponential(1.0, (B, T))
    k = rng.integers(1, 6, B)
    got = lindley_station(torch.from_numpy(arr), torch.from_numpy(svc), k, k_max=7)
    want = np.asarray(j_sim_vec.lindley_station(arr, svc, k, k_max=7))
    np.testing.assert_array_equal(got.numpy(), want)  # the same scan, step for step


@pytest.mark.parametrize("k_row", [0, 5])
def test_kserver_refuses_k_outside_1_to_k_max(k_row):
    arr = torch.zeros(3, 4, dtype=torch.float64)
    k = torch.tensor([1, k_row, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="1..k_max=4"):
        lindley_kserver(arr, arr, k, 4)


def test_lindley_station_refusals():
    arr = torch.zeros(3, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="k_max"):
        lindley_station(arr, arr, np.array([1, 4, 2]), k_max=3)


# ---------------------------------------------------------------------------
# the batched simulator
# ---------------------------------------------------------------------------


def _reference_draws(strategy: str, seed: int, shape):
    """The standard draws ``repro.fleet.sim_vec.simulate_fleet`` makes, by
    its own key splits: keys = split(PRNGKey(seed), 4); on-device services
    split keys[1], an edge's split keys[2] (exponential, then normal); the
    NIC stages draw from keys[1] and keys[3]."""
    with jax.experimental.enable_x64():
        keys = jax.random.split(jax.random.PRNGKey(seed), 4)
        out = {"inter": jax.random.exponential(keys[0], shape)}
        svc_key = keys[1] if strategy == "on_device" else keys[2]
        kn, kl = jax.random.split(svc_key)
        out["service_exp"] = jax.random.exponential(kn, shape)
        out["service_normal"] = jax.random.normal(kl, shape)
        if strategy != "on_device":
            out["nic_req"] = jax.random.exponential(keys[1], shape)
            out["nic_res"] = jax.random.exponential(keys[3], shape)
        return {k: np.asarray(v) for k, v in out.items()}


INTEGER_KS = (1.0, 2.0, 3.0, 4.0)


@pytest.mark.parametrize("strategy,ks", [("on_device", (1.0,)), ("on_device", INTEGER_KS),
                                         ("edge[0]", (1.0,)), ("edge[0]", INTEGER_KS)])
def test_simulate_fleet_on_reference_draws(x64, strategy, ks):
    """k = 1 everywhere takes the k = 1 scan alone; integer k > 1 takes the
    k-server scan and the resorts. Departure clocks agree to 1e-12 relative;
    latencies, their differences with the arrival clocks, to 1e-12 of the
    largest clock (the absolute error the cumulative sums leave)."""
    ports, refs = _pairs(8, 12, edges=1, background=False, rho_max=0.85, ks=ks)
    n, seed = 2000, 11
    want = j_sim_vec.simulate_fleet(JScenarioBatch.from_scenarios(refs), strategy, n=n,
                                    seed=seed)
    draws = _reference_draws(strategy, seed, (len(ports), n))
    got = simulate_fleet(ScenarioBatch.from_scenarios(ports), strategy, n=n, draws=draws,
                         device="cpu")
    np.testing.assert_allclose(got.arrivals, want.arrivals, rtol=SIM_RTOL, atol=0)
    np.testing.assert_allclose(got.latencies + got.arrivals, want.latencies + want.arrivals,
                               rtol=SIM_RTOL, atol=0)
    np.testing.assert_allclose(got.latencies, want.latencies, rtol=0,
                               atol=SIM_RTOL * want.arrivals.max())
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-9)


@pytest.mark.parametrize("strategy", ["on_device", "edge[0]"])
def test_simulate_fleet_own_draws_meet_the_mape_gate(strategy):
    """The paper's operating point swept to every queue at rho <= 0.72, on
    single-server stations, where the closed forms are exact (the k*mu
    aggregation at k > 1 is an approximation the reference does not gate)."""
    batch = ScenarioBatch.from_sweep(fleet_sweep.default_scenario(), {
        "workload.arrival_rate": np.linspace(0.5, 4.5, 8),
        "network.bandwidth_Bps": np.geomspace(1.5e6, 20e6, 6) / 8})
    res = simulate_fleet(batch, strategy, n=4096, seed=5, device="cpu")
    pred = fleet_analytic(batch, device="cpu")
    want = pred.t_dev if strategy == "on_device" else pred.t_edge[:, 0]
    assert res.latencies.shape == (48, 4096) and np.isfinite(res.latencies).all()
    mape = np.abs(res.mean - want) / want * 100
    assert mape.mean() <= 5.0, mape
    again = simulate_fleet(batch, strategy, n=4096, seed=5, device="cpu")
    np.testing.assert_array_equal(again.latencies, res.latencies)  # seeded
    other = simulate_fleet(batch, strategy, n=4096, seed=6, device="cpu")
    assert not np.array_equal(other.latencies, res.latencies)


def test_simulate_fleet_refusals():
    ports, _ = _pairs(10, 3, edges=1, background=False, rho_max=0.5, ks=(1.0,))
    base = ports[0]
    mt = replace(base, edges=(replace(base.edges[0],
                                      background=(TenantStream(1.0, 0.01, 0.0),)),))
    with pytest.raises(ValueError, match="background tenants"):
        simulate_fleet(ScenarioBatch.from_scenarios([mt]), "edge[0]", n=50, device="cpu")
    frac_dev = replace(base, device=replace(base.device, parallelism_k=2.5))
    with pytest.raises(ValueError, match="fractional device"):
        simulate_fleet(ScenarioBatch.from_scenarios([frac_dev]), "on_device", n=50,
                       device="cpu")
    frac_edge = replace(base, edges=(replace(base.edges[0], tier=replace(
        base.edges[0].tier, parallelism_k=1.5)),))
    with pytest.raises(ValueError, match="fractional edge"):
        simulate_fleet(ScenarioBatch.from_scenarios([frac_edge]), "edge[0]", n=50,
                       device="cpu")
    k3 = replace(base, device=replace(base.device, parallelism_k=3.0))
    with pytest.raises(ValueError, match="k_max"):
        simulate_fleet(ScenarioBatch.from_scenarios([k3]), "on_device", n=50, k_max=2,
                       device="cpu")
    with pytest.raises(ValueError, match="unknown strategy"):
        simulate_fleet(ScenarioBatch.from_scenarios([base]), "edge", n=50, device="cpu")
    with pytest.raises(ValueError, match="not every scenario"):
        simulate_fleet(ScenarioBatch.from_scenarios([base]), "edge[1]", n=50, device="cpu")
    with pytest.raises(ValueError, match="unknown draws"):
        simulate_fleet(ScenarioBatch.from_scenarios([base]), "on_device", n=50,
                       draws={"nic_req": np.zeros((1, 50))}, device="cpu")


# ---------------------------------------------------------------------------
# the fleet-sweep CLI
# ---------------------------------------------------------------------------


def test_run_sweep_matches_reference(x64):
    axes = {"network.bandwidth_Bps": np.geomspace(1e5, 1e8, 16),
            "workload.arrival_rate": np.linspace(0.5, 30.0, 8)}
    got = fleet_sweep.run_sweep(fleet_sweep.default_scenario(), axes,
                                crossover_axis="bandwidth", repeat=1, device="cpu")
    want = j_fleet_sweep.run_sweep(j_fleet_sweep.default_scenario(), axes,
                                   crossover_axis="bandwidth", repeat=1)
    assert got["batch_size"] == want["batch_size"] == 128
    assert got["strategy_counts"] == want["strategy_counts"]
    assert got["scenario"] == want["scenario"] and got["axes"] == want["axes"]
    for key in ("best_latency_s",):
        for stat, v in want[key].items():
            assert got[key][stat] == pytest.approx(v, rel=CLOSED_FORM_RTOL)
    for stat in ("found_frac", "min", "median", "max"):
        assert got["crossover"][stat] == pytest.approx(want["crossover"][stat],
                                                       rel=CLOSED_FORM_RTOL)


def test_fleet_sweep_cli_writes_report(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    rc = fleet_sweep.main(["--device", "cpu", "--axis", "workload.arrival_rate=0.5:20:6",
                           "--crossover", "arrival_rate", "--repeat", "1", "--out", str(out)])
    assert rc == 0
    d = json.loads(out.read_text())
    assert d["batch_size"] == 6 and d["device"] == "cpu"
    assert sum(d["strategy_counts"].values()) == 6
    assert "torch" in d["manifest"]["packages"] and "jax" not in d["manifest"]["packages"]
    assert "6 scenarios on cpu" in capsys.readouterr().out


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CUDA default is exercised by test_torch_cuda")
    ports, _ = _pairs(12, 1)
    batch = ScenarioBatch.from_scenarios(ports)
    for call in (lambda: fleet_analytic(batch), lambda: simulate_fleet(batch, n=10),
                 lambda: fleet_crossover(batch, "bandwidth"),
                 lambda: fleet_sweep.main(["--axis", "workload.arrival_rate=1:2:2"])):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
