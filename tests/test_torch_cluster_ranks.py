"""The port's closed loop on the rank path: ``simulate_cluster(shards=4)``
with one client block on each rank of a four-rank ``gloo`` group and one
collective an epoch, on the CPU.

One module-scoped run starts the group (``torch.multiprocessing.spawn``
behind a 180 s subprocess, a ``file://`` rendezvous) and runs every case on
every rank, each rank writing its results to ``.npz``; the reference's
``_closed_loop_scan_shardmap`` runs beside it in a child of its own (four
forced host devices, the C1 x64 shim). Inputs are made from numpy seeds;
where the counts are the reference's (``_poisson_counts``), they are drawn
here and handed to every rank.

Tolerances, each with its reason:
  * the rank path against the in-process ``shards=4`` blocked twin: choices
    exact; floats 1e-12 relative (the same arithmetic, the endogenous sum
    formed per block and then over the blocks on both sides);
  * rank against rank: bit for bit (every rank sums the gathered partials
    in rank order and scores the same gathered choices);
  * the rank path against the reference's ``shard_map`` on its counts: the
    budgets of ``tests/test_torch_cluster.py``'s ``_assert_cluster_close``
    (choices exact, latencies 1e-9, estimators and loads 1e-12).

Run as a script (``python tests/test_torch_cluster_ranks.py ranks DIR`` or
``reference DIR``), this file is the children; its module imports stay
light so that each spawned rank imports no JAX.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

WORLD = 4
CHILD_TIMEOUT_S = 180
CLOSED_FORM_RTOL = 1e-9
SUM_RTOL = 1e-12
SRC = Path(__file__).resolve().parents[1] / "src"
CASES = ("small", "acceptance", "slo", "seeded")
EPOCHS = {"small": 40, "acceptance": 120, "slo": 40, "seeded": 30}
ACCEPT_POLICIES = ("adaptive", "on_device") + tuple(f"edge[{j}]" for j in range(4))


def _flatten(res) -> dict[str, np.ndarray]:
    """A ``ClusterResult`` (either package's) as named arrays."""
    out = {f"est/{k}": np.asarray(getattr(res, k)) for k in (
        "est_bandwidth_Bps", "est_arrival_rate", "est_endo_rate", "est_exo_rate")}
    for name, p in res.policies.items():
        out[f"pol/{name}/choices"] = np.asarray(p.choices)
        out[f"pol/{name}/latencies_s"] = np.asarray(p.latencies_s)
        out[f"pol/{name}/edge_loads"] = np.asarray(p.edge_loads)
        out[f"pol/{name}/saturated"] = np.asarray(p.saturated_epochs)
    return out


def _acceptance_trace(mod):
    return mod.make_trace(120.0, 1.0, arrival_rate=2.0, bandwidth_Bps=lambda t: (
        mod.step_signal(t, [(0, 2.5e6), (40, 2.5e6 * 0.15), (80, 2.5e6)])))


# ---------------------------------------------------------------------------
# the children
# ---------------------------------------------------------------------------


def _rank_main(rank: int, out: str) -> None:
    """One rank: every case, written to ``{case}.{rank}.npz``."""
    import torch.distributed as dist

    from repro_torch.fleet import cluster as pc
    from repro_torch.fleet import simulate_cluster

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/rendezvous", rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=60))
    cases = pickle.loads(Path(out, "cases.pkl").read_bytes())

    def run(name, spec, tr, kw):
        before = dict(pc.RANK_PATH)
        res = simulate_cluster(spec, tr, device="cpu", shards=WORLD, **kw)
        counts = {k: pc.RANK_PATH[k] - before[k] for k in ("runs", "collectives")}
        np.savez(Path(out, f"{name}.{rank}.npz"), **_flatten(res),
                 **{f"count/{k}": np.asarray(v) for k, v in counts.items()})

    for name, (spec, tr, kw) in cases.items():
        run(name, spec, tr, kw)

    # the planted fault: rank 0 decides on its own partial, not the total
    real = pc._rank_total

    def local_only(group, world, device):
        gathered = real(group, world, device)
        return lambda own: (gathered(own), own.sum(dim=0))[1]

    if rank == 0:
        pc._rank_total = local_only
    spec, tr, kw = cases["acceptance"]
    run("fault", spec, tr, kw)
    pc._rank_total = real

    # a rank fed another seed: every rank must refuse before the loop
    spec, tr, kw = cases["seeded"]
    try:
        simulate_cluster(spec, tr, device="cpu", shards=WORLD,
                         **dict(kw, seed=kw["seed"] + (rank == WORLD - 1)))
        said = "no error"
    except ValueError as e:
        said = str(e)
    Path(out, f"mismatch.{rank}.txt").write_text(said)
    dist.destroy_process_group()


def _reference_main(out: str) -> None:
    """The reference's acceptance run through ``_closed_loop_scan_shardmap``
    on four forced host devices, with the C1 shim."""
    import jax
    import jax.experimental

    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    from repro.fleet import cluster as jc
    from repro.fleet import traces as j_traces
    from repro.launch.cluster_sim import default_cluster

    assert len(jax.devices()) == WORLD, jax.devices()
    calls = []
    real = jc._closed_loop_scan_shardmap
    jc._closed_loop_scan_shardmap = lambda *a, **k: calls.append(k["shards"]) or real(*a, **k)
    res = jc.simulate_cluster(default_cluster(64), _acceptance_trace(j_traces),
                              policies=ACCEPT_POLICIES, stagger=8, seed=1, shards=WORLD)
    np.savez(Path(out, "reference.npz"), **_flatten(res), shardmap_calls=np.asarray(calls))


# ---------------------------------------------------------------------------
# the run: cases, both children, the in-process twins
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, restored after (see test_torch_fleet)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _pair(jspec):
    from repro_torch.core.scenario import ClusterSpec

    return ClusterSpec.from_dict(jspec.to_dict()), jspec


def _small_pair(n: int = 5):
    """n clients on three edges: a dedicated A2, an exponential T4, and a
    general-service edge with a background tenant (test_torch_cluster's)."""
    from repro.core import EdgeSpec, NetworkPath, ServiceModel, TenantStream, Tier, Workload
    from repro.core.scenario import ClusterSpec as JClusterSpec
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
    return _pair(JClusterSpec(base=base, n_clients=n,
                              arrival_scale=tuple(np.linspace(0.6, 1.6, n)), name="small"))


def _trace_pair(duration, drop, edges, seed=3):
    """The same step-bandwidth trace through each package's generators, with
    seeded churn on ``edges`` exogenous background columns."""
    from repro.fleet import traces as j_traces
    from repro_torch.fleet import traces

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


def _reference_counts(seed, jtr, n):
    import jax
    import jax.numpy as jnp

    from repro.fleet import cluster as jc
    from repro.fleet import traces as j_traces

    tb = j_traces.TraceBatch.from_trace(jtr, n)
    with jax.enable_x64(True):
        return np.asarray(jc._poisson_counts(seed, jnp.asarray(tb.arrival_rate),
                                             jnp.float64(jtr.epoch_s)))


def _cases() -> dict:
    """name -> (port spec, port trace, simulate_cluster keywords)."""
    from repro.launch import cluster_sim as j_cluster_sim
    from repro.fleet import traces as j_traces
    from repro_torch.fleet import traces

    spec, _ = _small_pair(5)
    tr, jtr = _trace_pair(40.0, drop=0.3, edges=3)
    small = dict(policies=("adaptive", "on_device", "edge[1]", "edge[2]"), seed=7, stagger=3,
                 hysteresis=0.2, n_req=_reference_counts(7, jtr, 5))
    accept, _ = _pair(j_cluster_sim.default_cluster(64))
    seeded, _ = _pair(j_cluster_sim.default_cluster(18))
    tr_seeded, _ = _trace_pair(30.0, drop=0.3, edges=4)
    return {
        "small": (spec, tr, small),
        "acceptance": (accept, _acceptance_trace(traces), dict(
            policies=ACCEPT_POLICIES, stagger=8, seed=1,
            n_req=_reference_counts(1, _acceptance_trace(j_traces), 64))),
        "slo": (spec, tr, dict(small, slo_quantile=0.99, tail_method="asymptote")),
        "seeded": (seeded, tr_seeded, dict(policies=("adaptive", "on_device", "edge[3]"),
                                           seed=5, stagger=4, hysteresis=0.1)),
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both children started together, then the in-process twins while they
    run. Returns (cases, {case: [rank 0..3 arrays]}, twins, reference)."""
    from repro_torch.fleet import simulate_cluster

    out = tmp_path_factory.mktemp("ranks")
    cases = _cases()
    (out / "cases.pkl").write_bytes(pickle.dumps(cases))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")]),
               JAX_PLATFORMS="cpu", XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               OMP_NUM_THREADS="1")
    children = {mode: subprocess.Popen([sys.executable, __file__, mode, str(out)], env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
                for mode in ("ranks", "reference")}
    twins = {name: _flatten(simulate_cluster(spec, tr, device="cpu", shards=WORLD, **kw))
             for name, (spec, tr, kw) in cases.items()}
    for mode, proc in children.items():
        try:
            said, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            said, _ = proc.communicate()
            pytest.fail(f"the {mode} child passed {CHILD_TIMEOUT_S} s:\n{said[-4000:]}")
        assert proc.returncode == 0, f"the {mode} child failed:\n{said[-4000:]}"
    ranks = {name: [dict(np.load(out / f"{name}.{r}.npz")) for r in range(WORLD)]
             for name in CASES + ("fault",)}
    mismatch = [(out / f"mismatch.{r}.txt").read_text() for r in range(WORLD)]
    return cases, ranks, twins, dict(np.load(out / "reference.npz")), mismatch


def _assert_close(got, want, *, latency_rtol):
    """Choices and saturated counts exact; latencies to ``latency_rtol``;
    loads and estimators 1e-12 relative (``est_endo_rate`` with 1e-15
    absolute, for its zeros)."""
    assert sorted(k for k in got if not k.startswith("count/")) == sorted(
        k for k in want if k != "shardmap_calls")
    for k, w in want.items():
        if k == "shardmap_calls":
            continue
        g = got[k]
        if k.endswith(("/choices", "/saturated")):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k.endswith("/latencies_s"):
            np.testing.assert_allclose(g, w, rtol=latency_rtol, atol=0, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=SUM_RTOL, atol=1e-15 if "endo" in k else 0,
                                       err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_rank_path_equals_the_blocked_twin(run, case):
    """Every rank's result against the in-process ``shards=4`` run; the loop
    couples the clients (offloads, switches)."""
    _, ranks, twins, _, _ = run
    for arrays in ranks[case]:
        _assert_close(arrays, twins[case], latency_rtol=SUM_RTOL)
    choices = ranks[case][0]["pol/adaptive/choices"]
    assert (choices >= 0).mean() > 0 and (choices[1:] != choices[:-1]).sum() > 0


@pytest.mark.parametrize("case", CASES)
def test_every_rank_returns_the_same_result(run, case):
    _, ranks, _, _, _ = run
    first = ranks[case][0]
    for r, arrays in enumerate(ranks[case][1:], 1):
        assert arrays.keys() == first.keys()
        for k in first:
            if not k.startswith("count/"):
                np.testing.assert_array_equal(arrays[k], first[k], err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("case", CASES)
def test_one_rank_path_run_and_one_collective_an_epoch(run, case):
    _, ranks, _, _, _ = run
    for arrays in ranks[case]:
        assert int(arrays["count/runs"]) == 1
        assert int(arrays["count/collectives"]) == EPOCHS[case]
        assert arrays["pol/adaptive/choices"].shape[0] == EPOCHS[case]


def test_rank_path_equals_the_reference_shard_map(run):
    """The acceptance run against the reference's own ``shard_map`` path on
    its counts: the same decisions, scores and estimators."""
    _, ranks, _, reference, _ = run
    assert reference["shardmap_calls"].tolist() == [WORLD]
    for arrays in ranks["acceptance"]:
        _assert_close(arrays, reference, latency_rtol=CLOSED_FORM_RTOL)


def test_a_rank_on_its_own_partial_fails_the_parity(run):
    """The planted fault: rank 0 decides on its block's own load, not the
    gathered total; its choices part from the blocked twin's."""
    _, ranks, twins, _, _ = run
    fault = ranks["fault"][0]["pol/adaptive/choices"]
    want = twins["acceptance"]["pol/adaptive/choices"]
    assert fault.shape == want.shape and not np.array_equal(fault, want)
    with pytest.raises(AssertionError):
        _assert_close(ranks["fault"][0], twins["acceptance"], latency_rtol=SUM_RTOL)


def test_ranks_fed_other_counts_refuse(run):
    """Rank 3 with another seed: every rank raises before the loop, naming
    the checksum that differs and the rank."""
    *_, mismatch = run
    for said in mismatch:
        assert "different inputs" in said and "counts (rank 3" in said


# ---------------------------------------------------------------------------
# the dispatch, in this process
# ---------------------------------------------------------------------------


def _dispatch_case():
    from repro_torch.fleet import traces
    from repro_torch.launch.cluster_sim import default_cluster

    tr = traces.make_trace(20.0, 1.0, arrival_rate=2.0, bandwidth_Bps=lambda t: (
        traces.step_signal(t, [(0, 2.5e6), (10, 4e5)])))
    return default_cluster(6), tr, dict(policies=("adaptive", "on_device"), stagger=2, seed=3,
                                        device="cpu")


@pytest.fixture
def spy_rank_total(monkeypatch):
    from repro_torch.fleet import cluster as pc

    calls = []
    real = pc._rank_total
    monkeypatch.setattr(pc, "_rank_total", lambda *a: calls.append(a) or real(*a))
    return calls


@pytest.fixture
def world(tmp_path):
    """Bring up a process group in this process, torn down after."""
    import torch.distributed as dist

    def up(backend: str, size: int):
        if backend == "fake":
            from torch.testing._internal.distributed.fake_pg import FakeStore

            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
        else:
            dist.init_process_group(backend, init_method=f"file://{tmp_path}/rendezvous",
                                    rank=0, world_size=size)

    assert not dist.is_initialized()
    yield up
    if dist.is_initialized():
        dist.destroy_process_group()


def test_no_group_takes_the_in_process_loop(spy_rank_total):
    from repro_torch.fleet import cluster as pc
    from repro_torch.fleet import simulate_cluster

    spec, tr, kw = _dispatch_case()
    before = dict(pc.RANK_PATH)
    flat = _flatten(simulate_cluster(spec, tr, **kw))
    for shards in (2, 4):
        _assert_close(_flatten(simulate_cluster(spec, tr, shards=shards, **kw)), flat,
                      latency_rtol=SUM_RTOL)
    assert pc.RANK_PATH == before and not spy_rank_total


@pytest.mark.parametrize("size", [2, 4])
def test_a_fake_group_of_shards_ranks_is_refused(world, size):
    from repro_torch.fleet import simulate_cluster

    spec, tr, kw = _dispatch_case()
    world("fake", size)
    with pytest.raises(RuntimeError, match="'fake' process group"):
        simulate_cluster(spec, tr, shards=size, **kw)


@pytest.mark.parametrize("backend,size,shards", [("gloo", 1, 2), ("fake", 4, 2), ("fake", 2, 3)])
def test_a_group_of_another_size_takes_the_blocked_twin(world, spy_rank_total, backend, size,
                                                        shards):
    from repro_torch.fleet import cluster as pc
    from repro_torch.fleet import simulate_cluster

    spec, tr, kw = _dispatch_case()
    want = _flatten(simulate_cluster(spec, tr, shards=shards, **kw))
    world(backend, size)
    before = dict(pc.RANK_PATH)
    got = _flatten(simulate_cluster(spec, tr, shards=shards, **kw))
    assert pc.RANK_PATH == before and not spy_rank_total
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


if __name__ == "__main__":
    mode, out = sys.argv[1], sys.argv[2]
    if mode == "ranks":
        import torch.multiprocessing as mp

        mp.spawn(_rank_main, args=(out,), nprocs=WORLD)
    else:
        _reference_main(out)
