"""The port's fleet-side bench families (``repro_torch.bench.{fleet,cluster,
meanfield,validate,tail,plan}_bench``) on the CPU against the reference's
(``benchmarks/*_bench.py``), at the same shrunken module constants on both
sides (the reference sizes run on the card through ``chip_smoke.py``).

The reference's x64 paths run through the ``x64`` fixture (a scoped
``jax.enable_x64(True)`` in place of ``jax.experimental.enable_x64``, gone in
JAX 0.9.0: ROADMAP C1). Each report is flattened to its leaves; the paths the
spec itself declares ``volatile`` (timings, rates) are masked, and every
other leaf is held:

  * integers, booleans, strings (counts, iterations, plans, flags, names):
    exactly;
  * floats from closed forms and deterministic solvers: 1e-9 relative (XLA
    and torch may round a pow/log/exp an ulp apart, and sums associate
    differently);
  * sampled leaves, by statistical gates, since torch cannot replay
    ``jax.random``: fleet's ``vec_vs_scalar_mean_gap`` (batched vs scalar
    simulation, each side's own draws: under 5%), validate's smoke-gate MAPE
    and verdict (both sides' gates pass, MAPE within the 5% budget);
  * tail's ``euler_vec_vs_scalar_max_err``, a rounding-noise floor (~1e-12
    on both sides, never equal): at most 1e-8, the differential gate's
    budget.

The cluster family's closed loop draws Poisson counts; the test hands the
port the reference's own counts (``repro.fleet.cluster._poisson_counts``),
as ``tests/test_torch_cluster.py`` does, so its decisions and latencies are
held exactly / to 1e-9. C7: the port's scalar asymptote takes the Euler path
where a path's dominant pole is shared; ``C7_ENTRIES`` names the golden
corpus entries where that moves a p99 off the reference's (none at p99:
the tail family's asymptote-vs-Euler gap equals the reference's).
"""

import contextlib
import importlib
import io
import json
import math
from numbers import Number

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scenario import analytic_tail as ref_analytic_tail
from repro.fleet import cluster as ref_cluster
from repro.validate import generate_corpus as ref_generate_corpus
from repro_torch.core.scenario import analytic_tail
from repro_torch.exp import bench_family_specs
from repro_torch.fleet import TraceBatch, Trace
from repro_torch.validate import generate_corpus

RTOL = 1e-9
Q = 0.99

# family -> (row function, the same small constants on both sides)
FAMILIES = {
    "fleet": ("fleet_rows", dict(GRID_BW=16, GRID_LAM=8, SCALAR_SAMPLE=8, SIM_BATCH=8,
                                 SIM_JOBS=4000, CX_BATCH=64, CX_SCALAR=4)),
    "cluster": ("cluster_rows", dict(N_CLIENTS=8, EPOCHS=60)),
    "meanfield": ("meanfield_rows", dict(EPOCHS=48, DAY_S=48 * 60.0)),
    "validate": ("validate_rows", {}),  # the reference's smoke gate fails below 20,000 jobs
    "tail": ("tail_rows", dict(SWEEP_B=8, SWEEP_LAM=4)),
    "plan": ("plan_rows", dict(N_CLIENTS=8)),
}

# leaves held by a statistical gate instead of equality: leaf -> check(port, ref)
SAMPLED = {
    "fleet": {"simulation.vec_vs_scalar_mean_gap": lambda p, r: 0 <= p < 0.05 and 0 <= r < 0.05},
    "validate": {"smoke_gate_mean_mape_pct": lambda p, r: 0 < p < 5.0 and 0 < r < 5.0,
                 "smoke_gate_passed": lambda p, r: p is True and r is True},
    "tail": {"euler_vec_vs_scalar_max_err": lambda p, r: p <= 1e-8 and r <= 1e-8},
}

# golden-corpus entries whose p99 by the asymptote parts from the reference's
# on purpose (C7); none: no entry's path shares its dominant pole at p99
C7_ENTRIES: tuple[str, ...] = ()


def _reference_counts(seed, tb, dt):
    with jax.enable_x64(True):
        return np.asarray(ref_cluster._poisson_counts(seed, jnp.asarray(tb.arrival_rate),
                                                      jnp.float64(dt)))


def _with_reference_counts(port_simulate_cluster):
    """The port's simulate_cluster fed the reference's Poisson counts."""
    def run(spec, trace, **kw):
        tb = TraceBatch.from_trace(trace, spec.n_clients) if isinstance(trace, Trace) else trace
        n_req = _reference_counts(kw["seed"], tb, tb.epoch_s)
        return port_simulate_cluster(spec, tb, n_req=n_req, **kw)
    return run


def _run(pkg: str, family: str, out_dir):
    fn, consts = FAMILIES[family]
    mod = importlib.import_module(f"{pkg}.{family}_bench")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in consts.items():
            mp.setattr(mod, k, v)
        kw = {}
        if pkg == "repro_torch.bench":
            kw["device"] = "cpu"
            if family == "cluster":
                mp.setattr(mod, "simulate_cluster", _with_reference_counts(mod.simulate_cluster))
        out_dir.mkdir()
        with contextlib.redirect_stdout(io.StringIO()) as csv:
            report = getattr(mod, fn)(out_dir, **kw)
    doc = json.loads((out_dir / f"BENCH_{family}.json").read_text())
    return report, doc, csv.getvalue()


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Both packages' reports, once per family (the reference under the C1
    shim, torch on one intra-op thread, both restored after)."""
    cache = {}

    def get(family):
        if family not in cache:
            tmp = tmp_path_factory.mktemp(family)
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True),
                               raising=False)
                    ref = _run("benchmarks", family, tmp / "ref")
                port = _run("repro_torch.bench", family, tmp / "port")
            finally:
                torch.set_num_threads(threads)
            cache[family] = port, ref
        return cache[family]
    return get


def _flatten(doc, prefix=""):
    out = {}
    for k, v in doc.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _volatile(family):
    spec = bench_family_specs()[family]
    return set(spec.volatile.get(f"BENCH_{family}.json", ()))


def _close(a, b) -> bool:
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_close, a, b))
    if isinstance(a, bool) or not isinstance(a, Number):
        return a == b and type(a) is type(b)
    if isinstance(a, int) and isinstance(b, int):
        return a == b
    if math.isnan(a) or math.isnan(b) or math.isinf(a) or math.isinf(b):
        return a == b or (math.isnan(a) and math.isnan(b))
    return abs(a - b) <= RTOL * max(abs(a), abs(b), 1e-300)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_report_equals_the_reference(reports, family):
    (port, port_doc, _), (ref, ref_doc, _) = reports(family)
    p, r = _flatten(port), _flatten(ref)
    assert list(p) == list(r)
    volatile, sampled = _volatile(family), SAMPLED.get(family, {})
    held = 0
    for leaf in p:
        if leaf in volatile:
            continue
        if leaf in sampled:
            assert sampled[leaf](p[leaf], r[leaf]), (leaf, p[leaf], r[leaf])
            continue
        assert type(p[leaf]) is type(r[leaf]) or (
            isinstance(p[leaf], Number) and isinstance(r[leaf], Number)
            and not isinstance(p[leaf], bool)), (leaf, p[leaf], r[leaf])
        assert _close(p[leaf], r[leaf]), (leaf, p[leaf], r[leaf])
        held += 1
    assert held >= 2  # validate holds its two corpus counts; the rest hold more
    # the JSON artifact is the report (the manifest is stamped by bench.run)
    assert json.loads(json.dumps(port)) == port_doc and json.loads(json.dumps(ref)) == ref_doc


@pytest.mark.parametrize("family", list(FAMILIES))
def test_csv_rows_are_the_reference_s(reports, family):
    """The same CSV rows in the same order; the derived column equal where
    it carries no timing or sampled number."""
    (_, _, port_csv), (_, _, ref_csv) = reports(family)
    names = lambda csv: [line.split(",", 1)[0] for line in csv.splitlines()]  # noqa: E731
    assert names(port_csv) == names(ref_csv) and names(port_csv)
    deterministic = {"plan_provision_48c", "plan_provision_result", "plan_provision_p99",
                     "cluster_equilibrium", "meanfield_cross_check",
                     "tail_asym_vs_euler_gap", "tail_p99_crossover_shift"}
    rows = lambda csv: {line.split(",")[0]: line.split(",", 2)[2]  # noqa: E731
                        for line in csv.splitlines()}
    pr, rr = rows(port_csv), rows(ref_csv)
    for name in set(pr) & deterministic:
        assert pr[name] == rr[name], name


def test_plan_headlines(reports):
    """The acceptance headlines of the plan family: the plan, its cost in
    equilibrium solves and its worst p99 are the reference's."""
    (port, _, _), (ref, _, _) = reports("plan")
    assert port["plan"]["n_edges"] == ref["plan"]["n_edges"]
    assert port["solver"]["evaluations"] == ref["solver"]["evaluations"]
    assert port["plan"]["max_latency_ms"] == pytest.approx(ref["plan"]["max_latency_ms"],
                                                           rel=RTOL)
    assert port["plan"]["max_latency_ms"] <= port["slo_ms"]


def test_tail_c7_entries(x64):
    """The asymptote p99 of every golden-corpus entry, scalar path, against
    the reference's: the entries that part are exactly C7_ENTRIES."""
    port = generate_corpus(0, device="cpu")
    ref = ref_generate_corpus(0)
    assert [e.name for e in port] == [e.name for e in ref]
    parted = []
    for pe, re_ in zip(port, ref):
        got = analytic_tail(pe.scenario, Q, method="asymptote")
        want = ref_analytic_tail(re_.scenario, Q, method="asymptote")
        assert list(got) == list(want)
        if not all(_close(got[k], want[k]) for k in got):
            parted.append(pe.name)
    assert tuple(parted) == C7_ENTRIES


@pytest.fixture
def x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True),
                        raising=False)


def test_cli_writes_plan_and_validate(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.bench.run --device cpu --only plan,validate``
    writes both JSONs, each stamped with a manifest."""
    from repro_torch.bench import plan_bench
    from repro_torch.bench.run import main

    monkeypatch.setattr(plan_bench, "N_CLIENTS", 8)
    assert main(["--device", "cpu", "--only", "plan,validate", "--out", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["BENCH_plan.json",
                                                          "BENCH_validate.json"]
    for p in tmp_path.iterdir():
        doc = json.loads(p.read_text())
        assert doc["manifest"]["packages"]["torch"]
    plan = json.loads((tmp_path / "BENCH_plan.json").read_text())
    assert (plan["plan"]["n_edges"], plan["solver"]["evaluations"]) == (1, 6)
    assert capsys.readouterr().out.splitlines()[0] == "name,us_per_call,derived"
