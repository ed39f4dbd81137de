"""The port's experiment layer (``repro_torch.exp``), its regression gate
(``repro_torch.bench.check_regression``) and its ``reproduce`` CLI, against
the reference's (``repro.exp``, ``benchmarks.check_regression``,
``repro.launch.reproduce``).

The registry equals the reference's key for key once each payload is mapped
to its twin (descriptions aside); the runner and the CLI are held by twins of
``tests/test_exp.py`` run on the port with ``device="cpu"``; the gate's
``compare`` and ``manifest_notes`` give the reference's rows, counts and
notes on the same hand-made directories. New here: the device (and a card's
name) keys the run id, a payload outside ``repro_torch`` is refused, and the
CLIs raise without a card unless asked for the CPU. A subprocess holds that
``reproduce`` loads no module of ``jax``, ``repro`` or ``benchmarks``.
"""

import contextlib
import copy
import io
import itertools
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from benchmarks import check_regression as ref_gate
from repro.exp import registry as ref_registry
from repro_torch.bench import check_regression as gate
from repro_torch.bench import run as bench_run
from repro_torch.exp import (
    ExperimentError,
    ExperimentSpec,
    bench_family_specs,
    diff_results,
    registry,
    resolve_payload,
    run_experiment,
    run_id_for,
    strip_volatile,
)
from repro_torch.launch import reproduce
from repro_torch.obs import manifest_delta, run_manifest

ROOT = Path(__file__).resolve().parent.parent

# -- a controllable payload the runner resolves by dotted name ---------------
# (the port resolves only repro_torch modules, so the fake payload is handed
# to the runner through a monkeypatched resolve_payload)

_CALLS = itertools.count()


def fake_payload(out_dir, seed, config, device=None):
    assert device == "cpu"
    doc = {
        "value": 10.0 * (seed + 1) + float(config.get("offset", 0)),
        "elapsed_s": 0.25 + next(_CALLS),  # wall-clock stand-in: never stable
        "stable": "constant",
    }
    (Path(out_dir) / "OUT.json").write_text(json.dumps(doc, indent=2))
    return {"value": doc["value"], "gate": {"passed": config.get("ok", True)}}


FAKE = "repro_torch.exp.fake:fake_payload"


@pytest.fixture
def fake(monkeypatch):
    from repro_torch.exp import runner

    real = runner.resolve_payload
    monkeypatch.setattr(runner, "resolve_payload",
                        lambda p: fake_payload if p == FAKE else real(p))


def fake_spec(**over) -> ExperimentSpec:
    kw = dict(
        exp_id="fake-exp",
        kind="bench-family",
        payload=FAKE,
        seeds=(0,),
        seed_sensitive=True,
        outputs=("OUT.json",),
        volatile={"OUT.json": ("elapsed_s",)},
    )
    kw.update(over)
    return ExperimentSpec(**kw)


def run_cpu(spec, root, **kw):
    return run_experiment(spec, results_root=root, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def to_reference(payload: str) -> str:
    """The reference's payload for the port's twin."""
    mod, _, fn = payload.partition(":")
    if mod.startswith("repro_torch.bench."):
        mod = "benchmarks." + mod.removeprefix("repro_torch.bench.")
    elif mod.startswith("repro_torch."):
        mod = "repro." + mod.removeprefix("repro_torch.")
    return f"{mod}:{fn}"


def test_registry_equals_the_reference_payloads_mapped():
    port, ref = registry(), ref_registry()
    assert list(port) == list(ref) and len(port) == 15
    for exp_id, spec in port.items():
        got = spec.to_dict()
        want = ref[exp_id].to_dict()
        got["payload"] = to_reference(got["payload"])
        got.pop("description"), want.pop("description")
        assert got == want, exp_id


def test_every_bench_module_registered_exactly_once():
    """Each repro_torch/bench/*_bench.py rows module backs exactly one
    experiment, and the set of them is the reference's."""
    bench_dir = ROOT / "src" / "repro_torch" / "bench"
    modules = {f"repro_torch.bench.{p.stem}" for p in bench_dir.glob("*_bench.py")}
    payload_mods = [s.payload.split(":")[0] for s in registry().values()]
    assert {m.rsplit(".", 1)[1] for m in modules} == \
        {p.stem for p in (ROOT / "benchmarks").glob("*_bench.py")}
    for mod in sorted(modules):
        assert payload_mods.count(mod) == 1, mod


def test_every_payload_resolves_inside_the_port():
    for spec in registry().values():
        fn = resolve_payload(spec.payload)
        assert callable(fn) and fn.__module__.startswith("repro_torch."), spec.exp_id


@pytest.mark.parametrize("payload", ["benchmarks.fleet_bench:fleet_rows",
                                     "repro.exp.payloads:validate_payload",
                                     "jax.numpy:zeros"])
def test_resolve_payload_refuses_modules_outside_the_port(payload):
    with pytest.raises(ExperimentError, match="outside repro_torch"):
        resolve_payload(payload)


def test_validate_regimes_and_kinds():
    reg = registry()
    regimes = [e for e, s in reg.items() if s.kind == "validate-regime"]
    assert sorted(regimes) == ["validate-full", "validate-smoke"]
    assert {s.kind for s in reg.values()} == {"bench-family", "validate-regime", "figure",
                                              "measured-profile", "cluster-sim"}


def test_benches_cli_derives_from_the_registry():
    assert list(bench_run.BENCHES) == list(bench_family_specs())
    assert list(bench_family_specs()) == ["paper_figures", "fleet", "cluster", "meanfield",
                                          "validate", "tail", "kernels", "measure", "obs",
                                          "plan", "roofline"]


# ---------------------------------------------------------------------------
# the spec and the runner: twins of tests/test_exp.py on the port
# ---------------------------------------------------------------------------


def test_spec_round_trip_is_exact():
    spec = fake_spec(config={"offset": 3}, gates={"budget_pct": 5.0}, seeds=(0, 1))
    assert ExperimentSpec.from_dict(spec.to_dict()) == spec
    d = spec.to_dict()
    assert json.loads(json.dumps(d)) == d
    d["surprise"] = 1
    with pytest.raises(ExperimentError, match="surprise"):
        ExperimentSpec.from_dict(d)
    with pytest.raises(AttributeError):
        spec.exp_id = "other"


@pytest.mark.parametrize("over,msg", [
    ({"exp_id": "Bad Id"}, "exp_id"),
    ({"kind": "bench"}, "kind"),
    ({"payload": "no_colon"}, "payload"),
    ({"seeds": ()}, "non-empty"),
    ({"seeds": (1, 1)}, "duplicate seeds"),
    ({"seeds": (-1,)}, ">= 0"),
    ({"outputs": ("a.json", "a.json")}, "duplicate outputs"),
    ({"volatile": {"other.json": ("x",)}}, "undeclared output"),
])
def test_spec_validation_is_loud(over, msg):
    with pytest.raises(ExperimentError, match=msg):
        fake_spec(**over)


def test_strip_volatile():
    doc = {"a": {"wall_s": 1.0, "keep": 2}, "b": {"wall_s": 3.0}, "top": 4}
    assert strip_volatile(doc, ("*.wall_s", "top")) == {"a": {"keep": 2}, "b": {}}
    assert doc["top"] == 4
    assert strip_volatile({"x": 1}, ("nope.deep",)) == {"x": 1}


def test_run_layout_and_resume_skip(fake, tmp_path):
    spec = fake_spec()
    res = run_cpu(spec, tmp_path)
    assert not res.skipped and res.passed
    assert res.run_dir == tmp_path / "fake-exp" / res.run_id
    for fname in ("manifest.json", "metrics.json", "summary.md"):
        assert (res.run_dir / fname).exists(), fname
    assert (res.run_dir / "seed-0" / "OUT.json").exists()
    manifest = json.loads((res.run_dir / "manifest.json").read_text())
    assert manifest["experiment"]["spec"] == spec.to_dict()
    assert manifest["experiment"]["seeds"] == [0]
    assert manifest["experiment"]["device"] == {"device": "cpu"}
    assert manifest["packages"]["torch"] and "jax" not in manifest["packages"]
    again = run_cpu(spec, tmp_path)
    assert again.skipped and again.passed and again.run_dir == res.run_dir
    assert not run_cpu(spec, tmp_path, force=True).skipped


def test_config_change_is_a_new_run(fake, tmp_path):
    a = run_cpu(fake_spec(), tmp_path)
    b = run_cpu(fake_spec(config={"offset": 7}), tmp_path)
    assert not b.skipped and a.run_id != b.run_id


def test_seeds_override_only_when_seed_sensitive(fake, tmp_path):
    assert run_cpu(fake_spec(), tmp_path, seeds=(0, 1, 2)).seeds == (0, 1, 2)
    assert run_cpu(fake_spec(seed_sensitive=False), tmp_path, seeds=(0, 1, 2)).seeds == (0,)


def test_multi_seed_bootstrap_ci(fake, tmp_path):
    res = run_cpu(fake_spec(), tmp_path, seeds=(0, 1, 2))
    agg = res.metrics["aggregate"]["value"]
    assert agg["n_seeds"] == 3
    assert agg["mean"] == pytest.approx(20.0)
    assert agg["ci95_lo"] <= agg["mean"] <= agg["ci95_hi"]
    assert agg["seed_stable"] is False
    assert (res.run_dir / "seed-2" / "OUT.json").exists()


def test_gate_failure_fails_the_run(fake, tmp_path):
    res = run_cpu(fake_spec(config={"ok": False}), tmp_path)
    assert not res.passed
    assert "FAIL" in (res.run_dir / "summary.md").read_text()


def test_missing_declared_output_is_loud(fake, tmp_path):
    spec = fake_spec(outputs=("OUT.json", "NEVER.json"), volatile={"OUT.json": ("elapsed_s",)})
    with pytest.raises(ExperimentError, match="NEVER.json"):
        run_cpu(spec, tmp_path)


def test_partial_run_is_not_resumed(fake, tmp_path):
    res = run_cpu(fake_spec(), tmp_path)
    (res.run_dir / "summary.md").unlink()
    assert not run_cpu(fake_spec(), tmp_path).skipped


def test_two_runs_stable_with_volatile_masked(fake, tmp_path):
    spec = fake_spec()
    run_cpu(spec, tmp_path / "a")
    run_cpu(spec, tmp_path / "b")
    assert diff_results(tmp_path / "a", tmp_path / "b", {spec.exp_id: spec}) == []
    bare = {spec.exp_id: replace(spec, volatile={})}
    diffs = diff_results(tmp_path / "a", tmp_path / "b", bare)
    assert diffs and any("OUT.json" in d for d in diffs)


def test_missing_file_is_a_difference(fake, tmp_path):
    spec = fake_spec()
    ra = run_cpu(spec, tmp_path / "a")
    run_cpu(spec, tmp_path / "b")
    (ra.run_dir / "seed-0" / "OUT.json").unlink()
    assert any("only in" in d for d in diff_results(tmp_path / "a", tmp_path / "b",
                                                     {spec.exp_id: spec}))


def stub_card(monkeypatch, name: str) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)


def test_the_device_and_the_card_key_the_run_id(monkeypatch):
    spec = fake_spec()
    cpu = run_id_for(spec, (0,), "cpu")
    assert run_id_for(spec, (0,), "cpu") == cpu
    stub_card(monkeypatch, "NVIDIA H100 80GB HBM3")
    h100 = run_id_for(spec, (0,), "cuda")
    assert run_id_for(spec, (0,), None) == h100  # None means the card
    stub_card(monkeypatch, "NVIDIA H100 PCIe")
    other = run_id_for(spec, (0,), "cuda")
    assert len({cpu, h100, other}) == 3


def test_the_card_is_the_default_and_raises_without_one(fake, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_experiment(fake_spec(), results_root=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        reproduce.main(["--only", "validate-smoke", "--results", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_run.main(["--only", "plan", "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_validate_smoke_no_sim_through_the_runner(tmp_path):
    """One real registry experiment end to end, analytic-only for speed."""
    base = registry()["validate-smoke"]
    spec = replace(base, config={**base.config, "no_sim": True})
    res = run_cpu(spec, tmp_path)
    assert res.passed and not res.skipped
    doc = json.loads((res.run_dir / "seed-0" / "VALIDATION.json").read_text())
    assert doc["passed"] is True and doc["manifest"]["seed"] == 0
    assert "elapsed_s" in doc["corpus"]


# ---------------------------------------------------------------------------
# the reproduce CLI
# ---------------------------------------------------------------------------


def test_list_gives_the_reference_registry_in_order(capsys):
    assert reproduce.main(["--list"]) == 0
    rows = [line.split()[:2] for line in capsys.readouterr().out.splitlines()]
    assert rows == [[s.exp_id, s.kind] for s in ref_registry().values()]


@pytest.mark.parametrize("argv,msg", [(["--only", "not-an-exp"], "not-an-exp"),
                                      (["--only", ","], "no experiment ids parsed"),
                                      ([], "nothing to do"),
                                      (["--only", "validate-smoke", "--seeds", "0"],
                                       "--seeds must be >= 1")])
def test_bad_selection_exits_2(argv, msg, capsys):
    assert reproduce.main([*argv, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert msg in err


def test_run_report_and_skip(fake, tmp_path, monkeypatch, capsys):
    spec = fake_spec()
    monkeypatch.setattr(reproduce, "registry", lambda: {spec.exp_id: spec})
    argv = ["--only", "fake-exp", "--seeds", "2", "--device", "cpu",
            "--results", str(tmp_path / "results"), "--report", str(tmp_path / "R.md")]
    assert reproduce.main(argv) == 0
    report = (tmp_path / "R.md").read_text()
    assert "fake-exp" in report and "PASS" in report and "| ran |" in report
    assert "- device: cpu" in report
    assert reproduce.main(argv) == 0
    assert "skipped" in capsys.readouterr().out
    assert "skipped (complete)" in (tmp_path / "R.md").read_text()


def test_gate_failure_exits_1(fake, tmp_path, monkeypatch):
    spec = fake_spec(config={"ok": False})
    monkeypatch.setattr(reproduce, "registry", lambda: {spec.exp_id: spec})
    assert reproduce.main(["--only", "fake-exp", "--device", "cpu",
                           "--results", str(tmp_path / "results"),
                           "--report", str(tmp_path / "R.md")]) == 1
    assert "FAIL" in (tmp_path / "R.md").read_text()


def test_diff_mode(fake, tmp_path, monkeypatch, capsys):
    spec = fake_spec()
    run_cpu(spec, tmp_path / "a")
    run_cpu(spec, tmp_path / "b")
    monkeypatch.setattr(reproduce, "registry", lambda: {spec.exp_id: spec})
    assert reproduce.main(["--diff", str(tmp_path / "a"), str(tmp_path / "b")]) == 0
    assert "byte-stable" in capsys.readouterr().out
    (tmp_path / "b" / "extra.txt").write_text("x")
    assert reproduce.main(["--diff", str(tmp_path / "a"), str(tmp_path / "b")]) == 1


def test_the_paper_headline_in_the_report(tmp_path, monkeypatch):
    """A real validate regime through the CLI (a short simulation): the
    report sets the paper's 2.2% beside the regime's gated MAPE."""
    base = registry()["validate-smoke"]
    quick = replace(base, config={**base.config, "base_n": 4000})
    monkeypatch.setattr(reproduce, "registry", lambda: {quick.exp_id: quick})
    assert reproduce.main(["--only", "validate-smoke", "--device", "cpu",
                           "--results", str(tmp_path / "r"), "--report", str(tmp_path / "R.md")]) == 0
    text = (tmp_path / "R.md").read_text()
    metrics = json.loads(next((tmp_path / "r").rglob("metrics.json")).read_text())
    mape = metrics["aggregate"]["gate_mean_mape_pct"]["mean"]
    assert 0.0 < mape < 5.0
    assert f"The paper reports {reproduce.PAPER_MAPE_PCT}% mean MAPE" in text
    assert f"**{mape:.2f}%**" in text


# ---------------------------------------------------------------------------
# the regression gate: the reference's compare / manifest_notes on the same
# hand-made directories (twins of tests/test_bench_regression.py)
# ---------------------------------------------------------------------------

BASE_CLUSTER = {"closed_loop": {"client_epochs_per_sec": 4.0e5, "adaptive_mean_latency_s": 0.041},
                "equilibrium": {"iterations": 5}}


def _write(d: Path, name: str, doc) -> None:
    d.mkdir(parents=True, exist_ok=True)
    (d / name).write_text(json.dumps(doc))


def _scaled(**changes):
    doc = copy.deepcopy(BASE_CLUSTER)
    for path, factor in changes.items():
        group, key = path.split("__")
        if factor is None:
            del doc[group]
        else:
            doc[group][key] *= factor
    return doc


# name -> (fresh files, baseline files); a file is (relative dir, name, doc)
SCENARIOS = {
    "slowdown_2x": ([("", "BENCH_cluster.json",
                      _scaled(closed_loop__client_epochs_per_sec=0.5))],
                    [("", "BENCH_cluster.json", BASE_CLUSTER)]),
    "slowdown_3x": ([("", "BENCH_cluster.json",
                      _scaled(closed_loop__client_epochs_per_sec=1 / 3))],
                    [("", "BENCH_cluster.json", BASE_CLUSTER)]),
    "model_regression": ([("", "BENCH_cluster.json", _scaled(equilibrium__iterations=3))],
                         [("", "BENCH_cluster.json", BASE_CLUSTER)]),
    "within_tolerance": ([("", "BENCH_cluster.json",
                           _scaled(closed_loop__client_epochs_per_sec=0.8,
                                   equilibrium__iterations=1.2))],
                         [("", "BENCH_cluster.json", BASE_CLUSTER)]),
    "improvement": ([("", "BENCH_cluster.json",
                      _scaled(closed_loop__client_epochs_per_sec=10.0,
                              equilibrium__iterations=0.4))],
                    [("", "BENCH_cluster.json", BASE_CLUSTER)]),
    "missing_baseline": ([("", "BENCH_cluster.json", BASE_CLUSTER)], []),
    "missing_fresh": ([], [("", "BENCH_cluster.json", BASE_CLUSTER)]),
    "missing_metric": ([("", "BENCH_cluster.json", _scaled(equilibrium__x=None))],
                       [("", "BENCH_cluster.json", BASE_CLUSTER)]),
    "nested_results_tree": ([("bench-cluster/run-abc123/seed-0", "BENCH_cluster.json",
                              BASE_CLUSTER)],
                            [("", "BENCH_cluster.json", BASE_CLUSTER)]),
    "flat_wins_over_nested": ([("deep", "BENCH_cluster.json", {"x": 1}),
                               ("", "BENCH_cluster.json", BASE_CLUSTER)],
                              [("", "BENCH_cluster.json", BASE_CLUSTER)]),
    "kernels_error_growth": ([("", "BENCH_kernels.json",
                               {k: {"max_abs_err": 1e-5 if k == "rmsnorm" else 1e-9}
                                for k in ("flash_attention", "decode_attention", "ssm_scan",
                                          "rmsnorm", "lindley_scan", "decision_scan")})],
                             [("", "BENCH_kernels.json",
                               {k: {"max_abs_err": 1e-9}
                                for k in ("flash_attention", "decode_attention", "ssm_scan",
                                          "rmsnorm", "lindley_scan", "decision_scan")})]),
    "empty": ([], []),
}


def _dirs(tmp_path: Path, name: str):
    fresh_files, base_files = SCENARIOS[name]
    fresh, base = tmp_path / "fresh", tmp_path / "base"
    fresh.mkdir()
    base.mkdir()
    for rel, fname, doc in fresh_files:
        _write(fresh / rel, fname, doc)
    for rel, fname, doc in base_files:
        _write(base / rel, fname, doc)
    return fresh, base


def test_headlines_are_the_reference_s():
    assert gate.HEADLINES == ref_gate.HEADLINES
    assert gate.DEFAULT_TOLERANCE == ref_gate.DEFAULT_TOLERANCE == pytest.approx(0.30)
    assert gate._PORTABLE_MANIFEST_KEYS == ref_gate._PORTABLE_MANIFEST_KEYS
    assert gate.default_baseline_dir() == ROOT / "src" / "repro_torch" / "bench" / "baselines"


@pytest.mark.parametrize("name", list(SCENARIOS))
@pytest.mark.parametrize("machine_matched", [False, True])
def test_compare_equals_the_reference(tmp_path, name, machine_matched):
    fresh, base = _dirs(tmp_path, name)
    got = gate.compare(fresh, base, machine_matched=machine_matched)
    assert got == ref_gate.compare(fresh, base, machine_matched=machine_matched)
    argv = ["--fresh", str(fresh), "--baselines", str(base)]
    argv += ["--machine-matched"] if machine_matched else []
    assert gate.main(argv) == ref_gate.main(argv)


def test_compare_outcomes():
    """The gate's verdicts themselves, as tests/test_bench_regression.py
    states them (the equality above would pass two equally wrong gates)."""
    def run(name, **kw):
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            return gate.compare(*_dirs(Path(tmp), name), **kw)

    assert run("slowdown_2x", machine_matched=True)[1] == 1
    rows, regressions = run("slowdown_3x")
    assert regressions == 0 and any(r["status"] == "info(slower)" for r in rows)
    assert run("model_regression")[1] == 1
    assert run("within_tolerance", machine_matched=True)[1] == 0
    assert run("improvement", machine_matched=True)[1] == 0
    n = len(gate.HEADLINES["BENCH_cluster.json"])
    assert run("missing_baseline")[1] == run("missing_fresh")[1] == n
    assert run("missing_metric")[1] >= 1
    assert run("nested_results_tree")[1] == 0 and run("flat_wins_over_nested")[1] == 0
    assert run("kernels_error_growth")[1] == 1
    assert run("empty") == ([], 0)


def test_families_filter_equals_the_reference(tmp_path):
    fresh, base = tmp_path / "fresh", tmp_path / "base"
    _write(fresh, "BENCH_cluster.json", BASE_CLUSTER)
    _write(base, "BENCH_cluster.json", BASE_CLUSTER)
    _write(base, "BENCH_plan.json", {"solver": {"wall_s": 1.0}})
    fam = ["BENCH_cluster.json"]
    got = gate.compare(fresh, base, families=fam)
    assert got == ref_gate.compare(fresh, base, families=fam)
    assert got[1] == 0 and {r["family"] for r in got[0]} == set(fam)


def test_update_baselines_and_manifest_notes_equal_the_reference(tmp_path):
    doc = dict(BASE_CLUSTER, manifest=run_manifest(seed=0, config={"x": 1}))
    fresh = tmp_path / "fresh"
    _write(fresh, "BENCH_cluster.json", doc)
    _write(fresh, "UNRELATED.json", {"x": 1})
    assert gate.update_baselines(fresh, tmp_path / "port") == ["BENCH_cluster.json"]
    assert ref_gate.update_baselines(fresh, tmp_path / "ref") == ["BENCH_cluster.json"]
    port = (tmp_path / "port" / "BENCH_cluster.json").read_text()
    assert port == (tmp_path / "ref" / "BENCH_cluster.json").read_text()
    assert json.loads(port)["manifest"] == {k: doc["manifest"][k]
                                            for k in ("manifest_version", "seed", "config_sha256")}
    # stripped baselines: no drift notes on either side
    assert gate.manifest_notes(fresh, tmp_path / "port") == []
    assert ref_gate.manifest_notes(fresh, tmp_path / "ref") == []
    # genuine drift on a shared key: the same notes
    drifted = dict(doc, manifest=dict(doc["manifest"], git={"sha": "other", "dirty": False},
                                      python="3.0.0"))
    _write(tmp_path / "drift", "BENCH_cluster.json", drifted)
    notes = gate.manifest_notes(fresh, tmp_path / "drift")
    assert notes and notes == ref_gate.manifest_notes(fresh, tmp_path / "drift")
    assert manifest_delta(drifted["manifest"], doc["manifest"])


def test_update_baselines_cli_exit_codes(tmp_path):
    assert gate.main(["--fresh", str(tmp_path / "nope")]) == 2
    (tmp_path / "empty").mkdir()
    assert gate.main(["--fresh", str(tmp_path / "empty"), "--baselines", str(tmp_path / "b"),
                      "--update-baselines"]) == 2


# ---------------------------------------------------------------------------
# isolation: reproduce through the plan family and a validate regime loads
# nothing of jax, repro or benchmarks
# ---------------------------------------------------------------------------

PROBE = """
import contextlib, io, json, sys, tempfile
from pathlib import Path
from repro_torch.bench import plan_bench
from repro_torch.launch import reproduce
plan_bench.N_CLIENTS = 8
tmp = Path(tempfile.mkdtemp())
with contextlib.redirect_stdout(io.StringIO()):
    rc = reproduce.main(["--only", "bench-plan,validate-smoke", "--device", "cpu",
                         "--results", str(tmp / "results"), "--report", str(tmp / "R.md")])
plan = json.loads(next((tmp / "results").rglob("BENCH_plan.json")).read_text())
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"))
print(rc, plan["n_clients"], "manifest" in plan, bad)
"""


def test_reproduce_loads_no_jax_no_repro_no_benchmarks():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    # rc 1 is allowed: 8 clients take another plan than the baselines' 48, a
    # headline regression; the loaded modules are the point
    rc, n, stamped, bad = out.stdout.strip().split(" ", 3)
    assert rc in ("0", "1") and (n, stamped, bad) == ("8", "True", "[]"), out.stdout


# ---------------------------------------------------------------------------
# the non-bench payloads against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture
def x64(monkeypatch):
    """The reference's ``jax.experimental.enable_x64()`` for this test only (C1)."""
    import jax
    import jax.experimental

    monkeypatch.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True),
                        raising=False)


def _close(a, b, rtol=1e-9):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], rtol) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_close(x, y, rtol) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, (int, float)) and not isinstance(b, bool):
        return a == b or abs(a - b) <= rtol * max(abs(a), abs(b))
    return a == b


def test_cluster_sim_payload_equals_the_reference(tmp_path, x64):
    """The closed-loop CLI through both payloads: the equilibrium (exact
    iterations, 1e-9 latencies) and the verdict; the replay's Poisson counts
    are each side's own draws, so its means are not compared."""
    from repro.exp import payloads as ref_payloads
    from repro_torch.exp import payloads

    cfg = registry()["cluster-sim-smoke"].config
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        port = payloads.cluster_sim_payload(tmp_path / "p", 0, cfg, device="cpu")
        ref = ref_payloads.cluster_sim_payload(tmp_path / "r", 0, cfg)
    assert port["passed"] is ref["passed"] is True
    assert port["equilibrium_iterations"] == ref["equilibrium_iterations"]
    assert port["mean_latency_s"] == pytest.approx(ref["mean_latency_s"], rel=1e-9)
    p = json.loads((tmp_path / "p" / "CLUSTER.json").read_text())
    r = json.loads((tmp_path / "r" / "CLUSTER.json").read_text())
    assert p["device"] == "cpu"
    volatile = ("solve_s",)
    strip = lambda d: {k: v for k, v in d.items() if k not in volatile}  # noqa: E731
    assert _close(strip(p["equilibrium"]), strip(r["equilibrium"]))
    assert p["spec"] == r["spec"] and p["mode"] == r["mode"]


def test_measured_payload_passes_where_the_reference_fails_c13(tmp_path, x64):
    """measured-smoke's payload: the reference passes ``None`` budgets to its
    gate and raises (ROADMAP C13); the port's gate takes the spec's 15% /
    35%, and its profile and gate equal the reference's harness, profile and
    gate on the same config (the simulated clock never sees the weights)."""
    from repro.exp import payloads as ref_payloads
    from repro.measure import HarnessConfig as RefHarnessConfig
    from repro.measure import build_profile as ref_build_profile
    from repro.measure import run_harness as ref_run_harness
    from repro.validate.measured import run_measured_gate as ref_gate_run
    from repro_torch.exp import payloads

    spec = registry()["measured-smoke"]
    with pytest.raises(TypeError):
        ref_payloads.measured_payload(tmp_path, 0, spec.config)
    out = tmp_path / "port"
    out.mkdir()
    m = payloads.measured_payload(out, 0, spec.config, device="cpu")
    assert m["passed"] is True and m["n_requests"] == 240
    hc = RefHarnessConfig(arch="starcoder2_3b", slots=1, seed=0, n_requests=240,
                          target_rho=0.45)
    ref_profile = ref_build_profile(ref_run_harness(hc), seed=0)
    ref_gate = ref_gate_run(ref_profile, budget_pct=spec.gates["mean_budget_pct"],
                            tail_budget_pct=spec.gates["tail_budget_pct"]).to_dict()
    got = json.loads((out / "PROFILE_starcoder2_3b.json").read_text())
    want = json.loads(ref_profile.dumps())
    got.pop("manifest"), want.pop("manifest", None)
    assert got == want
    gate_doc = json.loads((out / "VALIDATION_measured.json").read_text())
    gate_doc.pop("manifest")
    assert _close(gate_doc, ref_gate)
    assert m["mean_mape_pct"] == pytest.approx(ref_gate["mean"]["mape_pct"], rel=1e-9)



def test_headlines_resolve_against_the_port_s_committed_baselines():
    """Every headline metric exists in the port's committed baselines (taken
    on the card), whose manifests keep only the portable keys."""
    base_dir = gate.default_baseline_dir()
    assert sorted(p.name for p in base_dir.glob("BENCH_*.json")) == sorted(gate.HEADLINES)
    for fname, metrics in gate.HEADLINES.items():
        doc = json.loads((base_dir / fname).read_text())
        assert set(doc["manifest"]) <= set(gate._PORTABLE_MANIFEST_KEYS), fname
        for metric in metrics:
            assert gate.resolve(doc, metric) is not None, (fname, metric)
