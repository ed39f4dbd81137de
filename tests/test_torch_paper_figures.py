"""The paper-figure suite through the port (``repro_torch.bench``) against
the repository's ``benchmarks/`` harness over the JAX package's core.

Both run the same operating points, seeds and simulations in numpy float64
(host code, no device), so every figure function's return, the JSON report
(its provenance manifest aside) and the CSV rows (their microseconds column
aside) are equal exactly. The port's suite runs without loading ``jax`` or
any module of ``repro``, which an import statement scan cannot show alone:
the reference reaches its split model through ``__import__`` at run time.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmarks import paper_figures as ref_figs
from benchmarks.run import run_paper_figures as ref_run_paper_figures
from repro_torch.bench import paper_figures as port_figs
from repro_torch.bench import run as port_run

ROOT = Path(__file__).resolve().parent.parent

# report key -> figure function, in run_paper_figures' order
FIGURES = {
    "fig2_mape_pct": "fig2_workload_characteristics",
    "fig3_mape_pct": "fig3_complex_models",
    "fig4_crossovers_mbps": "fig4_bandwidth_crossovers",
    "fig5a_split_mape_pct": "fig5a_split_processing",
    "fig5b_offload_wins": "fig5b_request_rate",
    "fig5c_crossover_m": "fig5c_multitenancy",
    "fig6_strategies": "fig6_network_adaptation",
    "fig7_targets": "fig7_multitenant_adaptation",
    "model_accuracy": "model_accuracy_suite",
}


def suite(run, out_dir: Path):
    """(report, CSV rows without the microseconds column, JSON document)."""
    out_dir.mkdir()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = run(out_dir)
    rows = {}
    for line in buf.getvalue().splitlines():
        name, _us, derived = line.split(",", 2)
        rows[name] = derived
    return report, rows, json.loads((out_dir / "BENCH_paper_figures.json").read_text())


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("paper_figures")
    return suite(ref_run_paper_figures, tmp / "ref"), suite(port_run.run_paper_figures,
                                                           tmp / "port")


@pytest.mark.parametrize("key", list(FIGURES))
def test_figure_equals_the_reference(suites, key):
    (ref_report, ref_rows, _), (port_report, port_rows, _) = suites
    assert port_report[key] == ref_report[key]
    assert type(port_report[key]) is type(ref_report[key])
    fn = FIGURES[key]
    assert port_rows[fn] == ref_rows[fn]


def test_report_json_equals_the_reference_manifest_aside(suites):
    (_, ref_rows, ref_doc), (_, port_rows, port_doc) = suites
    manifest = port_doc.pop("manifest")
    assert port_doc == ref_doc and list(port_rows) == list(ref_rows) == list(FIGURES.values())
    assert manifest["git"] and manifest["packages"]["torch"]


def test_headline_rows(suites):
    """The qualitative results the paper's figures show."""
    _, (report, rows, _) = suites
    assert report["fig6_strategies"] == ["offload", "offload", "on_device", "offload"]
    assert report["fig7_targets"] == ["edge[0]", "edge[1]", "on_device"]
    assert "ordered=True" in rows["fig4_bandwidth_crossovers"]
    assert "faster_net_wins_more=True" in rows["fig5b_request_rate"]
    for key in ("fig2_mape_pct", "fig3_mape_pct"):
        assert report[key] < 3.0
    acc = report["model_accuracy"]
    assert acc["mape_pct"] < 3.0 and acc["n"] == 36


def test_figure_functions_are_the_same_set():
    public = lambda m: {n for n in dir(m) if n.startswith(("fig", "model_"))}  # noqa: E731
    assert public(port_figs) == public(ref_figs) == set(FIGURES.values())


PROBE = """
import contextlib, io, sys, tempfile
from repro_torch.bench.run import main
with contextlib.redirect_stdout(io.StringIO()) as out:
    rc = main(["--only", "paper_figures", "--out", tempfile.mkdtemp()])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(rc, out.getvalue().splitlines()[0], len(out.getvalue().splitlines()), bad)
"""


def test_the_port_suite_loads_no_jax_and_no_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 name,us_per_call,derived 10 []", out.stdout


@pytest.mark.parametrize("argv", [["--only", "nope"], ["--only", "paper_figures,nope"],
                                  ["--only", ","]])
def test_cli_refuses_an_unknown_family(argv, tmp_path, capsys):
    assert port_run.main([*argv, "--out", str(tmp_path)]) == 2
    err = capsys.readouterr().err
    assert "known: paper_figures" in err
    assert not list(tmp_path.iterdir())
