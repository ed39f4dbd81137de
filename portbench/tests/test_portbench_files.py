"""The harness is driven by files: a configuration, a traffic mix, a cell
and a metric added as files are found by their names; the harness core
names none of them; and nothing here imports JAX, flax or the JAX package."""

import ast
import json
import shutil
from pathlib import Path

import pytest

from portbench import metrics
from portbench.cell import load_cell

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CORE = ["run.py", "cell.py", "metrics.py", "window.py", "check.py", "derive.py", "devtrace.py",
        "stats.py", "traffic.py", "knee.py"]


def test_a_cell_added_as_files_is_found(tmp_path):
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "traffic").mkdir()
    (tmp_path / "portbench" / "cells").mkdir()
    shutil.copy(BENCH / "configs" / "starcoder2-3b.json",
                tmp_path / "portbench" / "configs" / "new-model.json")
    (tmp_path / "portbench" / "traffic" / "bursty.json").write_text(json.dumps(
        {"arrivals": "poisson", "prompt_len": {"dist": "fixed", "value": 64},
         "new_tokens": {"dist": "fixed", "value": 4}, "slots": 1, "schedule_seed": 1}))
    (tmp_path / "portbench" / "cells" / "new-model.bursty.json").write_text(
        json.dumps({"rate_rps": 3.0}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new-model", "source": "x",
                             "file": "portbench/configs/new-model.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new-model.bursty", "config": "new-model",
                               "traffic": "bursty", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "engine",
                               "moves": "tpot_p95_ms",
                               "workloads": ["new-model.bursty"]})
    next(m for m in bench["end_to_end"] if m["name"] == "tpot_p95_ms")["workloads"].append(
        "new-model.bursty")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell(tmp_path, "new-model.bursty")
    assert cell.traffic["prompt_len"]["value"] == 64 and cell.numbers["rate_rps"] == 3.0
    assert cell.model["layers"] == [("attn", "mlp")] * 30 and cell.model["padded_vocab"] == 49152
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    assert "tpot_p95_ms" in [m["name"] for m in cell.end_to_end]
    (tmp_path / "new_metric.py").write_text("def read(run):\n    return 2.5\n")
    assert metrics.read_all(cell.per_layer, None, directory=tmp_path) == {
        "new_metric": {"value": 2.5, "unit": "ms"}}


def test_each_cell_reports_what_the_contract_asks():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = load_cell(ROOT, w["name"])
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
        assert (BENCH / "cells" / f"{w['name']}.json").exists()


def test_the_core_names_no_cell_config_or_metric():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = ([w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    for f in CORE:
        text = (BENCH / f).read_text()
        for name in names:
            assert f'"{name}"' not in text and f"'{name}'" not in text, (f, name)


def imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    roots = imported_roots(path)
    assert not roots & {"jax", "jaxlib", "flax", "repro"}, roots
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in roots and "portbench" not in roots - {"portbench"}
        assert not roots & {"repro_torch"}
    text = path.read_text()
    assert "src/" + "repro/" not in text and "bench" + "marks/" not in text


def test_the_top_level_names_are_compared_whole():
    from portbench.run import forbidden_modules
    import sys
    sys.modules["repro_torch_lookalike_for_test"] = sys
    try:
        assert "repro_torch_lookalike_for_test" not in forbidden_modules()
    finally:
        del sys.modules["repro_torch_lookalike_for_test"]
