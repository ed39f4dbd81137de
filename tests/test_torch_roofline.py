"""The port's roofline launchers: ``roofline_run`` and ``perf_probe`` on the
dry run's census, and the reports the benchmark's roofline family reads.

The census runs in child processes (side by side), so no fake world enters
this one. Held:
  * ``combine_linear``'s extrapolation from the 1- and 2-superblock probes
    equals the census at full depth, exactly, for a homogeneous stack
    (dense, train, on a (2, 4) mesh) and for the encoder-decoder's two
    groups (three probes, prefill, one rank);
  * ``perf_probe``'s ``total_extrapolated`` equals ``roofline_cell``'s
    per-device counts (the same probes; starcoder2_3b at reduced widths on
    the 16x16 mesh);
  * ``dryrun.main`` and ``roofline_run.main`` at full width
    (starcoder2_3b, decode_32k, the 16x16 mesh) write a record and a report
    that ``print_roofline_rows`` and the ``bench-roofline`` payload read,
    with the report's terms on the H100's data-sheet rates.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

LINEAR = r"""
import dataclasses, json, logging
logging.disable(logging.WARNING)
from repro_torch.configs.base import ShapeSuite, get_config
from repro_torch.launch.dryrun import census_cell
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.perf_probe import breakdown
from repro_torch.launch.roofline_run import roofline_cell
from repro_torch.perf.roofline import combine_linear

def costs(cfg, shape, mesh):
    c = census_cell(cfg, shape, mesh)
    return {"flops": c["flops"], "bytes": c["bytes"], "wire_bytes": c["collectives"].wire_bytes}

out = {}
dense = get_config("starcoder2_3b").reduced()
shape, mesh = ShapeSuite("t", 64, 4, "train"), make_mesh((2, 4), ("data", "model"))
s = {(n,): costs(dataclasses.replace(dense, num_superblocks=n), shape, mesh) for n in (1, 2, 3)}
out["dense"] = [combine_linear({k: s[k] for k in ((1,), (2,))}, (3,)), s[(3,)]]
encdec = get_config("seamless_m4t_large_v2").reduced()
shape, one = ShapeSuite("t", 32, 2, "prefill"), make_mesh((1, 1), ("data", "model"))
e = {p: costs(dataclasses.replace(encdec, num_superblocks=p[0], encoder_layers=p[1]), shape, one)
     for p in ((1, 1), (2, 1), (1, 2), (3, 3))}
out["encdec"] = [combine_linear({k: e[k] for k in ((1, 1), (2, 1), (1, 2))}, (3, 3)), e[(3, 3)]]
small = {k: v for k, v in dataclasses.asdict(dense).items()
         if k in ("d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                  "dtype", "remat", "seq_chunk", "window_size")}
small["num_superblocks"] = 3
rows = breakdown("starcoder2_3b", "decode_32k", overrides=small)
rep = roofline_cell("starcoder2_3b", "decode_32k", overrides=small, verbose=False)
out["probe"] = {k: r["total_extrapolated"] for k, r in rows.items()}
out["report"] = {"flops": rep.hlo_flops_per_dev, "bytes": rep.hlo_bytes_per_dev,
                 "wire_bytes": rep.wire_bytes_per_dev, "mesh": rep.mesh}
print(json.dumps(out))
"""

CLI = r"""
import logging, sys
logging.disable(logging.WARNING)
from repro_torch.launch import dryrun, roofline_run
d, r = sys.argv[1], sys.argv[2]
assert dryrun.main(["--arch", "starcoder2_3b", "--shape", "decode_32k", "--out", d]) == 0
assert roofline_run.main(["--arch", "starcoder2_3b", "--shape", "decode_32k", "--out", r,
                          "--dryrun-dir", d]) == 0
"""


def _spawn(code: str, *args) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait(proc: subprocess.Popen) -> str:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("roofline")
    dry, roof = tmp / "dryrun", tmp / "experiments" / "roofline"
    cli = _spawn(CLI, dry, roof)
    linear = json.loads(_wait(_spawn(LINEAR)).strip().splitlines()[-1])
    _wait(cli)
    return linear, dry, roof


@pytest.mark.parametrize("stack", ["dense", "encdec"])
def test_combine_linear_equals_full_depth(runs, stack):
    extrapolated, counted = runs[0][stack]
    for k in ("flops", "bytes", "wire_bytes"):
        assert extrapolated[k] == counted[k], k
    assert counted["flops"] > 0 and counted["bytes"] > 0
    assert (counted["wire_bytes"] > 0) == (stack == "dense")  # one rank moves nothing


def test_perf_probe_total_equals_roofline_cell(runs):
    probe, report = runs[0]["probe"], runs[0]["report"]
    for k in ("flops", "bytes", "wire_bytes"):
        assert probe[k] == report[k], k
    assert report["mesh"] == "single" and probe["wire_bytes"] > 0


def test_dryrun_record_keys(runs):
    rec = json.loads((runs[1] / "starcoder2_3b__decode_32k__single.json").read_text())
    assert set(rec) == {"arch", "shape", "mesh", "n_devices", "kind", "scan_layers", "lower_s",
                        "compile_s", "flops_per_device", "bytes_accessed_per_device",
                        "memory_analysis", "collectives"}
    assert rec["n_devices"] == 256 and rec["kind"] == "decode" and rec["mesh"] == "single"
    assert set(rec["memory_analysis"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                           "temp_size_in_bytes", "alias_size_in_bytes"}
    assert rec["memory_analysis"]["alias_size_in_bytes"] > 0  # the donated caches
    assert rec["flops_per_device"] > 0 and sum(rec["collectives"]["counts"].values()) > 0
    assert (runs[1] / "manifest.json").exists()


def test_reports_feed_the_roofline_rows(runs, capsys, monkeypatch):
    from repro_torch.bench.roofline_report import print_roofline_rows
    from repro_torch.bench.run import run_roofline
    from repro_torch.perf.hardware import H100_SXM

    roof = runs[2]
    rep = json.loads((roof / "starcoder2_3b__decode_32k__single.json").read_text())
    assert rep["n_chips"] == 256 and rep["mesh"] == "single"
    assert rep["compute_s"] == pytest.approx(
        (rep["hlo_flops_per_dev"] + rep["supplement_flops_per_dev"]) / H100_SXM.peak_flops)
    assert rep["memory_s"] == pytest.approx(rep["hlo_bytes_per_dev"] / H100_SXM.hbm_bw)
    assert rep["memory_analysis"]["argument_size_in_bytes"] > 0  # read from the dry-run record
    assert rep["collective_counts"]  # the dry-run record's census
    print_roofline_rows(roof)
    rows = [l for l in capsys.readouterr().out.splitlines() if l.startswith("roofline_")]
    assert len(rows) == 1 and rows[0].startswith("roofline_starcoder2_3b_decode_32k_single,")
    monkeypatch.chdir(roof.parent.parent)  # the payload reads experiments/roofline
    assert run_roofline(roof) == {}
    assert capsys.readouterr().out.splitlines() == rows
