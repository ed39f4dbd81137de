"""The port's dry run (``launch.dryrun.census_cell``) against the JAX
package's lower + compile, on reduced configs at batch 4 x 64 tokens.

Dense (starcoder2_3b), MoE (dbrx_132b) and encoder-decoder
(seamless_m4t_large_v2) cells, at train, prefill and decode, on (1, 1) and
(2, 4) fake meshes. The reference runs in a child process that imports
``repro.launch.roofline_run`` first (its 512 host devices) and builds
Auto-axis meshes, since ``jax.make_mesh``'s Explicit axes make its own
launchers raise (ROADMAP C15); it compiles the unrolled stack. The port's
census runs in child processes too, so no fake world enters this one.

Held: argument bytes exactly (every sharded dim divides at these sizes); no
collective at (1, 1) on either side; FLOPs per device within a measured
band. At (1, 1) the census counts matrix products only and XLA counts
elementwise work too, so the port reads 0.94-0.98 of the reference: held
to [0.90, 1.0]. At (2, 4) it reads 0.98-1.66: the same elementwise
shortfall below, and above it work that DTensor repeats on every rank of
the model axis where XLA pads a dim that does not split (2 kv heads over
4 ranks; a one-token decode query has no other dim to take the shards, so
its attention is gathered): held to [0.90, 2.0].
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("starcoder2_3b", "dbrx_132b", "seamless_m4t_large_v2")
KINDS = ("train", "prefill", "decode")
MESHES = ((1, 1), (2, 4))
B, S = 4, 64
CELLS = [(a, k, m) for a in ARCHS for k in KINDS for m in MESHES]
FLOPS_BAND = {(1, 1): (0.90, 1.0), (2, 4): (0.90, 2.0)}

REF = r"""
import repro.launch.roofline_run  # noqa: F401  (its 512 host devices come first)
import dataclasses, json, sys
import jax
from jax.sharding import AxisType
from repro.configs.base import ShapeSuite, get_config
from repro.launch.steps import cell_step_and_specs, shardings_for
from repro.perf.hlo import parse_collectives
from repro.sharding.partition import rules_for_cell, use_rules

out = {}
for arch, kind, B, S, mshape in json.loads(sys.argv[1]):
    cfg = dataclasses.replace(get_config(arch).reduced(), scan_layers=False,
                              unroll_attn_chunks=True)
    shape = ShapeSuite("t", S, B, kind)
    mesh = jax.make_mesh(tuple(mshape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rules = rules_for_cell(cfg, shape, mesh)
    with use_rules(rules):
        cell = cell_step_and_specs(cfg, shape, zero_size=dict(mesh.shape).get("data", 1))
        args = tuple(cell.specs[k] for k in cell.specs)
        in_sh = tuple(shardings_for(cell.axes[k], rules) for k in cell.axes)
        donate = (0, 1) if cell.kind == "train" else (3,) if cell.kind == "decode" else ()
        with mesh:
            compiled = jax.jit(cell.step, in_shardings=in_sh,
                               donate_argnums=donate).lower(*args).compile()
    cost = compiled.cost_analysis() or {}
    out[f"{arch}|{kind}|{mshape[0]}x{mshape[1]}"] = {
        "flops": float(cost.get("flops", 0.0)),
        "args": int(compiled.memory_analysis().argument_size_in_bytes),
        "colls": dict(parse_collectives(compiled.as_text()).counts)}
print(json.dumps(out))
"""

PORT = r"""
import json, logging, sys
logging.disable(logging.WARNING)
from repro_torch.configs.base import ShapeSuite, get_config
from repro_torch.launch.dryrun import census_cell
from repro_torch.launch.mesh import make_mesh

out = {}
for arch, kind, B, S, mshape in json.loads(sys.argv[1]):
    c = census_cell(get_config(arch).reduced(), ShapeSuite("t", S, B, kind),
                    make_mesh(tuple(mshape), ("data", "model")))
    out[f"{arch}|{kind}|{mshape[0]}x{mshape[1]}"] = {
        "flops": c["flops"], "args": c["memory_analysis"]["argument_size_in_bytes"],
        "colls": dict(c["collectives"].counts)}
print(json.dumps(out))
"""


def _spawn(code: str, cells, jax_cpu: bool) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    if jax_cpu:
        env["JAX_PLATFORMS"] = "cpu"
    spec = json.dumps([[a, k, B, S, list(m)] for a, k, m in cells])
    return subprocess.Popen([sys.executable, "-c", code, spec], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _collect(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def records():
    """(reference, port) records of every cell; the children run side by side."""
    ref = _spawn(REF, CELLS, jax_cpu=True)
    ports = [_spawn(PORT, [c for c in CELLS if c[0] == a], jax_cpu=False) for a in ARCHS]
    port = {}
    for p in ports:
        port.update(_collect(p))
    return _collect(ref), port


def _key(cell) -> str:
    arch, kind, m = cell
    return f"{arch}|{kind}|{m[0]}x{m[1]}"


@pytest.mark.parametrize("cell", CELLS, ids=_key)
def test_argument_bytes_equal_reference(records, cell):
    ref, port = records
    assert port[_key(cell)]["args"] == ref[_key(cell)]["args"]


@pytest.mark.parametrize("cell", CELLS, ids=_key)
def test_flops_per_device_within_band(records, cell):
    ref, port = records
    lo, hi = FLOPS_BAND[cell[2]]
    ratio = port[_key(cell)]["flops"] / ref[_key(cell)]["flops"]
    assert lo <= ratio <= hi, ratio


@pytest.mark.parametrize("cell", [c for c in CELLS if c[2] == (1, 1)], ids=_key)
def test_no_collectives_on_one_rank(records, cell):
    ref, port = records
    assert port[_key(cell)]["colls"] == {} and ref[_key(cell)]["colls"] == {}


@pytest.mark.parametrize("cell", [c for c in CELLS if c[2] == (2, 4)], ids=_key)
def test_sharded_cells_communicate(records, cell):
    """Both sides issue collectives on (2, 4); the kinds differ (DTensor and
    XLA's partitioner choose their own), so only their presence is held."""
    ref, port = records
    assert sum(port[_key(cell)]["colls"].values()) > 0
    assert sum(ref[_key(cell)]["colls"].values()) > 0
