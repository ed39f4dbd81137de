"""A cell's files, found by the names in ``BENCHMARK.json``.

``BENCHMARK.json`` names the cell's configuration (whose entry gives the
file) and traffic mix; beside them:

* ``portbench/traffic/<traffic>.json``: the mix (``traffic.py``);
* ``portbench/cells/<cell>.json``: the cell's own numbers: ``rate_rps`` for an
  open loop, ``check`` (how many requests or served tokens the correctness
  sample holds) and ``limits`` (each compared number's limit);
* ``portbench/metrics/<metric>.py``: one reader per metric, end to end and
  per layer (``metrics.py``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Cell", "load_cell", "expand_model", "round_up"]

BENCH_DIR = "portbench"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    model: dict  # its model block, expanded (layers, padded_vocab)
    traffic: dict
    numbers: dict  # portbench/cells/<cell>.json
    end_to_end: list[dict]  # the metric entries this cell reports
    per_layer: list[dict]


def round_up(n: int, to: int) -> int:
    return -(-n // to) * to


def expand_model(model: dict) -> dict:
    """The model block with its layer list spelt out over the superblocks and
    the vocabulary padded as the program pads it (to a multiple of 256)."""
    m = dict(model)
    m["layers"] = [tuple(spec) for spec in model["superblock"]] * model["num_superblocks"]
    m["padded_vocab"] = round_up(model["vocab_size"], 256)
    return m


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    bench = _load(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(wl)})")
    w = wl[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load(root / entry["file"])
    cell_file = root / BENCH_DIR / "cells" / f"{name}.json"
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        model=expand_model(config["model"]),
        traffic=_load(root / BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        numbers=_load(cell_file) if cell_file.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])
