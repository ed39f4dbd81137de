"""The control that the limits were set against: the reference in fp8 in the
program's place (``--control 1``), judged by the harness's own comparison.
At a size a test run holds, with the program in bf16 on the CPU as it is
served, the program's run is correct and the control's is not. On the card
(marker ``cuda``) the same at the cell's own size, over a short window."""

import json
from pathlib import Path

import pytest
import torch

from portbench import run as R
from portbench_small import SMALL, TRAFFIC, small_cell

CELLS = Path(__file__).resolve().parents[1] / "cells"
CASES = [("jamba-v0.1-2sb", "onepass", {"requests": 8}),
         ("jamba-v0.1-2sb", "chat", {"tokens": 40})]


def limits(cell: str) -> dict:
    return json.loads((CELLS / f"{cell}.json").read_text())["limits"]


@pytest.mark.parametrize("config,traffic,check", CASES)
@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_bf16_passes_and_the_fp8_control_fails(monkeypatch, config, traffic, check, seed):
    monkeypatch.setitem(SMALL, config, dict(SMALL[config], dtype="bfloat16"))
    monkeypatch.setitem(TRAFFIC, "chat", dict(TRAFFIC["chat"], new_tokens={
        "dist": "uniform", "min": 8, "max": 16}))
    cell = small_cell(config, traffic, limits=limits(f"{config}.{traffic}"), check=check)
    res = R.run(cell, seed=seed, seconds=1.0, trace=False, device="cpu")
    assert res["correct"], res["checks"]
    ctl = R.run(cell, seed=seed, seconds=1.0, trace=False, device="cpu", control=True)
    assert not ctl["correct"], ctl["checks"]
    assert all(c["value"] <= c["limit"] for c in ctl["program_checks"].values()), ctl
    assert list(ctl)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["jamba-v0.1-2sb.chat"])
def test_the_control_fails_at_the_cells_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the cell runs at its own size")
    cell = R.load_cell(R.ROOT, name)
    res = R.run(cell, seed=2**31 + 101, seconds=8.0, trace=False, control=True)
    assert not res["correct"], res["checks"]
    assert all(c["value"] <= c["limit"] for c in res["program_checks"].values()), res
