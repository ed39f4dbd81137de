"""Small cells for the CPU tests: a configuration file's model cut to a few
dozen channels in fp32, tiny traffic, built as the harness builds a cell."""

from __future__ import annotations

import json
import math
from pathlib import Path

from portbench.cell import Cell, expand_model

ROOT = Path(__file__).resolve().parents[2]

SMALL = {
    "starcoder2-3b": dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=256, num_superblocks=2, dtype="float32"),
    "jamba-v0.1-2sb": dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                           vocab_size=256, num_superblocks=1, num_experts=4,
                           num_experts_per_tok=2, capacity_factor=1.25, moe_group_size=32,
                           mamba_d_state=4, dtype="float32"),
}

TRAFFIC = {
    "onepass": {"arrivals": "poisson", "prompt_len": {"dist": "loguniform", "min": 6, "max": 24},
                "new_tokens": {"dist": "fixed", "value": 1}, "slots": 1, "schedule_seed": 7},
    "chat": {"arrivals": "standing", "requests": 6,
             "prompt_len": {"dist": "loguniform", "min": 5, "max": 40},
             "new_tokens": {"dist": "uniform", "min": 2, "max": 9}, "slots": 1,
             "schedule_seed": 8},
}


def small_cell(config: str, traffic: str, *, limits=None, check=None, rate=40.0) -> Cell:
    conf = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    over = dict(SMALL[config])
    conf["program_overrides"] = dict(over)
    model = dict(conf["model"], **over)
    if "mamba_dt_rank" in model:
        model["mamba_dt_rank"] = math.ceil(model["d_model"] / 16)
    conf["model"] = model
    return Cell(name=f"{config}.{traffic}", chips=1, config=conf, model=expand_model(model),
                traffic=dict(TRAFFIC[traffic]),
                numbers={"rate_rps": rate, "check": check or {"requests": 4},
                         "limits": limits or {"token_gap": 1e-3, "logits_rel_l2": 1e-4,
                                               "route_margin": 1e-4}},
                end_to_end=[], per_layer=[])
