"""The defect that keeps the benchmark's cells at one slot: with more than
one slot, every active slot decodes at the furthest active position
(``repro_torch/serving/engine.py:266-268``; ``LM.decode_step`` and
``attn_decode`` take one position for the batch), so a shorter or later
request writes its keys past its own length and attends cache rows its
prompt never wrote. Two staggered requests of different lengths served
through a 2-slot engine are held against the reference; this fails until
each slot decodes at its own position."""

import numpy as np
import pytest
import torch

from portbench.reference.model import Served, reference_logits
from portbench.window import capture_logits
from portbench_small import small_cell


@pytest.mark.xfail(strict=True, reason="repro_torch/serving/engine.py:266-268 decodes every "
                   "slot at the furthest active position (one shared decode position)")
def test_two_staggered_requests_through_two_slots_match_the_reference():
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import Engine, Request, ServeConfig

    cell = small_cell("starcoder2-3b", "onepass")
    cfg = replace(get_config("starcoder2_3b"), **cell.config["program_overrides"])
    seed = 11
    engine = Engine(cfg, LM(cfg, device="cpu", seed=seed), ServeConfig(slots=2, max_seq=64),
                    device="cpu")
    calls, undo = capture_logits(engine)
    rng = np.random.default_rng(0)
    a = Request(0, rng.integers(0, 256, 12).astype(np.int32), max_new_tokens=6)
    b = Request(1, rng.integers(0, 256, 5).astype(np.int32), max_new_tokens=4)
    engine.submit(a)
    engine.tick(now=0.0)
    engine.submit(b)
    while engine.queue or any(r is not None for r in engine.active):
        engine.tick(now=0.0)
    undo()
    logits = {0: [], 1: []}
    for call in calls:
        if call[0] == "prefill":
            rid = 0 if not logits[0] else 1
            logits[rid].append(call[1][0, -1])
        else:
            for slot, req in enumerate(call[3]):
                if req is not None:
                    logits[req.rid].append(call[1][slot, 0])
    served = [Served(torch.from_numpy(np.concatenate([r.prompt, r.tokens_out[:-1]]).astype(
        np.int64)), len(r.prompt)) for r in (a, b)]
    refs, _, _ = reference_logits(cell.model, seed, served, "cpu")
    for r, ref in zip((a, b), refs):
        got = torch.stack(logits[r.rid]).float()
        rel = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max()
        assert rel < 1e-4, (r.rid, float(rel))
