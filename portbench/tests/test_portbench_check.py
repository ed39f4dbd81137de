"""The comparison that decides ``correct``, driven through a whole run on the
CPU at a small size (the harness's look for a card skipped): the plain fp32
reference agrees with the program's CPU path, and each fault a serving cell
can have, planted in the timed path, turns ``correct`` false."""

import pytest
import torch

from portbench import run as R
from portbench_small import small_cell

SEED = 2**31 + 77
CELLS = [("starcoder2-3b", "onepass"), ("jamba-v0.1-2sb", "onepass"), ("jamba-v0.1-2sb", "chat")]


def run(cell, fault=None, seconds=1.0):
    return R.run(cell, seed=SEED, seconds=seconds, trace=False, device="cpu", fault=fault)


@pytest.mark.parametrize("config,traffic", CELLS)
def test_the_reference_agrees_with_the_programs_cpu_path(config, traffic):
    res = run(small_cell(config, traffic))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["logits_rel_l2"]["value"] < 1e-5
    assert res["checks"]["token_gap"]["value"] == 0.0
    assert list(res)[-1] == "checks"


def altered_token(engine):
    """A served token altered where it is produced (the engine's greedy pick)."""
    tick = engine.tick
    vocab = engine.cfg.vocab_size

    def faulty(now=None):
        before = {id(r): len(r.tokens_out) for r in engine.queue + engine.active if r is not None}
        touched = [r for r in engine.queue + engine.active if r is not None]
        n = tick(now=now)
        for r in touched:
            if len(r.tokens_out) > before[id(r)]:
                r.tokens_out[-1] = (r.tokens_out[-1] + 1) % vocab
        return n

    engine.tick = faulty


def state_unchanged(engine):
    """A decode step that returns its state unchanged: the caches it writes are
    thrown away."""
    decode = engine.model.decode_step

    def faulty(token, pos, caches):
        return decode(token, pos, tuple({k: v.clone() for k, v in c.items()} for c in caches))

    engine.model.decode_step = faulty


@pytest.mark.parametrize("config,traffic", CELLS)
def test_an_altered_token_fails(config, traffic):
    res = run(small_cell(config, traffic), fault=altered_token)
    assert not res["correct"]
    assert res["checks"]["token_gap"]["value"] > res["checks"]["token_gap"]["limit"]


def test_a_decode_step_that_keeps_its_state_fails():
    res = run(small_cell("jamba-v0.1-2sb", "chat"), fault=state_unchanged)
    assert not res["correct"]
    assert res["checks"]["logits_rel_l2"]["value"] > res["checks"]["logits_rel_l2"]["limit"]


def test_routing_to_the_wrong_experts_fails(monkeypatch):
    from repro_torch.models import moe

    route = moe.route

    def wrong(p, xt, cfg):
        probs, _ = route(p, xt, cfg)
        return probs, torch.topk(-probs, cfg.num_experts_per_tok, dim=-1).indices

    monkeypatch.setattr(moe, "route", wrong)
    res = run(small_cell("jamba-v0.1-2sb", "chat"))
    assert not res["correct"]
    assert res["checks"]["route_margin"]["value"] > res["checks"]["route_margin"]["limit"]


def test_a_run_whose_requests_never_finish_is_not_correct(monkeypatch):
    from portbench import window
    monkeypatch.setattr(window, "GRACE_S", 0.0)
    cell = small_cell("starcoder2-3b", "onepass", rate=4000.0)  # far past what the CPU serves
    res = run(cell, seconds=0.3)
    assert res["failed"] > 0 and not res["correct"]


def served(rid, prompt_len, n_tokens=1, finished=True):
    from portbench.window import ReqRecord
    r = ReqRecord(rid, 0.0, prompt_len, n_tokens, tokens=[0] * n_tokens, logits=[0] * n_tokens)
    r.t_done = 1.0 if finished else None
    return r


@pytest.mark.parametrize("n", [1, 2, 8, 48, 200])
def test_a_sample_by_requests_holds_the_longest_and_every_band_of_lengths(n):
    from portbench.check import sample
    recs = [served(i, 1536 + (i * 7919) % 2560) for i in range(120)] + [served(999, 9000, 1, False)]
    picked = sample(recs, {"requests": n}, seed=2**31 + 3)
    done = sorted((r for r in recs if r.finished), key=lambda r: (r.prompt_len, r.rid))
    assert picked[0] is done[-1] and len(picked) == min(n, len(done))
    assert len({r.rid for r in picked}) == len(picked) and all(r.finished for r in picked)
    if 1 < n <= len(done):
        # one from each of n - 1 equal strata of the rest, in order of length
        bands = [done[:-1][k * 119 // (n - 1)] for k in range(n - 1)]
        lens = sorted(r.prompt_len for r in picked[1:])
        assert all(a.prompt_len <= b for a, b in zip(bands, lens))
    assert picked == sample(recs, {"requests": n}, seed=2**31 + 3)


def test_a_sample_by_tokens_stops_once_it_holds_them():
    from portbench.check import sample
    recs = [served(i, 100 + i, 10) for i in range(30)]
    picked = sample(recs, {"tokens": 45}, seed=11)
    assert picked[0].rid == 29 and len(picked) == 5
