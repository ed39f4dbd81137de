"""The port's serving engine and launcher against the JAX package's, on the
CPU at reduced size.

Both engines get the same weights (the reference's init, carried across as
numpy arrays), the same ``PoissonWorkload`` seed and the same deterministic
injected timer, and are driven by the same event loop; their outputs must
then be equal token for token (argmax of float32 logits that agree to ~1e-6),
and their service logs equal in (phase, occupancy, tokens).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.workload import PoissonWorkload as JaxPoissonWorkload
from repro.serving.workload import WorkloadConfig as JaxWorkloadConfig
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import LM
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.workload import PoissonWorkload, WorkloadConfig


def fixed_timer(phase, run, *, tokens, occupancy):
    """Deterministic service times, so both engines see the same clock."""
    base = 2e-3 if phase == "prefill" else 1e-3
    return run(), base + 1e-4 * tokens + 5e-5 * occupancy


WL = dict(arrival_rate=400.0, prompt_len=12, prompt_len_jitter=4, max_new_tokens=6,
          new_tokens_geometric_p=0.3, seed=3)


def test_engine_matches_jax_engine_token_for_token():
    _engines_agree("starcoder2_3b")


def test_hybrid_engine_matches_jax_engine_token_for_token():
    """Reduced jamba: mamba state leaves copied into their slot wholesale,
    attention leaves by the prompt's prefix, MoE FFNs on the odd layers."""
    _engines_agree("jamba_v0_1_52b")


def _engines_agree(name):
    jcfg = jax_get_config(name).reduced(seq_chunk=8)
    cfg = get_config(name).reduced(seq_chunk=8)
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))

    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(slots=2, max_seq=32), timer=fixed_timer)
    eng = Engine(cfg, model, ServeConfig(slots=2, max_seq=32), timer=fixed_timer, device="cpu")
    jreqs = JaxPoissonWorkload(JaxWorkloadConfig(vocab=jcfg.vocab_size, **WL)).take(7)
    reqs = PoissonWorkload(WorkloadConfig(vocab=cfg.vocab_size, **WL)).take(7)
    t_end = serve.replay(eng, reqs)
    jt_end = serve.replay(jeng, jreqs)  # the loop only uses the shared engine contract

    assert len(eng.completed) == len(jeng.completed) == 7
    ours = {r.rid: r for r in eng.completed}
    for jr in jeng.completed:
        r = ours[jr.rid]
        assert r.tokens_out == jr.tokens_out
        assert (r.t_admit, r.t_first_token, r.t_done) == (jr.t_admit, jr.t_first_token,
                                                           jr.t_done)
    log = [(e.phase, e.occupancy, e.tokens) for e in eng.service_log]
    assert log == [(e.phase, e.occupancy, e.tokens) for e in jeng.service_log]
    assert t_end == jt_end
    # more than one slot was busy at once, so the shared decode position was exercised
    assert max(e.occupancy for e in eng.service_log if e.phase == "decode") == 2


def test_engine_slot_write_keeps_other_slots_and_copies_states_wholesale():
    cfg = get_config("jamba_v0_1_52b").reduced(seq_chunk=8)
    model = LM(cfg, device="cpu")
    eng = Engine(cfg, model, ServeConfig(slots=3, max_seq=32), device="cpu")
    for c in eng.caches:
        for leaf in c.values():
            leaf.fill_(7.0)
    _, one = model.prefill(torch.arange(5)[None])
    eng._write_slot(one, 1)
    for full, part in zip(eng.caches, one):
        for name, leaf in full.items():
            if name in ("k", "v"):  # the prompt's 5 positions, the rest untouched
                assert torch.equal(leaf[:, 1, :5], part[name][:, 0])
                assert bool((leaf[:, 1, 5:] == 7.0).all())
            else:
                assert torch.equal(leaf[:, 1], part[name][:, 0])
            assert bool((leaf[:, 0] == 7.0).all()) and bool((leaf[:, 2] == 7.0).all())


def test_serve_cli_runs_reduced_jamba_on_cpu(capsys):
    engine, _ = serve.run(["--arch", "jamba_v0_1_52b", "--reduced", "--device", "cpu",
                           "--requests", "4", "--slots", "2", "--max-new", "4"])
    assert len(engine.completed) == 4
    assert all(len(r.tokens_out) == 4 for r in engine.completed)
    out = capsys.readouterr().out
    assert "jamba_v0_1_52b-smoke" in out and "superblocks: 2 of 2" in out


def test_serve_cli_cuts_depth_by_superblocks(capsys):
    engine, _ = serve.run(["--arch", "jamba_v0_1_52b", "--reduced", "--device", "cpu",
                           "--superblocks", "1", "--requests", "2", "--max-new", "2"])
    assert engine.cfg.num_superblocks == 1 and len(engine.model.layers) == 8
    assert len(engine.completed) == 2
    assert "superblocks: 1 of 2" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.run(["--reduced", "--device", "cpu", "--superblocks", "3"])


def test_wall_clock_engine_flags_unwarmed_shapes_and_keeps_state():
    cfg = get_config("deepseek_7b").reduced(seq_chunk=8)
    eng = Engine(cfg, LM(cfg, device="cpu"), ServeConfig(slots=2, max_seq=32), device="cpu")
    before = [{k: v.clone() for k, v in c.items()} for c in eng.caches]
    eng.warmup([10])
    assert all(torch.equal(c[k], b[k]) for c, b in zip(eng.caches, before) for k in c)
    reqs = PoissonWorkload(WorkloadConfig(arrival_rate=50.0, prompt_len=10, prompt_len_jitter=1,
                                          max_new_tokens=3, vocab=cfg.vocab_size)).take(4)
    serve.replay(eng, reqs)
    assert len(eng.completed) == 4
    warm = {10}
    for ev in eng.service_log:
        assert ev.compile == (ev.phase == "prefill" and ev.tokens not in warm)
        assert ev.duration_s > 0
        if ev.phase == "prefill":
            warm.add(ev.tokens)
    mean, var = eng.observed_service_stats()
    assert mean > 0 and var >= 0


def test_serve_cli_runs_reduced_on_cpu(capsys):
    assert serve.main(["--arch", "starcoder2_3b", "--requests", "3", "--max-new", "3",
                       "--reduced", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "3 requests done" in out


def test_serve_cli_refuses_prompts_longer_than_the_cache():
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--prompt-len", "64", "--max-seq", "64"])


def test_serve_cli_sizes_the_cache_to_the_workload(capsys):
    # longest prompt 60 + 8, 3 new tokens: 72 positions, rounded up to 128
    engine, _ = serve.run(["--reduced", "--device", "cpu", "--requests", "3", "--slots", "2",
                           "--prompt-len", "60", "--prompt-jitter", "8", "--max-new", "3"])
    assert engine.sc.max_seq == 128
    assert len(engine.completed) == 3
    assert all(len(r.tokens_out) == 3 for r in engine.completed)
    assert "2 slots of 128 positions" in capsys.readouterr().out


def test_entry_points_default_to_the_card_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("starcoder2_3b").reduced(seq_chunk=8)
    model = LM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Engine(cfg, model, ServeConfig(slots=1, max_seq=16))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.main(["--reduced", "--requests", "1"])


def test_engine_refuses_a_model_on_another_device():
    cfg = get_config("starcoder2_3b").reduced(seq_chunk=8)
    model = LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="model is on cpu"):
        Engine(cfg, model, ServeConfig(slots=1, max_seq=16), device="meta")
