"""The port's encoder-decoder (seamless) against the JAX package's, at
reduced size on the CPU: 2 encoder + 2 decoder layers, d 64, 4 query heads
on 2 kv heads, head dim 16, vocab 257 padded to 512. Weights come from the
reference's own init through ``repro_torch.models.convert``; inputs are
drawn with numpy from a seed.

Tolerances (float32 throughout), as in ``tests/test_torch_models.py``: 1e-5
for the cross K/V projections (the same matmul), 2e-5 for a cross-attention
output (projections, softmax and the output projection in another summation
order), 2e-4 for the encoder output, whole-model logits and caches (two
layers of each stack accumulate rounding differences). The cross caches
are held bit for bit across decode steps: decode only reads them.

The reference's engine cannot serve this config (ROADMAP C11: its prefill
passes no encoder input); the port's engine refuses it by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import lm as jlm
from repro.models.params import init_params as jax_init_params
from repro.perf.flops import param_counts as jax_param_counts
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention.ref import decode_attention_reference
from repro_torch.kernels.flash_attention.ref import flash_attention_reference
from repro_torch.kernels.rmsnorm.ref import rmsnorm_add_reference, rmsnorm_reference
from repro_torch.models import attention as A
from repro_torch.models import layers
from repro_torch.models import lm
from repro_torch.models.convert import caches_from_jax, caches_to_numpy, params_from_jax
from repro_torch.perf.flops import param_counts
from repro_torch.serving.engine import Engine, ServeConfig

ARCH = "seamless_m4t_large_v2"
KEY = jax.random.PRNGKey(1)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


def cfgs():
    """The same reduced config in both packages (seq_chunk 8: the
    reference's query chunks, so Se = 13 leaves a ragged one)."""
    return (jax_get_config(ARCH).reduced(seq_chunk=8), get_config(ARCH).reduced(seq_chunk=8))


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module")
def models():
    """Both packages' reduced seamless with the reference's weights, its
    zero-initialised norm scales made random so every (1 + scale) counts."""
    jcfg, cfg = cfgs()
    tree = jax.tree.map(np.asarray, jlm.init_model(jcfg, KEY))
    rng = np.random.default_rng(20)

    def randomise(path, leaf):
        if any(getattr(k, "key", None) in ("norm1", "norm2", "norm_cross", "final_norm")
               for k in path):
            return (rng.standard_normal(leaf.shape) * 0.3).astype(leaf.dtype)
        return leaf

    tree = jax.tree_util.tree_map_with_path(randomise, tree)
    model = lm.LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg), strict=True)
    assert float(model.encoder.final_norm.abs().min()) > 0
    assert float(model.layers[0].norm_cross.abs().min()) > 0
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), model


def frames(B, Se, d, seed=21):
    return np.random.default_rng(seed).standard_normal((B, Se, d)).astype(np.float32)


@pytest.mark.parametrize("Se", [24, 13])  # 13: not a multiple of the reference's chunk of 8
def test_encode_matches_jax(models, Se):
    jcfg, cfg, jparams, model = models
    enc = frames(2, Se, cfg.d_model)
    out = model.encode(torch.from_numpy(enc))
    ref = jlm.encode(jparams, jcfg, jnp.asarray(enc))
    assert out.shape == (2, Se, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


@pytest.mark.parametrize("Sq,Se", [(5, 11), (9, 9), (13, 7)])  # Sq <, = and > Se
def test_cross_attention_matches_jax(Sq, Se):
    jcfg, cfg = cfgs()
    p = jax_init_params(JA.attn_template(jcfg), KEY, jnp.float32)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    enc_out = rng.standard_normal((2, Se, cfg.d_model)).astype(np.float32)
    k, v = A.cross_kv(to_torch(p), torch.from_numpy(enc_out), cfg)
    jk, jv = JA.cross_kv(p, jnp.asarray(enc_out), jcfg)
    assert k.shape == (2, Se, cfg.num_kv_heads, cfg.resolved_head_dim)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **LAYER_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **LAYER_TOL)
    y = A.cross_attn_forward(to_torch(p), torch.from_numpy(x), k, v, cfg)
    jy = JA.cross_attn_forward(p, jnp.asarray(x), jk, jv, jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **ATTN_TOL)


def test_cross_attention_decode_attends_every_frame_and_leaves_the_cache():
    """One query against all Se cached frames through the decode path (pos
    Se - 1), as the reference's cross-attention of a one-token x."""
    jcfg, cfg = cfgs()
    p = jax_init_params(JA.attn_template(jcfg), KEY, jnp.float32)
    rng = np.random.default_rng(23)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    shape = (3, 13, cfg.num_kv_heads, cfg.resolved_head_dim)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    y = A.cross_attn_forward(to_torch(p), torch.from_numpy(x), tk, tv, cfg, decode=True)
    jy = JA.cross_attn_forward(p, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **ATTN_TOL)
    np.testing.assert_array_equal(tk.numpy(), kc)
    np.testing.assert_array_equal(tv.numpy(), vc)


def _assert_caches_match(caches, jcaches, cfg, B, S, Se):
    n_sb, K, hd = cfg.num_superblocks, cfg.num_kv_heads, cfg.resolved_head_dim
    (ours,), (ref,) = caches_to_numpy(caches), jcaches
    assert set(ours) == set(ref) == {"k", "v", "cross_k", "cross_v"}
    assert ours["k"].shape == ours["v"].shape == (n_sb, B, S, K, hd)
    assert ours["cross_k"].shape == ours["cross_v"].shape == (n_sb, B, Se, K, hd)
    for name in ours:
        np.testing.assert_allclose(ours[name], np.asarray(ref[name]), **MODEL_TOL)


@pytest.mark.parametrize("Se", [24, 13])
def test_prefill_and_decode_match_jax(models, Se):
    """Prefill with the encoder input: logits and every cache leaf; then 3
    decode steps from the reference's caches grown by 3 positions: logits
    and caches, the cross caches unchanged."""
    jcfg, cfg, jparams, model = models
    B, S, extra = 2, 12, 3
    tokens = np.random.default_rng(24).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    enc = frames(B, Se, cfg.d_model, seed=25)
    logits, caches = model.prefill(torch.from_numpy(tokens), enc_embeds=torch.from_numpy(enc))
    jlogits, jcaches = jlm.prefill(jparams, jcfg, jnp.asarray(tokens),
                                   enc_embeds=jnp.asarray(enc))
    assert logits.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    _assert_caches_match(caches, jcaches, cfg, B, S, Se)

    grow = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    jcaches = ({**jcaches[0], "k": jnp.pad(jcaches[0]["k"], grow),
                "v": jnp.pad(jcaches[0]["v"], grow)},)
    caches = caches_from_jax(jax.tree.map(np.asarray, jcaches))
    cross_before = {k: caches[0][k].clone() for k in ("cross_k", "cross_v")}
    tok = np.argmax(np.asarray(jlogits)[:, 0], axis=-1).astype(np.int32)[:, None]
    for step in range(extra):
        pos = S + step
        logits, caches = model.decode_step(torch.from_numpy(tok), pos, caches)
        jlogits, jcaches = jlm.decode_step(jparams, jcfg, jnp.asarray(tok), jnp.int32(pos),
                                           jcaches)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
        tok = np.argmax(np.asarray(jlogits)[:, 0], axis=-1).astype(np.int32)[:, None]
    _assert_caches_match(caches, jcaches, cfg, B, S + extra, Se)
    for name, before in cross_before.items():
        assert torch.equal(caches[0][name], before)


def test_the_paths_launch_what_chip_smoke_counts(monkeypatch, models):
    """Every kernel call of encode + prefill and of a decode step, by entry
    (the chip's launch counts come from these): per prefill 1 + 2 rmsnorm
    (the encoder's and the decoder's first norm1, the final norm of the last
    position), 2Le + 3L - 1 fused adds and Le + 2L flash calls, the encoder
    unmasked over Se = Se keys with no rotary lost, the cross calls unmasked
    over Sq = S queries and Se keys; per decode step 1 rmsnorm, 3L fused adds
    and 2L decode calls, the cross calls at pos Se - 1."""
    jcfg, cfg, jparams, model = models
    calls = []

    def counted(name, ref):
        def run(*args, **kw):
            calls.append((name, args, kw))
            return ref(*args, **kw)
        return run

    for name, mod, ref in (("rmsnorm", layers, rmsnorm_reference),
                           ("rmsnorm_add", layers, rmsnorm_add_reference),
                           ("flash_attention", A, flash_attention_reference),
                           ("decode_attention", A, decode_attention_reference)):
        monkeypatch.setattr(mod, name, counted(name, ref))
    Le, L, B, S, Se = cfg.encoder_layers, cfg.num_layers, 2, 5, 13
    tokens = torch.from_numpy(np.random.default_rng(26).integers(0, 257, (B, S)))
    _, caches = model.prefill(tokens, enc_embeds=torch.from_numpy(frames(B, Se, cfg.d_model)))

    def count(name):
        return sum(c[0] == name for c in calls)

    assert (count("rmsnorm"), count("rmsnorm_add"), count("flash_attention")) == (
        3, 2 * Le + 3 * L - 1, Le + 2 * L)
    flash = [(c[1][0].shape[1], c[1][1].shape[1], c[2]["causal"]) for c in calls
             if c[0] == "flash_attention"]
    assert flash == [(Se, Se, False)] * Le + [(S, S, True), (S, Se, False)] * L
    calls.clear()
    full = model.init_caches(B, 8, enc_len=Se)
    for dst, src in zip(full, caches):
        for name in dst:
            dst[name][:, :, :src[name].shape[2]].copy_(src[name])
    model.decode_step(tokens[:, :1], S, full)
    assert (count("rmsnorm"), count("rmsnorm_add"), count("decode_attention")) == (
        1, 3 * L, 2 * L)
    assert [c[1][3] for c in calls if c[0] == "decode_attention"] == [S, Se - 1] * L


def test_prefill_asks_for_the_encoder_input(models):
    _, cfg, _, model = models
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="enc_embeds is required"):
        model.prefill(tokens)
    dense = get_config("starcoder2_3b").reduced()
    with pytest.raises(ValueError, match="encoder-decoders only"):
        lm.LM(dense, device="cpu").prefill(tokens, enc_embeds=torch.zeros((1, 3, 64)))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_param_counts_match_the_reference(reduced):
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = cfgs()
    assert lm.num_params(cfg) == jlm.num_params(jcfg)
    assert param_counts(cfg) == jax_param_counts(jcfg)
    if not reduced:
        assert lm.num_params(cfg) == 2_034_886_656


def test_full_width_templates_without_allocation():
    """The reference's tree (an encoder of 24 stacked blocks and a final
    norm; a cross branch in every decoder block) and the chip's caches: 4
    utterances of 1500 frames, 66 decoder positions."""
    cfg = get_config(ARCH)
    t = lm.model_template(cfg)
    assert sorted(t["encoder"]) == ["blocks", "final_norm"]
    (enc_block,) = t["encoder"]["blocks"]
    assert sorted(enc_block) == ["attn", "mlp", "norm1", "norm2"]
    assert enc_block["attn"]["wq"].shape == (24, 1024, 1024)
    (block,) = t["blocks"]
    assert sorted(block) == ["attn", "cross", "mlp", "norm1", "norm2", "norm_cross"]
    (c,) = lm.cache_template(cfg, 4, 66, enc_len=1500)
    assert c["k"].shape == (24, 4, 66, 16, 64)
    assert c["cross_k"].shape == c["cross_v"].shape == (24, 4, 1500, 16, 64)


def test_the_engine_refuses_the_encoder_decoder_naming_c11():
    _, cfg = cfgs()
    with pytest.raises(NotImplementedError, match="ROADMAP C11"):
        Engine(cfg, lm.LM(cfg, device="cpu"), ServeConfig(slots=1, max_seq=32), device="cpu")


def test_the_serve_cli_exits_with_the_engines_message(capsys):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit) as exc:
        serve.run(["--arch", ARCH, "--reduced", "--device", "cpu"])
    assert exc.value.code == 2
    assert "ROADMAP C11" in capsys.readouterr().err


def test_the_reference_engine_fails_on_its_first_prefill():
    """ROADMAP C11, recorded: the reference builds its engine (cross caches of
    max_seq frames) but its prefill passes no encoder input, so
    ``lm.prefill`` encodes None."""
    jcfg, _ = cfgs()
    engine = JaxEngine(jcfg, jlm.init_model(jcfg, KEY), JaxServeConfig(slots=1, max_seq=32))
    assert engine.caches[0]["cross_k"].shape[2] == 32
    engine.submit(JaxRequest(rid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=2))
    with pytest.raises(AttributeError, match="astype"):
        engine.tick(0.0)
