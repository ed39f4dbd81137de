"""internvl2's image prefix (ROADMAP A14) in the port against the JAX
package, at reduced size on the CPU: 2 layers, d 64, 4 query heads on 2 kv
heads, head dim 16, vocabulary 257 padded to 512. The prefix is (B, P, d)
stub patch embeddings put ahead of the tokens; weights come from the
reference's own init through ``repro_torch.models.convert``, inputs from
numpy with a seed.

Tolerances (float32 throughout), as in ``tests/test_torch_encdec.py``: 2e-4
for logits and caches (two layers accumulate rounding differences in
another summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.steps import batch_specs as jax_batch_specs
from repro.launch.steps import prefix_len as jax_prefix_len
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch.steps import batch_specs, decode_specs, make_prefill_step, prefix_len
from repro_torch.models import lm
from repro_torch.models.convert import caches_from_jax, caches_to_numpy, params_from_jax

ARCH = "internvl2_1b"
KEY = jax.random.PRNGKey(1)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


def cfgs(**kw):
    return (jax_get_config(ARCH).reduced(seq_chunk=8, **kw),
            get_config(ARCH).reduced(seq_chunk=8, **kw))


def models(**kw):
    """Both packages' reduced internvl2 with the reference's weights, the
    norm scales made random so every (1 + scale) counts."""
    jcfg, cfg = cfgs(**kw)
    tree = jax.tree.map(np.asarray, jlm.init_model(jcfg, KEY))
    rng = np.random.default_rng(30)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (rng.standard_normal(leaf.shape) * 0.3).astype(leaf.dtype)
        if any(getattr(k, "key", None) in ("norm1", "norm2", "final_norm") for k in path)
        else leaf, tree)
    model = lm.LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg), strict=True)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), model


def inputs(B, P, S, d, seed=31):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 257, (B, S)).astype(np.int32)
    prefix = (rng.standard_normal((B, P, d)) * 0.02).astype(np.float32)
    return tokens, prefix


@pytest.mark.parametrize("P,S", [(3, 12), (8, 5), (1, 1)])
def test_prefill_and_decode_with_a_prefix_match_jax(P, S):
    """Prefill after the prefix: last-position logits and every cache leaf
    over the P + S positions; then 3 decode steps from the reference's
    caches grown by 3 positions."""
    jcfg, cfg, jparams, model = models()
    B, extra = 2, 3
    tokens, prefix = inputs(B, P, S, cfg.d_model)
    logits, caches = model.prefill(torch.from_numpy(tokens), prefix_embeds=torch.from_numpy(prefix))
    jlogits, jcaches = jlm.prefill(jparams, jcfg, jnp.asarray(tokens),
                                   prefix_embeds=jnp.asarray(prefix))
    assert logits.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    (ours,), (ref,) = caches_to_numpy(caches), jcaches
    for name in ("k", "v"):
        assert ours[name].shape == (cfg.num_superblocks, B, P + S, cfg.num_kv_heads,
                                    cfg.resolved_head_dim)
        np.testing.assert_allclose(ours[name], np.asarray(ref[name]), **MODEL_TOL)

    grow = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    jcaches = ({k: jnp.pad(v, grow) for k, v in jcaches[0].items()},)
    caches = caches_from_jax(jax.tree.map(np.asarray, jcaches))
    tok = np.argmax(np.asarray(jlogits)[:, 0], axis=-1).astype(np.int32)[:, None]
    for step in range(extra):
        pos = P + S + step
        logits, caches = model.decode_step(torch.from_numpy(tok), pos, caches)
        jlogits, jcaches = jlm.decode_step(jparams, jcfg, jnp.asarray(tok), jnp.int32(pos),
                                           jcaches)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
        tok = np.argmax(np.asarray(jlogits)[:, 0], axis=-1).astype(np.int32)[:, None]
    for name in ("k", "v"):
        np.testing.assert_allclose(caches_to_numpy(caches)[0][name], np.asarray(jcaches[0][name]),
                                   **MODEL_TOL)


def test_forward_with_a_prefix_matches_jax_and_prefill():
    """Full-sequence logits over the P + S positions, and prefill's last
    position equal to forward's."""
    jcfg, cfg, jparams, model = models()
    tokens, prefix = inputs(2, 4, 9, cfg.d_model)
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens), prefix_embeds=torch.from_numpy(prefix))
    want = jlm.forward(jparams, jcfg, jnp.asarray(tokens), prefix_embeds=jnp.asarray(prefix))
    assert logits.shape == (2, 13, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **MODEL_TOL)
    last, _ = model.prefill(torch.from_numpy(tokens), prefix_embeds=torch.from_numpy(prefix))
    np.testing.assert_allclose(last.numpy(), logits[:, -1:].numpy(), rtol=1e-6, atol=1e-6)


def test_tied_scaling_applies_to_the_tokens_only():
    """With a tied embedding (gemma's sqrt(d) input scaling) the tokens are
    scaled and the prefix is not, as in the reference's ``_embed``."""
    jcfg, cfg, jparams, model = models(tie_embeddings=True)
    tokens, prefix = inputs(2, 3, 7, cfg.d_model, seed=32)
    logits, _ = model.prefill(torch.from_numpy(tokens), prefix_embeds=torch.from_numpy(prefix))
    jlogits, _ = jlm.prefill(jparams, jcfg, jnp.asarray(tokens), prefix_embeds=jnp.asarray(prefix))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)


def test_the_prefix_is_cast_to_the_model_dtype():
    """A float32 prefix into a bf16 model: cast, as the reference casts it."""
    _, cfg = cfgs()
    model = lm.LM(dataclasses.replace(cfg, dtype="bfloat16"), device="cpu")
    tokens, prefix = inputs(1, 2, 5, cfg.d_model)
    logits, caches = model.prefill(torch.from_numpy(tokens), prefix_embeds=torch.from_numpy(prefix))
    assert logits.dtype == torch.bfloat16 and caches[0]["k"].shape[2] == 7


@pytest.mark.parametrize("arch", ["starcoder2_3b", "gemma2_9b", "xlstm_1_3b"])
def test_a_prefix_on_a_text_only_config_raises(arch):
    cfg = get_config(arch).reduced()
    model = lm.LM(cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    prefix = torch.zeros((1, 2, cfg.d_model))
    with pytest.raises(ValueError, match="prefix_embeds"):
        model.prefill(tokens, prefix_embeds=prefix)
    with pytest.raises(ValueError, match="prefix_embeds"):
        model(tokens, prefix_embeds=prefix)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["internvl2_1b", "seamless_m4t_large_v2", "starcoder2_3b"])
def test_specs_match_the_reference(arch, shape):
    """``prefix_len`` and ``batch_specs`` as the reference's (shape, dtype);
    ``decode_specs``' caches as the port's cache template."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    suite = SHAPES[shape]
    assert prefix_len(cfg, suite.seq_len) == jax_prefix_len(jcfg, suite.seq_len)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jax_batch_specs(jcfg, suite).items()}
    got = {k: (tuple(s), str(d).removeprefix("torch.")) for k, (s, d) in
           batch_specs(cfg, suite).items()}
    assert got == want
    dec = decode_specs(cfg, suite)
    assert dec["token"] == ((suite.global_batch, 1), torch.int32)
    k_shape, k_dtype = dec["caches"][0]["k"]
    assert k_shape[:3] == (cfg.num_superblocks, suite.global_batch, suite.seq_len)
    assert k_dtype == torch.bfloat16


def test_prefill_step_passes_the_prefix():
    jcfg, cfg, jparams, model = models()
    tokens, prefix = inputs(2, 3, 6, cfg.d_model)
    batch = {"tokens": torch.from_numpy(tokens), "prefix_embeds": torch.from_numpy(prefix)}
    logits, caches = make_prefill_step(cfg)(model, batch)
    want, _ = model.prefill(batch["tokens"], prefix_embeds=batch["prefix_embeds"])
    assert torch.equal(logits, want) and caches[0]["k"].shape[2] == 9
