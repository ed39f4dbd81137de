"""The port's model layers and LM against the JAX package's, at reduced size
on the CPU. Weights and inputs come from the reference's own init (or numpy,
from a seed) and pass to the port as numpy arrays through
``repro_torch.models.convert``.

Tolerances (float32 throughout): 1e-5 for single layers (same arithmetic,
other summation order); 2e-4 for whole-model logits and caches (two
superblocks of matmuls, RoPE and softmax accumulate rounding differences;
tests/test_kernels.py budgets 2e-4 for attention inside the model as well).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.convert import caches_from_jax, caches_to_numpy, params_from_jax

KEY = jax.random.PRNGKey(1)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


def to_torch(tree):
    """A JAX param dict (one layer) as a dict of CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def cfgs(name, **kw):
    """The same reduced config in both packages."""
    return (jax_get_config(name).reduced(seq_chunk=8, **kw),
            get_config(name).reduced(seq_chunk=8, **kw))


def test_configs_are_the_same_data():
    for name in ("starcoder2_3b", "deepseek_7b", "gemma2_9b", "jamba_v0_1_52b"):
        assert repr(jax_get_config(name)) == repr(get_config(name))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32) * 2
    sc = rng.standard_normal(64).astype(np.float32) * 0.3  # non-zero: exercises (1+scale)
    out = L.rms_norm(torch.from_numpy(x), torch.from_numpy(sc), 1e-6)
    ref = JL.rms_norm(jnp.asarray(x), jnp.asarray(sc), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER_TOL)


@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope_apply(batched_positions):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + 5
    if batched_positions:
        pos = np.stack([pos, pos * 3])
    out = L.rope_apply(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    ref = JL.rope_apply(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER_TOL)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "deepseek_7b"])  # gelu plain, silu gated
def test_mlp_apply(arch):
    jcfg, cfg = cfgs(arch)
    assert (cfg.gated_mlp, cfg.mlp_act) == (
        (False, "gelu") if arch == "starcoder2_3b" else (True, "silu"))
    p = jax_init_params(JL.mlp_template(jcfg), KEY, jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    out = L.mlp_apply(to_torch(p), torch.from_numpy(x), cfg)
    ref = JL.mlp_apply(p, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER_TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,local,S", [
    ("starcoder2_3b", False, 24),
    ("deepseek_7b", False, 13),
    ("gemma2_9b", True, 21),  # sliding window 8 + softcap 50 (prefill path)
])
def test_attn_forward(arch, local, S):
    kw = dict(attn_softcap=50.0) if arch == "gemma2_9b" else {}
    jcfg, cfg = cfgs(arch, **kw)
    p = jax_init_params(JA.attn_template(jcfg), KEY, jnp.float32)
    x = np.random.default_rng(3).standard_normal((2, S, cfg.d_model)).astype(np.float32) * 0.5
    y, (k, v) = A.attn_forward(to_torch(p), torch.from_numpy(x), cfg, local=local,
                               return_kv=True)
    jy, (jk, jv) = JA.attn_forward(p, jnp.asarray(x), jcfg, local=local, return_kv=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **LAYER_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **LAYER_TOL)


def test_prefill_cache_from_kv():
    jcfg, cfg = cfgs("starcoder2_3b")
    rng = np.random.default_rng(6)
    k = rng.standard_normal((1, 19, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 19, 2, 16)).astype(np.float32)
    out = A.prefill_cache_from_kv(torch.from_numpy(k), torch.from_numpy(v), cfg, local=False)
    ref = JA.prefill_cache_from_kv(jnp.asarray(k), jnp.asarray(v), jcfg, local=False)
    for name in ("k", "v"):
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref[name]))


@pytest.mark.parametrize("arch,pos", [("starcoder2_3b", 17), ("deepseek_7b", 0)])
def test_attn_decode(arch, pos):
    jcfg, cfg = cfgs(arch)
    p = jax_init_params(JA.attn_template(jcfg), KEY, jnp.float32)
    rng = np.random.default_rng(4)
    B, S = 3, 32
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    y, new = A.attn_decode(to_torch(p), torch.from_numpy(x), cache, pos, cfg)
    jy, jnew = JA.attn_decode(p, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                              jnp.int32(pos), jcfg)
    assert new is cache  # written in place
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(new[name].numpy(), np.asarray(jnew[name]), **LAYER_TOL)


def test_local_decode_is_not_ported_yet():
    _, cfg = cfgs("gemma2_9b")
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        A.attn_decode({}, torch.zeros(1, 1, cfg.d_model), {}, 0, cfg, local=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        A.prefill_cache_from_kv(torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16), cfg,
                                local=True)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


def _models(arch):
    jcfg, cfg = cfgs(arch)
    jparams = jlm.init_model(jcfg, KEY)
    model = lm.LM(cfg, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    model.load_state_dict(params_from_jax(tree, cfg), strict=True)
    return jcfg, cfg, jparams, model


@pytest.mark.parametrize("arch", ["starcoder2_3b", "deepseek_7b"])
def test_prefill_and_decode_match_jax(arch):
    jcfg, cfg, jparams, model = _models(arch)
    assert cfg.num_superblocks == 2
    B, S, extra = 2, 12, 3
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)

    logits, caches = model.prefill(torch.from_numpy(tokens))
    jlogits, jcaches = jlm.prefill(jparams, jcfg, jnp.asarray(tokens))
    assert logits.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    for ours, ref in zip(caches_to_numpy(caches), jcaches):
        for name in ("k", "v"):
            assert ours[name].shape == (cfg.num_superblocks, B, S, cfg.num_kv_heads,
                                        cfg.resolved_head_dim)
            np.testing.assert_allclose(ours[name], np.asarray(ref[name]), **MODEL_TOL)

    # grow the caches as the engine would, then decode a few tokens on both
    pad = lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0)))  # noqa: E731
    jcaches = jax.tree.map(pad, jcaches)
    caches = caches_from_jax(jax.tree.map(np.asarray, jcaches))
    tok = np.argmax(np.asarray(jlogits)[:, 0], axis=-1).astype(np.int32)[:, None]
    for step in range(extra):
        pos = S + step
        logits, caches = model.decode_step(torch.from_numpy(tok), pos, caches)
        jlogits, jcaches = jlm.decode_step(jparams, jcfg, jnp.asarray(tok), jnp.int32(pos),
                                           jcaches)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
        tok = np.argmax(np.asarray(jlogits)[:, 0], axis=-1).astype(np.int32)[:, None]
    for ours, ref in zip(caches_to_numpy(caches), jcaches):
        for name in ("k", "v"):
            np.testing.assert_allclose(ours[name], np.asarray(ref[name]), **MODEL_TOL)


def test_full_width_starcoder2_3b_param_count_without_allocation():
    cfg = get_config("starcoder2_3b")
    assert lm.num_params(cfg) == 3_180_518_400 == jlm.num_params(jax_get_config("starcoder2_3b"))
    # the template's cache for 4 slots x 1024 positions, 30 layers, 2 kv heads
    (c,) = lm.cache_template(cfg, 4, 1024)
    assert c["k"].shape == (30, 4, 1024, 2, 128)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "deepseek_7b", "starcoder2_15b",
                                  "internvl2_1b"])
def test_reduced_param_counts_match_jax(arch):
    jcfg, cfg = cfgs(arch)
    model = lm.LM(cfg, device="cpu")
    assert model.num_params() == lm.num_params(cfg) == jlm.num_params(jcfg)


def test_random_init_is_seeded_and_order_free():
    _, cfg = cfgs("starcoder2_3b")
    a, b = lm.LM(cfg, device="cpu", seed=3), lm.LM(cfg, device="cpu", seed=3)
    c = lm.LM(cfg, device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.0.attn.wq"], sc["layers.0.attn.wq"])
    assert not torch.equal(sa["layers.0.attn.wq"], sa["layers.1.attn.wq"])


@pytest.mark.parametrize("arch,item", [
    ("gemma2_9b", "A5"), ("jamba_v0_1_52b", "A6"), ("dbrx_132b", "A7"),
    ("arctic_480b", "A7"), ("xlstm_1_3b", "A8"), ("seamless_m4t_large_v2", "A9"),
])
def test_configs_outside_the_slice_name_their_roadmap_item(arch, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        lm.LM(get_config(arch).reduced(), device="cpu")
