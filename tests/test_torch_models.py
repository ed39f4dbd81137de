"""The port's model layers and LM against the JAX package's, at reduced size
on the CPU. Weights and inputs come from the reference's own init (or numpy,
from a seed) and pass to the port as numpy arrays through
``repro_torch.models.convert``.

Tolerances (float32 throughout): 1e-5 for single layers (same arithmetic,
other summation order); 2e-4 for whole-model logits and caches (two
superblocks of matmuls, RoPE and softmax accumulate rounding differences;
tests/test_kernels.py budgets 2e-4 for attention inside the model as well).
The mamba mixer is held to 1e-5 through prefill and decode (its scan runs in
fp32 in both packages); MoE layers to 1e-5, with the same (token, slot)
pairs dropped (the routing is compared exactly through the dropped count).
The local (sliding-window) ring cache is held bit for bit (a pad or a roll
of the same numbers). The xLSTM cells to 1e-4 (see ``XLSTM_TOL``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models import moe as JM
from repro.models import ssm as JS
from repro.models import xlstm as JX
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.convert import caches_from_jax, caches_to_numpy, params_from_jax

KEY = jax.random.PRNGKey(1)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
# the xLSTM cells: the port's mLSTM takes 256-token chunks where the
# reference takes its largest divisor <= 256 (one-token chunks at a prime
# length), so the same sums run in another order and the decay factors
# exp(b_t - b_tau) come from other cumsums; states accumulate up to exp(8)
# input gates over the sequence
XLSTM_TOL = dict(rtol=1e-4, atol=1e-4)


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
    for name in ("starcoder2_3b", "deepseek_7b", "gemma2_9b", "jamba_v0_1_52b", "xlstm_1_3b"):
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


@pytest.mark.parametrize("S", [5, 8, 9, 19])  # window 8: S < W, S = W, W + 1, 2W + 3
def test_prefill_ring_cache_matches_jax(S):
    jcfg, cfg = cfgs("gemma2_9b")
    assert cfg.window_size == 8
    rng = np.random.default_rng(6)
    k = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    out = A.prefill_cache_from_kv(torch.from_numpy(k), torch.from_numpy(v), cfg, local=True)
    ref = JA.prefill_cache_from_kv(jnp.asarray(k), jnp.asarray(v), jcfg, local=True)
    for name in ("k", "v"):
        assert out[name].shape == (2, 8, 2, 16)
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref[name]))


@pytest.mark.parametrize("slots,pos", [
    (8, 0), (8, 7), (8, 8), (8, 9), (8, 19),  # a ring of W = 8: before, at and past the wrap
    (5, 0), (5, 4),  # a cache of 5 slots, below W: positions below its capacity
])
def test_local_attn_decode_matches_jax(slots, pos):
    """The ring's slot pos % W written in place, then the decode kernel's
    wrapper over min(pos + 1, slots) keys: the reference's ring mask."""
    jcfg, cfg = cfgs("gemma2_9b", attn_softcap=50.0)
    p = jax_init_params(JA.attn_template(jcfg), KEY, jnp.float32)
    rng = np.random.default_rng(11)
    B = 3
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, slots, cfg.num_kv_heads, cfg.resolved_head_dim)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    y, new = A.attn_decode(to_torch(p), torch.from_numpy(x), cache, pos, cfg, local=True)
    jy, jnew = JA.attn_decode(p, jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                              jnp.int32(pos), jcfg, local=True)
    assert new is cache  # written in place
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(new[name].numpy(), np.asarray(jnew[name]), **LAYER_TOL)
        # only the token's slot changed
        rest = np.delete(np.arange(slots), pos % cfg.window_size)
        before = kc if name == "k" else vc
        np.testing.assert_array_equal(new[name].numpy()[:, rest], before[:, rest])


# ---------------------------------------------------------------------------
# xLSTM cells
# ---------------------------------------------------------------------------


def _xlstm_params(jcfg, kind):
    """The reference's init with its zero biases and head norm made random:
    input gates past the exp(8) cap on one head, forget gates from near 0 to
    near 1, so every term of the cell counts."""
    template = JX.mlstm_template(jcfg) if kind == "mlstm" else JX.slstm_template(jcfg)
    p = dict(jax_init_params(template, KEY, jnp.float32))
    rng = np.random.default_rng(12)
    d, H = jcfg.d_model, jcfg.num_heads
    p["headnorm"] = jnp.asarray(rng.standard_normal(d).astype(np.float32) * 0.3)
    if kind == "mlstm":
        b = np.concatenate([[9.0, 1.0, -1.0, 0.0][:H], rng.standard_normal(H) * 2.0])
        p["b_if"] = jnp.asarray(b.astype(np.float32))
    else:
        p["b"] = jnp.asarray(rng.standard_normal(4 * d).astype(np.float32))
        p["r"] = jnp.asarray(rng.standard_normal(p["r"].shape).astype(np.float32) * 0.3)
    return p


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S", [13, 257])  # prime: the reference's chunks fall to one token
def test_xlstm_forward_then_decode_match_jax(kind, S):
    jcfg, cfg = cfgs("xlstm_1_3b")
    p = _xlstm_params(jcfg, kind)
    tp = to_torch(p)
    fwd, dec = ((XL.mlstm_forward, XL.mlstm_decode) if kind == "mlstm"
                else (XL.slstm_forward, XL.slstm_decode))
    jfwd, jdec = ((JX.mlstm_forward, JX.mlstm_decode) if kind == "mlstm"
                  else (JX.slstm_forward, JX.slstm_decode))
    rng = np.random.default_rng(13)
    B = 2
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    y, cache = fwd(tp, torch.from_numpy(x), cfg, return_cache=True)
    jy, jcache = jfwd(p, jnp.asarray(x), jcfg, return_cache=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **XLSTM_TOL)
    assert set(cache) == set(jcache)
    for name in cache:
        assert cache[name].dtype == torch.float32
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), **XLSTM_TOL)
    for _ in range(3):
        xt = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        y, new = dec(tp, torch.from_numpy(xt), cache, cfg)
        jy, jcache = jdec(p, jnp.asarray(xt), jcache, jcfg)
        assert new is cache  # the states are updated in place
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **XLSTM_TOL)
        for name in cache:
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                       **XLSTM_TOL)


def test_xlstm_head_norms_hand_the_kernel_contiguous_rows(monkeypatch):
    """On the card the RMSNorm kernels take contiguous rows only: the mLSTM's
    head norm reads h after a reshape over heads, the sLSTM's h[:, None],
    and the fused adds a mixer's output as the residual."""
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_add_reference, rmsnorm_reference
    from repro_torch.models import layers

    seen, fused = [], []

    def checked(x, scale, eps):
        assert x.is_contiguous()
        seen.append(tuple(x.shape))
        return rmsnorm_reference(x, scale, eps)

    def checked_add(x, r, scale, eps):
        assert x.is_contiguous() and r.is_contiguous()
        fused.append(tuple(x.shape))
        return rmsnorm_add_reference(x, r, scale, eps)

    monkeypatch.setattr(layers, "rmsnorm", checked)
    monkeypatch.setattr(layers, "rmsnorm_add", checked_add)
    _, cfg = cfgs("xlstm_1_3b")
    model = lm.LM(cfg, device="cpu")
    _, caches = model.prefill(torch.arange(9)[None].repeat(2, 1))
    model.decode_step(torch.zeros((2, 1), dtype=torch.long), 9, caches)
    d = cfg.d_model
    # prefill: layer 0's norm1, 16 head norms, the final norm (last position);
    # decode: layer 0's norm1 and 16 head norms (the final norm is fused)
    assert seen == [(2, 9, d)] * 17 + [(2, 1, d)] * 18
    # layers 1-15's norm1 in each call, and the final norm at decode
    assert fused == [(2, 9, d)] * 15 + [(2, 1, d)] * 16


# ---------------------------------------------------------------------------
# mamba mixer
# ---------------------------------------------------------------------------


def _mamba_params(jcfg):
    """The reference's mamba init, with its zero-init biases and unit D made
    random so every term of the layer counts."""
    p = dict(jax_init_params(JS.mamba_template(jcfg), KEY, jnp.float32))
    rng = np.random.default_rng(8)
    di = jcfg.mamba_d_inner
    p["conv_b"] = jnp.asarray(rng.standard_normal(di).astype(np.float32) * 0.1)
    p["dt_bias"] = jnp.asarray(rng.standard_normal(di).astype(np.float32) * 0.5)
    p["D"] = jnp.asarray(1.0 + rng.standard_normal(di).astype(np.float32) * 0.1)
    p["A_log"] = jnp.asarray(rng.standard_normal(p["A_log"].shape).astype(np.float32) * 0.5)
    return p


@pytest.mark.parametrize("B,S", [(2, 13), (1, 2)])  # S < d_conv - 1 pads the conv cache
def test_mamba_forward_then_decode_match_jax(B, S):
    jcfg, cfg = cfgs("jamba_v0_1_52b")
    p = _mamba_params(jcfg)
    tp = to_torch(p)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    y, cache = SSM.mamba_forward(tp, torch.from_numpy(x), cfg, return_cache=True)
    jy, jcache = JS.mamba_forward(p, jnp.asarray(x), jcfg, return_cache=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LAYER_TOL)
    assert cache["h"].dtype == torch.float32
    assert tuple(cache["conv"].shape) == (B, cfg.mamba_d_conv - 1, cfg.mamba_d_inner)
    for name in ("conv", "h"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), **LAYER_TOL)
    for _ in range(3):
        xt = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        y, cache = SSM.mamba_decode(tp, torch.from_numpy(xt), cache, cfg)
        jy, jcache = JS.mamba_decode(p, jnp.asarray(xt), jcache, jcfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LAYER_TOL)
        for name in ("conv", "h"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                       **LAYER_TOL)


def test_mixer_hands_the_scan_the_kernels_layout(monkeypatch):
    """On the card the scan kernel takes contiguous dt and u, B and C with unit
    stride on N, fp32 A and h0: the mixer must hand it those at prefill and at
    decode (where the conv's einsum comes back channel-major)."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_reference

    seen = []

    def checked(dt, Bc, Cc, u, A, h0=None):
        assert dt.is_contiguous() and u.is_contiguous() and A.is_contiguous()
        assert Bc.stride(-1) == 1 and Cc.stride(-1) == 1
        assert A.dtype == torch.float32 and (h0 is None or (
            h0.dtype == torch.float32 and h0.is_contiguous()))
        seen.append(u.shape[1])
        return ssm_scan_reference(dt, Bc, Cc, u, A, h0)

    monkeypatch.setattr(SSM, "ssm_scan", checked)
    _, cfg = cfgs("jamba_v0_1_52b")
    model = lm.LM(cfg, device="cpu")
    _, caches = model.prefill(torch.arange(9)[None].repeat(2, 1))
    full = model.init_caches(2, 16)
    for dst, src in zip(full, caches):
        for name in dst:
            dst[name][:, :, :src[name].shape[2]].copy_(src[name])
    model.decode_step(torch.zeros((2, 1), dtype=torch.long), 9, full)
    assert seen == [9] * 14 + [1] * 14


def test_mamba_softplus_is_not_cut_above_20():
    x = torch.tensor([-30.0, 0.0, 19.0, 20.5, 40.0])
    np.testing.assert_allclose(SSM._softplus(x).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))), rtol=1e-7)


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------


def _group_and_capacity(cfg, x):
    """The dispatch group's size and each expert's capacity, by the
    reference's own arithmetic."""
    n = x.shape[0] * x.shape[1]
    s = JM._largest_divisor(n, min(cfg.moe_group_size, n))
    return s, JM.capacity(cfg, s)


@pytest.mark.parametrize("arch,cf,S", [
    ("dbrx_132b", 0.5, 24),  # top-4 of 4, half capacity: drops
    ("jamba_v0_1_52b", 0.25, 20),  # top-2 of 4, groups of 20 tokens: drops
    ("arctic_480b", 8.0, 9),  # the reduced default: no drops
])
def test_moe_apply_matches_jax(arch, cf, S):
    jcfg, cfg = cfgs(arch, capacity_factor=cf)
    p = jax_init_params(JM.moe_template(jcfg), KEY, jnp.float32)
    x = np.random.default_rng(10).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    out = M.moe_apply(to_torch(p), torch.from_numpy(x), cfg)
    ref = JM.moe_apply(p, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER_TOL)
    # count the dropped pairs from the same routing: capacity in force or not
    s, C = _group_and_capacity(cfg, x)
    logits = torch.from_numpy(x).reshape(-1, s, cfg.d_model) @ to_torch(p)["router"]
    idx = torch.topk(torch.softmax(logits, -1), cfg.num_experts_per_tok, -1).indices
    counts = torch.nn.functional.one_hot(idx, cfg.num_experts).sum(dim=(1, 2))
    dropped = int(torch.clamp(counts - C, min=0).sum())
    assert (dropped > 0) == (cf < 1.0), (dropped, C)


def test_moe_capacity_and_groups_match_jax():
    for arch in ("dbrx_132b", "jamba_v0_1_52b", "arctic_480b"):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        for n in (1, 4, 241, 256, 320, 4096):
            assert M._largest_divisor(n, min(cfg.moe_group_size, n)) == \
                JM._largest_divisor(n, min(jcfg.moe_group_size, n))
            assert M.capacity(cfg, n) == JM.capacity(jcfg, n)


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


# each mixer's cache leaves
CACHE_LEAVES = {"attn": {"k", "v"}, "attn_local": {"k", "v"}, "mamba": {"conv", "h"},
                "mlstm": {"C", "n"}, "slstm": {"c", "n", "h", "m"}}


def _assert_caches_match(caches, jcaches, cfg, B, S):
    """Every leaf of every superblock position, in the reference's layout:
    global attention K/V (n_sb, B, S, K, hd), a local ring (n_sb, B, W, K,
    hd); mamba conv (n_sb, B, dc-1, di) and h (n_sb, B, di, n), mLSTM C (n_sb,
    B, H, hd, hd) and n, sLSTM c, n, h, m (n_sb, B, d), the states float32."""
    n_sb, K, hd = cfg.num_superblocks, cfg.num_kv_heads, cfg.resolved_head_dim
    H = cfg.num_heads
    for spec, ours, (t, ref) in zip(cfg.superblock, caches_to_numpy(caches),
                                    zip(caches, jcaches)):
        assert set(ours) == set(ref) == CACHE_LEAVES[spec.mixer]
        if spec.mixer == "attn":
            assert ours["k"].shape == (n_sb, B, S, K, hd)
        elif spec.mixer == "attn_local":
            assert ours["k"].shape == (n_sb, B, cfg.window_size, K, hd)
        elif spec.mixer == "mamba":
            assert ours["h"].shape == (n_sb, B, cfg.mamba_d_inner, cfg.mamba_d_state)
        elif spec.mixer == "mlstm":
            assert ours["C"].shape == (n_sb, B, H, cfg.d_model // H, cfg.d_model // H)
        else:
            assert ours["m"].shape == (n_sb, B, cfg.d_model)
        for name in ours:
            if spec.mixer not in ("attn", "attn_local") and name != "conv":
                assert t[name].dtype == torch.float32
                assert np.asarray(ref[name]).dtype == np.float32
            tol = XLSTM_TOL if spec.mixer in ("mlstm", "slstm") else MODEL_TOL
            np.testing.assert_allclose(ours[name], np.asarray(ref[name]), **tol)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "deepseek_7b", "jamba_v0_1_52b",
                                  "dbrx_132b", "arctic_480b", "gemma2_9b", "xlstm_1_3b"])
def test_prefill_and_decode_match_jax(arch):
    jcfg, cfg, jparams, model = _models(arch)
    assert cfg.num_superblocks == 2
    # gemma2's window is 8: the 12-token prompt is rolled into the ring, and
    # 6 decode steps write slots 4..7, then wrap to 0 and 1
    B, S, extra = 2, 12, 6 if arch == "gemma2_9b" else 3
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)

    logits, caches = model.prefill(torch.from_numpy(tokens))
    jlogits, jcaches = jlm.prefill(jparams, jcfg, jnp.asarray(tokens))
    assert logits.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
    _assert_caches_match(caches, jcaches, cfg, B, S)

    # grow the global attention caches as the engine would (a ring and the
    # recurrent states keep their shape), then decode a few tokens on both
    def pad(c, spec):
        if spec.mixer != "attn":
            return c
        return {k: jnp.pad(x, ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))) for k, x in c.items()}

    jcaches = tuple(pad(c, spec) for c, spec in zip(jcaches, cfg.superblock))
    caches = caches_from_jax(jax.tree.map(np.asarray, jcaches))
    tok = np.argmax(np.asarray(jlogits)[:, 0], axis=-1).astype(np.int32)[:, None]
    for step in range(extra):
        pos = S + step
        logits, caches = model.decode_step(torch.from_numpy(tok), pos, caches)
        jlogits, jcaches = jlm.decode_step(jparams, jcfg, jnp.asarray(tok), jnp.int32(pos),
                                           jcaches)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL_TOL)
        tok = np.argmax(np.asarray(jlogits)[:, 0], axis=-1).astype(np.int32)[:, None]
    _assert_caches_match(caches, jcaches, cfg, B, S + extra)


def test_full_width_starcoder2_3b_param_count_without_allocation():
    cfg = get_config("starcoder2_3b")
    assert lm.num_params(cfg) == 3_180_518_400 == jlm.num_params(jax_get_config("starcoder2_3b"))
    # the template's cache for 4 slots x 1024 positions, 30 layers, 2 kv heads
    (c,) = lm.cache_template(cfg, 4, 1024)
    assert c["k"].shape == (30, 4, 1024, 2, 128)


def test_full_width_jamba_param_count_and_cache_without_allocation():
    cfg, jcfg = get_config("jamba_v0_1_52b"), jax_get_config("jamba_v0_1_52b")
    assert lm.num_params(cfg) == 51_570_315_264 == jlm.num_params(jcfg)
    # the depth cut one card serves: 2 of 4 superblocks, 16 of 32 layers
    cut = dataclasses.replace(cfg, num_superblocks=2)
    assert lm.num_params(cut) == 26_053_595_136 == jlm.num_params(
        dataclasses.replace(jcfg, num_superblocks=2))
    tpl = lm.cache_template(cut, 4, 512)
    assert [sorted(c) for c in tpl] == [["conv", "h"]] * 4 + [["k", "v"]] + [["conv", "h"]] * 3
    assert tpl[0]["h"].shape == (2, 4, 8192, 16) and tpl[0]["h"].dtype == "float32"
    assert tpl[0]["conv"].shape == (2, 4, 3, 8192) and tpl[0]["conv"].dtype is None
    assert tpl[4]["k"].shape == (2, 4, 512, 8, 128)


def test_full_width_gemma2_param_count_and_caches_without_allocation():
    cfg = get_config("gemma2_9b")
    assert lm.num_params(cfg) == 9_241_404_928 == jlm.num_params(jax_get_config("gemma2_9b"))
    # the serve_local cell's caches: 4 slots of 4928 positions, 21 local + 21 global layers
    local, glob = lm.cache_template(cfg, 4, 4928)
    assert local["k"].shape == local["v"].shape == (21, 4, 4096, 8, 256)
    assert glob["k"].shape == glob["v"].shape == (21, 4, 4928, 8, 256)
    assert lm.cache_template(cfg, 4, 1000)[0]["k"].shape == (21, 4, 1000, 8, 256)


def test_full_width_xlstm_param_count_and_states_without_allocation():
    cfg = get_config("xlstm_1_3b")
    assert lm.num_params(cfg) == 1_239_304_528 == jlm.num_params(jax_get_config("xlstm_1_3b"))
    tpl = lm.cache_template(cfg, 4, 384)
    assert [sorted(c) for c in tpl] == [["c", "h", "m", "n"]] + [["C", "n"]] * 7
    assert tpl[0]["m"].shape == (6, 4, 2048) and tpl[0]["m"].dtype == "float32"
    assert tpl[1]["C"].shape == (6, 4, 4, 512, 512) and tpl[1]["C"].dtype == "float32"
    assert tpl[1]["n"].shape == (6, 4, 4, 512)
    # no norm2 in a block without an FFN: the reference's tree
    blocks = lm.model_template(cfg)["blocks"]
    assert sorted(blocks[0]) == ["norm1", "slstm"] and sorted(blocks[1]) == ["mlstm", "norm1"]


def test_init_caches_keep_each_leafs_dtype():
    _, cfg = cfgs("jamba_v0_1_52b", dtype="bfloat16")
    caches = lm.LM(cfg, device="cpu").init_caches(2, 16)
    assert caches[0]["h"].dtype == torch.float32
    assert caches[0]["conv"].dtype == caches[4]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["starcoder2_3b", "deepseek_7b", "starcoder2_15b",
                                  "internvl2_1b", "jamba_v0_1_52b", "dbrx_132b", "arctic_480b",
                                  "gemma2_9b", "xlstm_1_3b", "seamless_m4t_large_v2"])
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
