"""The port's training path against the JAX package's, at reduced size on
the CPU: the same weights (the reference's init through
``repro_torch.models.convert.params_from_jax``, norm scales made random so
every (1 + scale) counts) and the same batch (the reference's
``data.pipeline.make_batch``, as numpy).

Held, per family (starcoder2; gemma2 with its soft-caps, local layers past
the window and tied embedding; jamba, its mamba scans through the plain
``ssm_scan``; dbrx; xLSTM; seamless with ``enc_embeds``; internvl2 with
``prefix_embeds``): ``LM.forward``'s logits against ``lm.forward``, and
``loss_fn``'s loss and every parameter's gradient against
``jax.value_and_grad(lm.loss_fn)``, the JAX gradients carried to the port's
parameter names by the same ``params_from_jax``. Then one
``make_train_step`` update with AdamW (internvl2) and one with Adafactor
(dbrx, two microbatches of ``grad_accum``): the new parameters, and AdamW's
master and moments or Adafactor's factors. And ``router_aux_loss``.

Tolerances (float32 throughout): logits 2e-4, as in
``tests/test_torch_models.py`` (two superblocks of matmuls, RoPE and
softmax in another summation order); the loss 1e-5 relative (a mean of
fp32 log-sum-exps over those logits); a gradient by its rel-L2 to the
reference's, 1e-4 (autograd through the plain versions on the CPU runs the
same products as XLA's backward in another order; the largest reading is
beside ``GRAD_REL_L2``). An optimizer's first step moves a parameter by
about lr * g / (|g| + eps) whatever the gradient's size, so where a gradient
entry sits near its leaf's fp32 noise that step differs far beyond the
gradient's 1e-4: each leaf's update (new - old parameter, AdamW's master
alike) is held by its rel-L2 to the reference's, ``UPDATE_REL_L2`` (a few
entries in ten thousand moved 0.5% apart); the moments and factors to 1e-4
and 2e-4 relative (v and the factors square the gradient).

A top-k router is discontinuous: a choice that flipped between the packages
would not be a gradient error. The MoE families are held on inputs where
every (token, slot) choice of the reference (recorded through
``jax.debug.callback`` on ``jax.lax.top_k``) equals the port's; the tests
count the choices compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import make_batch as jax_make_batch
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import lm as jlm
from repro.models import moe as JM
from repro.training import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm, moe
from repro_torch.models.convert import params_from_jax
from repro_torch.training import optimizer as opt

KEY = jax.random.PRNGKey(1)
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_RTOL = 1e-5
# the largest rel-L2 of a gradient against the reference's was 1.8e-5
# (xLSTM, whose mLSTM chunks its sums otherwise: XLSTM_TOL in
# tests/test_torch_models.py), the others 8e-7 to 5.4e-6 (an x86 CPU);
# 1e-4 leaves room for another machine's summation order
GRAD_REL_L2 = 1e-4
UPDATE_REL_L2 = 1e-3

FAMILIES = {
    "starcoder2_3b": dict(batch=2, seq=24),
    "gemma2_9b": dict(batch=2, seq=24),  # window 8: local layers mask and slide
    "jamba_v0_1_52b": dict(batch=2, seq=16, num_superblocks=1),  # 8 layers: every kind
    "dbrx_132b": dict(batch=4, seq=16),
    "xlstm_1_3b": dict(batch=2, seq=16),
    "seamless_m4t_large_v2": dict(batch=2, seq=16),
    "internvl2_1b": dict(batch=2, seq=48),  # a prefix of 48 / 16 = 3 positions
}
MOE = ("jamba_v0_1_52b", "dbrx_132b")
NORMS = ("norm1", "norm2", "norm_cross", "final_norm", "headnorm")


def cfgs(name, **kw):
    """The same reduced config in both packages (query chunks of 8)."""
    return (jax_get_config(name).reduced(seq_chunk=8, **kw),
            get_config(name).reduced(seq_chunk=8, **kw))


def reference_params(jcfg, seed=20):
    """The reference's init as numpy, its zero-initialised norm scales made
    random so every (1 + scale) counts."""
    tree = jax.tree.map(np.asarray, jlm.init_model(jcfg, KEY))
    rng = np.random.default_rng(seed)

    def randomise(path, leaf):
        if any(getattr(k, "key", None) in NORMS for k in path):
            return (rng.standard_normal(leaf.shape) * 0.3).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(randomise, tree)


def port_model(cfg, tree):
    model = lm.LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg), strict=True)
    return model.requires_grad_(True)


def batches(jcfg, batch, seq, step=0):
    """The reference's batch as numpy, and the same arrays as tensors."""
    np_batch = {k: np.asarray(v) for k, v in jax_make_batch(jcfg, batch, seq, step=step).items()}
    return np_batch, {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}


def rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / max(np.linalg.norm(want),
                                                                          1e-30))


@pytest.fixture
def routing(monkeypatch):
    """Record every top-k choice of both packages: the reference's through a
    debug callback on ``jax.lax.top_k``, the port's from ``moe.route``."""
    seen = {"ref": [], "port": []}
    top_k, route = jax.lax.top_k, moe.route

    def ref_top_k(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda i: seen["ref"].append(np.asarray(i)), idx, ordered=True)
        return vals, idx

    def port_route(p, xt, cfg):
        probs, idx = route(p, xt, cfg)
        seen["port"].append(idx.numpy().copy())
        return probs, idx

    monkeypatch.setattr(jax.lax, "top_k", ref_top_k)
    monkeypatch.setattr(moe, "route", port_route)
    return seen


def assert_same_choices(seen, n_layers):
    """Every recorded choice equal; returns how many were compared."""
    assert len(seen["ref"]) == len(seen["port"]) == n_layers
    for r, p in zip(seen["ref"], seen["port"]):
        np.testing.assert_array_equal(p, r)
    return sum(r.size for r in seen["ref"])


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_forward_loss_and_gradients_match_jax(arch, routing):
    spec = dict(FAMILIES[arch])
    jcfg, cfg = cfgs(arch, **{k: spec.pop(k) for k in ("num_superblocks",) if k in spec})
    tree = reference_params(jcfg)
    model = port_model(cfg, tree)
    np_batch, batch = batches(jcfg, spec["batch"], spec["seq"])
    extra = {k: batch[k] for k in ("prefix_embeds", "enc_embeds") if k in batch}
    jextra = {k: jnp.asarray(np_batch[k]) for k in extra}

    # forward logits over every position (a prefix's too)
    with torch.no_grad():
        logits = model(batch["tokens"], **extra)
    jlogits = jlm.forward(jax.tree.map(jnp.asarray, tree), jcfg,
                          jnp.asarray(np_batch["tokens"]), **jextra)
    n_moe = sum(s.ffn.startswith("moe") for s in cfg.superblock) * cfg.num_superblocks
    if arch in MOE:
        assert_same_choices(routing, n_moe)
        routing["ref"].clear(), routing["port"].clear()
    P = np_batch["prefix_embeds"].shape[1] if "prefix_embeds" in np_batch else 0
    assert logits.shape == (spec["batch"], P + np_batch["tokens"].shape[1], cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGITS_TOL)

    # loss and every gradient
    loss, metrics = lm.loss_fn(model, batch)
    loss.backward()
    vg = jax.jit(jax.value_and_grad(lambda p: jlm.loss_fn(p, jcfg, {
        k: jnp.asarray(v) for k, v in np_batch.items()}), has_aux=True))
    (jloss, jmetrics), jgrads = vg(jax.tree.map(jnp.asarray, tree))
    if arch in MOE:
        n_choices = assert_same_choices(routing, n_moe)
        assert n_choices == n_moe * spec["batch"] * spec["seq"] * cfg.num_experts_per_tok
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    for key in ("nll", "tokens"):
        np.testing.assert_allclose(float(metrics[key].detach()), float(jmetrics[key]),
                                   rtol=LOSS_RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    grads = dict(model.named_parameters())
    assert set(want) == set(grads)
    worst = {name: rel_l2(grads[name].grad.numpy(), want[name].numpy()) for name in want}
    bad = {k: v for k, v in worst.items() if not v <= GRAD_REL_L2}
    assert not bad, bad
    assert all(float(want[n].abs().max()) > 0 for n in want if not n.endswith("unembed")), \
        "a gradient the reference gives is zero: the comparison would hold nothing"


def _state_by_name(tree, cfg):
    """A reference optimizer-state tree shaped like the parameters (or with
    a dict per leaf, Adafactor's factors) by the port's names."""
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree), cfg).items()}


def _reference_leaf(tree, name, cfg):
    """The leaf of a reference tree shaped like its parameters (here
    Adafactor's factor dicts) that the port's parameter ``name`` reads:
    ``layers.{n}`` is superblock n // P at position n % P of a stack."""
    parts = name.split(".")
    if parts[0] != "layers":
        node = tree
        for key in parts:
            node = node[key]
        return node
    n, P = int(parts[1]), len(cfg.superblock)
    node = tree["blocks"][n % P]
    for key in parts[2:]:
        node = node[key]
    return {k: v[n // P] for k, v in node.items()}


@pytest.mark.parametrize("arch,optimizer", [("internvl2_1b", "adamw"),
                                            ("dbrx_132b", "adafactor")])
def test_one_train_step_matches_jax(arch, optimizer, routing):
    """One ``make_train_step`` update on both packages from the same state.
    dbrx: d 128 so that its expert matrices (128 x 128) take factored
    second moments, and two microbatches of ``grad_accum``; Adafactor's RMS
    statistics pooled over each stack as the reference's (ROADMAP C14)."""
    kw = dict(d_model=128, grad_accum=2) if arch == "dbrx_132b" else {}
    jcfg, cfg = cfgs(arch, **kw)
    assert cfg.optimizer == optimizer
    tree = reference_params(jcfg)
    model = port_model(cfg, tree)
    np_batch, batch = batches(jcfg, 4, 32, step=3)
    if optimizer == "adamw":
        ocfg = opt.AdamWConfig(lr=opt.cosine_schedule(1e-3, 2, 10))
        jocfg = jopt.AdamWConfig(lr=jopt.cosine_schedule(1e-3, 2, 10))
        state = opt.adamw_init(dict(model.named_parameters()))
        jstate = jopt.adamw_init(jax.tree.map(jnp.asarray, tree))
    else:
        ocfg, jocfg = opt.AdafactorConfig(lr=1e-3), jopt.AdafactorConfig(lr=1e-3)
        state = opt.adafactor_init(dict(model.named_parameters()))
        jstate = jopt.adafactor_init(jax.tree.map(jnp.asarray, tree))
        assert any("vr" in f for f in state["factors"].values())
    metrics = make_train_step(cfg, ocfg)(model, state, batch)
    jparams, jstate, jmetrics = jax_make_train_step(jcfg, jocfg)(
        jax.tree.map(jnp.asarray, tree), jstate, {k: jnp.asarray(v) for k, v in np_batch.items()})
    if arch == "dbrx_132b":  # two microbatches: two forwards through each MoE layer
        n = assert_same_choices(routing, 2 * 2)
        assert n == cfg.num_layers * 4 * 32 * cfg.num_experts_per_tok  # every layer is MoE
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["lr"]), float(jmetrics["lr"]), rtol=1e-7)
    if optimizer == "adamw":
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                                   rtol=GRAD_REL_L2)
    assert int(state["count"]) == int(jstate["count"]) == 1
    new = _state_by_name(jparams, cfg)
    old = {k: v.numpy() for k, v in params_from_jax(tree, cfg).items()}
    for name, p in model.named_parameters():
        assert rel_l2(p.detach().numpy() - old[name], new[name] - old[name]) <= UPDATE_REL_L2, \
            name
    if optimizer == "adamw":
        for key in ("master", "m", "v"):
            want = _state_by_name(jstate[key], cfg)
            for name, got in state[key].items():
                if key == "master":
                    assert rel_l2(got.numpy() - old[name], want[name] - old[name]) \
                        <= UPDATE_REL_L2, name
                else:
                    assert rel_l2(got.numpy(), want[name]) <= (GRAD_REL_L2 if key == "m"
                                                                else 2 * GRAD_REL_L2), name
    else:
        for name, fac in state["factors"].items():
            want = _reference_leaf(jstate["factors"], name, cfg)
            assert set(fac) == set(want), name
            for part, got in fac.items():
                assert rel_l2(got.numpy(), np.asarray(want[part])) <= 2 * GRAD_REL_L2, \
                    (name, part)


def test_router_aux_loss_matches_jax():
    jcfg, cfg = cfgs("dbrx_132b")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 20, cfg.d_model)).astype(np.float32)
    router = (rng.standard_normal((cfg.d_model, cfg.num_experts)) * 0.2).astype(np.float32)
    got = moe.router_aux_loss({"router": torch.from_numpy(router)}, torch.from_numpy(x), cfg)
    want = JM.router_aux_loss({"router": jnp.asarray(router)}, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
