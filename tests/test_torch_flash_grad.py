"""The plain backwards of the port's flash-attention and RMSNorm kernels
(``flash_attention_backward_reference``, ``rmsnorm_backward_reference``: the
CPU's backward, and what the card's backward kernels are held against) and
the plain forward's log-sum-exp, against the JAX package on the CPU:

- the flash backward against ``jax.vjp`` of ``repro.models.attention.
  mha_reference`` at head dims 16, 64 and 256 over the case list of
  ``tests/test_torch_kernel_grads.py`` (GQA groups of 1, 2 and 7, a window
  narrower than a chunk, the soft-cap of 50 with q drawn past it, Sq < Skv,
  unmasked Sq > Skv);
- the LSE against ``jax.nn.logsumexp`` of the masked scores of the JAX
  kernel's oracle (``repro.kernels.flash_attention.ref``), read from the
  oracle's own softmax call;
- the RMSNorm backward, both entries, against ``jax.vjp`` of
  ``repro.models.layers.rms_norm`` (the fused entry as the reference's add
  followed by its norm);
- the dispatchers: CPU tensors take the plain backward and count no launch,
  a tensor on another device raises; ``_Flash``, ``_Norm`` and ``_NormAdd``
  route their backward through them (the forward's LSE handed on);
- the slice as a whole: reduced internvl2 and gemma2 with every attention
  and norm routed through those ``autograd.Function``s (the card's wiring,
  here over the plain forwards), loss and every gradient against
  ``jax.value_and_grad`` of the reference's loss, each backward called once
  per forward op;
- the flash backward's launch plan (every visible pair in exactly one tile
  pair of each kernel, no tile pair outside the mask band, the scratch
  sizes) and the RMSNorm backward's, and each wrapper's ctypes signature
  against its C entry's parameter list.

Tolerances (float32): a gradient, and the LSE, within 1e-5 of its largest
entry (an LSE row can sit near 0, so not relative per entry): both packages
compute the same function in float32, their products and sums associated
otherwise (the largest readings were ~1e-6, 3e-6 under the soft-cap with q
past it). The slice's loss and
gradients as in ``tests/test_torch_train_parity.py`` (1e-5 relative, rel-L2
1e-4: a model's worth of products in another order).
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernel_grads import CASES
from test_torch_train_parity import GRAD_REL_L2, LOSS_RTOL, batches, cfgs, port_model, \
    reference_params, rel_l2

from repro.kernels.flash_attention import ref as jax_oracle
from repro.models import lm as jlm
from repro.models.attention import mha_reference
from repro.models.layers import rms_norm
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_backward_reference,
    flash_attention_reference,
)
from repro_torch.kernels.rmsnorm import ops as rn
from repro_torch.kernels.rmsnorm.ref import (
    rmsnorm_add_reference,
    rmsnorm_backward_reference,
    rmsnorm_reference,
)
from repro_torch.models import attention as port_attention
from repro_torch.models import layers as port_layers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import loss_fn

TOL = 1e-5
CSRC = Path(fa.__file__).resolve().parents[2] / "csrc"


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * max(scale, 1e-30), (err, scale)


def attn_inputs(B, Sq, Skv, H, K, hd, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Sq, H, hd)) * q_scale).astype(np.float32)
    k, v = (rng.standard_normal((B, Skv, K, hd)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("hd", [16, 64, 256])
@pytest.mark.parametrize("B,Sq,Skv,H,K,causal,window,softcap,chunk", CASES)
def test_flash_backward_reference_is_jax_vjp_of_mha_reference(B, Sq, Skv, H, K, causal, window,
                                                              softcap, chunk, hd):
    q, k, v, do = attn_inputs(B, Sq, Skv, H, K, hd, seed=Sq * 37 + hd,
                              q_scale=40.0 if softcap else 1.0)
    out, vjp = jax.vjp(lambda a, b, c: mha_reference(a, b, c, causal=causal, window=window,
                                                     cap=softcap), q, k, v)
    want = vjp(jnp.asarray(do))
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o = torch.from_numpy(np.array(out))
    got = flash_attention_backward_reference(*t[:3], o, t[3], causal=causal, window=window,
                                             softcap=softcap, chunk=chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        close(g.numpy(), w)


@pytest.mark.parametrize("hd", [16, 64, 256])
@pytest.mark.parametrize("B,Sq,Skv,H,K,causal,window,softcap,chunk", CASES)
def test_reference_lse_is_logsumexp_of_the_jax_oracles_scores(monkeypatch, B, Sq, Skv, H, K,
                                                              causal, window, softcap, chunk, hd):
    """The oracle is head-major; its masked scores are what it hands to
    ``jax.nn.softmax`` (recorded there), (B, K, G, Sq, Skv)."""
    q, k, v, _ = attn_inputs(B, Sq, Skv, H, K, hd, seed=Sq * 41 + hd,
                             q_scale=40.0 if softcap else 1.0)
    seen = []
    softmax = jax.nn.softmax

    def spy(x, axis=-1):
        seen.append(np.asarray(x))
        return softmax(x, axis=axis)

    monkeypatch.setattr(jax_oracle.jax.nn, "softmax", spy)
    jax_oracle.flash_attention_reference(*(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)),
                                         causal=causal, window=window, softcap=softcap)
    assert len(seen) == 1
    want = np.asarray(jax.nn.logsumexp(jnp.asarray(seen[0]), axis=-1)).reshape(B, H, Sq)
    out, lse = flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                         window=window, softcap=softcap, return_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    close(lse.numpy(), want)
    assert torch.equal(out, flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=window, softcap=softcap))


NORM_SHAPES = [(5, 64), (2, 7, 896), (3, 1, 16), (2, 3, 4096)]


def norm_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    r, gy, gs = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    scale = (rng.standard_normal(shape[-1]) * 0.3).astype(np.float32)
    return x, r, scale, gy, gs


@pytest.mark.parametrize("shape", NORM_SHAPES)
def test_rmsnorm_backward_reference_is_jax_vjp_of_rms_norm(shape):
    x, _, scale, gy, _ = norm_inputs(shape, seed=shape[-1])
    _, vjp = jax.vjp(lambda a, s: rms_norm(a, s, 1e-6), x, scale)
    want = vjp(jnp.asarray(gy))
    got = rmsnorm_backward_reference(torch.from_numpy(x), torch.from_numpy(scale),
                                     torch.from_numpy(gy), 1e-6)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g.numpy(), w)


@pytest.mark.parametrize("shape", NORM_SHAPES)
def test_rmsnorm_add_backward_reference_is_jax_vjp_of_add_then_rms_norm(shape):
    """The fused entry's backward: the plain backward at s = x + r with gs
    added, which x and r both receive, against the reference's ``x = x + y;
    h = rms_norm(x)`` differentiated through both outputs."""
    x, r, scale, gy, gs = norm_inputs(shape, seed=shape[-1] + 1)

    def fused(a, b, s):
        t = a + b
        return t, rms_norm(t, s, 1e-6)

    _, vjp = jax.vjp(fused, x, r, scale)
    dx, dr, dscale = vjp((jnp.asarray(gs), jnp.asarray(gy)))
    got_dx, got_dscale = rmsnorm_backward_reference(
        torch.from_numpy(x + r), torch.from_numpy(scale), torch.from_numpy(gy), 1e-6,
        torch.from_numpy(gs))
    close(got_dx.numpy(), dx)
    close(got_dx.numpy(), dr)
    close(got_dscale.numpy(), dscale)


def test_dispatchers_take_the_plain_backward_on_the_cpu_and_refuse_other_devices():
    q, k, v, do = (torch.from_numpy(a) for a in attn_inputs(1, 9, 9, 4, 2, 16, seed=3))
    o, lse = flash_attention_reference(q, k, v, return_lse=True)
    kw = dict(causal=True, window=0, softcap=0.0, chunk=4)
    x, _, scale, gy, gs = (torch.from_numpy(a) for a in norm_inputs((3, 64), seed=5))
    before = (fa.flash_attention_backward.launches, rn.rmsnorm_backward.launches)
    for got, want in zip(fa.flash_attention_backward(q, k, v, o, do, **kw, lse=lse),
                         flash_attention_backward_reference(q, k, v, o, do, **kw)):
        assert torch.equal(got, want)  # lse is not read by the plain backward
    for got, want in zip(rn.rmsnorm_backward(x, scale, gy, 1e-6, gs),
                         rmsnorm_backward_reference(x, scale, gy, 1e-6, gs)):
        assert torch.equal(got, want)
    assert (fa.flash_attention_backward.launches, rn.rmsnorm_backward.launches) == before
    meta = [t.to("meta") for t in (q, k, v, o, do)]
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        fa.flash_attention_backward(*meta, **kw, lse=lse.to("meta"))
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        rn.rmsnorm_backward(x.to("meta"), scale.to("meta"), gy.to("meta"))
    assert (fa.flash_attention_backward.launches, rn.rmsnorm_backward.launches) == before


def test_the_functions_route_their_backward_through_the_dispatchers(monkeypatch):
    """``_Flash`` saves the forward's LSE and hands it to
    ``flash_attention_backward``; ``_Norm`` and ``_NormAdd`` call
    ``rmsnorm_backward`` (with gs for the fused entry): one call each."""
    calls = {"flash": [], "norm": []}
    flash_bwd, norm_bwd = fa.flash_attention_backward, rn.rmsnorm_backward

    def flash_spy(*a, **kw):
        calls["flash"].append(kw.get("lse"))
        return flash_bwd(*a, **kw)

    def norm_spy(x, scale, gy, eps=1e-6, gs=None):
        calls["norm"].append(gs)
        return norm_bwd(x, scale, gy, eps, gs)

    monkeypatch.setattr(fa, "flash_attention_backward", flash_spy)
    monkeypatch.setattr(rn, "rmsnorm_backward", norm_spy)
    q, k, v, do = (torch.from_numpy(a) for a in attn_inputs(2, 19, 19, 4, 2, 16, seed=7))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa._Flash.apply(*leaves, True, 5, 0.0, 8, flash_attention_reference)
    torch.autograd.grad(out, leaves, do)
    _, want_lse = flash_attention_reference(q, k, v, window=5, return_lse=True)
    assert len(calls["flash"]) == 1 and torch.equal(calls["flash"][0], want_lse)

    x, r, scale, gy, gs = (torch.from_numpy(a) for a in norm_inputs((4, 64), seed=9))
    xl, sl = x.clone().requires_grad_(), scale.clone().requires_grad_()
    torch.autograd.grad(rn._Norm.apply(xl, sl, 1e-6, rmsnorm_reference), (xl, sl), gy)
    leaves = [t.clone().requires_grad_() for t in (x, r, scale)]
    s, y = rn._NormAdd.apply(*leaves, 1e-6, rmsnorm_add_reference)
    torch.autograd.grad((s, y), leaves, (gs, gy))
    assert len(calls["norm"]) == 2 and calls["norm"][0] is None
    assert torch.equal(calls["norm"][1], gs)


@pytest.mark.parametrize("arch,batch,seq", [("internvl2_1b", 2, 48), ("gemma2_9b", 2, 24)])
def test_the_slice_through_the_functions_matches_jax(monkeypatch, arch, batch, seq):
    """Every attention and norm of a reduced model through the Functions the
    card runs (their forwards the plain versions, their backwards the
    dispatchers, here the plain backwards): loss and every gradient against
    ``jax.value_and_grad(lm.loss_fn)`` on the same weights and batch, and
    each backward called once per forward op (under remat the forwards run
    twice)."""
    calls = {"flash": 0, "norm": 0}
    flash_bwd, norm_bwd = fa.flash_attention_backward, rn.rmsnorm_backward

    def flash_counted(*a, **kw):
        calls["flash"] += 1
        return flash_bwd(*a, **kw)

    def norm_counted(*a, **kw):
        calls["norm"] += 1
        return norm_bwd(*a, **kw)

    def flash(q, k, v, *, causal=True, window=0, softcap=0.0, chunk=512):
        return fa._Flash.apply(q, k, v, causal, window, softcap, chunk, flash_attention_reference)

    monkeypatch.setattr(fa, "flash_attention_backward", flash_counted)
    monkeypatch.setattr(rn, "rmsnorm_backward", norm_counted)
    monkeypatch.setattr(port_attention, "flash_attention", flash)
    monkeypatch.setattr(port_layers, "rmsnorm",
                        lambda x, s, eps=1e-6: rn._Norm.apply(x, s, eps, rmsnorm_reference))
    monkeypatch.setattr(port_layers, "rmsnorm_add", lambda x, r, s, eps=1e-6: rn._NormAdd.apply(
        x, r, s, eps, rmsnorm_add_reference))
    jcfg, cfg = cfgs(arch)
    tree = reference_params(jcfg)
    model = port_model(cfg, tree)
    np_batch, tbatch = batches(jcfg, batch, seq)
    loss, _ = loss_fn(model, tbatch)
    loss.backward()
    L = cfg.num_layers
    assert calls == {"flash": L, "norm": 2 * L + 1}
    (jloss, _), jgrads = jax.value_and_grad(lambda p: jlm.loss_fn(p, jcfg, {
        k: jnp.asarray(v) for k, v in np_batch.items()}), has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    params = dict(model.named_parameters())
    bad = {n: rel_l2(params[n].grad.numpy(), w.numpy()) for n, w in want.items()}
    assert not {n: e for n, e in bad.items() if not e <= GRAD_REL_L2}, bad


# (Sq, Skv, causal, window): square and ragged, the queries the tail of the
# keys, windows narrower and wider than a tile (65 and 66 put a band's edge
# on a step's first row), unmasked Sq < Skv and Sq > Skv, a window without
# the causal mask, a single query
PLAN_MASKS = [(300, 300, True, 0), (200, 333, True, 0), (130, 700, True, 100),
              (500, 500, True, 64), (400, 400, True, 65), (400, 400, True, 66),
              (257, 640, True, 300), (300, 100, False, 0), (37, 300, False, 0),
              (260, 260, False, 0), (200, 300, False, 50), (1, 129, True, 0)]


def _visible(Sq, Skv, causal, window):
    pos = np.arange(Sq)[:, None] + (Skv - Sq)
    key = np.arange(Skv)[None, :]
    vis = np.ones((Sq, Skv), bool)
    if causal:
        vis &= key <= pos
    if window > 0:
        vis &= key > pos - window
    return vis


class TestBackwardPlans:
    """The flash backward's and the RMSNorm backward's launch plans, made on
    the host."""

    @pytest.mark.parametrize("hd", fa.HEAD_DIMS)
    @pytest.mark.parametrize("Sq,Skv,causal,window", PLAN_MASKS)
    def test_flash_backward_visits_every_visible_pair_once(self, Sq, Skv, causal, window, hd):
        """Both kernels' sweeps (``backward_visits``, which the kernels'
        ranges mirror): every visible (query, key) pair lies in exactly one
        dK/dV tile pair and exactly one dQ tile pair, and every tile pair
        visited holds a visible pair (no tile outside the band is loaded)."""
        plan = fa.backward_plan(2, Sq, Skv, 6, 3, hd)
        vis = _visible(Sq, Skv, causal, window)
        for visits, grid, (tile, step) in zip(
                fa.backward_visits(plan, Sq, Skv, causal, window),
                (plan.dkdv_grid, plan.dq_grid),
                ((plan.key_tile, plan.query_step), (plan.query_tile, plan.key_step))):
            seen = np.zeros((Sq, Skv), np.int32)
            for (t, _), keys, queries in visits:
                assert t < grid[1]
                block = vis[queries.start:queries.stop, keys.start:keys.stop]
                assert block.any(), (t, keys, queries)
                seen[queries.start:queries.stop, keys.start:keys.stop] += 1
            assert (seen[vis] == 1).all() and seen.max(initial=0) <= 1
            assert len({v[0] for v in visits}) == len(visits)
        assert plan.dkdv_grid == (6 * plan.splits, -(-Skv // plan.key_tile), 2)
        assert plan.dq_grid == (6 * plan.dq_splits, -(-Sq // plan.query_tile), 2)

    @pytest.mark.parametrize("hd", fa.HEAD_DIMS)
    @pytest.mark.parametrize("Sq,H,K", [(1, 4, 4), (300, 14, 2), (4096, 32, 8), (4097, 16, 8)])
    def test_flash_backward_scratch_and_tiles(self, Sq, H, K, hd):
        """The stats' padded rows hold every query step and query tile whole
        (the kernels read them without a bound check); a split covers hd in
        whole 64-column boxes; fp32 parts only where a kv head has several
        query heads; ``STATS_PAD`` is the C file's."""
        plan = fa.backward_plan(2, Sq, 333, H, K, hd)
        assert plan.stats_rows >= Sq and plan.stats_rows % fa.STATS_PAD == 0
        assert fa.STATS_PAD % plan.query_step == 0 and fa.STATS_PAD % plan.query_tile == 0
        assert plan.stats_shape == (2, H, plan.stats_rows, 2)
        assert plan.parts_shape == ((2, 333, H, hd) if H > K else None)
        assert hd % plan.splits == 0 and hd // plan.splits <= 64
        assert hd % plan.dq_splits == 0 and hd // plan.dq_splits <= 128
        assert re.search(rf"constexpr int STATS_PAD = {fa.STATS_PAD};",
                         (CSRC / "flash_attention.cu").read_text())

    @pytest.mark.parametrize("rows", [0, 1, 5, 64, 1000, 8192, 70_000])
    @pytest.mark.parametrize("d,elt", [(16, 4), (64, 2), (896, 2), (896, 4), (4096, 2)])
    def test_rmsnorm_backward_walks_every_row_once(self, rows, d, elt):
        """The forward's row layout on at most ``BWD_SLOTS`` row slots: CTA c
        takes row groups c, c + ctas, ... (csrc/rmsnorm.cu's grid-stride
        loop), so every row lands in exactly one slot."""
        fwd, plan = rn.norm_plan(rows, d, elt), rn.norm_backward_plan(rows, d, elt)
        assert plan[:3] == fwd[:3]
        assert plan.ctas * plan.rows_per_cta <= max(rn.BWD_SLOTS, plan.rows_per_cta)
        groups = -(-rows // plan.rows_per_cta)
        seen = [g * plan.rows_per_cta + sub for c in range(plan.ctas)
                for g in range(c, groups, plan.ctas) for sub in range(plan.rows_per_cta)]
        assert sorted(r for r in seen if r < rows) == list(range(rows))


_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


@pytest.mark.parametrize("source,entry,argtypes", [
    ("flash_attention.cu", "flash_attention_launch", fa._ARGTYPES),
    ("flash_attention.cu", "flash_attention_backward_launch", fa._BWD_ARGTYPES),
    ("rmsnorm.cu", "rmsnorm_launch", rn._NORM_ARGS),
    ("rmsnorm.cu", "rmsnorm_add_launch", rn._ADD_ARGS),
    ("rmsnorm.cu", "rmsnorm_backward_launch", rn._BWD_ARGS),
])
def test_the_wrappers_argtypes_follow_the_c_entries(source, entry, argtypes):
    """Each wrapper's ctypes signature is its C entry's parameter list, type
    by type: the C ABI is checked by nothing else off the card."""
    text = (CSRC / source).read_text()
    head = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert head, f"no C entry {entry} in {source}"
    kinds = [ctypes.c_void_p if "*" in p else _C_TYPES[" ".join(p.split()[:-1])]
             for p in head.group(1).split(",")]
    assert kinds == list(argtypes)
