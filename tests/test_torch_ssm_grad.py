"""The selective scan's backward on the CPU: the plain reverse loop
(``ssm_scan_backward_reference``, what the card's backward kernel is held
to) against ``torch.autograd.grad`` through the plain scan and against
``jax.vjp`` of the JAX package's ``ssm_scan_reference``, on the same numpy
inputs; the plain chunk states against the scan's own states; the
``autograd.Function`` that wires the backward to a forward (here the plain
one, on the card the kernel); the backward wrapper's refusals; the backward
kernel's plan (``bwd_plan``: every channel in one CTA, the layout the C
entry mirrors) and both C entries' ctypes signatures; and, for the slice as
a whole, reduced jamba's loss and
every gradient with its scans routed through that Function under remat,
against the reference's ``jax.value_and_grad``.

Tolerances: the gradients are sums over T, D or N in fp32 on both sides, in
another order (autograd and XLA reduce as they like): 1e-5 relative to each
gradient's largest entry, as ``tests/test_torch_kernel_grads.py``. The
model's loss and gradients as ``tests/test_torch_train_parity.py``: the loss
1e-5 relative, each gradient's rel-L2 1e-4.
"""

import ctypes
import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import make_batch as jax_make_batch
from repro.kernels.ssm_scan.ref import ssm_scan_reference as jax_ssm_scan_reference
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import (
    ssm_scan_backward_reference,
    ssm_scan_chunk_states,
    ssm_scan_reference,
)
from repro_torch.models import lm, moe
from repro_torch.models import ssm as SSM
from repro_torch.models.convert import params_from_jax

TOL = 1e-5
NAMES = ("ddt", "dBc", "dCc", "du", "dA", "dh0")
# B x N x T, each with and without h0 and dh_final: T of one step, below a
# chunk, past eight chunks with a ragged last one, and past sixteen
CASES = [(B, N, T, h0, dh)
         for B, N, T in itertools.product((1, 2), (1, 4, 16), (1, 5, 130, 257))
         for h0, dh in ((False, False), (True, True))]
CASES += [(2, 4, 37, True, False), (2, 4, 37, False, True)]


def inputs(B, T, D, N, seed, h0=False, dh=False):
    """dt > 0, u, B, C ~ N(0, 1), A < 0 as the mixer makes them, and the
    output gradients dy (and dh_final), as numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = dict(dt=(np.log1p(np.exp(rng.standard_normal((B, T, D)))) * 0.1).astype(f32),
               Bc=rng.standard_normal((B, T, N)).astype(f32),
               Cc=rng.standard_normal((B, T, N)).astype(f32),
               u=rng.standard_normal((B, T, D)).astype(f32),
               A=(-np.exp(rng.standard_normal((D, N)) * 0.5)).astype(f32),
               h0=rng.standard_normal((B, D, N)).astype(f32) if h0 else None,
               dy=rng.standard_normal((B, T, D)).astype(f32),
               dh=rng.standard_normal((B, D, N)).astype(f32) if dh else None)
    return out


def torch_of(x):
    return None if x is None else torch.from_numpy(x)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(scale, 1e-30), (err, scale)


def plain_forward(dt, Bc, Cc, u, A, h0):
    """The plain scan with its chunk states: what ``_Scan`` takes on the CPU."""
    return (*ssm_scan_reference(dt, Bc, Cc, u, A, h0),
            ssm_scan_chunk_states(dt, Bc, u, A, h0, ops.CHUNK))


def plain_grads(x):
    args = [torch_of(x[k]) for k in ("dt", "Bc", "Cc", "u", "A", "h0")]
    return ssm_scan_backward_reference(*args, torch_of(x["dy"]), torch_of(x["dh"]))


@pytest.mark.parametrize("B,N,T,h0,dh", CASES)
def test_plain_backward_is_autograd_through_the_scan(B, N, T, h0, dh):
    x = inputs(B, T, 6, N, seed=T * 7 + N + B, h0=h0, dh=dh)
    leaves = [torch_of(x[k]).clone().requires_grad_() for k in ("dt", "Bc", "Cc", "u", "A")]
    h0t = torch_of(x["h0"]).clone().requires_grad_() if h0 else None
    y, h = ssm_scan_reference(*leaves, h0t)
    target = (y * torch_of(x["dy"])).sum()
    if dh:
        target = target + (h * torch_of(x["dh"])).sum()
    want = torch.autograd.grad(target, leaves + ([h0t] if h0 else []), allow_unused=True)
    got = plain_grads(x)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        close(g, torch.zeros_like(g) if w is None else w)
    if not h0:  # dh0 = a_1 dh_1 whether or not the caller passed h0
        h0z = torch.zeros((B, 6, N), requires_grad=True)
        y, h = ssm_scan_reference(*leaves, h0z)
        target = (y * torch_of(x["dy"])).sum() + ((h * torch_of(x["dh"])).sum() if dh else 0)
        close(got[5], torch.autograd.grad(target, h0z)[0])


@pytest.mark.parametrize("B,N,T,h0,dh", CASES)
def test_plain_backward_matches_jax_vjp(B, N, T, h0, dh):
    x = inputs(B, T, 6, N, seed=T * 11 + N + B, h0=h0, dh=dh)
    names = ("dt", "Bc", "Cc", "u", "A") + (("h0",) if h0 else ())
    primals = [jnp.asarray(x[k]) for k in names]

    def scan(*a):
        return jax_ssm_scan_reference(*a[:5], a[5] if h0 else None)

    _, vjp = jax.vjp(scan, *primals)
    dh_ct = jnp.asarray(x["dh"]) if dh else jnp.zeros((B, 6, N), jnp.float32)
    want = vjp((jnp.asarray(x["dy"]), dh_ct))
    got = plain_grads(x)
    for name, g, w in zip(NAMES, got, want):
        close(g.numpy(), np.asarray(w))


def test_bfloat16_gradients_round_once_to_their_inputs_dtype():
    x = inputs(2, 40, 8, 16, seed=4, h0=True, dh=True)
    bf = {k: torch_of(x[k]).bfloat16() for k in ("dt", "Bc", "Cc", "u", "dy")}
    got = ssm_scan_backward_reference(bf["dt"], bf["Bc"], bf["Cc"], bf["u"], torch_of(x["A"]),
                                      torch_of(x["h0"]), bf["dy"], torch_of(x["dh"]))
    want = ssm_scan_backward_reference(*(bf[k].float() for k in ("dt", "Bc", "Cc", "u")),
                                       torch_of(x["A"]), torch_of(x["h0"]), bf["dy"].float(),
                                       torch_of(x["dh"]))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == (torch.float32 if name in ("dA", "dh0") else torch.bfloat16), name
        assert torch.equal(g, w.to(g.dtype)), name


@pytest.mark.parametrize("T,chunk", [(1, 16), (16, 16), (17, 16), (130, 16), (37, 5)])
def test_chunk_states_are_the_scans_states(T, chunk):
    x = inputs(2, T, 6, 4, seed=T + chunk, h0=True)
    dt, Bc, Cc, u, A, h0 = (torch_of(x[k]) for k in ("dt", "Bc", "Cc", "u", "A", "h0"))
    states = ssm_scan_chunk_states(dt, Bc, u, A, h0, chunk)
    assert states.shape == (2, -(-T // chunk), 6, 4) and states.dtype == torch.float32
    assert torch.equal(states[:, 0], h0)
    for k in range(1, states.shape[1]):  # the scan's h_final after k chunks
        _, h = ssm_scan_reference(dt[:, :k * chunk], Bc[:, :k * chunk], Cc[:, :k * chunk],
                                  u[:, :k * chunk], A, h0)
        assert torch.equal(states[:, k], h), k


# which of (dt, Bc, Cc, u, A, h0) require grad
GRAD_SETS = [(True,) * 6, (False, True, False, True, True, False),
             (True, False, False, False, False, True), (False, False, True, False, False, False)]


@pytest.mark.parametrize("needs", GRAD_SETS)
@pytest.mark.parametrize("use_h", [False, True])
def test_scan_function_wires_the_backward(needs, use_h):
    """``_Scan`` over the plain forward: its outputs are the forward's; autograd
    through it gives the plain backward's gradients for the inputs that
    require grad and None for the rest; h_final's gradient reaches it."""
    x = inputs(2, 37, 6, 4, seed=9, h0=True, dh=True)
    base = [torch_of(x[k]) for k in ("dt", "Bc", "Cc", "u", "A", "h0")]
    ins = [t.clone().requires_grad_(n) for t, n in zip(base, needs)]
    y, h = ops._Scan.apply(*ins, plain_forward)
    ry, rh = ssm_scan_reference(*base)
    assert torch.equal(y, ry) and torch.equal(h, rh)
    target = (y * torch_of(x["dy"])).sum() + ((h * torch_of(x["dh"])).sum() if use_h else 0)
    target.backward()
    refs = [t.clone().requires_grad_(n) for t, n in zip(base, needs)]
    ry, rh = ssm_scan_reference(*refs)
    rt = (ry * torch_of(x["dy"])).sum() + ((rh * torch_of(x["dh"])).sum() if use_h else 0)
    rt.backward()
    for t, r, n in zip(ins, refs, needs):
        assert (t.grad is None) == (not n)
        if n:
            close(t.grad, r.grad)


def test_scan_function_takes_none_for_h0_and_an_unused_y():
    x = inputs(1, 20, 6, 4, seed=2, dh=True)
    base = [torch_of(x[k]) for k in ("dt", "Bc", "Cc", "u", "A")]
    ins = [t.clone().requires_grad_() for t in base]
    _, h = ops._Scan.apply(*ins, None, plain_forward)
    (h * torch_of(x["dh"])).sum().backward()
    want = ssm_scan_backward_reference(*base, None, torch.zeros_like(base[3]), torch_of(x["dh"]))
    for t, w in zip(ins, want):
        close(t.grad, w)


def test_backward_wrapper_counts_no_cpu_launch():
    x = inputs(2, 9, 6, 4, seed=1)
    args = [torch_of(x[k]) for k in ("dt", "Bc", "Cc", "u", "A", "h0")]
    before = ops.ssm_scan_backward.launches
    got = ops.ssm_scan_backward(*args, torch_of(x["dy"]), None,
                                ssm_scan_chunk_states(*args[:2], *args[3:], ops.CHUNK))
    assert ops.ssm_scan_backward.launches == before
    for g, w in zip(got, plain_grads(x)):
        assert torch.equal(g, w)


def _wrong(name):
    x = inputs(2, 20, 6, 4, seed=3, h0=True, dh=True)
    t = {k: torch_of(x[k]) for k in x}
    states = ssm_scan_chunk_states(t["dt"], t["Bc"], t["u"], t["A"], t["h0"], ops.CHUNK)
    args = dict(dy=t["dy"], dh_final=t["dh"], states=states)
    args[name[0]] = name[1](args[name[0]])
    return [t[k] for k in ("dt", "Bc", "Cc", "u", "A", "h0")], args


@pytest.mark.parametrize("what", [
    ("dy", lambda v: v.bfloat16()),  # y's gradient in another dtype than u
    ("dy", lambda v: v[:, :-1]),  # a step short
    ("dh_final", lambda v: v[..., :2]),  # fewer states
    ("dh_final", lambda v: v.double()),
    ("states", lambda v: v[:, :1]),  # a chunk short
    ("states", lambda v: v.bfloat16()),
])
def test_backward_wrapper_refuses_wrong_inputs(what):
    args, kw = _wrong(what)
    with pytest.raises(ValueError):
        ops.ssm_scan_backward(*args, **kw)


def test_backward_wrapper_refuses_other_devices():
    x = torch.empty(1, 4, 8, device="meta")
    bc = torch.empty(1, 4, 2, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        ops.ssm_scan_backward(x, bc, bc, x, torch.empty(8, 2, device="meta"), None, x)


# ---------------------------------------------------------------------------
# the backward kernel's plan (csrc/ssm_scan.cu mirrors it and refuses a plan
# whose layout differs from its own)

CSRC = Path(ops.__file__).resolve().parents[2] / "csrc"
PLAN_SHAPES = [(1, 8192), (2, 200), (3, 203), (2, 96), (1, 64), (3, 32), (2, 1), (1, 257)]


def _csrc_int(name: str) -> str:
    found = re.search(rf"constexpr int {name} = (\w+);", (CSRC / "ssm_scan.cu").read_text())
    assert found, name
    return found.group(1)


class TestBwdPlan:
    @pytest.mark.parametrize("b,d", PLAN_SHAPES)
    def test_every_channel_in_one_cta(self, b, d):
        """CTA (x, row) takes channels [x ch, (x + 1) ch) of its batch row and
        writes partial x: every (b, d) lands in exactly one CTA, and no CTA
        lies wholly past D."""
        plan = ops.bwd_plan(b, d, 16, 2)
        assert plan.ctas == b * plan.partials
        seen = []
        for row in range(b):
            for x in range(plan.partials):
                chans = range(x * ops.BWD_CHANNELS, min((x + 1) * ops.BWD_CHANNELS, d))
                assert chans, (row, x)
                seen += [(row, c) for c in chans]
        assert sorted(seen) == [(row, c) for row in range(b) for c in range(d)]

    @pytest.mark.parametrize("b,d", PLAN_SHAPES)
    @pytest.mark.parametrize("n,elt", [(1, 4), (4, 4), (7, 2), (16, 2), (16, 4)])
    def test_partials_and_shared_memory_follow_the_layout(self, b, d, n, elt):
        """The partials and shared memory by the layout the C entry recomputes
        (``bwd_layout``, the ``n_part`` check): two of the fp32 tile, (ddt,
        du) and the warps' dB / dC sums, and three raw stages."""
        plan = ops.bwd_plan(b, d, n, elt)
        r16 = lambda v: -(-v // 16) * 16  # noqa: E731
        S, CH, G = ops.CHUNK, ops.BWD_CHANNELS, ops.BWD_GROUP
        want = (2 * (S * CH * 16 + S * 16 * 8 + S * CH * 8 + G * S * 32 * 4)
                + 3 * (3 * r16(S * CH * elt) + 2 * r16(S * n * elt)))
        assert plan.smem == want == ops.bwd_smem_bytes(n, elt)
        assert 2 * plan.smem <= ops.SMEM_LIMIT  # two CTAs an SM
        assert plan.partials == -(-d // CH)

    def test_the_c_entry_mirrors_the_constants(self):
        assert int(_csrc_int("CHUNK")) == ops.CHUNK
        assert int(_csrc_int("BWD_CH")) == ops.BWD_CHANNELS
        assert int(_csrc_int("BWD_G")) == ops.BWD_GROUP
        assert _csrc_int("BWD_STEPS") == "CHUNK"

    def test_chunk_is_a_whole_number_of_the_register_steps(self):
        """A lane keeps one chunk in registers and reduce-scatters ddt and du
        ``BWD_GROUP`` steps at a time."""
        assert ops.CHUNK % ops.BWD_GROUP == 0 and ops.N_MAX % ops.BWD_GROUP == 0

    def test_the_planted_faults_follow_the_c_entry(self):
        found = re.search(r"enum \{ (FAULT_NONE = 0, [^}]*) \};",
                          (CSRC / "ssm_scan.cu").read_text())
        assert found
        codes = [int(item.split("=")[1]) for item in found.group(1).split(",")]
        assert sorted(ops.BWD_FAULTS.values()) == codes and ops.BWD_FAULTS["none"] == 0

    @pytest.mark.parametrize("args", [(0, 64, 16, 2), (1, 0, 16, 2), (1, 64, 0, 2),
                                      (1, 64, 17, 2), (1, 64, 16, 8), (70_000, 64, 16, 2)])
    def test_sizes_the_kernel_does_not_take_raise(self, args):
        with pytest.raises(ValueError):
            ops.bwd_plan(*args)


_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong}


@pytest.mark.parametrize("entry,argtypes", [("ssm_scan_launch", ops._ARGTYPES),
                                            ("ssm_scan_backward_launch", ops._BWD_ARGTYPES)])
def test_the_wrappers_argtypes_follow_the_c_entries(entry, argtypes):
    """Each wrapper's ctypes signature is its C entry's parameter list, type
    by type: the C ABI is checked by nothing else off the card."""
    head = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)",
                     (CSRC / "ssm_scan.cu").read_text())
    assert head, entry
    kinds = [ctypes.c_void_p if "*" in p else _C_TYPES[" ".join(p.split()[:-1])]
             for p in head.group(1).split(",")]
    assert kinds == list(argtypes)


# ---------------------------------------------------------------------------
# the slice as a whole: reduced jamba trains through the Function


KEY = jax.random.PRNGKey(1)
NORMS = ("norm1", "norm2", "norm_cross", "final_norm", "headnorm")


def test_jamba_gradients_through_the_scan_function_match_jax(monkeypatch):
    """Reduced jamba (one superblock: 7 mamba layers, MoE, attention) under
    remat "full", every scan through ``_Scan`` with the plain forward and
    the plain backward, 40 positions (three chunks, the last ragged): the
    loss and every parameter's gradient against the reference's
    ``jax.value_and_grad``; each layer's forward twice (remat) and its
    backward once. The routers' choices are held equal first (a top-k
    choice that flipped would not be a gradient error)."""
    kw = dict(seq_chunk=8, num_superblocks=1, remat="full")
    jcfg = jax_get_config("jamba_v0_1_52b").reduced(**kw)
    cfg = get_config("jamba_v0_1_52b").reduced(**kw)
    tree = jax.tree.map(np.asarray, jlm.init_model(jcfg, KEY))
    rng = np.random.default_rng(20)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (rng.standard_normal(leaf.shape) * 0.3).astype(leaf.dtype)
        if any(getattr(k, "key", None) in NORMS for k in path) else leaf, tree)
    model = lm.LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg), strict=True)
    model.requires_grad_(True)
    np_batch = {k: np.asarray(v) for k, v in jax_make_batch(jcfg, 2, 40, step=0).items()}
    batch = {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}

    calls = {"forward": 0, "backward": 0}
    backward = ops.ssm_scan_backward

    def counted_forward(*a):
        calls["forward"] += 1
        return plain_forward(*a)

    def counted_backward(*a, **k):
        calls["backward"] += 1
        return backward(*a, **k)

    seen = {"ref": [], "port": []}
    top_k, route = jax.lax.top_k, moe.route

    def ref_top_k(v, k):
        vals, idx = top_k(v, k)
        jax.debug.callback(lambda i: seen["ref"].append(np.asarray(i)), idx, ordered=True)
        return vals, idx

    def port_route(p, xt, c):
        probs, idx = route(p, xt, c)
        seen["port"].append(idx.numpy().copy())
        return probs, idx

    monkeypatch.setattr(jax.lax, "top_k", ref_top_k)
    monkeypatch.setattr(moe, "route", port_route)
    monkeypatch.setattr(SSM, "ssm_scan",
                        lambda *a: ops._Scan.apply(*a, counted_forward))
    monkeypatch.setattr(ops, "ssm_scan_backward", counted_backward)
    loss, _ = lm.loss_fn(model, batch)
    loss.backward()
    n_mamba = sum(s.mixer == "mamba" for s in cfg.superblock)
    assert calls == {"forward": 2 * n_mamba, "backward": n_mamba}

    vg = jax.jit(jax.value_and_grad(lambda p: jlm.loss_fn(p, jcfg, {
        k: jnp.asarray(v) for k, v in np_batch.items()}), has_aux=True))
    (jloss, _), jgrads = vg(jax.tree.map(jnp.asarray, tree))
    n_moe = sum(s.ffn.startswith("moe") for s in cfg.superblock)
    # each MoE layer routes twice (its forward again under remat); the
    # forward's choices, in layer order, first
    assert len(seen["port"]) == 2 * n_moe and len(seen["ref"]) >= n_moe
    for p, r in zip(seen["port"][:n_moe], seen["ref"][:n_moe]):
        np.testing.assert_array_equal(p, r)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    grads = dict(model.named_parameters())
    bad = {}
    for name, w in want.items():
        g = grads[name].grad.double().numpy()
        w = w.double().numpy()
        rel = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        if not rel <= 1e-4:
            bad[name] = rel
    assert not bad, bad
    assert all(float(grads[n].grad.abs().max()) > 0 for n in grads if ".mamba." in n), \
        "a mamba gradient is zero: the comparison would hold nothing"
