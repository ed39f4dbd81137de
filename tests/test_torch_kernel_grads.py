"""The backward passes of the port's differentiable kernel wrappers, on the
CPU: ``flash_attention_backward`` and ``rmsnorm_backward`` (the backward of
both RMSNorm entries) against ``torch.autograd.grad`` through the plain
versions (``ref.py``), and the ``autograd.Function``s that wire them to a
forward (here the plain version, on the card the kernel). Then the
grad-refusal helper of the kernels with no backward.

Tolerances: the backwards compute in float32 from float32 inputs and
autograd differentiates the same function in float32 in another order:
1e-5 relative to each gradient's largest entry (the largest readings were
1.1e-6, and 2.9e-6 under the soft-cap of 50 with q drawn past the cap).
"""

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_reference
from repro_torch.kernels.rmsnorm import ops as rn
from repro_torch.kernels.rmsnorm.ref import rmsnorm_add_reference, rmsnorm_reference

TOL = 1e-5


def close(got, want, tol):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * max(scale, 1e-30), (err, scale)


def attn_inputs(B, Sq, Skv, H, K, hd, seed, q_scale=1.0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Sq, H, hd), generator=g) * q_scale
    k, v = (torch.randn((B, Skv, K, hd), generator=g) for _ in range(2))
    do = torch.randn((B, Sq, H, hd), generator=g)
    return q, k, v, do


# (B, Sq, Skv, H, K, causal, window, softcap, chunk): GQA groups of 1, 2 and
# 7, the chunk ragged against Sq, a window narrower than a chunk, Sq < Skv
# (the queries the tail of the keys) and Sq > Skv unmasked
CASES = [
    (2, 37, 37, 4, 2, True, 0, 0.0, 8),
    (1, 45, 45, 14, 2, True, 0, 0.0, 16),  # internvl2's 7 query heads per kv head
    (2, 40, 40, 4, 4, True, 6, 0.0, 16),  # window 6 < chunk
    (2, 33, 33, 4, 2, True, 8, 50.0, 8),  # gemma2's local layer: window and soft-cap
    (2, 29, 29, 4, 2, True, 0, 50.0, 7),
    (2, 13, 40, 4, 2, True, 0, 0.0, 5),  # Sq < Skv
    (2, 21, 9, 4, 1, False, 0, 0.0, 8),  # unmasked, more queries than keys (cross)
    (2, 7, 30, 4, 2, False, 0, 0.0, 4),  # unmasked, fewer queries than keys
    (1, 24, 24, 4, 2, False, 0, 0.0, 24),  # bidirectional (an encoder), one chunk
]


@pytest.mark.parametrize("hd", [16, 64, 256])
@pytest.mark.parametrize("B,Sq,Skv,H,K,causal,window,softcap,chunk", CASES)
def test_flash_attention_backward_is_autograd_through_ref(B, Sq, Skv, H, K, causal, window,
                                                         softcap, chunk, hd):
    q, k, v, do = attn_inputs(B, Sq, Skv, H, K, hd, seed=Sq * 31 + hd,
                              q_scale=40.0 if softcap else 1.0)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    out = flash_attention_reference(qr, kr, vr, causal=causal, window=window, softcap=softcap)
    want = torch.autograd.grad(out, (qr, kr, vr), do)
    got = fa.flash_attention_backward(q, k, v, out.detach(), do, causal=causal, window=window,
                                      softcap=softcap, chunk=chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        close(g, w, TOL)


def test_flash_function_wires_the_backward():
    """The autograd.Function over the plain forward: its output is the
    forward's, and autograd through it gives the backward's gradients."""
    q, k, v, do = attn_inputs(2, 19, 19, 4, 2, 16, seed=3)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa._Flash.apply(qr, kr, vr, True, 5, 0.0, 8, flash_attention_reference)
    assert out.requires_grad and out.grad_fn is not None
    got = torch.autograd.grad(out, (qr, kr, vr), do)
    want = fa.flash_attention_backward(q, k, v, out.detach(), do, causal=True, window=5,
                                       softcap=0.0, chunk=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flash_backward_bf16_inputs_come_back_in_bf16():
    q, k, v, do = (t.bfloat16() for t in attn_inputs(1, 9, 9, 4, 2, 16, seed=4))
    out = flash_attention_reference(q, k, v)
    grads = fa.flash_attention_backward(q, k, v, out, do, causal=True, window=0, softcap=0.0,
                                        chunk=4)
    assert all(g.dtype == torch.bfloat16 for g in grads)


@pytest.mark.parametrize("shape", [(5, 64), (2, 7, 896), (3, 1, 16)])
def test_rmsnorm_backward_is_autograd_through_ref(shape):
    g = torch.Generator().manual_seed(shape[-1])
    x = torch.randn(shape, generator=g) * 2
    scale = torch.randn(shape[-1], generator=g) * 0.3
    gy = torch.randn(shape, generator=g)
    xr, sr = x.clone().requires_grad_(), scale.clone().requires_grad_()
    want = torch.autograd.grad(rmsnorm_reference(xr, sr, 1e-6), (xr, sr), gy)
    got = rn.rmsnorm_backward(x, scale, gy, 1e-6)
    for a, b in zip(got, want):
        close(a, b, TOL)
    # through the Function over the plain forward
    xr, sr = x.clone().requires_grad_(), scale.clone().requires_grad_()
    y = rn._Norm.apply(xr, sr, 1e-6, rmsnorm_reference)
    assert torch.equal(y, rmsnorm_reference(x, scale, 1e-6))
    for a, b in zip(torch.autograd.grad(y, (xr, sr), gy), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_s", [True, False])
def test_rmsnorm_add_backward_is_autograd_through_ref(use_s):
    """Both outputs' gradients: s's (the residual stream) adds to the norm's,
    and x and r receive the same; with s unused only the norm's."""
    g = torch.Generator().manual_seed(7)
    x, r = torch.randn((4, 6, 64), generator=g), torch.randn((4, 6, 64), generator=g)
    scale = torch.randn(64, generator=g) * 0.3
    gs, gy = torch.randn((4, 6, 64), generator=g), torch.randn((4, 6, 64), generator=g)
    leaves = [t.clone().requires_grad_() for t in (x, r, scale)]
    s, y = rmsnorm_add_reference(*leaves, 1e-6)
    outs, grads = ((s, y), (gs, gy)) if use_s else ((y,), (gy,))
    want = torch.autograd.grad(outs, leaves, grads)
    leaves2 = [t.clone().requires_grad_() for t in (x, r, scale)]
    s2, y2 = rn._NormAdd.apply(*leaves2, 1e-6, rmsnorm_add_reference)
    outs2 = (s2, y2) if use_s else (y2,)
    got = torch.autograd.grad(outs2, leaves2, grads)
    for a, b in zip(got, want):
        close(a, b, TOL)


def test_refuse_grad_raises_only_under_grad_with_a_grad_input():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP B-perf kernel item 5"):
        _build.refuse_grad("ssm_scan", "ROADMAP B-perf kernel item 5", torch.zeros(3), x, None)
    _build.refuse_grad("ssm_scan", "item", torch.zeros(3), None)  # nothing requires grad
    with torch.no_grad():
        _build.refuse_grad("ssm_scan", "item", x)  # grad mode off
    with torch.inference_mode():
        _build.refuse_grad("decode_attention", "item", torch.zeros(3))
