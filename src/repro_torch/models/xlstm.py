"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory) + sLSTM (scalar).

The port's counterpart of ``repro.models.xlstm``. The mLSTM runs in
chunkwise-parallel form: within a chunk the contribution matrix is an
attention-like product, across chunks an fp32 state (C, n) is carried.
Stability: log-sigmoid forget gate (decay factors <= 1), an input gate
capped at exp(8), and the normaliser max(|q.n|, 1). The sLSTM has true
hidden-to-gate recurrence and runs a per-token loop with the paper's
m-stabilised exponential gates.

The reference cuts a sequence into chunks of its largest divisor <= 256 (a
prime length falls to one-token chunks); the port takes 256-token chunks
and a ragged last one. The form is exact for any split: the same q . C_t
and max(|q . n_t|, 1) per position, summed in another order.

Neither cell has a TPU kernel in the reference; they stay plain torch. The
head norms go through ``layers.rms_norm`` (the RMSNorm kernel on the card).
Decode updates the cache's states in place and returns (y, cache).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

from .layers import rms_norm
from .params import TSpec
from .ssm import _softplus

__all__ = [
    "mlstm_template",
    "slstm_template",
    "mlstm_cache_template",
    "slstm_cache_template",
    "mlstm_forward",
    "mlstm_decode",
    "slstm_forward",
    "slstm_decode",
]

_ILOG_CAP = 8.0  # cap on the exponential input gate pre-activation
MLSTM_CHUNK = 256


def mlstm_template(cfg: ModelConfig) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    return {
        "wq": TSpec((d, d), ("embed", "qkv"), init="fan_in"),
        "wk": TSpec((d, d), ("embed", "qkv"), init="fan_in"),
        "wv": TSpec((d, d), ("embed", "qkv"), init="fan_in"),
        "w_if": TSpec((d, 2 * H), ("embed", None), init="normal", std=0.01),
        "b_if": TSpec((2 * H,), (None,), init="zeros"),
        "w_og": TSpec((d, d), ("embed", "qkv"), init="fan_in"),
        "headnorm": TSpec((d,), ("embed",), init="zeros"),
        "wo": TSpec((d, d), ("qkv", "embed"), init="fan_in"),
    }


def slstm_template(cfg: ModelConfig) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    return {
        "w_in": TSpec((d, 4 * d), ("embed", "qkv"), init="fan_in"),
        "r": TSpec((H, hd, 4 * hd), (None, None, None), init="normal", std=0.01),
        "b": TSpec((4 * d,), (None,), init="zeros"),
        "headnorm": TSpec((d,), ("embed",), init="zeros"),
        "wo": TSpec((d, d), ("qkv", "embed"), init="fan_in"),
    }


def mlstm_cache_template(cfg: ModelConfig, batch: int) -> dict:
    H = cfg.num_heads
    hd = cfg.d_model // H
    return {
        "C": TSpec((batch, H, hd, hd), ("cache_batch", None, "mlstm_dk", None), init="zeros",
                   dtype="float32"),
        "n": TSpec((batch, H, hd), ("cache_batch", None, "mlstm_dk"), init="zeros",
                   dtype="float32"),
    }


def slstm_cache_template(cfg: ModelConfig, batch: int) -> dict:
    d = cfg.d_model
    z = dict(init="zeros", dtype="float32")
    return {name: TSpec((batch, d), ("cache_batch", None), **z) for name in ("c", "n", "h", "m")}


# ---------------------------------------------------------------------------
# mLSTM: chunkwise parallel
# ---------------------------------------------------------------------------


def _mlstm_qkv_gates(p, x: torch.Tensor, cfg: ModelConfig):
    B, S, d = x.shape
    H = cfg.num_heads
    hd = d // H
    q = (x @ p["wq"]).view(B, S, H, hd)
    k = (x @ p["wk"]).view(B, S, H, hd) * (hd**-0.5)
    v = (x @ p["wv"]).view(B, S, H, hd)
    gates = x @ p["w_if"] + p["b_if"]  # (B, S, 2H)
    ilog = torch.clamp(gates[..., :H].float(), max=_ILOG_CAP)
    flog = -_softplus(-gates[..., H:].float())  # log sigmoid
    og = torch.sigmoid(x @ p["w_og"])  # (B, S, d)
    return q, k, v, ilog, flog, og


def _mlstm_finish(p, h: torch.Tensor, og: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The head norm over h (B, S, H, hd) as rows of d (contiguous, as the
    RMSNorm kernel takes them), gated by og, then the output projection."""
    B, S = h.shape[:2]
    hn = rms_norm(h.reshape(B, S, cfg.d_model).contiguous(), p["headnorm"], cfg.norm_eps)
    return (hn * og) @ p["wo"]


def _mlstm_chunk(C0, n0, q, k, v, ilog, flog):
    """One chunk from the fp32 state (C0 (B, H, hd, hd), n0 (B, H, hd)).
    q, k, v: (B, L, H, hd); ilog, flog: (B, L, H). Returns (C1, n1, h)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    b = torch.cumsum(flog, dim=1)  # (B, L, H), <= 0, decreasing
    L = q.shape[1]
    # intra-chunk weights w[t, tau] = exp(b_t - b_tau + ilog_tau), tau <= t
    decay = b[:, :, None, :] - b[:, None, :, :] + ilog[:, None, :, :]  # (B, t, tau, H)
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    w = torch.where(tri[None, :, :, None], torch.exp(decay), 0.0)
    ws = w * torch.einsum("bthd,bshd->btsh", qf, kf)
    num_intra = torch.einsum("btsh,bshd->bthd", ws, vf)
    den_intra = ws.sum(dim=2)  # (B, t, H)
    eb = torch.exp(b)
    num_inter = torch.einsum("bthd,bhde->bthe", qf, C0) * eb[..., None]
    den_inter = torch.einsum("bthd,bhd->bth", qf, n0) * eb
    den = torch.clamp((den_intra + den_inter).abs(), min=1.0)
    h = (num_intra + num_inter) / den[..., None]  # (B, L, H, hd)
    # the state at the chunk's end
    wL = torch.exp(b[:, -1:, :] - b + ilog)  # (B, L, H): decay from tau to the end
    fL = torch.exp(b[:, -1])  # (B, H)
    wk = wL[..., None] * kf
    C1 = fL[:, :, None, None] * C0 + torch.einsum("blhd,blhe->bhde", wk, vf)
    n1 = fL[..., None] * n0 + wk.sum(dim=1)
    return C1, n1, h


def mlstm_forward(p, x: torch.Tensor, cfg: ModelConfig, *, return_cache: bool = False):
    """x: (B, S, d) -> (B, S, d) [, cache {C (B, H, hd, hd), n (B, H, hd)} fp32]."""
    B, S, d = x.shape
    H = cfg.num_heads
    hd = d // H
    q, k, v, ilog, flog, og = _mlstm_qkv_gates(p, x, cfg)
    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    hs = []
    for s in range(0, S, MLSTM_CHUNK):
        c = slice(s, s + MLSTM_CHUNK)
        C, n, h = _mlstm_chunk(C, n, q[:, c], k[:, c], v[:, c], ilog[:, c], flog[:, c])
        hs.append(h)
    out = _mlstm_finish(p, torch.cat(hs, dim=1).to(x.dtype), og, cfg)
    if not return_cache:
        return out
    return out, {"C": C, "n": n}


def mlstm_decode(p, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """x: (B, 1, d). The linear-space single-step update, written into
    ``cache`` ({C, n}, fp32) in place; returns (y, cache)."""
    q, k, v, ilog, flog, og = _mlstm_qkv_gates(p, x, cfg)
    i = torch.exp(ilog[:, 0])  # (B, H)
    f = torch.exp(flog[:, 0])
    kf, vf = k[:, 0].float(), v[:, 0].float()
    C, n = cache["C"], cache["n"]
    C.mul_(f[..., None, None]).add_(i[..., None, None] * (kf[..., :, None] * vf[..., None, :]))
    n.mul_(f[..., None]).add_(i[..., None] * kf)
    qf = q[:, 0].float()
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.clamp(torch.einsum("bhd,bhd->bh", qf, n).abs(), min=1.0)
    h = (num / den[..., None]).to(x.dtype)[:, None]  # (B, 1, H, hd)
    return _mlstm_finish(p, h, og, cfg), cache


# ---------------------------------------------------------------------------
# sLSTM: sequential with m-stabilised exponential gating
# ---------------------------------------------------------------------------


def _slstm_step(p, cfg: ModelConfig, c, n, h, m, zifo_t):
    """c, n, h, m: (B, d) fp32; zifo_t: (B, 4d), the input projection.
    Returns the new (c, n, h, m)."""
    B = c.shape[0]
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    rec = torch.einsum("bhd,hdf->bhf", h.view(B, H, hd).to(p["r"].dtype), p["r"])
    g = (zifo_t + rec.reshape(B, 4 * d)).float()
    zt, it, ft, ot = g.chunk(4, dim=-1)
    z = torch.tanh(zt)
    m_new = torch.maximum(ft + m, it)
    i = torch.exp(it - m_new)
    f = torch.exp(ft + m - m_new)
    c = f * c + i * z
    n = f * n + i
    h_new = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
    return c, n, h_new, m_new


def slstm_forward(p, x: torch.Tensor, cfg: ModelConfig, *, return_cache: bool = False):
    """x: (B, S, d) -> (B, S, d) [, cache {c, n, h, m} each (B, d) fp32]."""
    B, S, d = x.shape
    zifo = x @ p["w_in"] + p["b"]  # (B, S, 4d)
    zeros = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    state = (zeros, zeros, zeros, torch.full((B, d), -1e30, dtype=torch.float32,
                                             device=x.device))
    hs = []
    for t in range(S):
        state = _slstm_step(p, cfg, *state, zifo[:, t])
        hs.append(state[2])
    hn = rms_norm(torch.stack(hs, dim=1).to(x.dtype), p["headnorm"], cfg.norm_eps)
    out = hn @ p["wo"]
    if not return_cache:
        return out
    return out, dict(zip(("c", "n", "h", "m"), state))


def slstm_decode(p, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """x: (B, 1, d). One step from ``cache`` ({c, n, h, m}), written back
    in place; returns (y, cache)."""
    zifo = (x @ p["w_in"] + p["b"])[:, 0]  # (B, 4d)
    names = ("c", "n", "h", "m")
    new = _slstm_step(p, cfg, *(cache[k] for k in names), zifo)
    for name, leaf in zip(names, new):
        cache[name].copy_(leaf)
    hn = rms_norm(new[2][:, None, :].to(x.dtype).contiguous(), p["headnorm"], cfg.norm_eps)
    return hn @ p["wo"], cache
