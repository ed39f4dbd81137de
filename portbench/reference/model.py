"""The reference forward pass: plain PyTorch in fp32, TF32 off.

It follows the architecture that a configuration file's ``model`` block
declares, departures from the published model included (the file lists
them), layer by layer over every sampled request, so that only one layer's
weights are held at a time:

* embedding lookup; per layer RMSNorm ((1 + scale), fp32), the mixer, the
  residual add, RMSNorm, the FFN, the residual add; the final RMSNorm and
  the logits (``h @ unembed``);
* attention: GQA (query head h reads kv head h // (H / K)), RoPE
  rotate-half where the model has it, causal softmax over every earlier
  position, unchunked;
* mamba (S6): input projection into (u, z), causal depthwise conv with bias,
  SiLU, x projection into (dt, B, C), dt = softplus(dt @ dt_proj + bias),
  the recurrence h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t with A = -exp(A_log)
  stepped in time (several requests at once), y = C . h + D u, then
  (y * SiLU(z)) @ out_proj;
* MLP: gelu (tanh) or a SiLU-gated GLU;
* MoE: fp32 router softmax, top-k, the k gates renormalised, GShard capacity
  per dispatch group: the tokens of one forward call form groups of the
  largest divisor of their count up to ``moe_group_size``; in a group each
  expert keeps ceil(k s cf / E) (rounded up to 4, at least 4) (token, slot)
  pairs in token-major order and drops the rest. A served request's prompt is
  one call (its prefill), each later token one call of its own (a decode
  step).

``control=True`` computes the same pass with every linear layer's inputs
rounded to fp8 (e4m3): weights per tensor (per expert), activations per row,
each scaled to the format's largest value; attention, the scan and the norms
stay fp32. It is the lower precision a later change could be tempted by, and
the comparison that decides ``correct`` has to fail it.
"""

from __future__ import annotations

import math

import torch

from .weights import DTYPES, draw, leaf_specs

__all__ = ["Served", "reference_logits", "fp32_mode"]

FP8_MAX = 448.0  # float8 e4m3's largest finite value


def fp32_mode() -> None:
    """Plain fp32 matrix products: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Served:
    """One served request: ``tokens`` = its prompt and every served token but
    the last, ``prompt_len`` = L; logits are wanted at positions L - 1 ..
    len(tokens) - 1 (the positions that produced the served tokens).
    ``routes``, where given, holds per MoE layer the (len(tokens), k) experts
    to follow instead of the reference's own top-k."""

    def __init__(self, tokens: torch.Tensor, prompt_len: int, routes: list | None = None):
        self.tokens = tokens
        self.prompt_len = int(prompt_len)
        self.routes = routes


def _fp8(x: torch.Tensor, dims) -> torch.Tensor:
    amax = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Ops:
    def __init__(self, control: bool):
        self.control = control

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return _fp8(w, (-2, -1)) if self.control else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x, (-1,)) if self.control else x


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + scale)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, hd), positions 0..T-1, rotate-half."""
    T, _, hd = x.shape
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(m: dict, w: dict, h: torch.Tensor, ops: _Ops) -> torch.Tensor:
    T = h.shape[0]
    H, K, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    a = ops.act(h)
    q = (a @ w["wq"]).view(T, H, hd)
    k = (a @ w["wk"]).view(T, K, hd)
    v = (a @ w["wv"]).view(T, K, hd)
    if m["rope"]:
        q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
    G = H // K
    k = k.repeat_interleave(G, dim=1)  # query head h reads kv head h // G
    v = v.repeat_interleave(G, dim=1)
    out = torch.empty((T, H, hd), dtype=torch.float32, device=h.device)
    mask = torch.ones((T, T), dtype=torch.bool, device=h.device).tril()
    for h0 in range(0, H, 8):  # a few heads at a time bounds the score matrix
        s = torch.einsum("qhd,khd->hqk", q[:, h0:h0 + 8], k[:, h0:h0 + 8]) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, h0:h0 + 8] = torch.einsum("hqk,khd->qhd", p, v[:, h0:h0 + 8])
    return ops.act(out.reshape(T, H * hd)) @ w["wo"]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), device=x.device))


SCAN_ROWS = 16  # requests stepped through the recurrence together
SCAN_BLOCK = 64  # time steps whose decays are formed at once


def _mamba(m: dict, w: dict, hs: list[torch.Tensor], ops: _Ops) -> list[torch.Tensor]:
    """Each request's mixer output. The recurrence steps up to ``SCAN_ROWS``
    requests of similar length in time together, padded at the end (no
    earlier position sees a later one)."""
    n, dc, dtr = m["mamba_d_state"], m["mamba_d_conv"], m["mamba_dt_rank"]
    A = -torch.exp(w["A_log"])  # (di, n)
    out: list = [None] * len(hs)
    order = sorted(range(len(hs)), key=lambda i: hs[i].shape[0])
    for g in range(0, len(order), SCAN_ROWS):
        group = order[g:g + SCAN_ROWS]
        T = max(hs[i].shape[0] for i in group)
        uz, dus, dts, Bs, Cs = [], [], [], [], []
        for i in group:
            h = hs[i]
            Ti = h.shape[0]
            u, z = (ops.act(h) @ w["in_proj"]).chunk(2, dim=-1)
            u_pad = torch.cat([torch.zeros((dc - 1, u.shape[1]), device=u.device), u], dim=0)
            conv = sum(u_pad[k:k + Ti] * w["conv_w"][k] for k in range(dc)) + w["conv_b"]
            uc = torch.nn.functional.silu(conv)
            dt_in, Bc, Cc = (ops.act(uc) @ w["x_proj"]).split([dtr, n, n], dim=-1)
            dt = _softplus(ops.act(dt_in) @ w["dt_proj"] + w["dt_bias"])

            def pad(x):
                return torch.nn.functional.pad(x, (0, 0, 0, T - Ti))

            uz.append((uc, z))
            dus.append(pad(dt * uc))
            dts.append(pad(dt))
            Bs.append(pad(Bc))
            Cs.append(pad(Cc))
        du, dt, Bm, Cm = (torch.stack(x) for x in (dus, dts, Bs, Cs))
        del dus, dts, Bs, Cs
        state = torch.zeros((len(group),) + A.shape, device=A.device)
        ys = torch.empty_like(du)
        for t0 in range(0, T, SCAN_BLOCK):
            t1 = min(T, t0 + SCAN_BLOCK)
            decay = torch.exp(dt[:, t0:t1, :, None] * A)
            states = du[:, t0:t1, :, None] * Bm[:, t0:t1, None, :]
            for t in range(t1 - t0):  # h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t
                torch.addcmul(states[:, t], decay[:, t], state, out=states[:, t])
                state = states[:, t]
            ys[:, t0:t1] = torch.einsum("rtdn,rtn->rtd", states, Cm[:, t0:t1])
        for j, i in enumerate(group):
            uc, z = uz[j]
            y = ys[j, :hs[i].shape[0]] + uc * w["D"]
            out[i] = ops.act(y * torch.nn.functional.silu(z)) @ w["out_proj"]
        del du, dt, Bm, Cm, ys, uz
    return out


def _mlp(m: dict, w: dict, h: torch.Tensor, ops: _Ops) -> torch.Tensor:
    a = ops.act(h)
    if m["gated_mlp"]:
        g = a @ w["wg"]
        g = torch.nn.functional.silu(g) if m["mlp_act"] == "silu" else _gelu(g)
        return ops.act(g * (a @ w["wi"])) @ w["wo"]
    x = a @ w["wi"]
    x = torch.nn.functional.silu(x) if m["mlp_act"] == "silu" else _gelu(x)
    return ops.act(x) @ w["wo"]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _groups(n: int, group: int) -> int:
    """The dispatch group size: the largest divisor of n up to ``group``."""
    for s in range(min(group, n), 0, -1):
        if n % s == 0:
            return s
    return 1


def _moe_call(m: dict, w: dict, h: torch.Tensor, ops: _Ops, given: torch.Tensor | None,
              record: dict) -> torch.Tensor:
    """One forward call's MoE over its tokens h (n, d). ``given`` (n, k): the
    experts to follow; ``record`` gathers the experts used ("idx") and the
    routing margin ("margin"): how far, in router probability, the followed
    experts fall below the best ones left out (<= 0 where they are the top-k)."""
    n, E, k = h.shape[0], m["num_experts"], m["num_experts_per_tok"]
    s = _groups(n, m["moe_group_size"])
    cap = max(4, ((math.ceil(k * s * m["capacity_factor"] / E) + 3) // 4) * 4)
    probs = torch.softmax(h @ w["router"], dim=-1)
    if given is None:
        idx = torch.topk(probs, k, dim=-1).indices  # (n, k), most probable first
    else:
        idx = given.to(probs.device).long()
        chosen = torch.zeros_like(probs, dtype=torch.bool).scatter_(1, idx, True)
        worst_in = probs.masked_fill(~chosen, float("inf")).min(dim=-1).values
        best_out = probs.masked_fill(chosen, float("-inf")).max(dim=-1).values
        record["margin"] = max(record["margin"], float((best_out - worst_in).max()))
    record["idx"].append(idx)
    vals = probs.gather(1, idx)
    gates = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    # each (token, slot)'s place in its expert's buffer, token-major per group
    onehot = torch.nn.functional.one_hot(idx, E).reshape(n // s, s * k, E)
    place = ((onehot.cumsum(1) - onehot) * onehot).sum(-1).reshape(n, k)
    keep = place < cap
    out = torch.zeros_like(h)
    a = ops.act(h)
    for e in range(E):
        tok, slot = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = a[tok]
        y = torch.nn.functional.silu(x @ w["wg"][e]) * (x @ w["wi"][e])
        out.index_add_(0, tok, (ops.act(y) @ w["wo"][e]) * gates[tok, slot, None])
    return out


def _moe(m: dict, w: dict, h: torch.Tensor, prompt_len: int, ops: _Ops,
         given: torch.Tensor | None, record: dict) -> torch.Tensor:
    """The prompt as one call (the prefill), each later token as its own (a
    decode step)."""
    L = prompt_len
    parts = [_moe_call(m, w, h[:L], ops, None if given is None else given[:L], record)]
    parts += [_moe_call(m, w, h[t:t + 1], ops, None if given is None else given[t:t + 1], record)
              for t in range(L, h.shape[0])]
    return torch.cat(parts, dim=0)


LINEAR = ("wq", "wk", "wv", "wo", "wi", "wg", "in_proj", "x_proj", "dt_proj", "out_proj")


def _layer_weights(m: dict, part: str, seed: int, device, ops: _Ops) -> dict:
    """One part's leaves in fp32; under the control the linear layers' in fp8."""
    dtype = DTYPES[m["dtype"]]
    out = {}
    for path, spec in leaf_specs(m, part).items():
        t = draw(spec, path, seed, dtype, device)
        key = path[len(part) + 1:] if path.startswith(part + ".") else path
        out[key] = ops.weight(t) if path.rsplit(".", 1)[-1] in LINEAR else t
    return out


def _sub(w: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in w.items() if k.startswith(prefix + ".")}


def reference_logits(m: dict, seed: int, served: list[Served], device, *,
                     control: bool = False):
    """For each request, the logits (positions, vocab) in fp32 at positions
    L - 1 .. len(tokens) - 1. Returns (logits per request, the widest routing
    margin over the followed routes (0.0 where none are followed), the
    experts used per request and MoE layer, each (len(tokens), k))."""
    fp32_mode()
    ops = _Ops(control)
    eps = m["norm_eps"]
    records = [{"idx": [], "margin": float("-inf")} for _ in served]
    used: list[list] = [[] for _ in served]
    with torch.no_grad():
        emb = _layer_weights(m, "embed", seed, device, _Ops(False))
        xs = [emb["embedding"][r.tokens.to(device).long()] for r in served]
        unembed = emb["embedding"].T if m["tie_embeddings"] else emb["unembed"]
        unembed = ops.weight(unembed.contiguous())
        del emb
        j = 0  # MoE layers so far
        for n, (mixer, ffn) in enumerate(m["layers"]):
            w = _layer_weights(m, f"layers.{n}", seed, device, ops)
            hs = [_rms(x, w["norm1"], eps) for x in xs]
            if mixer == "attn":
                ys = [_attention(m, _sub(w, "attn"), h, ops) for h in hs]
            else:
                ys = _mamba(m, _sub(w, "mamba"), hs, ops)
            del hs
            for i, r in enumerate(served):
                x = xs[i] + ys[i]
                ys[i] = None
                h = _rms(x, w["norm2"], eps)
                if ffn == "mlp":
                    f = _mlp(m, _sub(w, "mlp"), h, ops)
                else:
                    rec = records[i]
                    rec["idx"] = []
                    given = None if r.routes is None else r.routes[j]
                    f = _moe(m, _sub(w, "moe"), h, r.prompt_len, ops, given, rec)
                    used[i].append(torch.cat(rec["idx"], dim=0))
                xs[i] = x + f
            j += ffn == "moe"
            del w
        fn = _layer_weights(m, "final_norm", seed, device, ops)["final_norm"]
        out = []
        for i, r in enumerate(served):
            h = _rms(xs[i][r.prompt_len - 1:], fn, eps)
            out.append(ops.act(h) @ unembed)
        margin = max([rec["margin"] for rec in records] + [0.0]) if any(
            r.routes is not None for r in served) else 0.0
        return out, margin, used
