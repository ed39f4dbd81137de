"""Useful FLOPs of a model call, from a configuration's ``model`` block.

Counted: every matrix product (2 per multiply-add), attention's QK^T and PV
over the causal pairs only, the routed experts only (top-k per token, dropped
or not), the selective scan as 4 FLOPs per (token, channel, state) (the state
update's multiply-add and the output's), the depthwise conv, and the logits
of the positions a call returns (the last position of a prefill, each token
of a decode step). Norms, activations and the router's softmax are left out:
they are a fraction of a percent.
"""

from __future__ import annotations

__all__ = ["per_token_linear", "prefill_flops", "decode_flops"]


def per_token_linear(m: dict) -> dict[str, int]:
    """FLOPs a token spends in each layer kind's matrix products."""
    d, hd, f = m["d_model"], m["head_dim"], m["d_ff"]
    q, kv = m["num_heads"] * hd, m["num_kv_heads"] * hd
    out = {"attn": 2 * d * (q + 2 * kv) + 2 * q * d}
    out["mlp"] = 2 * d * f * (3 if m["gated_mlp"] else 2)
    if m.get("num_experts"):
        out["moe"] = 2 * d * m["num_experts"] + m["num_experts_per_tok"] * 6 * d * f
    if any(mixer == "mamba" for mixer, _ in m["layers"]):
        di, n, dtr = m["mamba_expand"] * d, m["mamba_d_state"], m["mamba_dt_rank"]
        out["mamba"] = (2 * d * 2 * di + 2 * m["mamba_d_conv"] * di + 2 * di * (dtr + 2 * n)
                        + 2 * dtr * di + 4 * di * n + 2 * di * d)
    return out


def _attn_pairs(m: dict, pairs: int) -> int:
    return 4 * m["num_heads"] * m["head_dim"] * pairs


def prefill_flops(m: dict, L: int) -> int:
    lin = per_token_linear(m)
    total = 2 * m["d_model"] * m["padded_vocab"]  # the last position's logits
    for mixer, ffn in m["layers"]:
        total += L * (lin[mixer] + lin[ffn])
        if mixer == "attn":
            total += _attn_pairs(m, L * (L + 1) // 2)
    return total


def decode_flops(m: dict, pos: int, batch: int = 1) -> int:
    """A decode step of ``batch`` tokens at position ``pos`` (each attends
    pos + 1 keys)."""
    lin = per_token_linear(m)
    total = 2 * m["d_model"] * m["padded_vocab"]
    for mixer, ffn in m["layers"]:
        total += lin[mixer] + lin[ffn]
        if mixer == "attn":
            total += _attn_pairs(m, pos + 1)
    return batch * total
