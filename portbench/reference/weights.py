"""The weights of a configuration, one leaf at a time, from the seed.

A frozen copy of the program's parameter rule (the templates of its model
files and ``init_tensor``): each leaf is drawn by a ``torch.Generator`` on the
given device, seeded by sha256("{seed}:{path}"), as fp32 normals times the
leaf's standard deviation (``fan_in``: 1 / sqrt(shape[-2])), then rounded to
the served dtype. The reference reads the rounded values back in fp32: the
served model is the rounded one. The same device type gives the same draws,
so the reference regenerates on the card what the program drew there, and
never reads the program's tensors.
"""

from __future__ import annotations

import hashlib
import math

import torch

__all__ = ["path_seed", "draw", "leaf_specs", "DTYPES"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def path_seed(seed: int, path: str) -> int:
    digest = hashlib.sha256(f"{seed}:{path}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def draw(spec: tuple, path: str, seed: int, dtype: torch.dtype,
         device: torch.device) -> torch.Tensor:
    """One leaf, (shape, init, std), as the served dtype rounds it, in fp32."""
    shape, init, std = spec
    if init == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if init == "fan_in":
        std = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
    elif init != "normal":
        raise ValueError(init)
    gen = torch.Generator(device=device)
    gen.manual_seed(path_seed(seed, path))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(std).to(dtype).float()


def _attn(m: dict) -> dict:
    d, hd = m["d_model"], m["head_dim"]
    q, kv = m["num_heads"] * hd, m["num_kv_heads"] * hd
    return {"wq": ((d, q), "fan_in", 0), "wk": ((d, kv), "fan_in", 0),
            "wv": ((d, kv), "fan_in", 0), "wo": ((q, d), "fan_in", 0)}


def _mamba(m: dict) -> dict:
    d, n, dc = m["d_model"], m["mamba_d_state"], m["mamba_d_conv"]
    di, dtr = m["mamba_expand"] * d, m["mamba_dt_rank"]
    return {"in_proj": ((d, 2 * di), "fan_in", 0), "conv_w": ((dc, di), "normal", 0.1),
            "conv_b": ((di,), "zeros", 0), "x_proj": ((di, dtr + 2 * n), "fan_in", 0),
            "dt_proj": ((dtr, di), "fan_in", 0), "dt_bias": ((di,), "zeros", 0),
            "A_log": ((di, n), "ones", 0), "D": ((di,), "ones", 0),
            "out_proj": ((di, d), "fan_in", 0)}


def _mlp(m: dict) -> dict:
    d, f = m["d_model"], m["d_ff"]
    t = {"wi": ((d, f), "fan_in", 0), "wo": ((f, d), "fan_in", 0)}
    if m["gated_mlp"]:
        t["wg"] = ((d, f), "fan_in", 0)
    return t


def _moe(m: dict) -> dict:
    d, f, e = m["d_model"], m["d_ff"], m["num_experts"]
    return {"router": ((d, e), "fan_in", 0), "wi": ((e, d, f), "fan_in", 0),
            "wg": ((e, d, f), "fan_in", 0), "wo": ((e, f, d), "fan_in", 0)}


def leaf_specs(m: dict, part: str) -> dict[str, tuple]:
    """The leaves of one part of the model: "embed", "final_norm" or
    "layers.{n}", as {path: (shape, init, std)}."""
    d = m["d_model"]
    if part == "embed":
        t = {"embed.embedding": ((m["padded_vocab"], d), "normal", 0.02)}
        if not m["tie_embeddings"]:
            t["embed.unembed"] = ((d, m["padded_vocab"]), "fan_in", 0)
        return t
    if part == "final_norm":
        return {"final_norm": ((d,), "zeros", 0)}
    n = int(part.split(".")[1])
    mixer, ffn = m["layers"][n]
    t = {"norm1": ((d,), "zeros", 0)}
    t.update({f"{mixer}.{k}": v for k, v in (_attn(m) if mixer == "attn" else _mamba(m)).items()})
    t["norm2"] = ((d,), "zeros", 0)
    t.update({f"{ffn}.{k}": v for k, v in (_mlp(m) if ffn == "mlp" else _moe(m)).items()})
    return {f"{part}.{k}": v for k, v in t.items()}
