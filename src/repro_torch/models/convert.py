"""Carry weights and caches from the JAX package's layout to the port's.

Both packages keep weights as (in, out) matrices applied as ``x @ w``, so
the conversion is a copy: the reference's parameter tree
``{"embed": {...}, "blocks": (dict stacked over num_superblocks, ...),
"final_norm"}``, given as numpy arrays, becomes a ``state_dict`` for
``models.lm.LM``, whose layer n is superblock n // P, position n % P; an
encoder-decoder's ``{"encoder": {"blocks": (dict stacked over
encoder_layers,), "final_norm"}}`` becomes ``encoder.layers.{n}`` and
``encoder.final_norm``. The flattening is generic over the leaves, so
attention (global or local, with or without a cross branch), mamba, mLSTM,
sLSTM, MLP and MoE blocks carry across alike, each leaf in its own dtype.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["tensor_from_numpy", "params_from_jax", "caches_from_jax", "caches_to_numpy"]


def tensor_from_numpy(a: Any) -> torch.Tensor:
    """A copy of ``a`` as a CPU tensor; bfloat16 arrays (ml_dtypes) keep their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _flatten(tree: Any, prefix: str, index: int | None, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}.{k}", index, out)
        return
    arr = np.asarray(tree)
    out[prefix] = tensor_from_numpy(arr if index is None else arr[index])


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy leaves) as an ``LM`` state dict."""
    out: dict[str, torch.Tensor] = {}
    _flatten(tree["embed"], "embed", None, out)
    P = len(cfg.superblock)
    for sb in range(cfg.num_superblocks):
        for i in range(P):
            _flatten(tree["blocks"][i], f"layers.{sb * P + i}", sb, out)
    out["final_norm"] = tensor_from_numpy(tree["final_norm"])
    if "encoder" in tree:
        enc = tree["encoder"]
        for n in range(cfg.encoder_layers):
            _flatten(enc["blocks"][0], f"encoder.layers.{n}", n, out)
        out["encoder.final_norm"] = tensor_from_numpy(enc["final_norm"])
    return out


def caches_from_jax(caches: Any, device: str | torch.device = "cpu") -> tuple:
    """The reference's decode caches (a tuple over superblock positions of
    dicts stacked over n_sb: attention {"k", "v"} (n_sb, B, S, K, hd), a
    local ring's S being min(S, W), plus {"cross_k", "cross_v"} (n_sb, B,
    enc_len, K, hd) in an encoder-decoder; mamba {"conv", "h"}; mLSTM {"C",
    "n"}; sLSTM {"c", "n", "h", "m"}; the recurrent states float32; numpy
    leaves) in the port's layout, which is the same, each leaf keeping its
    dtype."""
    return tuple({k: tensor_from_numpy(v).to(device) for k, v in c.items()} for c in caches)


def caches_to_numpy(caches: tuple) -> tuple:
    """The port's caches as numpy arrays (float32), for comparison."""
    return tuple({k: v.detach().float().cpu().numpy() for k, v in c.items()} for c in caches)
