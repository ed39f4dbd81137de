"""Decoder-only LM over a superblock stack, as an ``nn.Module``.

The port's counterpart of ``repro.models.lm`` for dense global-attention
configurations: every superblock layer is ``attn`` followed by ``mlp``
(gated or plain). That covers ``starcoder2_3b``, ``starcoder2_15b``,
``deepseek_7b`` and ``internvl2_1b`` (token path). The reference scans its
stacked layers; the port holds one module per layer (``layers.{n}``, with
n = superblock * len(superblock) + position) and loops over them.

Modes:
  prefill      — full sequence, returns last-position logits + decode caches
  decode_step  — one token per sequence, reads and updates the caches in place

Caches keep the reference's layout: a tuple over superblock positions of
{"k", "v"} tensors stacked (num_superblocks, B, S, K, hd).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device

from . import attention as A
from .layers import (embed_template, mlp_apply, mlp_template, norm_template, rms_norm,
                     rope_tables, softcap)
from .params import ParamTree, count_params, init_tensor, stack, torch_dtype, tree_map

__all__ = [
    "LM",
    "check_supported",
    "model_template",
    "cache_template",
    "num_params",
]

# Mixers and FFNs outside this slice, with the ROADMAP item that ports each.
_NOT_PORTED = {
    "attn_local": "sliding-window attention decode (gemma2): ROADMAP A5",
    "mamba": "the mamba mixer and the ssm_scan kernel (jamba): ROADMAP A6",
    "moe": "mixture-of-experts FFNs (dbrx, arctic, jamba): ROADMAP A7",
    "moe_dense": "mixture-of-experts FFNs (dbrx, arctic, jamba): ROADMAP A7",
    "mlstm": "xLSTM cells: ROADMAP A8",
    "slstm": "xLSTM cells: ROADMAP A8",
    "none": "xLSTM cells: ROADMAP A8",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for a config this
    slice does not serve."""
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are not ported yet "
                                  "(ROADMAP A9)")
    for spec in cfg.superblock:
        for kind in (spec.mixer, spec.ffn):
            if kind in _NOT_PORTED:
                raise NotImplementedError(
                    f"{cfg.name}: {kind!r} is not ported yet: {_NOT_PORTED[kind]}")
        if spec.mixer != "attn" or spec.ffn != "mlp":
            raise ValueError(f"{cfg.name}: unknown layer {spec}")


def _block_template(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "norm1": norm_template(d),
        "attn": A.attn_template(cfg),
        "norm2": norm_template(d),
        "mlp": mlp_template(cfg),
    }


def model_template(cfg: ModelConfig) -> dict:
    """The reference's parameter tree: embed, blocks stacked over superblocks,
    final norm."""
    check_supported(cfg)
    blocks = tuple(_block_template(cfg) for _ in cfg.superblock)
    return {
        "embed": embed_template(cfg),
        "blocks": stack(blocks, cfg.num_superblocks),
        "final_norm": norm_template(cfg.d_model),
    }


def num_params(cfg: ModelConfig) -> int:
    """Exact parameter count from the templates; allocates nothing."""
    return count_params(model_template(cfg))


def cache_template(cfg: ModelConfig, batch: int, cache_len: int) -> tuple:
    """Decode-cache template: tuple over superblock positions, leaves stacked
    over num_superblocks."""
    check_supported(cfg)
    per_pos = tuple(A.kv_cache_template(cfg, batch, cache_len, local=False)
                    for _ in cfg.superblock)
    return stack(per_pos, cfg.num_superblocks)


class LM(nn.Module):
    """Decoder-only LM with random weights drawn from ``seed`` (or weights
    loaded with ``load_state_dict``, e.g. from ``convert.params_from_jax``).

    ``device=None`` puts it on the CUDA card; pass ``device="cpu"`` for the CPU.
    """

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.layer_specs: tuple[LayerSpec, ...] = cfg.superblock * cfg.num_superblocks
        kw = dict(seed=seed, dtype=dtype, device=dev)
        self.embed = ParamTree(embed_template(cfg), path="embed", **kw)
        self.layers = nn.ModuleList(
            ParamTree(_block_template(cfg), path=f"layers.{n}", **kw)
            for n in range(len(self.layer_specs)))
        self.final_norm = nn.Parameter(
            init_tensor(norm_template(cfg.d_model), "final_norm", **kw), requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def cache_template(self, batch: int, cache_len: int) -> tuple:
        return cache_template(self.cfg, batch, cache_len)

    def init_caches(self, batch: int, cache_len: int) -> tuple:
        """Zeroed decode caches on the model's device, in the model's dtype."""
        dtype = torch_dtype(self.cfg.dtype)
        return tree_map(lambda _, leaf: torch.zeros(leaf.shape, dtype=dtype, device=self.device),
                        self.cache_template(batch, cache_len))

    # ------------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens.long(), self.embed["embedding"])
        if self.cfg.tie_embeddings:  # gemma-style input scaling
            x = x * torch.tensor(self.cfg.d_model**0.5, dtype=x.dtype)
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            logits = x @ self.embed["embedding"].T
        else:
            logits = x @ self.embed["unembed"]
        return softcap(logits, self.cfg.final_softcap)

    def _ffn(self, p: Any, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, p["norm2"], self.cfg.norm_eps)
        return x + mlp_apply(p["mlp"], h, self.cfg)

    def _rope(self, positions: torch.Tensor):
        cfg = self.cfg
        return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta) if cfg.rope else None

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor):
        """tokens: (B, S) ids. Returns (last-position logits (B, 1, V), caches
        holding the S positions)."""
        cfg = self.cfg
        S = tokens.shape[1]
        x = self._embed(tokens)
        rope_cs = self._rope(torch.arange(S, device=x.device))
        P = len(cfg.superblock)
        ks: list[list[torch.Tensor]] = [[] for _ in range(P)]
        vs: list[list[torch.Tensor]] = [[] for _ in range(P)]
        for n, p in enumerate(self.layers):
            h = rms_norm(x, p["norm1"], cfg.norm_eps)
            y, (k, v) = A.attn_forward(p["attn"], h, cfg, causal=True, return_kv=True,
                                       rope_cs=rope_cs)
            c = A.prefill_cache_from_kv(k, v, cfg, local=False)
            ks[n % P].append(c["k"])
            vs[n % P].append(c["v"])
            x = self._ffn(p, x + y)
        caches = tuple({"k": torch.stack(ks[i]), "v": torch.stack(vs[i])} for i in range(P))
        return self._head(x[:, -1:, :]), caches

    @torch.inference_mode()
    def decode_step(self, token: torch.Tensor, pos: int, caches: tuple):
        """token: (B, 1) ids; pos: the absolute position shared by the batch.
        Writes position ``pos`` of ``caches`` in place and returns
        (logits (B, 1, V), caches)."""
        cfg = self.cfg
        pos = int(pos)
        x = self._embed(token)
        rope_cs = self._rope(torch.full((1,), pos, device=x.device))
        P = len(cfg.superblock)
        for n, p in enumerate(self.layers):
            c = caches[n % P]
            layer_cache = {"k": c["k"][n // P], "v": c["v"][n // P]}
            h = rms_norm(x, p["norm1"], cfg.norm_eps)
            y, _ = A.attn_decode(p["attn"], h, layer_cache, pos, cfg, rope_cs=rope_cs)
            x = self._ffn(p, x + y)
        return self._head(x), caches
