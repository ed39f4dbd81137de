"""Decoder-only LM over a superblock stack, as an ``nn.Module``.

The port's counterpart of ``repro.models.lm`` for every decoder-only config:
``starcoder2_3b``, ``starcoder2_15b``, ``deepseek_7b``, ``internvl2_1b``
(token path), ``gemma2_9b``, ``jamba_v0_1_52b``, ``dbrx_132b``,
``arctic_480b`` and ``xlstm_1_3b``. A layer mixes with global attention,
sliding-window attention (``attn_local``), mamba, an mLSTM or an sLSTM, and
follows with an MLP, a routed MoE, a MoE beside a dense MLP, or nothing
(``none``: no norm2, the mixer's output is the residual). The reference
scans its stacked layers; the port holds one module per layer
(``layers.{n}``, with n = superblock * len(superblock) + position) and loops
over them.

Modes:
  prefill      — full sequence, returns last-position logits + decode caches
  decode_step  — one token per sequence, reads and updates the caches in place

Each residual add that feeds a norm is fused into it (``rms_norm_add``):
the mixer's add into ``norm2``, the FFN's add (or, in a block without one,
the mixer's) into the next layer's ``norm1`` and, at decode, into the final
norm. The arithmetic is the reference's add-then-norm, one launch fewer per
add.

Caches keep the reference's layout: a tuple over superblock positions of
dicts stacked over num_superblocks — {"k", "v"} (n_sb, B, S, K, hd) for a
global attention position and (n_sb, B, min(S, W), K, hd) ring buffers for a
local one, {"conv" (n_sb, B, d_conv - 1, d_inner), "h" (n_sb, B, d_inner,
d_state)} for a mamba position, {"C" (n_sb, B, H, hd, hd), "n" (n_sb, B, H,
hd)} for an mLSTM and {"c", "n", "h", "m"} (n_sb, B, d) for an sLSTM, the
recurrent states in float32.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device

from . import attention as A
from . import moe as M
from . import ssm as SSM
from . import xlstm as XL
from .layers import (embed_template, mlp_apply, mlp_template, norm_template, rms_norm,
                     rms_norm_add, rope_tables, softcap)
from .params import ParamTree, count_params, init_tensor, stack, torch_dtype, tree_map

__all__ = [
    "LM",
    "check_supported",
    "model_template",
    "cache_template",
    "num_params",
]

_MIXERS = ("attn", "attn_local", "mamba", "mlstm", "slstm")
_FFNS = ("mlp", "moe", "moe_dense", "none")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for a config the
    port does not serve yet."""
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are not ported yet "
                                  "(ROADMAP A9)")
    for spec in cfg.superblock:
        if spec.mixer not in _MIXERS or spec.ffn not in _FFNS:
            raise ValueError(f"{cfg.name}: unknown layer {spec}")


def _block_template(cfg: ModelConfig, spec: LayerSpec) -> dict:
    d = cfg.d_model
    t: dict[str, Any] = {"norm1": norm_template(d)}
    if spec.mixer in ("attn", "attn_local"):
        t["attn"] = A.attn_template(cfg)
    elif spec.mixer == "mamba":
        t["mamba"] = SSM.mamba_template(cfg)
    elif spec.mixer == "mlstm":
        t["mlstm"] = XL.mlstm_template(cfg)
    else:
        t["slstm"] = XL.slstm_template(cfg)
    if spec.ffn == "none":
        return t
    t["norm2"] = norm_template(d)
    if spec.ffn == "mlp":
        t["mlp"] = mlp_template(cfg)
    else:
        t["moe"] = M.moe_template(cfg)
        if spec.ffn == "moe_dense":
            t["dense_mlp"] = mlp_template(cfg)
    return t


def model_template(cfg: ModelConfig) -> dict:
    """The reference's parameter tree: embed, blocks stacked over superblocks,
    final norm."""
    check_supported(cfg)
    blocks = tuple(_block_template(cfg, spec) for spec in cfg.superblock)
    return {
        "embed": embed_template(cfg),
        "blocks": stack(blocks, cfg.num_superblocks),
        "final_norm": norm_template(cfg.d_model),
    }


def num_params(cfg: ModelConfig) -> int:
    """Exact parameter count from the templates; allocates nothing."""
    return count_params(model_template(cfg))


def _layer_cache_template(cfg: ModelConfig, spec: LayerSpec, batch: int, cache_len: int) -> dict:
    if spec.mixer in ("attn", "attn_local"):
        return A.kv_cache_template(cfg, batch, cache_len, local=spec.mixer == "attn_local")
    if spec.mixer == "mamba":
        return SSM.mamba_cache_template(cfg, batch)
    if spec.mixer == "mlstm":
        return XL.mlstm_cache_template(cfg, batch)
    return XL.slstm_cache_template(cfg, batch)


def cache_template(cfg: ModelConfig, batch: int, cache_len: int) -> tuple:
    """Decode-cache template: tuple over superblock positions, leaves stacked
    over num_superblocks."""
    check_supported(cfg)
    per_pos = tuple(_layer_cache_template(cfg, spec, batch, cache_len)
                    for spec in cfg.superblock)
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
            ParamTree(_block_template(cfg, spec), path=f"layers.{n}", **kw)
            for n, spec in enumerate(self.layer_specs))
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
        """Zeroed decode caches on the model's device, each leaf in its
        template's dtype (the model's dtype unless the leaf names one)."""
        dtype = torch_dtype(self.cfg.dtype)
        return tree_map(lambda _, leaf: torch.zeros(
            leaf.shape, dtype=torch_dtype(leaf.dtype) if leaf.dtype else dtype,
            device=self.device), self.cache_template(batch, cache_len))

    # ------------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens.long(), self.embed["embedding"])
        if self.cfg.tie_embeddings:  # gemma-style input scaling
            x = x * torch.tensor(self.cfg.d_model**0.5, dtype=x.dtype)
        return x

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """Logits from the final norm's output."""
        if self.cfg.tie_embeddings:
            logits = h @ self.embed["embedding"].T
        else:
            logits = h @ self.embed["unembed"]
        return softcap(logits, self.cfg.final_softcap)

    def _norm1(self, p: Any, x: torch.Tensor, f: torch.Tensor | None):
        """The layer's input x + f (f None in the first layer) and its norm1."""
        if f is None:
            return x, rms_norm(x, p["norm1"], self.cfg.norm_eps)
        return rms_norm_add(x, f, p["norm1"], self.cfg.norm_eps)

    def _ffn(self, spec: LayerSpec, p: Any, x: torch.Tensor, y: torch.Tensor):
        """The mixer's residual add fused into norm2, then the FFN. Returns
        (x, f): the layer's output is x + f, left for the next norm to add.
        A block without an FFN hands the mixer's y on as f."""
        if spec.ffn == "none":
            return x, y
        x, h = rms_norm_add(x, y, p["norm2"], self.cfg.norm_eps)
        if spec.ffn == "mlp":
            return x, mlp_apply(p["mlp"], h, self.cfg)
        f = M.moe_apply(p["moe"], h, self.cfg)
        if spec.ffn == "moe_dense":  # arctic: routed experts + parallel dense MLP, last add fused
            return x + f, mlp_apply(p["dense_mlp"], h, self.cfg)
        return x, f

    def _rope(self, positions: torch.Tensor):
        cfg = self.cfg
        return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta) if cfg.rope else None

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor):
        """tokens: (B, S) ids. Returns (last-position logits (B, 1, V), caches
        holding the S positions (a local layer's last W, as a ring) and the
        recurrent layers' states)."""
        cfg = self.cfg
        S = tokens.shape[1]
        x, f = self._embed(tokens), None
        rope_cs = self._rope(torch.arange(S, device=x.device))
        P = len(cfg.superblock)
        parts: list[dict[str, list[torch.Tensor]]] = [{} for _ in range(P)]
        for n, (spec, p) in enumerate(zip(self.layer_specs, self.layers)):
            x, h = self._norm1(p, x, f)
            if spec.mixer in ("attn", "attn_local"):
                local = spec.mixer == "attn_local"
                y, (k, v) = A.attn_forward(p["attn"], h, cfg, causal=True, local=local,
                                           return_kv=True, rope_cs=rope_cs)
                c = A.prefill_cache_from_kv(k, v, cfg, local=local)
            elif spec.mixer == "mamba":
                y, c = SSM.mamba_forward(p["mamba"], h, cfg, return_cache=True)
            else:
                forward = XL.mlstm_forward if spec.mixer == "mlstm" else XL.slstm_forward
                y, c = forward(p[spec.mixer], h, cfg, return_cache=True)
            for name, leaf in c.items():
                parts[n % P].setdefault(name, []).append(leaf)
            x, f = self._ffn(spec, p, x, y)
        caches = tuple({name: torch.stack(leaves) for name, leaves in part.items()}
                       for part in parts)
        last = x[:, -1:, :] + f[:, -1:, :]  # the final norm reads only the last position
        return self._logits(rms_norm(last, self.final_norm, cfg.norm_eps)), caches

    @torch.inference_mode()
    def decode_step(self, token: torch.Tensor, pos: int, caches: tuple):
        """token: (B, 1) ids; pos: the absolute position shared by the batch.
        Writes position ``pos`` of the attention caches (slot pos % W of a
        ring) and the new recurrent states into ``caches`` in place and
        returns (logits (B, 1, V), caches)."""
        cfg = self.cfg
        pos = int(pos)
        x, f = self._embed(token), None
        rope_cs = self._rope(torch.full((1,), pos, device=x.device))
        P = len(cfg.superblock)
        for n, (spec, p) in enumerate(zip(self.layer_specs, self.layers)):
            c, sb = caches[n % P], n // P
            layer_cache = {name: leaf[sb] for name, leaf in c.items()}
            x, h = self._norm1(p, x, f)
            if spec.mixer in ("attn", "attn_local"):
                y, _ = A.attn_decode(p["attn"], h, layer_cache, pos, cfg,
                                     local=spec.mixer == "attn_local", rope_cs=rope_cs)
            elif spec.mixer == "mamba":
                y, new = SSM.mamba_decode(p["mamba"], h, layer_cache, cfg)
                for name, leaf in new.items():
                    layer_cache[name].copy_(leaf)
            else:
                decode = XL.mlstm_decode if spec.mixer == "mlstm" else XL.slstm_decode
                y, _ = decode(p[spec.mixer], h, layer_cache, cfg)
            x, f = self._ffn(spec, p, x, y)
        _, h = rms_norm_add(x, f, self.final_norm, cfg.norm_eps)
        return self._logits(h), caches
