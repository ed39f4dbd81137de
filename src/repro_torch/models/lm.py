"""Decoder-only and encoder-decoder LMs over a superblock stack, as an
``nn.Module``.

The port's counterpart of ``repro.models.lm`` for every config:
``starcoder2_3b``, ``starcoder2_15b``, ``deepseek_7b``, ``internvl2_1b``
(token path), ``gemma2_9b``, ``jamba_v0_1_52b``, ``dbrx_132b``,
``arctic_480b``, ``xlstm_1_3b`` and the encoder-decoder
``seamless_m4t_large_v2``. A layer mixes with global attention,
sliding-window attention (``attn_local``), mamba, an mLSTM or an sLSTM, and
follows with an MLP, a routed MoE, a MoE beside a dense MLP, or nothing
(``none``: no norm2, the mixer's output is the residual). The reference
scans its stacked layers; the port holds one module per layer
(``layers.{n}``, with n = superblock * len(superblock) + position) and loops
over them.

An encoder-decoder adds an encoder stack (``encoder.layers.{n}``, each a
bidirectional attention layer with RoPE and an MLP, then
``encoder.final_norm``) over frame embeddings that a stub frontend supplies,
and in every decoder attention layer a cross-attention branch after the
self-attention (``norm_cross``, ``cross``): queries from the decoder stream,
K/V projected from the encoder output, no rotary, no mask.

Modes:
  encode       — (encoder-decoder) frame embeddings to the encoder output
  prefill      — full sequence, returns last-position logits + decode caches
                 (an encoder-decoder encodes ``enc_embeds`` first)
  decode_step  — one token per sequence, reads and updates the caches in place

Each residual add that feeds a norm is fused into it (``rms_norm_add``):
the mixer's add into ``norm2`` (with a cross branch: the self-attention's
add into ``norm_cross``, the cross-attention's into ``norm2``), the FFN's add
(or, in a block without one, the mixer's) into the next layer's ``norm1``
and, at decode, into the final norm; the encoder's last add into its final
norm. The arithmetic is the reference's add-then-norm, one launch fewer per
add.

Caches keep the reference's layout: a tuple over superblock positions of
dicts stacked over num_superblocks — {"k", "v"} (n_sb, B, S, K, hd) for a
global attention position and (n_sb, B, min(S, W), K, hd) ring buffers for a
local one, {"conv" (n_sb, B, d_conv - 1, d_inner), "h" (n_sb, B, d_inner,
d_state)} for a mamba position, {"C" (n_sb, B, H, hd, hd), "n" (n_sb, B, H,
hd)} for an mLSTM and {"c", "n", "h", "m"} (n_sb, B, d) for an sLSTM, the
recurrent states in float32. An encoder-decoder's attention positions also
hold {"cross_k", "cross_v"} (n_sb, B, enc_len, K, hd): the encoder output's
K/V, written by prefill and only read at decode.
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
from .params import ParamTree, TSpec, count_params, init_tensor, stack, torch_dtype, tree_map

__all__ = [
    "LM",
    "check_supported",
    "model_template",
    "cache_template",
    "num_params",
]

_MIXERS = ("attn", "attn_local", "mamba", "mlstm", "slstm")
_FFNS = ("mlp", "moe", "moe_dense", "none")
ENCODER_SPEC = LayerSpec("attn", "mlp")  # every encoder layer


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a layer kind the port does not know."""
    for spec in cfg.superblock:
        if spec.mixer not in _MIXERS or spec.ffn not in _FFNS:
            raise ValueError(f"{cfg.name}: unknown layer {spec}")


def _block_template(cfg: ModelConfig, spec: LayerSpec, *, cross: bool = False) -> dict:
    d = cfg.d_model
    t: dict[str, Any] = {"norm1": norm_template(d)}
    if spec.mixer in ("attn", "attn_local"):
        t["attn"] = A.attn_template(cfg)
        if cross:
            t["norm_cross"] = norm_template(d)
            t["cross"] = A.attn_template(cfg)
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
    final norm; an encoder-decoder's blocks carry the cross branch, and its
    ``encoder`` holds one block stacked over encoder_layers and a final norm."""
    check_supported(cfg)
    blocks = tuple(_block_template(cfg, spec, cross=cfg.is_encdec) for spec in cfg.superblock)
    t: dict[str, Any] = {
        "embed": embed_template(cfg),
        "blocks": stack(blocks, cfg.num_superblocks),
        "final_norm": norm_template(cfg.d_model),
    }
    if cfg.is_encdec:
        t["encoder"] = {"blocks": stack((_block_template(cfg, ENCODER_SPEC),), cfg.encoder_layers),
                        "final_norm": norm_template(cfg.d_model)}
    return t


def num_params(cfg: ModelConfig) -> int:
    """Exact parameter count from the templates; allocates nothing."""
    return count_params(model_template(cfg))


def _layer_cache_template(cfg: ModelConfig, spec: LayerSpec, batch: int, cache_len: int,
                          enc_len: int) -> dict:
    if spec.mixer in ("attn", "attn_local"):
        c = A.kv_cache_template(cfg, batch, cache_len, local=spec.mixer == "attn_local")
        if cfg.is_encdec:
            shape = (batch, enc_len, cfg.num_kv_heads, cfg.resolved_head_dim)
            axes = ("cache_batch", "cache_seq", None, None)
            c["cross_k"] = TSpec(shape, axes, init="zeros")
            c["cross_v"] = TSpec(shape, axes, init="zeros")
        return c
    if spec.mixer == "mamba":
        return SSM.mamba_cache_template(cfg, batch)
    if spec.mixer == "mlstm":
        return XL.mlstm_cache_template(cfg, batch)
    return XL.slstm_cache_template(cfg, batch)


def cache_template(cfg: ModelConfig, batch: int, cache_len: int, *, enc_len: int = 0) -> tuple:
    """Decode-cache template: tuple over superblock positions, leaves stacked
    over num_superblocks; an encoder-decoder's cross caches hold ``enc_len``
    frames."""
    check_supported(cfg)
    per_pos = tuple(_layer_cache_template(cfg, spec, batch, cache_len, enc_len)
                    for spec in cfg.superblock)
    return stack(per_pos, cfg.num_superblocks)


class LM(nn.Module):
    """Decoder-only or encoder-decoder LM with random weights drawn from
    ``seed`` (or weights loaded with ``load_state_dict``, e.g. from
    ``convert.params_from_jax``).

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
            ParamTree(_block_template(cfg, spec, cross=cfg.is_encdec), path=f"layers.{n}", **kw)
            for n, spec in enumerate(self.layer_specs))
        self.final_norm = nn.Parameter(
            init_tensor(norm_template(cfg.d_model), "final_norm", **kw), requires_grad=False)
        if cfg.is_encdec:
            self.encoder = nn.Module()
            self.encoder.layers = nn.ModuleList(
                ParamTree(_block_template(cfg, ENCODER_SPEC), path=f"encoder.layers.{n}", **kw)
                for n in range(cfg.encoder_layers))
            self.encoder.final_norm = nn.Parameter(
                init_tensor(norm_template(cfg.d_model), "encoder.final_norm", **kw),
                requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def cache_template(self, batch: int, cache_len: int, *, enc_len: int = 0) -> tuple:
        return cache_template(self.cfg, batch, cache_len, enc_len=enc_len)

    def init_caches(self, batch: int, cache_len: int, *, enc_len: int = 0) -> tuple:
        """Zeroed decode caches on the model's device, each leaf in its
        template's dtype (the model's dtype unless the leaf names one)."""
        dtype = torch_dtype(self.cfg.dtype)
        return tree_map(lambda _, leaf: torch.zeros(
            leaf.shape, dtype=torch_dtype(leaf.dtype) if leaf.dtype else dtype,
            device=self.device), self.cache_template(batch, cache_len, enc_len=enc_len))

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

    def _cross(self, p: Any, x: torch.Tensor, y: torch.Tensor, ck: torch.Tensor,
               cv: torch.Tensor, *, decode: bool):
        """The self-attention's residual add fused into norm_cross, then
        cross-attention over the encoder's K/V. Returns (x, cross y) for
        norm2 to add."""
        x, h = rms_norm_add(x, y, p["norm_cross"], self.cfg.norm_eps)
        return x, A.cross_attn_forward(p["cross"], h, ck, cv, self.cfg, decode=decode)

    def _rope(self, positions: torch.Tensor):
        cfg = self.cfg
        return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta) if cfg.rope else None

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """enc_embeds: (B, Se, d) frame embeddings, cast to the model's dtype.
        The encoder stack, bidirectional with RoPE, then its final norm (fused
        with the last layer's add). Returns the encoder output (B, Se, d)."""
        cfg = self.cfg
        x, f = enc_embeds.to(torch_dtype(cfg.dtype)), None
        rope_cs = self._rope(torch.arange(x.shape[1], device=x.device))
        for p in self.encoder.layers:
            x, h = self._norm1(p, x, f)
            y = A.attn_forward(p["attn"], h, cfg, causal=False, rope_cs=rope_cs)
            x, f = self._ffn(ENCODER_SPEC, p, x, y)
        return rms_norm_add(x, f, self.encoder.final_norm, cfg.norm_eps)[1]

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, enc_embeds: torch.Tensor | None = None):
        """tokens: (B, S) ids; an encoder-decoder also takes ``enc_embeds`` (B,
        Se, d), which it encodes first. Returns (last-position logits (B, 1,
        V), caches holding the S positions (a local layer's last W, as a
        ring), the recurrent layers' states and the Se frames' cross K/V)."""
        cfg = self.cfg
        if cfg.is_encdec != (enc_embeds is not None):
            raise ValueError(f"{cfg.name}: enc_embeds is "
                             f"{'required' if cfg.is_encdec else 'for encoder-decoders only'}")
        enc_out = self.encode(enc_embeds) if cfg.is_encdec else None
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
                if enc_out is not None:
                    ck, cv = A.cross_kv(p["cross"], enc_out, cfg)
                    x, y = self._cross(p, x, y, ck, cv, decode=False)
                    c.update(cross_k=ck, cross_v=cv)
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
        returns (logits (B, 1, V), caches); cross caches are only read."""
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
                if cfg.is_encdec:
                    x, y = self._cross(p, x, y, layer_cache["cross_k"], layer_cache["cross_v"],
                                       decode=True)
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
