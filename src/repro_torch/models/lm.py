"""Decoder-only and encoder-decoder LMs over a superblock stack, as an
``nn.Module``.

The port's counterpart of ``repro.models.lm`` for every config:
``starcoder2_3b``, ``starcoder2_15b``, ``deepseek_7b``, ``internvl2_1b``
(with its stub image prefix), ``gemma2_9b``, ``jamba_v0_1_52b``, ``dbrx_132b``,
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
  forward      — full-sequence logits (training; differentiable, not under
                 inference mode)
  encode       — (encoder-decoder) frame embeddings to the encoder output
  prefill      — full sequence, returns last-position logits + decode caches
                 (an encoder-decoder encodes ``enc_embeds`` first)
  decode_step  — one token per sequence, reads and updates the caches in place;
                 after ``capture_decode`` its position-free layers replay as
                 CUDA graphs (``decode_graph.py``)
``loss_fn(model, batch)`` is the training loss over ``forward``'s logits.

``prefill`` and ``decode_step`` take a ``tracer`` (a ``repro_torch.obs.Tracer``,
default None), which the serving engine passes on the wall clock, and name
their host regions by it in a ``torch.profiler`` capture: each layer's mixer
(with norm1 and the cache update) ``lm.mixer.<mixer>``, its FFN (with norm2)
``lm.ffn.<ffn>``, and the final norm with the logits ``lm.head``; a decode
step that replays its graphs names each graph ``lm.graph`` (its input copies
and its launch), each eager attention mixer ``lm.mixer.<mixer>``, each MoE's
routing ``lm.moe.route`` and the head ``lm.head``. Without a tracer each site
enters one shared no-op context.

A config with ``prefix_embed`` (internvl2's stub vision frontend) takes
``prefix_embeds`` (B, P, d) in ``forward`` and ``prefill``: cast to the
model's dtype and put ahead of the token embeddings (gemma's sqrt(d) scaling
applies to the tokens only), so RoPE numbers the P + S positions 0..P+S-1
and the caches hold all of them. Any other config refuses a prefix.

Activations carry the reference's sharding hints (``sharding.partition.hint``
at its 21 sites): identities unless a dry run's rules are active, when they
redistribute ``DTensor``s (``launch/dryrun.py``).

Parameters are registered with ``requires_grad=False``; training turns them
on (``model.requires_grad_(True)``), serving leaves them off. With
``cfg.remat == "full"`` each layer of ``forward`` runs under
``torch.utils.checkpoint`` (the reference checkpoints each layer), so its
kernels launch again in the backward pass.

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

import functools
import itertools
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.obs.tracer import no_region
from repro_torch.sharding.partition import current_rules, hint

from . import attention as A
from . import decode_graph as DG
from . import moe as M
from . import ssm as SSM
from . import xlstm as XL
from .layers import (embed_template, mlp_apply, mlp_template, norm_template, rms_norm,
                     rms_norm_add, rope_tables, softcap)
from .params import ParamTree, TSpec, count_params, init_tensor, stack, torch_dtype, tree_map

__all__ = [
    "LM",
    "loss_fn",
    "prepend_prefix",
    "stack_groups",
    "check_supported",
    "model_template",
    "param_templates",
    "cache_template",
    "num_params",
]

_MIXERS = ("attn", "attn_local", "mamba", "mlstm", "slstm")
_FFNS = ("mlp", "moe", "moe_dense", "none")
ENCODER_SPEC = LayerSpec("attn", "mlp")  # every encoder layer


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a layer kind or a remat policy the port does
    not know."""
    for spec in cfg.superblock:
        if spec.mixer not in _MIXERS or spec.ffn not in _FFNS:
            raise ValueError(f"{cfg.name}: unknown layer {spec}")
    if cfg.remat not in ("none", "full"):
        raise ValueError(f"{cfg.name}: remat {cfg.remat!r} is not ported ('none' or 'full')")


def stack_groups(cfg: ModelConfig, names) -> dict[str, str]:
    """Each parameter name's leaf in the reference's stacked tree:
    ``layers.{n}.<path>`` is position n % P of every superblock
    (``blocks.{n % P}.<path>``), ``encoder.layers.{n}.<path>`` one stack;
    any other name is its own. A per-tensor statistic of the reference
    (Adafactor's RMS, the int8 compression's scale) runs over a whole stack."""
    P = len(cfg.superblock)

    def group(name: str) -> str:
        head, _, rest = name.partition("layers.")
        if head not in ("", "encoder.") or not rest:
            return name
        n, _, path = rest.partition(".")
        return f"{head}blocks.{int(n) % P if not head else 0}.{path}"

    return {name: group(name) for name in names}


def prepend_prefix(prefix: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The prefix embeddings (B, P, d), cast to x's dtype, ahead of the
    token embeddings x (B, S, d)."""
    return torch.cat([prefix.to(x.dtype), x], dim=1)


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


def param_templates(cfg: ModelConfig) -> dict[str, TSpec]:
    """The port's parameters, name -> TSpec, named as
    ``LM(cfg).named_parameters()`` names them: one leaf per layer
    (``layers.{n}.<path>``) where the reference stacks each superblock
    position."""
    check_supported(cfg)
    out: dict[str, TSpec] = {}

    def add(prefix: str, template) -> None:
        tree_map(lambda path, leaf: out.__setitem__(f"{prefix}.{path}", leaf), template)

    add("embed", embed_template(cfg))
    for n, spec in enumerate(cfg.superblock * cfg.num_superblocks):
        add(f"layers.{n}", _block_template(cfg, spec, cross=cfg.is_encdec))
    out["final_norm"] = norm_template(cfg.d_model)
    if cfg.is_encdec:
        for n in range(cfg.encoder_layers):
            add(f"encoder.layers.{n}", _block_template(cfg, ENCODER_SPEC))
        out["encoder.final_norm"] = norm_template(cfg.d_model)
    return out


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
        self._region_names = tuple((f"lm.mixer.{s.mixer}", f"lm.ffn.{s.ffn}")
                                   for s in self.layer_specs)
        # the eager decode step's pieces by profiler range: a layer's norm1 and
        # mixer in its mixer's, the rest of the layer in its FFN's, the embedding
        # in none
        self._decode_ranges = tuple(
            (name, tuple(pieces)) for (name, _), pieces in itertools.groupby(
                DG.decode_pieces(self.layer_specs), key=self._range_of))
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
        self._decode_graphs: DG.DecodeGraphs | None = None
        self.decode_graph_steps = 0  # decode steps replayed as graphs
        self.decode_eager_steps = 0  # decode steps run eagerly on the card

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
    def _embed(self, tokens: torch.Tensor, prefix_embeds: torch.Tensor | None = None):
        x = F.embedding(tokens.long(), self.embed["embedding"])
        if self.cfg.tie_embeddings:  # gemma-style input scaling, of the tokens only
            x = x * torch.tensor(self.cfg.d_model**0.5, dtype=x.dtype)
        if prefix_embeds is not None:
            x = prepend_prefix(prefix_embeds, x)
        return hint(x, "batch", "seq", None)

    def _check_inputs(self, prefix_embeds, enc_embeds) -> None:
        cfg = self.cfg
        if cfg.is_encdec != (enc_embeds is not None):
            raise ValueError(f"{cfg.name}: enc_embeds is "
                             f"{'required' if cfg.is_encdec else 'for encoder-decoders only'}")
        if prefix_embeds is not None and not cfg.prefix_embed:
            raise ValueError(f"{cfg.name}: prefix_embeds is for a config with a prefix "
                             "embedding (prefix_embed) only")

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """Logits from the final norm's output."""
        if self.cfg.tie_embeddings:
            logits = h @ self.embed["embedding"].T
        else:
            logits = h @ self.embed["unembed"]
        return hint(softcap(logits, self.cfg.final_softcap), "batch", "seq_inner", "vocab")

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
            return hint(x, "batch", "seq", None), hint(y, "batch", "seq", None)
        x, h = rms_norm_add(x, y, p["norm2"], self.cfg.norm_eps)
        return self._ffn_out(spec, p, x, h)

    def _ffn_out(self, spec: LayerSpec, p: Any, x: torch.Tensor, h: torch.Tensor,
                 routed: tuple | None = None):
        """The FFN over norm2's output h: (x, f). ``routed``: a MoE's (probs,
        expert ids) where the caller routed h itself (``moe.route`` over
        ``moe.moe_groups(h)``)."""
        if spec.ffn == "mlp":
            f = mlp_apply(p["mlp"], h, self.cfg)
        else:
            f = (M.moe_apply(p["moe"], h, self.cfg) if routed is None
                 else M.moe_dispatch(p["moe"], h, *routed, self.cfg))
            if spec.ffn == "moe_dense":  # arctic: routed + parallel dense MLP, last add fused
                x, f = x + f, mlp_apply(p["dense_mlp"], h, self.cfg)
        return hint(x, "batch", "seq", None), hint(f, "batch", "seq", None)

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

    def _rope_at(self, pos: int, device: torch.device):
        """A decode step's RoPE tables at ``pos`` (None without RoPE)."""
        return self._rope(torch.full((1,), pos, device=device)) if self.cfg.rope else None

    def _layers(self):
        """Apply one layer: under ``torch.utils.checkpoint`` when remat is
        "full" and grad mode is on (its activations are recomputed in the
        backward pass), else directly."""
        if self.cfg.remat == "full" and torch.is_grad_enabled():
            return functools.partial(checkpoint, use_reentrant=False)
        return lambda fn, *args: fn(*args)

    def _encoder_layer(self, p: Any, x: torch.Tensor, f: torch.Tensor | None, rope_cs):
        x, h = self._norm1(p, x, f)
        y = A.attn_forward(p["attn"], h, self.cfg, causal=False, rope_cs=rope_cs)
        return self._ffn(ENCODER_SPEC, p, x, y)

    def _encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        cfg, run = self.cfg, self._layers()
        x, f = hint(enc_embeds.to(torch_dtype(cfg.dtype)), "batch", "seq", None), None
        rope_cs = self._rope(torch.arange(x.shape[1], device=x.device))
        for p in self.encoder.layers:
            x, f = run(self._encoder_layer, p, x, f, rope_cs)
        return rms_norm_add(x, f, self.encoder.final_norm, cfg.norm_eps)[1]

    def _layer(self, spec: LayerSpec, p: Any, x: torch.Tensor, f: torch.Tensor | None, rope_cs,
               enc_out: torch.Tensor | None):
        """One layer of the full-sequence (training) path: (x, f) in and out."""
        cfg = self.cfg
        x, h = self._norm1(p, x, f)
        if spec.mixer in ("attn", "attn_local"):
            y = A.attn_forward(p["attn"], h, cfg, causal=True, local=spec.mixer == "attn_local",
                               rope_cs=rope_cs)
            if enc_out is not None:
                x, y = self._cross(p, x, y, *A.cross_kv(p["cross"], enc_out, cfg), decode=False)
        elif spec.mixer == "mamba":
            y = SSM.mamba_forward(p["mamba"], h, cfg)
        else:
            forward = XL.mlstm_forward if spec.mixer == "mlstm" else XL.slstm_forward
            y = forward(p[spec.mixer], h, cfg)
        return self._ffn(spec, p, x, y)

    def _trunk(self, tokens: torch.Tensor, prefix_embeds: torch.Tensor | None = None,
               enc_embeds: torch.Tensor | None = None):
        """The stack over every position: (x, f), whose sum the final norm
        reads (an encoder-decoder encodes ``enc_embeds`` first)."""
        self._check_inputs(prefix_embeds, enc_embeds)
        run = self._layers()
        enc_out = self._encode(enc_embeds) if self.cfg.is_encdec else None
        x, f = self._embed(tokens, prefix_embeds), None
        rope_cs = self._rope(torch.arange(x.shape[1], device=x.device))
        for spec, p in zip(self.layer_specs, self.layers):
            x, f = run(self._layer, spec, p, x, f, rope_cs, enc_out)
        return x, f

    def _head(self, x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """The last add fused into the final norm, then the logits."""
        return self._logits(rms_norm_add(x, f, self.final_norm, self.cfg.norm_eps)[1])

    def forward(self, tokens: torch.Tensor, *, prefix_embeds: torch.Tensor | None = None,
                enc_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """tokens: (B, S) ids, after ``prefix_embeds`` (B, P, d) where the
        config takes a prefix; an encoder-decoder's ``enc_embeds`` (B, Se, d).
        Returns the logits at every position (B, P + S, V), differentiably."""
        return self._head(*self._trunk(tokens, prefix_embeds, enc_embeds))

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """enc_embeds: (B, Se, d) frame embeddings, cast to the model's dtype.
        The encoder stack, bidirectional with RoPE, then its final norm (fused
        with the last layer's add). Returns the encoder output (B, Se, d)."""
        return self._encode(enc_embeds)

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, prefix_embeds: torch.Tensor | None = None,
                enc_embeds: torch.Tensor | None = None, tracer=None):
        """tokens: (B, S) ids, after ``prefix_embeds`` (B, P, d) where the
        config takes a prefix; an encoder-decoder also takes ``enc_embeds``
        (B, Se, d), which it encodes first. Returns (last-position logits (B,
        1, V), caches holding the P + S positions (a local layer's last W, as
        a ring), the recurrent layers' states and the Se frames' cross K/V).
        ``tracer``: the regions of the module docstring."""
        cfg = self.cfg
        region = no_region if tracer is None else tracer.region
        self._check_inputs(prefix_embeds, enc_embeds)
        enc_out = self._encode(enc_embeds) if cfg.is_encdec else None
        x, f = self._embed(tokens, prefix_embeds), None
        rope_cs = self._rope(torch.arange(x.shape[1], device=x.device))
        P = len(cfg.superblock)
        parts: list[dict[str, list[torch.Tensor]]] = [{} for _ in range(P)]
        for n, (spec, p) in enumerate(zip(self.layer_specs, self.layers)):
            mixer, ffn = self._region_names[n]
            with region(mixer):
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
            with region(ffn):
                x, f = self._ffn(spec, p, x, y)
        caches = tuple({name: torch.stack(leaves) for name, leaves in part.items()}
                       for part in parts)
        with region("lm.head"):
            last = x[:, -1:, :] + f[:, -1:, :]  # the final norm reads only the last position
            logits = self._logits(rms_norm(last, self.final_norm, cfg.norm_eps))
        return logits, caches

    def _mix(self, n: int, x: torch.Tensor, h: torch.Tensor, caches: tuple, pos: int,
             rope_cs):
        """Layer n's mixer at decode over norm1's output h: (x, y). Writes
        the layer's cache in place (an attention layer's slot ``pos``, a
        recurrent layer's states); an encoder-decoder's attention adds its
        cross-attention branch."""
        cfg, spec, p = self.cfg, self.layer_specs[n], self.layers[n]
        P = len(cfg.superblock)
        layer_cache = {name: leaf[n // P] for name, leaf in caches[n % P].items()}
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
        return x, y

    def _range_of(self, piece: DG.Piece) -> tuple[str | None, int]:
        """(the profiler range an eager decode step runs ``piece`` in, None
        for none; its layer)."""
        if piece.layer < 0:
            return ("lm.head" if piece.kind == "head" else None), -1
        mixer, ffn = self._region_names[piece.layer]
        return (mixer if piece.kind in ("norm1", "mixer") else ffn), piece.layer

    def _decode_piece(self, piece: DG.Piece, s: dict, caches: tuple, pos: int,
                      rope_cs) -> None:
        """Run one piece of the decode step (``decode_graph.decode_pieces``)
        on the step's state ``s``, a dict of the tensors live between pieces
        ("token"; "x" and "f", "h", "y", "probs", "idx"; "logits"), taking
        what it reads and putting what it makes."""
        kind, n = piece
        cfg = self.cfg
        if kind == "embed":
            s["x"] = self._embed(s.pop("token"))
            return
        if kind == "head":
            s["logits"] = self._head(s.pop("x"), s.pop("f"))
            return
        spec, p = self.layer_specs[n], self.layers[n]
        if kind == "norm1":
            s["x"], s["h"] = self._norm1(p, s["x"], s.pop("f", None))
        elif kind == "mixer":
            s["x"], s["y"] = self._mix(n, s["x"], s.pop("h"), caches, pos, rope_cs)
            if spec.ffn == "none":
                s["x"], s["f"] = self._ffn(spec, p, s["x"], s.pop("y"))
        elif kind == "ffn":
            s["x"], s["f"] = self._ffn(spec, p, s["x"], s.pop("y"))
        elif kind == "norm2":
            s["x"], s["h"] = rms_norm_add(s["x"], s.pop("y"), p["norm2"], cfg.norm_eps)
        elif kind == "route":
            s["probs"], s["idx"] = M.route(p["moe"], M.moe_groups(s["h"], cfg), cfg)
        else:
            s["x"], s["f"] = self._ffn_out(spec, p, s["x"], s.pop("h"),
                                           (s.pop("probs"), s.pop("idx")))

    @torch.inference_mode()
    def capture_decode(self, caches: tuple) -> DG.DecodeGraphs:
        """Capture ``decode_step`` against ``caches`` on the card as CUDA
        graphs (``decode_graph.DecodeGraphs``). Later calls with these caches
        replay them; they replace any graphs captured before. Nothing runs.
        The graphs read the parameters' storage as it is now: ``.to()`` and
        the like drop them (``_apply``), and code that swaps a parameter's
        ``.data`` must set ``_decode_graphs`` to None."""
        if self.device.type != "cuda":
            raise ValueError(f"decode graphs are CUDA graphs; the model is on {self.device}")
        if current_rules() is not None:
            raise ValueError("decode graphs are not captured under sharding rules")
        self._decode_graphs = None
        self._decode_graphs = DG.DecodeGraphs(self, caches)
        return self._decode_graphs

    def _apply(self, fn, *args, **kwargs):
        self._decode_graphs = None  # new storage for the parameters the graphs read
        return super()._apply(fn, *args, **kwargs)

    @torch.inference_mode()
    def decode_step(self, token: torch.Tensor, pos: int, caches: tuple, *, tracer=None):
        """token: (B, 1) ids; pos: the absolute position shared by the batch.
        Writes position ``pos`` of the attention caches (slot pos % W of a
        ring) and the new recurrent states into ``caches`` in place and
        returns (logits (B, 1, V), caches); cross caches are only read.
        Replays the graphs of ``capture_decode`` where ``decode_graph.engages``
        (counted in ``decode_graph_steps``), else runs eagerly (on the card,
        counted in ``decode_eager_steps``). ``tracer``: the regions of the
        module docstring; a replayed step names each graph ``lm.graph`` and
        its eager pieces ``lm.mixer.<mixer>``, ``lm.moe.route``, ``lm.head``."""
        region = no_region if tracer is None else tracer.region
        pos = int(pos)
        if DG.engages(self._decode_graphs, token, caches):
            self.decode_graph_steps += 1
            return self._decode_graphs.run(self, token, pos, caches, region), caches
        if token.device.type == "cuda":
            self.decode_eager_steps += 1
        rope_cs = self._rope_at(pos, token.device)
        s = {"token": token}
        for name, pieces in self._decode_ranges:
            with (no_region if name is None else region)(name):
                for piece in pieces:
                    self._decode_piece(piece, s, caches, pos, rope_cs)
        return s["logits"], caches


def loss_fn(model: LM, batch: dict) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy with an fp32 log-sum-exp, plus the z-loss
    1e-4 * lse^2, averaged over ``batch["loss_mask"]``; the reference's
    ``loss_fn``. The batch holds "tokens", "targets", "loss_mask" (B, S) and
    "prefix_embeds" or "enc_embeds" where the config takes them. Prefix
    positions carry no targets: the head runs on the last S positions only
    (it is per position, so their logits are those of ``forward``). Returns
    (loss, {"loss", "nll", "tokens"})."""
    x, f = model._trunk(batch["tokens"], batch.get("prefix_embeds"), batch.get("enc_embeds"))
    targets = batch["targets"]
    S = targets.shape[1]
    if x.shape[1] != S:
        x, f = x[:, -S:].contiguous(), f[:, -S:].contiguous()
    lf = model._head(x, f).float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])  # (B, S, 1)
    del lf
    # subtracted before the trailing dim goes: a vocab-sharded DTensor's
    # gather result cannot be reduced once that dim is indexed away
    nll = (lse[..., None] - gold)[..., 0]
    mask = batch["loss_mask"].float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = torch.sum((nll + 1e-4 * lse**2) * mask) / denom
    return loss, {"loss": loss, "nll": torch.sum(nll * mask) / denom, "tokens": mask.sum()}
