"""Model configuration system.

Every assigned architecture is expressed as a ``ModelConfig`` built from a
*superblock* pattern: the smallest repeating run of layers (1 for homogeneous
stacks, 2 for gemma2's local/global alternation, 8 for jamba's mamba/attn
interleave). The model stack is ``num_superblocks`` repetitions. This is the
port's own copy of ``repro.configs``: the same data, so ``get_config`` returns
equal configurations in both packages.

Layer kinds:
  "attn"        full-causal (or bidirectional for encoders) GQA attention
  "attn_local"  sliding-window causal attention (gemma2)
  "mamba"       selective SSM (S6) token mixer
  "mlstm"       xLSTM matrix-memory cell
  "slstm"       xLSTM scalar-memory cell (recurrent gates)
Mixer is followed by "mlp", "moe", or nothing ("none", for xLSTM blocks that
have no separate FFN).
"""

from __future__ import annotations

import enum
import importlib
from dataclasses import dataclass, field, replace
from typing import Sequence

__all__ = [
    "LayerSpec",
    "ModelConfig",
    "ShapeSuite",
    "SHAPES",
    "register",
    "get_config",
    "list_configs",
    "ARCH_IDS",
]


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the superblock pattern."""

    mixer: str  # "attn" | "attn_local" | "mamba" | "mlstm" | "slstm"
    ffn: str = "mlp"  # "mlp" | "moe" | "moe_dense" (moe + parallel dense residual) | "none"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm (doc only)
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    superblock: tuple[LayerSpec, ...]
    num_superblocks: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- attention ---
    rope: bool = True
    rope_theta: float = 10_000.0
    window_size: int = 4096  # for attn_local
    attn_softcap: float = 0.0  # gemma2: 50.0 (0 disables)
    final_softcap: float = 0.0  # gemma2: 30.0
    # --- mlp ---
    gated_mlp: bool = True  # SwiGLU/GeGLU (3 mats) vs plain MLP (2 mats)
    mlp_act: str = "silu"  # "silu" | "gelu"
    # --- moe ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 2048  # tokens per dispatch group (GShard G x S split)
    # --- ssm (mamba) ---
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # --- encoder-decoder (seamless) ---
    encoder_layers: int = 0  # 0 -> decoder-only
    # --- modality frontend stub (vlm / audio) ---
    prefix_embed: bool = False  # model accepts precomputed prefix embeddings
    prefix_len_fraction: float = 0.0  # fraction of seq carried by the stub prefix
    # --- numerics / execution ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"  # "none" | "full" | "dots"
    scan_layers: bool = True  # False unrolls superblocks (roofline accounting)
    seq_chunk: int = 512  # query-chunk for the XLA flash-style attention
    unroll_attn_chunks: bool = False  # True for roofline-accounting compiles
    attn_impl: str = "xla"  # "xla" | "pallas" (TPU)
    seq_parallel: str = "auto"  # "auto" | "on" | "off" (Megatron-SP residual)
    optimizer: str = "adamw"  # "adamw" | "adafactor" (480B-class memory)
    grad_accum: int = 1  # microbatches per step (activation memory lever)
    grad_dtype: str = "float32"  # gradient accumulation dtype
    # --- paper linkage ---
    service_model: str = "md1"  # queueing formulation (md1 dense | mm1 variable)
    # --- shape policy ---
    supports_long_context: bool = False  # run long_500k?
    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the logits/embedding
        dims shard cleanly over any mesh axis (MaxText-style padding;
        151655 and 256206 are not divisible by 16)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def num_layers(self) -> int:
        return len(self.superblock) * self.num_superblocks

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def has_mixer(self, kind: str) -> bool:
        return any(l.mixer == kind for l in self.superblock)

    @property
    def attn_layers(self) -> int:
        per = sum(1 for l in self.superblock if l.mixer.startswith("attn"))
        total = per * self.num_superblocks
        if self.is_encdec:
            total += self.encoder_layers  # encoder is all attention
        return total

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 2,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=257,
            num_superblocks=min(2, self.num_superblocks),
            num_experts=4 if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            # untrained tiny routers are heavily skewed; give smoke tests
            # enough capacity that GShard dropping never fires
            capacity_factor=8.0,
            moe_group_size=32,
            window_size=8,
            mamba_d_state=4,
            mamba_d_conv=4,
            encoder_layers=2 if self.encoder_layers else 0,
            seq_chunk=16,
            grad_accum=1,
            grad_dtype="float32",
            remat="none",
            dtype="float32",
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return replace(self, **small)


@dataclass(frozen=True)
class ShapeSuite:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSuite] = {
    "train_4k": ShapeSuite("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSuite("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSuite("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSuite("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "starcoder2_15b",
    "gemma2_9b",
    "starcoder2_3b",
    "deepseek_7b",
    "seamless_m4t_large_v2",
    "internvl2_1b",
    "arctic_480b",
    "dbrx_132b",
    "xlstm_1_3b",
    "jamba_v0_1_52b",
]

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    key = cfg.name.replace("-", "_").replace(".", "_")
    _REGISTRY[key] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in _REGISTRY:
        if key in ARCH_IDS:
            importlib.import_module(f"repro_torch.configs.{key}")
        else:
            # try importing anyway (user-supplied config module)
            importlib.import_module(f"repro_torch.configs.{key}")
    return _REGISTRY[key]


def list_configs() -> list[str]:
    for arch in ARCH_IDS:
        try:
            importlib.import_module(f"repro_torch.configs.{arch}")
        except ImportError:
            pass
    return sorted(_REGISTRY)


def shape_cells(cfg: ModelConfig) -> list[ShapeSuite]:
    """The shape cells this arch runs (long_500k only for sub-quadratic archs)."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.supports_long_context:
        cells.append(SHAPES["long_500k"])
    return cells
