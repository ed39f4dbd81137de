"""Jamba-v0.1 52B [arXiv:2403.19887; hf]. Mamba+attention 1:7 interleave + MoE.

Period-8 superblock with attention at index 4 and MoE on odd layers (16
experts top-2), matching the published Jamba block layout. Attention layers
use no positional embedding (NoPE) as in the paper. KV state exists only on
the 4 attention layers -> long_500k runs.
"""
from .base import LayerSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba_v0_1_52b",
    family="hybrid",
    d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    superblock=(
        LayerSpec("mamba", "mlp"), LayerSpec("mamba", "moe"),
        LayerSpec("mamba", "mlp"), LayerSpec("mamba", "moe"),
        LayerSpec("attn", "mlp"), LayerSpec("mamba", "moe"),
        LayerSpec("mamba", "mlp"), LayerSpec("mamba", "moe"),
    ),
    num_superblocks=4,
    num_experts=16, num_experts_per_tok=2, capacity_factor=1.25,
    rope=False,  # Jamba uses NoPE on its attention layers
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    grad_accum=8,  # measured: temp 18.7 GiB at accum 4 -> 13.6 at 8 (fits 16 GiB HBM)
    service_model="mm1",
    supports_long_context=True,
    notes="32L = 4 x 8(1 attn : 7 mamba, MoE every other layer).",
))
