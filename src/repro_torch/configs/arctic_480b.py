"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base]. Dense-MoE hybrid.

128 experts top-2 with a parallel dense residual MLP on every layer
("moe_dense" ffn kind).
"""
from .base import LayerSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic_480b",
    family="moe",
    d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000,
    superblock=(LayerSpec("attn", "moe_dense"),), num_superblocks=35,
    num_experts=128, num_experts_per_tok=2, capacity_factor=1.25,
    rope=True,
    optimizer="adafactor",  # fp32 AdamW state (5.6 TB) exceeds pod HBM (4 TB)
    grad_accum=4, grad_dtype="bfloat16",  # fp32 grad buffer alone is 7.3 GiB/chip
    service_model="mm1",
    supports_long_context=False,
    notes="35L; MoE-128 top-2 + dense residual MLP in parallel per layer.",
))
