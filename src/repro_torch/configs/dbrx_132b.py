"""DBRX 132B [hf:databricks/dbrx-base; unverified]. Fine-grained MoE 16e top-4."""
from .base import LayerSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="dbrx_132b",
    family="moe",
    d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    superblock=(LayerSpec("attn", "moe"),), num_superblocks=40,
    num_experts=16, num_experts_per_tok=4, capacity_factor=1.25,
    moe_group_size=1024,  # 16e x top-4 makes E*C fat; smaller groups bound the dispatch tensor
    rope=True,
    optimizer="adafactor", grad_accum=4,
    service_model="mm1",
    supports_long_context=False,
    notes="40L; MoE-16 top-4.",
))
