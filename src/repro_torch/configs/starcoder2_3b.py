"""StarCoder2-3B [arXiv:2402.19173; hf]. Dense GQA decoder, RoPE."""
from .base import LayerSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2_3b",
    family="dense",
    d_model=3072, num_heads=24, num_kv_heads=2, head_dim=128,
    d_ff=12288, vocab_size=49152,
    superblock=(LayerSpec("attn", "mlp"),), num_superblocks=30,
    rope=True,
    gated_mlp=False, mlp_act="gelu",
    service_model="mm1",
    supports_long_context=False,
    notes="30L GQA kv=2; full causal attention.",
))
