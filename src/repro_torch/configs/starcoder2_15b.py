"""StarCoder2-15B [arXiv:2402.19173; hf]. Dense GQA decoder, RoPE."""
from .base import LayerSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2_15b",
    family="dense",
    d_model=6144, num_heads=48, num_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152,
    superblock=(LayerSpec("attn", "mlp"),), num_superblocks=40,
    rope=True,
    grad_accum=2,
    gated_mlp=False, mlp_act="gelu",
    service_model="mm1",  # autoregressive LLM -> Lemma 3.3 formulation
    supports_long_context=False,  # pure full attention -> long_500k skipped
    notes="40L GQA kv=4; full causal attention.",
))
