"""InternVL2-1B backbone [arXiv:2404.16821; hf]. InternLM2 decoder; ViT stub.

The InternViT frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, prefix, d_model) prepended to the token sequence.
"""
from .base import LayerSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2_1b",
    family="vlm",
    d_model=896, num_heads=14, num_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151655,
    superblock=(LayerSpec("attn", "mlp"),), num_superblocks=24,
    prefix_embed=True, prefix_len_fraction=1.0 / 16.0,
    rope=True,
    service_model="mm1",
    supports_long_context=False,
    notes="24L GQA kv=2; 1/16 of seq is stubbed patch-embedding prefix.",
))
