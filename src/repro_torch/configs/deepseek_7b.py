"""DeepSeek-7B [arXiv:2401.02954; hf]. Llama-architecture dense decoder (MHA)."""
from .base import LayerSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek_7b",
    family="dense",
    d_model=4096, num_heads=32, num_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=102400,
    superblock=(LayerSpec("attn", "mlp"),), num_superblocks=30,
    rope=True,
    service_model="mm1",
    supports_long_context=False,
    notes="30L MHA (kv=32); llama-style SwiGLU MLP.",
))
