"""Gemma2-9B [arXiv:2408.00118; hf]. Local/global alternating attention + softcaps."""
from .base import LayerSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2_9b",
    family="dense",
    d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    # 42 layers = 21 x (local, global)
    superblock=(LayerSpec("attn_local", "mlp"), LayerSpec("attn", "mlp")),
    num_superblocks=21,
    rope=True, window_size=4096,
    mlp_act="gelu",
    attn_softcap=50.0, final_softcap=30.0,
    tie_embeddings=True,
    grad_accum=2,
    service_model="mm1",
    # half the stack is window-4096; global layers keep full KV (DESIGN.md S4)
    supports_long_context=True,
    notes="42L alternating local(4096)/global attention; attn softcap 50, final 30.",
))
