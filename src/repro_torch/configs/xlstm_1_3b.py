"""xLSTM-1.3B [arXiv:2405.04517; unverified]. sLSTM + mLSTM recurrent blocks.

48 blocks as 6 x (1 sLSTM + 7 mLSTM) following the paper's a:b block-ratio
notation; blocks carry their own up/down projections (d_ff=0 -> no separate
FFN). O(1) recurrent state -> long_500k runs.
"""
from .base import LayerSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm_1_3b",
    family="ssm",
    d_model=2048, num_heads=4, num_kv_heads=4, head_dim=512,
    d_ff=0, vocab_size=50304,
    superblock=(
        LayerSpec("slstm", "none"),
        LayerSpec("mlstm", "none"), LayerSpec("mlstm", "none"),
        LayerSpec("mlstm", "none"), LayerSpec("mlstm", "none"),
        LayerSpec("mlstm", "none"), LayerSpec("mlstm", "none"),
        LayerSpec("mlstm", "none"),
    ),
    num_superblocks=6,
    rope=False,
    grad_accum=2,
    service_model="mm1",  # length-dependent recurrence: the paper's RNN case
    supports_long_context=True,
    notes="48 blocks = 6 x (sLSTM + 7 mLSTM); constant-size recurrent state.",
))
