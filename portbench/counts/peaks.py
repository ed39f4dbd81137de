"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit). A run reports the card's power limit beside them."""

HBM_BPS = 3.35e12  # bytes/s
BF16_FLOPS = 989e12  # tensor cores, dense
FP32_FLOPS = 67e12  # outside the tensor cores
