"""Hardware constants for roofline analysis and service-time estimates.

``H100_SXM`` is the card the port runs on. ``TPU_V5E``, ``DEVICE_TIER_V5E_1``
and ``CLIENT_NPU`` are copies of the JAX package's constants (the reference's
target chip and its benchmark's client NPU), kept so that a roofline built at
the reference's default spec reads the same in both packages. They are data
sheet figures, not measurements.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["HardwareSpec", "TPU_V5E", "DEVICE_TIER_V5E_1", "CLIENT_NPU", "H100_SXM"]


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float  # bf16 FLOP/s per chip
    hbm_bw: float  # bytes/s per chip
    ici_bw: float  # bytes/s per link
    hbm_bytes: float  # capacity per chip
    dcn_bw: float = 25e9  # bytes/s per host, cross-pod (pod axis)


TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    hbm_bytes=16 * 1024**3,
)

# Tiers for the paper's device/edge instantiation:
DEVICE_TIER_V5E_1 = TPU_V5E  # "device" = one v5e chip
CLIENT_NPU = HardwareSpec(  # a phone/laptop-class NPU for benchmarks
    name="client_npu",
    peak_flops=10e12,
    hbm_bw=100e9,
    ici_bw=0.0,
    hbm_bytes=8 * 1024**3,
)

# NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet): 989 TFLOP/s
# dense bf16, 3.35 TB/s HBM3, 80 GB. The inter-chip link is NVLink 4, 900 GB/s
# in both directions together, so 450 GB/s per direction (same data sheet);
# no one-card path reads it.
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    hbm_bytes=80e9,
)
