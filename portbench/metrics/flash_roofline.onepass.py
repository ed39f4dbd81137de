"""The flash-attention forward kernel's share of its roofline over the profiled
stretch: the bound of every launch over their device time."""
from portbench.derive import flash_roofline_pct

KERNEL = "flash_attention_kernel"


def read(run):
    return flash_roofline_pct(run, KERNEL)
