"""Useful model FLOPs finished in the window over the bf16 peak times the window."""
from portbench.derive import mfu_pct


def read(run):
    return mfu_pct(run)
