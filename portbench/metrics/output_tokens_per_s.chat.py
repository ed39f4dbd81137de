"""Output tokens stamped inside the window over its seconds (in a traced run,
the window up to its profiled stretch)."""
from portbench.derive import tokens_per_s


def read(run):
    return tokens_per_s(run)
