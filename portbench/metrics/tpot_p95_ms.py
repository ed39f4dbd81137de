"""p95 of the gaps between a request's consecutive output tokens."""
from portbench.derive import token_gap_p95_ms


def read(run):
    return token_gap_p95_ms(run)
