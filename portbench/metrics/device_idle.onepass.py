"""Share of the profiled stretch in which no operation ran on the card."""
from portbench.derive import idle_pct


def read(run):
    return idle_pct(run)
