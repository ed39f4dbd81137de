"""p95 of due time -> response over every request due in the window."""
from portbench.derive import due_to_done_p95_ms


def read(run):
    return due_to_done_p95_ms(run)
