"""Mean decode-step service (the engine's service log) over the window."""
from portbench.derive import mean_service_ms


def read(run):
    return mean_service_ms(run, "decode")
