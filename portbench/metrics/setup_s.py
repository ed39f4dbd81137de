"""Process start to the window's opening: imports, the kernels' build (the first
run of a checkout), the weights drawn on the card, the warm-up."""


def read(run):
    return run.setup_s
