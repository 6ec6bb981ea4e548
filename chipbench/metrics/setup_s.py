"""Set-up: from process start to the start of the window (CUDA start, the
kernel library, weights and state from the seed, the receiver, the set-up
units of work).  Host clock."""

UNIT = "s"


def read(run: dict):
    return run.get("setup_s")
