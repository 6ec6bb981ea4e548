"""The 90th percentile of time to first token over every request due in
the window (open loop): the driver's clock when the batch's first tokens
are on the host, minus the time the request was due.  A request that
failed counts as never served (infinite)."""

import numpy as np

UNIT = "s"


def read(run: dict):
    if run.get("kind") != "serve" or not run["ttft_s"]:
        return None
    return float(np.percentile(np.asarray(run["ttft_s"], float), 90))
