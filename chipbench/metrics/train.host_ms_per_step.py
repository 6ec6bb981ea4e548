"""The training loop's time outside its timed step, per step, in ms: the
per-layer span's seconds minus the step times the host agent posted and
the receiver decoded (``step_time_s``), over its steps.  Data, posts,
``/alerts`` polls and the loop's own work."""

import math

UNIT = "ms"


def read(run: dict):
    span = run.get("span")
    if run.get("kind") != "train" or not span or not span["steps"] \
            or not math.isfinite(span["step_time_s"]):
        return None
    return 1e3 * (span["seconds"] - span["step_time_s"]) / span["steps"]
