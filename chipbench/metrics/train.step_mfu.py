"""The train step's share of the card's peak: 6 N T per step, with N the
benchmark's own count of the parameters a token is multiplied by
(``costs.flop_params``) and T the step's tokens, over the step times the
host agent posted for the per-layer span, over the peak bf16 FLOP/s."""

import math

from chipbench import costs

UNIT = "%"


def read(run: dict):
    span = run.get("span")
    if run.get("kind") != "train" or not span or not span["steps"] \
            or not math.isfinite(span["step_time_s"]):
        return None
    flops = 6.0 * costs.flop_params(run["port"]) * run["tokens_per_step"]
    return 100.0 * flops * span["steps"] / span["step_time_s"] \
        / run["peaks"]["flops"]
