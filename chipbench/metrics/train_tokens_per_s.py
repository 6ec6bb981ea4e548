"""Tokens trained over the window by the monitored job: the window's steps
times the tokens of a step, over the window's seconds (host clock, from the
end of the last set-up step to the end of the last step)."""

UNIT = "tokens/s"


def read(run: dict):
    if run.get("kind") != "train":
        return None
    return run["window_steps"] * run["tokens_per_step"] / run["window_s"]
