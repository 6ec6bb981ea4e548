"""The monitoring client's cost: seconds the job's ``RemoteStack`` spent
posting points to the receiver (its ``stats["seconds"]``) over the steps
of the per-layer span, per step, in ms."""

UNIT = "ms"


def read(run: dict):
    span = run.get("span")
    if run.get("kind") != "train" or not span or not span["steps"]:
        return None
    return 1e3 * span["post_s"] / span["steps"]
