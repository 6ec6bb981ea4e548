"""The card's idle share over the traced steps of a training window: one
minus the union of device operations' intervals over the traced window
(``torch.profiler``)."""

UNIT = "%"


def read(run: dict):
    t = run.get("trace")
    if run.get("kind") != "train" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
