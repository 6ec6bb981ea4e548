"""The card's idle share over the traced batches of a serving window: one
minus the union of device operations' intervals over the traced span
(``torch.profiler``)."""

UNIT = "%"


def read(run: dict):
    t = run.get("trace")
    if run.get("kind") != "serve" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
