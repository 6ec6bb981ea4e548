"""The engine's decode time per step over the window's batches: the
``decode_time_s`` of its ``serve_decode`` points, as the receiver decoded
them, over the untraced batches' decode steps (host-paced, so per-layer here)."""

UNIT = "ms"


def read(run: dict):
    if run.get("kind") != "serve" or not run["decode_steps"]:
        return None
    return 1e3 * run["decode_s"] / run["decode_steps"]
