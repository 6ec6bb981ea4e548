"""The served model's share of the card's peak: 2 N per token over the
real prompt and generated tokens of the window's untraced batches (N: the
benchmark's own count, ``costs.flop_params``), over the engine's summed
``prefill_time_s`` and ``decode_time_s``, over the peak bf16 FLOP/s."""

from chipbench import costs

UNIT = "%"


def read(run: dict):
    if run.get("kind") != "serve":
        return None
    busy = run["prefill_s"] + run["decode_s"]
    if busy <= 0:
        return None
    flops = 2.0 * costs.flop_params(run["port"]) * (
        run["real_prompt_tokens"] + run["served_tokens"])
    return 100.0 * flops / busy / run["peaks"]["flops"]
