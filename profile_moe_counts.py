#!/usr/bin/env python3
"""Does the MoE dispatch's host sync slow mixtral's decode?

Run from the root of a checkout on a machine with a CUDA card::

    python3 profile_moe_counts.py

``models.moe`` counts each expert's triples with ``torch.bincount``, which
on a CUDA tensor reads its input's max back to the host to size its output:
one host sync an MoE layer.  This serves ``chip_smoke.py``'s mixtral-8x7b
workload (16 layers, 4 prompts of 4200-6000 tokens, 16 new tokens) four
times on one set of weights, in turns: counts by ``bincount``, by a
sync-free ``scatter_add_`` (the same integers), ``scatter_add_``,
``bincount``, and prints each run's prefill and decode times and decode
rate (``moe-sync:`` lines, with the tokens served, which must agree).
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

bincount = torch.bincount


def scatter_count(x, weights=None, minlength=0):
    """``bincount(x, minlength=...)`` of a 1-D int tensor, without a sync."""
    return torch.zeros(minlength, dtype=torch.long,
                       device=x.device).scatter_add_(0, x,
                                                     torch.ones_like(x))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_moe_counts: CUDA is not available", file=sys.stderr)
        return 1
    cs.kbuild.build()
    cs.kbuild.load_library()
    print("gpu:", cs.gpu_line(), flush=True)
    cfg, prompts, max_len, max_new = cs.serve_plan("mixtral-8x7b")
    params = cs.serving_params(cfg)
    served = []
    try:
        for variant in ("bincount", "scatter", "scatter", "bincount"):
            torch.bincount = bincount if variant == "bincount" \
                else scatter_count
            rec = cs.Recorder()
            eng = ServingEngine(cfg, params, max_batch=cs.MAX_BATCH,
                                max_len=max_len, usermetric=rec, markers=rec)
            for p in prompts:
                eng.submit(p, max_new_tokens=max_new)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            served.append([r.output for r in eng.run_until_empty()])
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            pre = [f for n, f, _ in rec.metrics if n == "serve_prefill"][0]
            dec = [f for n, f, _ in rec.metrics if n == "serve_decode"][0]
            print("moe-sync: " + json.dumps({
                "variant": variant, "wall_s": wall,
                "prefill_s": pre["prefill_time_s"],
                "decode_s": dec["decode_time_s"],
                "decode_step_tokens_per_s": (dec["new_tokens"] - dec["batch"])
                / dec["decode_time_s"], "tokens": served[-1]}), flush=True)
    finally:
        torch.bincount = bincount
    if any(out != served[0] for out in served):
        print("profile_moe_counts: the variants served different tokens",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
