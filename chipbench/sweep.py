#!/usr/bin/env python3
"""The rate a serving cell's engine sustains, found once by a sweep.

From the root of a checkout, on a machine with a CUDA card::

    python3 chipbench/sweep.py --workload <cell> --rates 2,2.5,3 \\
        --seconds 40 --seed 1

One process builds the cell's weights and engine and warms it up, then
serves the cell's mix open loop at each rate in turn for ``--seconds``
(``serve_driver.serve``, as a run's window) and prints a JSON line a
rate: requests due, TTFT percentiles, how late the last batch started
after the last request was due, and the backlog (requests due but not yet
started) when the window closed.  ``run.py`` does none of this: the cell's
traffic file holds the rate chosen from it as a number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chipbench import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 1
    from chipbench import requests, serve_driver, weights
    from repro_torch.serve.engine import ServingEngine
    bench = common.benchmark()
    cell = common.cell(args.workload, bench)
    port = common.config_file(cell["config"], bench)["port"]
    mix = common.traffic_file(cell["traffic"])
    cfg = serve_driver.model_config(port)
    params = weights.make(port, args.seed, "cuda")

    class Quiet:
        markers = None

        def metric(self, name, fields, tags=None):
            pass

    um = serve_driver.StampedMetrics(Quiet())
    eng = ServingEngine(cfg, weights.nested(params),
                        max_batch=mix["max_batch"], max_len=mix["max_len"],
                        usermetric=um, device="cuda")
    for _ in range(mix["max_batch"]):
        eng.submit(np.ones(mix["prompt_max"], np.int32), mix["new_max"])
    eng.run_batch()
    for rate in (float(r) for r in args.rates.split(",")):
        plan = requests.plan(dict(mix, rate=rate), args.seed, args.seconds,
                             port["vocab_size"])
        batches = []
        state = serve_driver.serve(eng, um, plan, args.seconds, mix,
                                   batches, trace_batches=0, ops=None,
                                   t_process=0.0)
        t0, t1 = state["t_start"], state["t_end"]
        started = {rid: b["start"] for b in batches
                   for rid, _, _ in b["requests"]}
        backlog = sum(1 for p in plan if t0 + p.due_s <= t1
                      and started.get(p.rid, t1 + 1) > t1)
        run = serve_driver.readings(port, mix, plan, batches, state,
                                    {"points": []}, None,
                                    {"flops": 989e12})
        ttft = np.asarray(run["ttft_s"])
        print(json.dumps({
            "rate": rate, "requests": len(plan), "batches": len(batches),
            "window_s": t1 - t0, "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p90_s": float(np.percentile(ttft, 90)),
            "ttft_max_s": float(ttft.max()),
            "last_due_to_start_s": max(started[p.rid] - (t0 + p.due_s)
                                       for p in plan if p.rid in started),
            "backlog_at_close": backlog,
            "mean_batch": float(np.mean([len(b["requests"])
                                         for b in batches]))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
