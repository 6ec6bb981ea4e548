#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from.

From the root of a checkout, on a machine with a CUDA card::

    python3 chipbench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control 3] [--faults 3] [--seconds 15] [--requests 24]

For each seed, in one process.  A training cell: the job through its
set-up steps (the same driver and wrapper as ``run.py``, no window), the
fp32 reference of those steps, and the numbers compared
(``reference.train.gaps``); on the first ``--control`` seeds also the
control, the reference in fp8 put in the program's place, and on the first
``--faults`` seeds the job with each fault planted underneath (half of the
batch left out; every input token altered).  A serving cell: a short window
of ``--seconds`` at the cell's own load (a backlog cut to ``--requests``
requests, so few are left to serve after it), then the same sample a run
compares (``serve_driver.check``), and on the first ``--control`` seeds the
control's gaps at the same positions.  One JSON line a reading, each
with the verdict a run would give it: ``correct`` from the harness's own
comparison (``common.checks_block``) under the cell's limits
(``limits/<cell>.json``), beside every number and its limit.  Then a
summary line: the largest of the program's readings, the smallest of the
control's and of each fault's, and for each kind of reading how many
came out correct.  Every program reading should, and no control or fault
reading.  ``run.py`` does none of this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chipbench import common  # noqa: E402

NUMBERS = ("loss", "grad", "change")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--requests", type=int, default=0,
                    help="a backlog's requests (0: the mix's own)")
    args = ap.parse_args(argv)
    common.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 1
    from chipbench import train_driver as driver
    bench = common.benchmark()
    cell = common.cell(args.workload, bench)
    cfg_file = common.config_file(cell["config"], bench)
    traffic = common.traffic_file(cell["traffic"])
    if args.requests and "requests" in traffic:
        traffic["requests"] = args.requests
    limits = common.limits_file(cell["name"])
    seeds = [int(s) for s in args.seeds.split(",")]
    worst, verdicts = {}, {}
    numbers = NUMBERS if traffic["kind"] == "train" else ("token_gap",)

    def note(kind, seed, gaps, **extra):
        row = {k: gaps[k] for k in numbers}
        ok, checks = common.checks_block(gaps, limits)
        print(json.dumps({"kind": kind, "seed": seed, **row,
                          "correct": ok, "checks": checks, **extra}),
              flush=True)
        pick = max if kind == "program" else min
        for k in numbers:
            key = (kind, k)
            worst[key] = pick(worst.get(key, row[k]), row[k])
        n_ok, n = verdicts.get(kind, (0, 0))
        verdicts[kind] = (n_ok + ok, n + 1)

    if traffic["kind"] == "serve":
        from chipbench import serve_driver
        for i, seed in enumerate(seeds):
            got = serve_driver.run(cell, cfg_file, traffic, seed=seed,
                                   seconds=args.seconds, trace=False)
            ck = serve_driver.check(cfg_file, traffic, seed, got, "cuda")
            note("program", seed, ck["gaps"], requests=ck["requests"],
                 tokens=ck["tokens"], worst=ck["worst"])
            if i < args.control:
                ck = serve_driver.check(cfg_file, traffic, seed, got,
                                        "cuda", control=True)
                note("control", seed, ck["gaps"], worst=ck["worst"])
            del got
            torch.cuda.empty_cache()
        seeds = []
    for i, seed in enumerate(seeds):
        got = driver.run(cell, cfg_file, traffic, seed=seed, seconds=0,
                         trace=False, window=False)
        checked = driver.check(cfg_file, traffic, seed, got, "cuda")
        ref = checked["ref"]
        note("program", seed, checked["gaps"],
             worst=checked["gaps"]["worst"])
        print(json.dumps({"kind": "losses", "seed": seed,
                          "program": got["losses"],
                          "reference": ref["losses"]}), flush=True)
        if i < args.control:
            ctl = driver.rtrain.follow(cfg_file["port"], traffic, seed,
                                       traffic["set_up_steps"], "cuda",
                                       fp8=True)
            note("control", seed, driver.rtrain.gaps(ctl, ref))
            del ctl
        if i < args.faults:
            for fault in ("half_batch", "tokens"):
                bad = driver.run(cell, cfg_file, traffic, seed=seed,
                                 seconds=0, trace=False, window=False,
                                 fault=fault)
                note(fault, seed, driver.rtrain.gaps(bad, ref))
        del got, checked, ref
        torch.cuda.empty_cache()
    print(json.dumps({"summary": {f"{k}.{n}": v for (k, n), v in
                                  sorted(worst.items())},
                      "correct": {k: f"{a} of {n}" for k, (a, n) in
                                  sorted(verdicts.items())}}), flush=True)
    loaded = common.forbidden_modules()
    if loaded:
        print(f"readings: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
