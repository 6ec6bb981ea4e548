#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` and print its result.

From the root of a checkout, on a machine with the cards the cell asks for::

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; the traffic's ``kind`` picks the driver.  The run makes its
weights and inputs from ``--seed``, warms up, measures for ``--seconds``,
checks what the timed path produced against the plain fp32 reference
(``reference/``) under the cell's limits (``limits/<cell>.json``), and
prints one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, ``setup_phases`` (the
seconds of each phase of set-up, also on standard error), and last
``checks``, each number compared beside its limit (also the last lines of
standard error).
Without a CUDA card, or with a forbidden module loaded (``jax``,
``jaxlib``, ``flax``, ``repro``), it prints no result and exits with 1.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chipbench import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    common.set_cache_dirs()
    bench = common.benchmark()
    cell = common.cell(args.workload, bench)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"run: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 1
    cfg_file = common.config_file(cell["config"], bench)
    traffic = common.traffic_file(cell["traffic"])
    limits = common.limits_file(cell["name"])
    if traffic["kind"] == "train":
        from chipbench import train_driver as driver
    elif traffic["kind"] == "serve":
        from chipbench import serve_driver as driver
    else:
        print(f"run: no driver for traffic kind {traffic['kind']!r}",
              file=sys.stderr)
        return 1

    got = driver.run(cell, cfg_file, traffic, seed=args.seed,
                     seconds=args.seconds, trace=bool(args.trace),
                     t_process=T_PROCESS)
    run = got["run"]
    metrics = common.read_metrics(cell["name"], bench, bool(args.trace), run)
    device = common.device_block(torch, cell["chips"],
                                 got["memory_peak_bytes"])
    result = {"correct": None, "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics, "device": device}
    if args.trace:
        t = run["trace"]
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    checked = driver.check(cfg_file, traffic, args.seed, got, "cuda")
    ok, checks = common.checks_block(checked["gaps"], limits)
    result["correct"] = ok
    if not ok:
        print(f"run: outside the limits; worst "
              f"{checked.get('worst') or checked['gaps'].get('worst')}",
              file=sys.stderr)
    loaded = common.forbidden_modules()
    if loaded:
        print(f"run: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 1
    result["setup_phases"] = run["setup_phases"]
    print(f"run: set-up phases (s): {run['setup_phases']}", file=sys.stderr)
    common.print_result(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
