"""Why phase 6 (e)'s bf16 qwen2-vl world misses its one-device step past
step 0: bf16's own spread, set beside the world's gap, at phase 6 (e)'s
shape (qwen2-vl-7b, 4 of 28 layers, full width, seq 2048 x batch 4,
AdamW, the loop's stub patches and positions, ``DIST_STEPS`` steps from
the seed's params).

Four runs on the same params and batches:

* ``fp32``: the one-device step in fp32 (the exact trajectory, as near as
  the card gets);
* ``bf16``: the one-device step in the config's bf16, through the kernels;
* ``bf16-plain``: the same with the plain versions swapped in (another
  rounding of the same function on one device);
* ``bf16-tp``: ``chip_smoke.py``'s ``qwen2-vl-bf16`` world, two processes
  sharing the card over gloo with sequence parallelism (rank 0's row).

For each pair, each step's relative gaps in loss, grad norm and param
norm, and step 0's gradient gap (the largest ||g - g_ref|| / ||g_ref||
over the leaves).  If the world's gap from ``bf16`` is of the size of
``bf16-plain``'s, and the world is no farther from ``fp32`` than ``bf16``
is, its miss is bf16's spread on a trajectory that amplifies it; if the
world stands clearly farther from ``fp32``, the miss is the world's own.

Run from the repository root on a machine with one H100:
``python3 tp_bf16_witness.py``; prints one ``witness:`` JSON line and
writes it to ``chiprun_out/tp_bf16_witness.json``.
"""

import dataclasses
import json
import os
import sys
import time
from contextlib import nullcontext

import torch

import chip_smoke as cs

CASE = "qwen2-vl-bf16"


def step_gaps(got: list, want: list) -> list:
    return [{k: abs(a[k] - b[k]) / abs(b[k]) for k in a}
            for a, b in zip(got, want)]


def grads_gap(got: dict, want: dict) -> float:
    def norm(t):
        return float(torch.linalg.vector_norm(t, dtype=torch.float64))
    return max(norm(got[k] - g) / norm(g) for k, g in want.items()
               if norm(g) > 0)


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_bf16_witness: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    cs.kbuild.build()
    cs.kbuild.load_library()
    cs.log(f"gpu: {cs.gpu_line()}  build {time.monotonic() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    case = cs.TP_CASES[CASE]
    cfg = cs.tp_cfg(case)
    one_cfg = cs.tp_train_cfg(case)
    runs = {}
    for name, c, swap in (
            ("fp32", dataclasses.replace(cfg, dtype="float32"),
             nullcontext),
            ("bf16", cfg, nullcontext),
            ("bf16-plain", cfg, cs.plain_kernels)):
        batches = cs.dist_batches(c, cs.TP_SHAPE, cs.DIST_STEPS, "cuda")
        with swap():
            run = cs.dist_steps(c, one_cfg, batches, None, "cuda",
                                grads=True)
        runs[name] = {"metrics": run["metrics"], "grads": run["grads"]}
        del run, batches
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    ranks = cs.tp_world(CASE, 0, "cuda", grads={
        k: runs[k]["grads"] for k in ("bf16", "fp32")})
    runs["bf16-tp"] = {"metrics": ranks[0]["metrics"]}
    pairs = {"bf16-tp vs bf16": ("bf16-tp", "bf16"),
             "bf16-plain vs bf16": ("bf16-plain", "bf16"),
             "bf16 vs fp32": ("bf16", "fp32"),
             "bf16-plain vs fp32": ("bf16-plain", "fp32"),
             "bf16-tp vs fp32": ("bf16-tp", "fp32")}
    out = {"gpu": cs.gpu_line(), "seq_parallel": case.runs[0][1],
           "world_wall_s": time.monotonic() - t0,
           "metrics": {k: r["metrics"] for k, r in runs.items()},
           "step_gaps": {p: step_gaps(runs[a]["metrics"], runs[b]["metrics"])
                         for p, (a, b) in pairs.items()},
           "step0_grads_gap": {
               "bf16-tp vs bf16": ranks[0]["grads_gap"]["bf16"],
               "bf16-tp vs fp32": ranks[0]["grads_gap"]["fp32"],
               "bf16-plain vs bf16": grads_gap(runs["bf16-plain"]["grads"],
                                               runs["bf16"]["grads"]),
               "bf16 vs fp32": grads_gap(runs["bf16"]["grads"],
                                         runs["fp32"]["grads"]),
               "bf16-plain vs fp32": grads_gap(runs["bf16-plain"]["grads"],
                                               runs["fp32"]["grads"])},
           "limits": cs.TRAIN_TOL}
    line = json.dumps(out)
    cs.log(f"witness: {line}")
    os.makedirs(os.path.join(cs.ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(cs.ROOT, "chiprun_out", "tp_bf16_witness.json"),
              "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
