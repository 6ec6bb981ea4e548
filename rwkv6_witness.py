"""Whether rwkv6's tensor-parallel world at seq 2048 x batch 2 missed its
one-device step (its step-2 grad norm 2.7e-2 off, against TRAIN_TOL's
1e-2, on an H100) because the trajectory amplifies a change in summation
order: the one-device step alone, in two orders, at two learning rates.

The runs are ``chip_smoke.py``'s phase 6 (e) rwkv6 case as it stood then
(rwkv6-1.6b, all 24 layers, fp32, AdamW, 3 steps from the seed's params
and batches) at seq 2048 x batch 2 on one device:

* ``m1``: the whole batch in one pass (the one-device step the world was
  held to);
* ``m2``: two microbatches of one row, their gradients summed (the same
  function, its sums in another order: each row's products on their own,
  the gradient a sum of two);

each at phase 6's learning rate (1e-3, no warmup: the run whose loss
jumped from 11.55 to 22.95 at step 1) and at 1e-4.  For each pair, each
step's relative gaps in loss, grad norm and param norm.  If ``m2`` stands
as far from ``m1`` at 1e-3 as the world did (past TRAIN_TOL) and close at
1e-4, where the loss does not jump, the world's miss is rounding that the
diverging trajectory amplifies, by design; if the orders agree at 1e-3,
the miss is the world's own fault.

Run from the repository root on a machine with one H100:
``python3 rwkv6_witness.py``; prints one ``witness:`` JSON line and writes
it to ``chiprun_out/rwkv6_witness.json``.
"""

import dataclasses
import json
import os
import sys
import time

import torch

import chip_smoke as cs

CASE = "rwkv6"
SHAPE = cs.ShapeConfig("tp_2k_b2", seq_len=2048, global_batch=2,
                       kind="train")
LAYERS, STEPS = 24, 3
RATES = (1e-3, 1e-4)
ORDERS = {"m1": 1, "m2": 2}


def step_gaps(a: list, b: list) -> list:
    """Each step's |a - b| / |b| by metric."""
    return [{k: abs(x[k] - y[k]) / abs(y[k]) for k in x}
            for x, y in zip(a, b)]


def main() -> int:
    if not torch.cuda.is_available():
        print("rwkv6_witness: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    cs.kbuild.build()
    cs.kbuild.load_library()
    cs.log(f"gpu: {cs.gpu_line()}  build {time.monotonic() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    case = cs.TP_CASES[CASE]
    cfg = dataclasses.replace(cs.tp_cfg(case), num_layers=LAYERS)
    batches = cs.dist_batches(cfg, SHAPE, STEPS, "cuda")
    runs = {}
    for lr in RATES:
        for name, m in ORDERS.items():
            tcfg = dataclasses.replace(cs.tp_train_cfg(case),
                                       learning_rate=lr, total_steps=STEPS,
                                       num_microbatches=m)
            t0 = time.monotonic()
            run = cs.dist_steps(cfg, tcfg, batches, None, "cuda")
            runs[f"{name}@{lr:g}"] = {"metrics": run["metrics"],
                                      "step_s": run["step_s"],
                                      "wall_s": time.monotonic() - t0}
            del run
            torch.cuda.empty_cache()
    out = {"gpu": cs.gpu_line(), "model": case.model,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "seq_len": SHAPE.seq_len, "global_batch": SHAPE.global_batch,
           "steps": STEPS, "runs": runs,
           "step_gaps": {f"m2 vs m1 @{lr:g}": step_gaps(
               runs[f"m2@{lr:g}"]["metrics"], runs[f"m1@{lr:g}"]["metrics"])
               for lr in RATES},
           "limits": cs.TRAIN_TOL}
    line = json.dumps(out)
    cs.log(f"witness: {line}")
    os.makedirs(os.path.join(cs.ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(cs.ROOT, "chiprun_out", "rwkv6_witness.json"),
              "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
