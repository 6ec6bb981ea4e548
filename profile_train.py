#!/usr/bin/env python3
"""Where the device time goes when the port trains on one GPU.

Run from the root of a checkout on a machine with a CUDA card::

    python3 profile_train.py [--model granite-3-8b] [--steps 3] [--out DIR]

It runs one of ``chip_smoke.py``'s training runs (``--model``: granite-3-8b,
zamba2-7b, mixtral-8x7b, deepseek-v2-236b, qwen2-vl-7b, rwkv6-1.6b or
seamless-m4t-large-v2, at full width and
``chip_smoke.TRAIN_LAYERS_OF`` layers with ``chip_smoke.TRAIN_OPTIMIZER``;
seq 2048, global batch 8 or as ``chip_smoke.TRAIN_SHAPE_OF`` says, remat
"minimal", bf16 compute, fp32 params; random weights from its seed) through
``train()`` under ``torch.profiler``, with the loop's marker regions
(``data_wait``, ``train_step``) as trace annotations.  From the Chrome
trace (written gzipped to ``<out>/profile_train_<model>.json.gz``, by
default under the gitignored ``build/profiles``) it prints the last
``train_step``'s wall seconds, device-busy seconds (union of kernel
intervals), the device's idle share, and kernel time by class (the port's
kernels by name -- the SSD scan's forward and backward kernels each a class
of their own --, matrix products, the rest) and by the ten costliest
kernels; and the step times of every step, traced.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke  # also puts the checkout's src/ on sys.path
from chip_smoke import ROOT
from profile_serve import Annotations, breakdown
from repro_torch.configs import TrainConfig, get_config
from repro_torch.train.loop import train


class AnnotatingRecorder(chip_smoke.Recorder):
    """The loop's usermetric hook, its marker regions as annotations."""

    @property
    def markers(self):
        return Annotations()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default=chip_smoke.TRAIN_MODEL,
                    choices=sorted(chip_smoke.TRAIN_LAYERS_OF))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profiles"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: CUDA is not available", file=sys.stderr)
        return 1
    print(f"gpu: {chip_smoke.gpu_line()}; torch {torch.__version__}",
          flush=True)
    cfg = dataclasses.replace(
        get_config(args.model),
        num_layers=chip_smoke.TRAIN_LAYERS_OF[args.model])
    tcfg = TrainConfig(total_steps=args.steps,
                       optimizer=chip_smoke.TRAIN_OPTIMIZER[args.model],
                       remat_policy="minimal", seed=chip_smoke.SEED)
    shape = chip_smoke.TRAIN_SHAPE_OF.get(args.model, chip_smoke.TRAIN_SHAPE)
    stack = chip_smoke.RecorderStack()
    stack.um = AnnotatingRecorder()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train(cfg, tcfg, shape, stack=stack,
              job_id="profile-train")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"profile_train_{args.model}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
        g.write(f.read())
    os.remove(path)
    print("traced: " + json.dumps({
        "model": cfg.name, "layers": cfg.num_layers,
        "tokens_per_step": shape.global_batch * shape.seq_len,
        "step_times_s": [s["step_time_s"] for s in stack.agent.steps]}),
        flush=True)
    for phase, row in breakdown(trace, prefix="train_step").items():
        print(f"breakdown {phase}: {json.dumps(row)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
