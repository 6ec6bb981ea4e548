"""Serving entry point: ``python -m repro_torch.launch.serve --arch lms-demo
--lms-url http://HOST:PORT``.

Random-inits the weights from seed 0 (or restores them from a training
checkpoint, ``--ckpt-dir``), records the device's peaks on the stack,
serves a synthetic workload (``default_rng(0)``, prompts of 4-16 tokens)
through a monitored ``ServingEngine`` on one device (the CUDA card unless
``--device cpu``), and prints TTFT p50 and latency p50 / p99, what the
client posted and the URL of the job's report on the stack.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch import resolve_device
from repro_torch.ckpt import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import RemoteStack, calibrate
from repro_torch.launch.common import (
    add_stack_args, resolve_peaks)
from repro_torch.models.transformer import init_model_params
from repro_torch.serve.engine import ServingEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro-torch-serve")
    ap.add_argument("--arch", default="lms-demo")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable; head dim 16 has no "
                         "flash instance on the card)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="",
                    help="restore weights from a training checkpoint")
    add_stack_args(ap)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    peak_flops, hbm_bw, _ = resolve_peaks(args, device)
    params = init_model_params(cfg, seed=0, device=device)
    if args.ckpt_dir:
        step, out = load_checkpoint(args.ckpt_dir, {"params": params})
        params = out["params"]
        print(f"restored weights from step {step}")

    stack = RemoteStack(args.lms_url)
    rng = np.random.default_rng(0)
    job_id = f"serve-{cfg.name}"
    try:
        with stack.job(job_id, user="server", hosts=["host0"],
                       tags={"arch": cfg.name}):
            um = stack.usermetric(host="host0")
            calibrate(um, peak_flops, hbm_bw)
            eng = ServingEngine(cfg, params, max_batch=args.max_batch,
                                max_len=args.max_len, usermetric=um,
                                device=device)
            for _ in range(args.requests):
                plen = int(rng.integers(4, 17))
                eng.submit(rng.integers(1, cfg.vocab_size, plen),
                           max_new_tokens=args.max_new_tokens)
            done = eng.run_until_empty()
            um.flush()
    finally:
        stack.close()

    lat = [r.finished_at - r.submitted_at for r in done]
    ttft = [r.first_token_at - r.submitted_at for r in done]
    print(f"served {len(done)} requests | "
          f"ttft p50 {np.percentile(ttft, 50) * 1e3:.1f}ms | "
          f"latency p50 {np.percentile(lat, 50) * 1e3:.1f}ms "
          f"p99 {np.percentile(lat, 99) * 1e3:.1f}ms")
    print(f"client: {json.dumps(stack.stats)}")
    print(f"job: {job_id} report: {stack.report_url(job_id)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
