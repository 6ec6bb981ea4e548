"""End-to-end run of the PyTorch port: train the lms-demo config
(47.8M parameters) for a few hundred steps on the CUDA card, monitored by a
stack that runs in another process, with a checkpoint every 20 steps and
(optionally) an injected failure and an automatic restart.

Start a stack with its HTTP face first (``repro.core``, in its own
process; see the README), then:

    PYTHONPATH=src python examples/train_monitored_torch.py --lms-url URL
    PYTHONPATH=src python examples/train_monitored_torch.py --lms-url URL \\
        --steps 60 --inject-failure 30     # crash at 30, resume from 20

``--smoke --device cpu --peak-flops F --hbm-bw B`` runs the reduced config
on the CPU.  At the end it prints a ``summary:`` JSON line (median step
wall time, tokens/s, MFU against the peak, peak device memory, and what the
client posted: requests, points, bytes, seconds) and writes it, with the
stack's report of the job, under ``--out-dir``.
"""

import argparse
import json
import os
import statistics
import sys
import time
import uuid

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ShapeConfig, TrainConfig, get_config)
from repro_torch.core import RemoteStack  # noqa: E402
from repro_torch.launch.common import (  # noqa: E402
    add_stack_args, resolve_peaks)
from repro_torch.train.loop import InjectedFailure, train  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--inject-failure", type=int, default=None)
    ap.add_argument("--ckpt-dir", default="train_monitored_torch_ckpt")
    ap.add_argument("--out-dir", default="train_monitored_torch_out")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, for the CPU")
    add_stack_args(ap)
    args = ap.parse_args(argv)

    cfg = get_config("lms-demo", smoke=args.smoke)   # full config
    print(f"model: {cfg.name}, {cfg.param_count() / 1e6:.0f}M params")
    shape = ShapeConfig("e2e", seq_len=args.seq_len,
                        global_batch=args.batch, kind="train")
    tcfg = TrainConfig(total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 20),
                       learning_rate=6e-4, ckpt_dir=args.ckpt_dir,
                       ckpt_interval=20)
    device = resolve_device(args.device)
    peak_flops, hbm_bw, ici_bw = resolve_peaks(args, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    stack = RemoteStack(args.lms_url)
    walls = []                     # step -> wall seconds since the last
    last = {"t": None}

    def cb(step, metrics):
        now = time.monotonic()
        if last["t"] is not None and step % tcfg.ckpt_interval != 1:
            walls.append(now - last["t"])   # checkpoint steps left out
        last["t"] = now
        if step % 10 == 0 or step <= 2:
            print(f"step {step:4d}  loss {float(metrics['loss']):.4f}",
                  flush=True)

    job_id = f"e2e-torch-{uuid.uuid4().hex[:8]}"
    kw = dict(stack=stack, device=device, peak_flops=peak_flops,
              hbm_bw=hbm_bw, ici_bw=ici_bw, step_callback=cb)
    try:
        try:
            r = train(cfg, tcfg, shape, fail_at_step=args.inject_failure,
                      job_id=job_id, **kw)
        except InjectedFailure as e:
            print(f"\n-- {e}; restarting (auto-resume from checkpoint) --\n")
            last["t"] = None
            job_id += "-restart"
            r = train(cfg, tcfg, shape, job_id=job_id, **kw)
            print(f"resumed from step {r.resumed_from}")
    finally:
        stack.close()

    print(f"\nfinal loss {r.last_loss:.4f} after {r.final_step} steps")
    # the mean keeps the steps that posted; the median leaves them out
    step_s = statistics.fmean(walls) if walls else None
    tokens = shape.seq_len * shape.global_batch
    summary = {
        "model": cfg.name, "params": cfg.param_count(),
        "device": str(device), "steps": r.final_step,
        "resumed_from": r.resumed_from, "final_loss": r.last_loss,
        "step_wall_s_mean": step_s,
        "step_wall_s_median": statistics.median(walls) if walls else None,
        "client_post_s_per_step": stack.stats["seconds"] / len(walls)
        if walls else None,
        "tokens_per_s": tokens / step_s if step_s else None,
        "mfu": 6 * cfg.active_param_count() * tokens / step_s / peak_flops
        if step_s else None,
        "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9
        if device.type == "cuda" else None,
        "client": stack.stats, "findings": [f.rule for f in r.findings],
        "job": job_id}
    print(f"summary: {json.dumps(summary)}")
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"{job_id}.json")
    with open(path, "w") as f:
        json.dump({"summary": summary,
                   "report": stack.sink.report(job_id)}, f, indent=1)
    print(f"report: {stack.report_url(job_id)} (saved to {path})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
