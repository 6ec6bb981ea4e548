"""Training entry point: ``python -m repro_torch.launch.train --arch lms-demo
--lms-url http://HOST:PORT``.

Runs a monitored training job on one device (the CUDA card unless
``--device cpu``) and reports it to a monitoring stack served elsewhere
over HTTP (a ``repro.core`` stack started with ``serve_http=True``):
checkpoint auto-resume, failure injection (``--fail-at-step``), the loss
every 10 steps, the findings the stack raised, what the client posted
(requests, points, bytes, seconds, failed flushes) and the URL of the
job's report on the stack.

Under ``torchrun`` with more than one rank (``WORLD_SIZE`` > 1) every rank
runs this CLI: it joins the world (NCCL on the cards, gloo with ``--device
cpu``), builds ``make_mesh_for(world, model=--tp)`` and trains on it
(``train(..., mesh=, pc=)``): data-parallel over "data", and
tensor-parallel over "model" for every family.  On one rank it builds no
mesh and says so.

``--grad-compression`` (``none``, ``int8``, ``bf16``) is the reference's:
it sets ``TrainConfig.grad_compression``, the method of the gradients'
mean over a "pod" axis, and where the mesh has a live "pod" axis the
batch binds to "data" alone (the reference's ``batch=("data",)``
override).  ``make_mesh_for`` builds ("data", "model") only, as the
reference's does, so on this CLI's own mesh the flag changes nothing.
``--overlap-flags`` is the reference's name (off by default, as there).
The reference's flag appends its compiler's TPU scheduler flags (latency
hiding, async collective fusion), so the compiled step overlaps its
collectives with compute.  Here it makes the mesh step overlap its FSDP
exchanges with compute (``train(..., overlap=True)``,
``train.step.make_train_step``): each layer's gather is issued before the
layer ahead of it computes (under remat, each recompute issues the previous
layer's), each gradient's reduce-scatter runs while the backward goes on
and is waited once it has ended; the step's bits do not change.  On one
rank there is no mesh and nothing to overlap, and the CLI says so.  Apart
from the flag, every leaf a bf16 pass casts at its uses (the matrices, the
embedding table) is gathered in bf16, half the bytes of its fp32 piece.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import uuid
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import ShapeConfig, TrainConfig, get_config
from repro_torch.core import RemoteStack
from repro_torch.launch.common import (
    add_stack_args, resolve_peaks)
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import PartitionConstraints, rules_for
from repro_torch.train.loop import train


def main(argv=None, *, step_callback: Optional[Callable] = None) -> int:
    """``step_callback(step, metrics)`` is called after each step's own
    reporting, for a program that drives the CLI."""
    ap = argparse.ArgumentParser(prog="repro-torch-train")
    ap.add_argument("--arch", default="lms-demo")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable; head dim 16 has no "
                         "flash instance on the card)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--remat", default="none",
                    choices=["none", "minimal", "full"])
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8", "bf16"])
    ap.add_argument("--overlap-flags", action="store_true",
                    help="overlap the mesh step's per-layer gathers and "
                         "gradient reduce-scatters with compute (the "
                         "reference's flag switches on its compiler's "
                         "latency-hiding scheduler); a world of more than "
                         "one rank only")
    ap.add_argument("--tp", type=int, default=0,
                    help="model-parallel axis size (0 = auto; a world of "
                         "more than one rank only)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--no-monitor", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject a failure (restart-path testing)")
    ap.add_argument("--user", default=os.environ.get("USER", "user"))
    add_stack_args(ap)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    shape = ShapeConfig("cli", seq_len=args.seq_len,
                        global_batch=args.global_batch, kind="train")
    tcfg = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 20),
        optimizer=args.optimizer, num_microbatches=args.microbatches,
        remat_policy=args.remat, grad_compression=args.grad_compression,
        ckpt_dir=args.ckpt_dir, ckpt_interval=args.ckpt_interval,
        monitor=not args.no_monitor)
    device = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = pc = None
    joined = False                      # this call joined the world
    if world > 1:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             "0")))
            torch.cuda.set_device(device)
        if not dist.is_initialized():
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo")
            joined = True
        mesh = make_mesh_for(world, model=args.tp,
                             device_type=device.type)
        rules = rules_for("train")
        if args.grad_compression != "none" and \
                comm.live_axes(mesh, ("pod",)):
            rules = rules.with_overrides(batch=("data",))
        pc = PartitionConstraints(rules, mesh,
                                  seq_parallel=tcfg.seq_parallel)
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        if args.overlap_flags:
            print("overlap: the FSDP gathers and gradient syncs run in "
                  "flight")
    else:
        print("mesh: none (one rank; --tp acts on a world of more than "
              "one)")
        if args.overlap_flags:
            print("overlap: nothing to overlap on one rank (no mesh, no "
                  "exchange)")
    peak_flops, hbm_bw, ici_bw = resolve_peaks(args, device)

    stack = RemoteStack(args.lms_url)
    print(f"LMS HTTP endpoint: {stack.url}")
    losses = []

    def cb(step, metrics):
        losses.append(float(metrics["loss"]))
        if step % 10 == 0 or step == 1:
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"grad {float(metrics['grad_norm']):.3f}", flush=True)
        if step_callback is not None:
            step_callback(step, metrics)

    job_id = f"{cfg.name}-{uuid.uuid4().hex[:8]}"
    if mesh is not None:                # every rank posts under rank 0's id
        ids = [job_id]
        dist.broadcast_object_list(ids, src=0)
        job_id = ids[0]
    try:
        result = train(cfg, tcfg, shape, stack=stack, device=device,
                       peak_flops=peak_flops, hbm_bw=hbm_bw, ici_bw=ici_bw,
                       mesh=mesh, pc=pc,
                       overlap=args.overlap_flags and mesh is not None,
                       fail_at_step=args.fail_at_step,
                       step_callback=cb, user=args.user, job_id=job_id)
    finally:
        stack.close()
        if joined:
            dist.destroy_process_group()
    print(f"done: steps={result.steps_run} final_loss={result.last_loss:.4f}"
          f" resumed_from={result.resumed_from}")
    for f in result.findings:
        print(f"finding: {f.rule} on {f.host} ({f.duration_s:.0f}s)")
    print(f"client: {json.dumps(stack.stats)}")
    print(f"job: {job_id} report: {stack.report_url(job_id)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
