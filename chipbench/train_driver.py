"""The training driver: one monitored job through ``repro_torch``'s
``train.loop.train``, its points posted over HTTP to the receiver.

Set-up: the receiver starts, ``train()`` builds its model, optimizer state
and data from the seed and runs the traffic's ``set_up_steps`` steps (the
first compiles nothing, but loads the kernel library and counts the step);
the window then runs from the end of the last set-up step to the end of the
first step that ends ``seconds`` later, and the step callback stops the job
there (it lowers ``total_steps``, which the loop reads each step).  The
same job object serves set-up and window.

The numbers compared with the reference are read in set-up from that job:
each step's loss, each leaf's norm of the first clipped gradient (from
AdamW's first moment after one step: m = (1 - beta1) g) and of its change
over the set-up steps (against the initial parameters, worked out again
from the seed by ``reference.params``).  They are read through a wrapper
around the step ``train()`` builds, which passes the step its arguments and
returns its results; in the window it only counts.

With ``trace`` the first ``trace_steps`` steps of the window run under
``torch.profiler``; the per-layer metrics that need no trace are read over
the rest of the window.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
import urllib.request
from contextlib import contextmanager

import torch

from chipbench import common, costs
from chipbench import trace as tracing
from chipbench.reference import params as rparams
from chipbench.reference import train as rtrain


def model_config(port: dict):
    """The port's ``ModelConfig`` of a configuration file's ``port``."""
    from repro_torch.configs.base import (
        HybridConfig, ModelConfig, SSMConfig)
    kw = dict(port)
    if "ssm" in kw:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    if "hybrid" in kw:
        kw["hybrid"] = HybridConfig(**kw["hybrid"])
    return ModelConfig(**kw)


class ReceiverProcess:
    """The receiver (``receiver.py``) as a child process."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, str(common.HERE / "receiver.py")],
            stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        if not line.startswith("PORT "):
            self.proc.kill()
            self.proc.wait()
            raise RuntimeError(f"the receiver did not start: {line!r}")
        self.url = f"http://127.0.0.1:{int(line.split()[1])}"

    def _call(self, path: str, data=None):
        req = urllib.request.Request(self.url + path, data=data,
                                     method="GET" if data is None else "POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read() or b"{}")

    def summary(self) -> dict:
        return self._call("/summary")

    def close(self) -> None:
        try:
            self._call("/quit", b"{}")
            self.proc.wait(timeout=10)
        except (OSError, ValueError, subprocess.TimeoutExpired):
            self.proc.kill()
            self.proc.wait()
        finally:
            self.proc.stdout.close()


def flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = v
    return out


class StepProbe:
    """Wraps the step ``train()`` builds: reads the set-up steps' numbers,
    counts the window's steps, and (for the tests of the comparison) can
    plant a fault underneath: ``"unchanged"`` (the step returns its state
    unchanged), ``"half_batch"`` (half of the rows left out, the loss the
    mean over the rest) or ``"tokens"`` (every input token altered where the
    feed produces it)."""

    def __init__(self, port: dict, traffic: dict, seed: int, fault=None,
                 phases: common.Phases | None = None):
        self.port, self.traffic, self.seed = port, traffic, seed
        self.fault = fault
        self.grad, self.change = None, None
        self.phases = phases

    def _mark(self, label: str) -> None:
        if self.phases is not None:
            self.phases.mark(label)

    def wrap(self, make):
        def make_step(*args, **kwargs):
            step_fn, opt = make(*args, **kwargs)

            def step(params, opt_state, batch, step_idx):
                # the loop counts its step once on meta copies first
                live = not next(iter(flat(params).values())).is_meta
                if not live:
                    self._mark("build")
                batch = self._planted(batch)
                if self.fault == "unchanged":
                    keep = {k: v.clone() for k, v in
                            flat({"p": params, "s": opt_state}).items()}
                out = step_fn(params, opt_state, batch, step_idx)
                if self.fault == "unchanged":
                    for k, v in flat({"p": params, "s": opt_state}).items():
                        if v.is_floating_point():
                            v.copy_(keep[k])
                if not live:
                    self._mark("meta count")
                elif step_idx < self.traffic["set_up_steps"]:
                    self._read(step_idx, out[0], out[1])
                return out
            return step, opt
        return make_step

    def _planted(self, batch):
        if self.fault == "half_batch":
            rows = batch["tokens"].shape[0] // 2
            return {k: v[:rows] for k, v in batch.items()}
        if self.fault == "tokens":
            v = self.port["vocab_size"]
            return dict(batch, tokens=(batch["tokens"] + 1) % v)
        return batch

    @torch.no_grad()
    def _read(self, step_idx: int, params, opt_state) -> None:
        if step_idx == 0:
            b1 = self.traffic["beta1"]
            self.grad = {k: float(m.float().norm()) / (1 - b1)
                         for k, m in flat(opt_state["m"]).items()}
        if step_idx == self.traffic["set_up_steps"] - 1:
            self._mark(f"step {step_idx + 1}")
            leaves = rparams.leaves(self.port)
            self.change = {}
            for k, p in flat(params).items():
                p0 = rparams.init_leaf(leaves[k], k, self.seed, p.device)
                self.change[k] = float((p.float() - p0).norm())
                del p0
            self._mark("read change")


@contextmanager
def patched_step(probe: StepProbe):
    import repro_torch.train.loop as loop
    make = loop.make_train_step
    loop.make_train_step = probe.wrap(make)
    try:
        yield
    finally:
        loop.make_train_step = make


def run(cell: dict, cfg_file: dict, traffic: dict, *, seed: int,
        seconds: float, trace: bool, device="cuda", t_process: float = None,
        fault=None, window: bool = True) -> dict:
    """One run of a training cell, up to the end of the window.  Returns
    the readings (``run`` for the metric readers, the numbers for the
    comparison, the receiver's view); frees the job's state before it
    returns.  ``window=False`` stops after set-up."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.core import RemoteStack
    from repro_torch.kernels import ops
    from repro_torch.train.loop import train

    t_process = time.monotonic() if t_process is None else t_process
    port = cfg_file["port"]
    cfg = model_config(port)
    warm = traffic["set_up_steps"]
    tcfg = TrainConfig(
        learning_rate=traffic["learning_rate"],
        weight_decay=traffic["weight_decay"], beta1=traffic["beta1"],
        beta2=traffic["beta2"], eps=traffic["eps"],
        grad_clip_norm=traffic["grad_clip_norm"],
        warmup_steps=traffic["warmup_steps"], total_steps=10 ** 6,
        optimizer=traffic["optimizer"],
        remat_policy=traffic["remat_policy"], attn_impl=traffic["attn_impl"],
        seed=seed, monitor=True, monitor_interval=traffic["monitor_interval"],
        ckpt_dir="")
    shape = ShapeConfig(cell["traffic"], traffic["seq_len"],
                        traffic["global_batch"], "train")
    dev = torch.device(device)
    peaks = costs.peaks_for(torch.cuda.get_device_name(dev)) \
        if dev.type == "cuda" else costs.PEAKS["H100"]
    phases = common.Phases(t_process)
    phases.mark("imports, CUDA")
    probe = StepProbe(port, traffic, seed, fault, phases)
    receiver = ReceiverProcess()
    stack = RemoteStack(receiver.url)
    phases.mark("receiver")
    marks = {"losses": [], "times": {}, "posts": {}, "launches": {}}
    state = {"prof": None, "annot": None}
    trace_steps = traffic["trace_steps"] if trace else 0

    def on_step(step, metrics):
        now = time.monotonic()
        marks["times"][step] = now
        marks["posts"][step] = stack.stats["seconds"]
        if step <= warm:
            marks["losses"].append(float(metrics["loss"]))
            phases.mark(f"step {step}")
        if step == warm:
            if not window:
                tcfg.total_steps = step
                return
            if trace_steps:
                state["prof"] = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                state["prof"].start()
                state["annot"] = torch.profiler.record_function(
                    tracing.WINDOW)
                state["annot"].__enter__()
                ops.reset_launch_counts()
            marks["t_start"] = time.monotonic()
            marks["times"][step] = marks["t_start"]
            marks["posts"][step] = stack.stats["seconds"]
        elif trace_steps and step == warm + trace_steps:
            marks["launches"] = dict(ops.launch_counts())
            state["annot"].__exit__(None, None, None)
            state["prof"].stop()
            marks["times"][step] = time.monotonic()
            marks["posts"][step] = stack.stats["seconds"]
        if step > warm and step >= warm + trace_steps and \
                now - marks["t_start"] >= seconds:
            marks["t_end"] = now
            marks["end_step"] = step
            tcfg.total_steps = step

    try:
        with patched_step(probe):
            train(cfg, tcfg, shape, stack=stack, device=dev,
                  peak_flops=peaks["flops"], hbm_bw=peaks["bytes"],
                  step_callback=on_step, job_id=f"chipbench-{seed}")
        stack.close()
        summary = receiver.summary()
    finally:
        receiver.close()
    out = {"losses": marks["losses"], "grad": probe.grad,
           "change": probe.change, "summary": summary}
    if not window:
        return out
    memory = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    trace_read = tracing.read(tracing.export_events(state["prof"])) \
        if trace_steps else None
    state.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["memory_peak_bytes"] = memory
    out["run"] = readings(port, traffic, marks, summary, trace_read, peaks,
                          t_process, warm, trace_steps)
    out["run"]["setup_phases"] = phases.seconds
    return out


def readings(port, traffic, marks, summary, trace_read, peaks, t_process,
             warm, trace_steps) -> dict:
    """What the metric readers read of one run."""
    steps = marks["end_step"] - warm
    tokens = traffic["seq_len"] * traffic["global_batch"]
    step_time = {}
    for p in summary["points"]:
        if p["measurement"] == "hpm" and "step_time_s" in p["fields"]:
            # the agent posts step index i for the step that ends at i + 1
            step_time[int(p["fields"]["step"]) + 1] = \
                float(p["fields"]["step_time_s"])
    posted = {int(p["fields"]["step"]) + 1 for p in summary["points"]
              if p["measurement"] == "hpm"}
    train_pts = sum(1 for p in summary["points"]
                    if p["measurement"] == "train")
    window_steps = range(warm + 1, marks["end_step"] + 1)
    # a window step is failed if its hpm point did not arrive; train
    # points carry no step, so each one missing fails one step more
    failed = sum(1 for s in window_steps if s not in posted) \
        + max(0, marks["end_step"] - train_pts)
    # the per-layer span: the window's steps after the traced ones
    s0 = warm + trace_steps
    span_steps = list(range(s0 + 1, marks["end_step"] + 1))
    return {
        "kind": "train",
        "port": port, "traffic": traffic, "peaks": peaks,
        "setup_s": marks["t_start"] - t_process,
        "window_s": marks["t_end"] - marks["t_start"],
        "window_steps": steps,
        "tokens_per_step": tokens,
        "attempted": steps,
        "failed": min(failed, steps),
        "span": {
            "steps": len(span_steps),
            "seconds": marks["times"][marks["end_step"]]
            - marks["times"][s0],
            "step_time_s": sum(step_time.get(s, math.nan)
                               for s in span_steps),
            "post_s": marks["posts"][marks["end_step"]] - marks["posts"][s0],
        },
        "trace": trace_read,
        "trace_steps": trace_steps,
        "launches": marks["launches"] or None,
        "signals": summary["signals"],
        # the raw record, for readers added later
        "points": summary["points"], "step_end_s": marks["times"],
        "step_posts_s": marks["posts"],
    }


def check(cfg_file: dict, traffic: dict, seed: int, got: dict, device,
          fp8: bool = False) -> dict:
    """The reference's readings of the set-up steps and the numbers
    compared (see ``reference.train.gaps``)."""
    rtrain.model.no_tf32()
    ref = rtrain.follow(cfg_file["port"], traffic, seed,
                        traffic["set_up_steps"], device, fp8=fp8)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"ref": ref, "gaps": rtrain.gaps(got, ref)}
