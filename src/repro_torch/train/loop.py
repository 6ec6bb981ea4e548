"""Monitored training loop (port of ``repro.train.loop``).

The loop is a *job* in the LMS sense, wired as the reference wires it:

* the job bracket (``stack.job``) tags every metric of the run;
* one host agent emits the HPM metrics each step from the step constants
  (:func:`step_constants`: this rank's step counted once, before the first
  step, by :func:`repro_torch.launch.cost_analysis.analyze_step`) and the
  step time;
* ``usermetric`` carries the ``train`` series (loss, grad norm, lr) and the
  ``run_state`` events (start, checkpoint, failure injected, halt, finish);
* marker regions ``data_wait``, ``train_step`` and ``checkpoint``, and
  the device's peaks as the stack's calibration point (region ``_calib``,
  :func:`repro_torch.core.marker.calibrate`), which the stack's roofline
  of marker regions reads;
* a ``nan_loss`` finding (or a NaN loss seen directly) halts the run, a
  ``step_time_straggler`` finding does when ``halt_on_straggler`` is set.

Fault tolerance: auto-resume from the latest checkpoint, atomic keep-k
saves, deterministic data replay (step-keyed source), optional failure
injection.

The monitoring stack is duck-typed and required: any object with
``.job(...)``, ``.host_agent(host)``, ``.usermetric(host=...)``,
``.on_finding`` and ``.findings()``: ``repro.core.MonitoringStack`` in
the same process, or :class:`repro_torch.core.RemoteStack` for a stack
reached over HTTP.  A stack with ``.poll_findings()`` (the remote one) is
asked for new findings at each monitor interval, outside the timed step,
so its findings halt the run as the in-process stack's callbacks do.
Every post to a remote stack happens outside the timed step.  There is no
``jit``: the step runs eagerly.

With ``mesh`` every rank runs this loop (the data-parallel step of
:mod:`repro_torch.train.step`): its host is ``hosts[rank % len(hosts)]`` (one
a rank by default, as the reference's ``process_index``), its loader makes
only its rows (``host_index`` / ``host_count`` over the data-parallel
ranks), its params and optimizer state are its pieces, and its host agent
posts its own points, the step constants a rank's share of the step
(tokens and model flops over the world size).  The rank at the mesh's
origin opens and closes the job (once); the others start posting after it
opened and have posted everything before it closes.  A halt (a finding, a
NaN loss) is agreed over the ranks each step, so all leave together.
Checkpoints hold whole leaves, gathered and written by the origin rank, and
a resume slices them under the mesh the job has now.
"""

from __future__ import annotations

import math
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core.marker import calibrate
from repro_torch.data.pipeline import (
    DataLoader, SyntheticTokenSource, make_batch_fn)
from repro_torch.launch.cost_analysis import analyze_step
from repro_torch.models.transformer import init_model_params
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import shard_tree
from repro_torch.train.step import (
    DP_AXES, batch_to_device, make_train_step, shardings)

# Published peaks by card name: FLOP/s (dense bf16 on the tensor cores),
# device-memory bytes/s and interconnect bytes/s.  NVIDIA's data sheet, SXM
# part at full power.  NVLink 4 gives an H100 SXM 900 GB/s, both directions
# of its 18 links together; the interconnect rate here is one direction,
# 450 GB/s, since the ICI group and the collective roofline term divide
# the bytes one card sends (the wire bytes of the reference's formulas) by
# it.  Between hosts a card's traffic goes through its network adapter, far
# slower: over a multi-host mesh the collective term is a lower bound.
DEVICE_PEAKS = {"H100": (989e12, 3.35e12, 450e9)}


class InjectedFailure(RuntimeError):
    """Raised by the failure-injection hook (restart-path testing)."""


@dataclass
class TrainResult:
    steps_run: int
    final_step: int
    last_loss: float
    findings: list
    resumed_from: Optional[int]
    # this rank's step as launch.cost_analysis counted it (the constants'
    # source, with its memory block); None if no step ran
    step_analysis: Optional[dict] = None


def device_peaks(device: torch.device) -> tuple:
    """(peak FLOP/s, memory bytes/s, interconnect bytes/s) of a known CUDA
    card; raises for any other device (pass the peaks to :func:`train`
    instead)."""
    peaks = _known_peaks(device)
    if peaks is not None:
        return peaks
    what = repr(torch.cuda.get_device_name(device)) \
        if device.type == "cuda" else f"device {device}"
    raise ValueError(f"no published peaks for {what}; pass peak_flops and "
                     f"hbm_bw")


def _known_peaks(device: torch.device) -> Optional[tuple]:
    """:data:`DEVICE_PEAKS` of a known card, else None."""
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        for key, peaks in DEVICE_PEAKS.items():
            if key in name:
                return peaks
    return None


def step_constants(analysis: dict, *, model_flops: float,
                   tokens_per_step: float, peak_flops: float, hbm_bw: float,
                   ici_bw: Optional[float] = None) -> dict:
    """HPM step constants of one step, for the host agent, from
    :func:`~repro_torch.launch.cost_analysis.analyze_step`'s count of this
    rank's step (its pieces and its local batch through the same
    ``train_step`` the loop times, the optimizer update included): the
    counterpart of the reference's constants from the compiled step.

    ``hlo_flops`` (the products and the kernels' cost models; elementwise
    work is counted apart and not posted, as before) feeds FLOPS
    (``gflops_per_s``, ``hw_flops_util``, ``mfu``, ``useful_flop_ratio``);
    ``hlo_bytes`` (each operation's inputs read and outputs written once,
    a kernel's call at its cost model) feeds MEM (``mem_gb_per_s``,
    ``hbm_bw_util``); ``collective_bytes`` and ``wire_bytes`` (this rank's
    collectives, operand bytes and the reference's wire formulas; 0 on one
    device) feed ICI (``ici_gb_per_s``, ``ici_bw_util`` and the wire
    pair); ``model_flops`` and ``tokens_per_step`` (this rank's share)
    feed FLOPS and GOODPUT.  The card's peaks ride along as the raw events
    ``PEAK_FLOPS``, ``HBM_BW`` and ``ICI_BW``, which the group formulas
    read (``ICI_BW`` only when known: without it the two utilisations are
    skipped).  The roofline of marker regions is the stack's query and
    sees no step constants: it reads the peaks of the calibration point
    that :func:`train` records, and the ``train_step`` region's ``flops``
    and ``bytes`` counters, which :func:`train` seeds from these."""
    per = analysis["per_device"]
    out = {"hlo_flops": float(per["flops"]),
           "hlo_bytes": float(per["bytes"]),
           "collective_bytes": float(per["collective_operand_bytes"]),
           "wire_bytes": float(per["collective_wire_bytes"]),
           "model_flops": float(model_flops),
           "tokens_per_step": float(tokens_per_step),
           "PEAK_FLOPS": float(peak_flops), "HBM_BW": float(hbm_bw)}
    if ici_bw is not None:
        out["ICI_BW"] = float(ici_bw)
    return out


def train(model_cfg: ModelConfig, train_cfg: TrainConfig,
          shape: ShapeConfig, *, stack, hosts: Optional[list] = None,
          device=None, peak_flops: Optional[float] = None,
          hbm_bw: Optional[float] = None, ici_bw: Optional[float] = None,
          mesh=None, pc=None, overlap: bool = False,
          fail_at_step: Optional[int] = None,
          step_callback: Optional[Callable] = None,
          user: str = "user", job_id: Optional[str] = None,
          markers: bool = True) -> TrainResult:
    """Run (or resume) a monitored training job on one device (default
    CUDA), or with ``mesh`` as one rank of a data-parallel job (every rank
    calls it; see the module docstring; ``overlap``: the step's exchanges
    overlapped with compute, ``make_train_step(..., overlap=)``).
    ``peak_flops``/``hbm_bw`` default
    to the card's published peaks (:data:`DEVICE_PEAKS`), and so does
    ``ici_bw`` on a known card (elsewhere, unless given, the ICI group's
    utilisations are not derived)."""
    device = resolve_device(device)
    known = device_peaks(device) if peak_flops is None or hbm_bw is None \
        else _known_peaks(device)
    if known is not None:
        pf, bw, ici = known
        peak_flops = pf if peak_flops is None else peak_flops
        hbm_bw = bw if hbm_bw is None else hbm_bw
        ici_bw = ici if ici_bw is None else ici_bw
    world = dist.get_world_size() if mesh is not None else 1
    rank = dist.get_rank() if mesh is not None else 0
    lead = not any(comm.coordinate(mesh).values())
    hosts = hosts or [f"host{i}" for i in range(world)]
    host = hosts[rank % len(hosts)]
    job_id = job_id or f"{model_cfg.name}-{int(time.time())}"

    # ---- data (deterministic, resumable) ---------------------------------
    source = SyntheticTokenSource(model_cfg.vocab_size, seed=train_cfg.seed)
    batch_fn = make_batch_fn(source, model_cfg, shape,
                             extras_fn=stub_extras(model_cfg, shape))

    # ---- params / resume ---------------------------------------------------
    train_step, opt = make_train_step(model_cfg, train_cfg, pc=pc,
                                      mesh=mesh, overlap=overlap)
    sh = dict(zip(("params", "opt_state"),
                  shardings(model_cfg, train_cfg, mesh, pc))) \
        if mesh is not None else None
    ckpt = CheckpointManager(train_cfg.ckpt_dir, keep=train_cfg.ckpt_keep) \
        if train_cfg.ckpt_dir else None
    resumed_from = None
    start_step = 0
    params = init_model_params(model_cfg, seed=train_cfg.seed, device=device)
    if sh:
        params = shard_tree(params, sh["params"], mesh)
    opt_state = opt.init(params, sh["params"] if sh else None)
    if ckpt and ckpt.latest_step() is not None:
        start_step, trees = ckpt.restore(
            {"params": params, "opt_state": opt_state}, shardings=sh,
            mesh=mesh)
        params, opt_state = trees["params"], trees["opt_state"]
        resumed_from = start_step

    loader = DataLoader(batch_fn, global_batch=shape.global_batch,
                        host_index=comm.group_index(mesh, DP_AXES),
                        host_count=comm.group_size(mesh, DP_AXES),
                        start_step=start_step)

    # ---- LMS wiring ----------------------------------------------------------
    tokens_per_step = shape.global_batch * shape.seq_len
    if world > 1:
        tokens_per_step /= world            # a rank's share of the step
    # 6 N T with N the parameters a token touches (MoE: its top-k experts),
    # as the reference's ``_active_params``
    model_flops = 6 * model_cfg.active_param_count() * tokens_per_step
    agent = stack.host_agent(host)
    um = stack.usermetric(host=host)
    mk = um.markers if (markers and train_cfg.monitor) else None
    step_counters: dict = {}
    halted = {"reason": None}
    poll_findings = getattr(stack, "poll_findings", None)

    @stack.on_finding
    def _react(finding):
        if finding.rule == "nan_loss":
            halted["reason"] = "nan_loss"
        if finding.rule == "step_time_straggler" and \
                train_cfg.halt_on_straggler:
            halted["reason"] = f"straggler:{finding.host}"

    last_loss = float("nan")
    steps_run = 0
    step = start_step
    step_analysis = None
    try:
        with (stack.job(job_id, user=user, hosts=hosts,
                        tags={"arch": model_cfg.name, "shape": shape.name})
              if lead else nullcontext()):
            _barrier(world)             # the job is open before any post
            um.event("run_state", f"starting {model_cfg.name} at step "
                     f"{start_step}")
            # the device's peaks, where the stack's marker roofline reads
            # them (flushed at once, inside the job bracket)
            calibrate(um, peak_flops, hbm_bw)
            while step < train_cfg.total_steps:
                step_idx, np_batch = next(loader)
                data_wait = loader.wait_time_s
                batch = batch_to_device(np_batch, device)

                if step_analysis is None:
                    # one-time, before the first step: this rank's step
                    # (its pieces, its rows, the optimizer update) traced
                    # on meta copies, which launch and exchange nothing
                    # (the reference reads its constants from the
                    # compiled step)
                    step_analysis = analyze_step(
                        train_step, (params, opt_state, batch, step_idx))
                    consts = step_constants(
                        step_analysis,
                        model_flops=model_flops,
                        tokens_per_step=tokens_per_step,
                        peak_flops=peak_flops, hbm_bw=hbm_bw, ici_bw=ici_bw)
                    agent.set_step_constants(**consts)
                    # static per-call work counters seeding the train_step
                    # region's roofline operands
                    step_counters = {"flops": consts["hlo_flops"],
                                     "bytes": consts["hlo_bytes"]}

                if mk:
                    mk.record("data_wait", data_wait)
                t0 = time.monotonic()
                with (mk.region("train_step", counters=step_counters)
                      if mk else nullcontext()):
                    # forward, backward and the optimizer update run
                    # eagerly; the loss read waits for the whole step
                    params, opt_state, metrics = train_step(
                        params, opt_state, batch, step_idx)
                    loss = float(metrics["loss"])
                    # timed before the region's exit, which may post the
                    # marker deltas
                    step_time = time.monotonic() - t0

                # LMS per-step emission
                if train_cfg.monitor and \
                        step_idx % train_cfg.monitor_interval == 0:
                    agent.collect_step(step=step_idx, step_time_s=step_time,
                                       extra_events={"data_wait_s":
                                                     data_wait})
                    um.metric("train",
                              {"loss": loss,
                               "grad_norm": float(metrics["grad_norm"]),
                               "lr": float(metrics["lr"])})
                    if poll_findings is not None:
                        poll_findings()
                if math.isnan(loss):
                    um.event("run_state", f"NaN loss at step {step_idx}")
                    halted["reason"] = "nan_loss"
                if world > 1 and _any_rank(halted["reason"] is not None,
                                           mesh, device):
                    halted["reason"] = halted["reason"] or "another rank"

                last_loss = loss
                steps_run += 1
                step = step_idx + 1

                if step_callback:
                    step_callback(step, metrics)
                if ckpt and step % train_cfg.ckpt_interval == 0 and \
                        not math.isnan(loss):
                    with (mk.region("checkpoint") if mk
                          else nullcontext()):
                        ckpt.save(step, {"params": params,
                                         "opt_state": opt_state},
                                  {"arch": model_cfg.name, "step": step},
                                  shardings=sh, mesh=mesh)
                    um.event("run_state", f"checkpoint at {step}")
                if fail_at_step is not None and step >= fail_at_step:
                    um.event("run_state", f"injected failure at {step}")
                    raise InjectedFailure(f"injected at step {step}")
                if halted["reason"]:
                    um.event("run_state", f"halt: {halted['reason']}")
                    break
            um.event("run_state", "finished")
            # flush inside the job bracket so marker points are enriched
            # with the live job's tags (jobid/username) by the router
            um.flush()
            flush = getattr(stack, "flush", None)
            if flush is not None:
                flush()
            _barrier(world)             # every rank posted before the end
    finally:
        um.flush()
        loader.close()
        if ckpt:
            ckpt.wait()

    return TrainResult(steps_run, step, last_loss, stack.findings(),
                       resumed_from, step_analysis)


def _barrier(world: int) -> None:
    if world > 1:
        dist.barrier()


def _any_rank(flag: bool, mesh, device) -> bool:
    """Whether ``flag`` holds on any rank of the mesh."""
    t = torch.tensor(float(flag), device=device)
    return bool(comm.all_reduce(t, mesh, tuple(comm.axis_sizes(mesh)),
                                "max"))


def stub_extras(cfg: ModelConfig, shape: ShapeConfig):
    """The reference's stub modality inputs of a batch, or None: a VLM's
    ``patches`` (zeros, fp32; the ViT frontend is a stub) at the first
    ``min(vlm_num_patches, S - 2)`` positions after BOS, and ``mrope_pos``
    with t = h = w = the token's index; an encoder-decoder's
    ``src_frames``, zeros of (rows, encdec_source_len, d), fp32 (the audio
    frontend is a stub)."""
    if cfg.family == "vlm":
        def fn(step, rows):
            p = min(cfg.vlm_num_patches, max(shape.seq_len - 2, 1))
            return {
                "patches": np.zeros((rows, p, cfg.d_model), np.float32),
                "mrope_pos": np.broadcast_to(
                    np.arange(shape.seq_len, dtype=np.int32)[None, :, None],
                    (rows, shape.seq_len, 3)).copy()}
        return fn
    if cfg.family == "encdec":
        def fn(step, rows):
            return {"src_frames": np.zeros(
                (rows, cfg.encdec_source_len, cfg.d_model), np.float32)}
        return fn
    return None
