"""Train and eval steps (port of ``repro.train.step``).

``make_train_step`` returns ``train_step(params, opt_state, batch, step)
-> (params, opt_state, metrics)``:

* microbatched gradient accumulation (``num_microbatches``) with the
  reference's interleaved split (microbatch m takes rows m, m + nm, ...)
  and fp32 accumulators;
* the ``grad_sync_dtype`` cast of the accumulated gradients, where the
  reference's ``_sync_cast`` applies it (one device has no reduction, but
  the rounding is kept so the numbers match the reference);
* global-norm clipping, the learning-rate schedule and the optimizer
  update (AdamW / Adafactor), in place (see :mod:`repro_torch.train.optim`);
* metrics ``loss``, ``grad_norm``, ``lr`` and ``param_norm``.

``batch`` holds (B, S) integer tensors on the params' device, and any
extras (split along the batch like the tokens).  Params are
leaves that need no grad; the step takes gradients of detached views.

With ``mesh`` (a DeviceMesh over axes among "pod", "data", "model") the
step is data-parallel with sharded storage, and computes the reference's
step on the global batch:

* params and optimizer state are this rank's pieces, split by the
  rules the pass computes with (``pc.rules``, by default ``TRAIN_RULES``:
  :func:`shardings`); the batch is this rank's rows of
  the global batch, block ``i`` of the data-parallel ranks ("pod" x
  "data", pod major: :func:`shard_batch`); ranks that differ only in their
  "model" coordinate hold the same rows and compute the same loss;
* the pass is handed this rank's pieces (``pc.with_pieces``: their
  shardings and roles, ``sharding.tp_roles`` for this batch's sequence
  length) and gathers each layer's leaves inside that layer's call, the
  leaves outside the layer stacks once a pass, as the reference's scan
  body does under XLA: a ``"split"`` leaf over the axes but "model" only
  (the tensor-parallel pass computes with this rank's piece), the others
  whole (``comm.gather_piece``); under remat ``"minimal"`` or ``"full"``
  the backward's recompute gathers a layer again, so one layer's gathered
  leaves are live at a time (the leaves outside the checkpoints are kept
  for the backward: the embedding, a hybrid's shared attention blocks at
  each use, an encoder-decoder's cross K/V projections);
* the port's gradient runs on them (``loss_fn`` with ``pc``: this rank's
  term of the global masked mean, the MoE dispatched over the mesh,
  tensor-parallel where "model" is live,
  sequence-parallel with ``seq_parallel``), and each microbatch's metrics
  are reduced over the data-parallel ranks (means; ``moe_max_load`` the
  largest);
* each gather's backward syncs its gradient by role as autograd reaches
  it (``comm.grad_piece``, reported as ``"grad_scatter"``): a
  ``"partial"`` one first summed over "model"; then averaged over "data"
  by a reduce-scatter into this rank's piece (a ``"whole"`` gradient is
  the same on every "model" rank and is cut to its chunk locally; a
  ``"split"`` one is that chunk already), so the microbatches accumulate
  pieces; after the ``grad_sync_dtype`` cast of the accumulated pieces,
  the one exchange left is over "pod", through
  :func:`~repro_torch.train.compression.compressed_pmean` when
  ``grad_compression`` is set (per-row int8 of this rank's piece), else a
  plain mean;
* clipping and the norms count every element once
  (:func:`~repro_torch.train.optim.global_norm`); the optimizer updates
  the pieces in place.

An axis of size 1 exchanges nothing and copies nothing: on one rank the
step is the one-device step plus its (skipped) collectives.

Each leaf is gathered in its ``sharding.wire_dtypes`` dtype: a matrix or
the embedding table of a bf16 pass in bf16 (every use casts it so; the
round trip is exact), the norms' scales and the other leaves read in fp32
in fp32.  With ``overlap`` (the train CLI's ``--overlap-flags``, the
counterpart of the reference's latency-hiding scheduler flags) the step's
FSDP exchanges run in flight (``comm.start``): each loop of layers issues
the next layer's gather before the layer ahead of it computes, and under
remat each recompute issues the previous layer's
(``sharding.LayerGathers``); each gradient's sync is issued as autograd
reaches its gather and waited after the backward, by a ``comm.GradSink``
that credits it to the leaf's gradient in autograd's order.  The metrics'
reductions, the loss's label count and the tensor-parallel regions stay
on the compute path.  The bits are the step without overlap's; a step on a
live "data" axis in which no exchange ran in flight raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.params import flatten, unflatten
from repro_torch.models.transformer import loss_fn, model_specs
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (
    PartitionConstraints, TRAIN_RULES, shardings_for_specs, tp_roles,
    wire_dtypes)
from repro_torch.train.compression import cross_pod_sync
from repro_torch.train.optim import (clip_by_global_norm, get_optimizer,
                                     global_norm, lr_schedule,
                                     opt_state_specs)


def _value_and_grad(params, batch, model_cfg, train_cfg, pc=None):
    """(metrics, fp32 grads as a flat dict) of one (micro)batch.  A pass
    whose pieces carry a ``comm.GradSink`` (the overlapped step) hands its
    gradients' syncs to it in flight: they are waited and credited after
    the backward."""
    flat = {k: v.detach().requires_grad_() for k, v in flatten(params).items()}
    loss, metrics = loss_fn(unflatten(flat), model_cfg, batch, pc=pc,
                            attn_impl=train_cfg.attn_impl,
                            remat=train_cfg.remat_policy)
    sink = getattr(getattr(pc, "pieces", None), "sink", None)
    grads = dict(zip(flat, torch.autograd.grad(
        loss, list(flat.values()), allow_unused=sink is not None)))
    if sink is not None:
        grads = sink.collect(flat, grads)
    return {k: v.detach() for k, v in metrics.items()}, grads


def _grads_and_metrics(params, batch, model_cfg: ModelConfig,
                       train_cfg: TrainConfig, pc=None, reduce=None):
    """Microbatched value-and-grad; returns (grads fp32 tree, metrics).
    ``reduce``: applied to each microbatch's metrics (the data-parallel
    reduction)."""
    reduce = reduce or (lambda m: m)
    nm = train_cfg.num_microbatches
    sync_dt = getattr(torch, train_cfg.grad_sync_dtype)

    def sync_cast(g):
        return g.float() if sync_dt == torch.float32 \
            else g.to(sync_dt).float()

    if nm <= 1:
        metrics, grads = _value_and_grad(params, batch, model_cfg, train_cfg,
                                         pc)
        return unflatten({k: sync_cast(g) for k, g in grads.items()}), \
            reduce(metrics)

    rows = next(iter(batch.values())).shape[0]
    if rows % nm:
        raise ValueError(f"batch of {rows} rows does not split into {nm} "
                         f"microbatches")
    acc, macc = None, None
    for m in range(nm):
        # interleaved split, as the reference's (B, ...) -> (B/nm, nm, ...)
        mb = {k: v.view(rows // nm, nm, *v.shape[1:])[:, m]
              for k, v in batch.items()}
        metrics, grads = _value_and_grad(params, mb, model_cfg, train_cfg, pc)
        metrics = reduce(metrics)
        if acc is None:
            acc = {k: torch.zeros_like(g, dtype=torch.float32)
                   for k, g in grads.items()}
            macc = {k: torch.zeros_like(v, dtype=torch.float32)
                    for k, v in metrics.items()}
        for k, g in grads.items():
            acc[k].add_(g.float() / nm)
        for k, v in metrics.items():
            macc[k].add_(v / nm)
        del grads
    return unflatten({k: sync_cast(g) for k, g in acc.items()}), macc


def count_step_flops(params, batch, model_cfg: ModelConfig,
                     train_cfg: TrainConfig) -> float:
    """Flops of one step's forward and backward, remat recomputes included,
    as :class:`~torch.utils.flop_counter.FlopCounterMode` counts them
    (matrix products and attention; not elementwise work or the optimizer
    update), the SSD scan's forward and backward included (their custom ops
    carry the cost model's flops: ``kernels.ssd.cost_estimate`` /
    ``bwd_cost_estimate``).  The pass runs on meta copies of ``params`` and
    ``batch``: the counts depend on shapes only, so nothing is computed, no
    device memory is taken and no kernel is launched."""
    def meta(tree):
        return unflatten({k: torch.empty_like(v, device="meta")
                          for k, v in flatten(tree).items()})
    with FlopCounterMode(display=False) as counter:
        _grads_and_metrics(meta(params), meta(batch), model_cfg, train_cfg)
    return float(counter.get_total_flops())


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig, *,
                    pc=None, mesh=None, overlap: bool = False):
    """Returns (train_step, optimizer); train_step(params, opt_state, batch,
    step) -> (params, opt_state, metrics), updating params and opt_state in
    place.  With ``mesh``: the data-parallel step of the module docstring
    (``pc`` defaults to the train rules on ``mesh``); ``overlap``: its
    exchanges overlapped with compute (see the module docstring; the train
    CLI's ``--overlap-flags``), which changes no bit of the step."""
    if mesh is not None:
        return _make_dist_step(model_cfg, train_cfg, pc, mesh, overlap)
    opt = get_optimizer(train_cfg)
    lr_fn = lr_schedule(train_cfg)
    grads_fn = make_grads_fn(model_cfg, train_cfg, pc=pc)

    def train_step(params, opt_state, batch, step):
        grads, metrics = grads_fn(params, batch)
        if train_cfg.grad_clip_norm > 0:
            grads, gnorm = clip_by_global_norm(grads,
                                               train_cfg.grad_clip_norm)
        else:
            gnorm = global_norm(grads)
        lr = lr_fn(step)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        del grads
        metrics = dict(metrics)
        metrics.update({"grad_norm": gnorm, "lr": lr,
                        "param_norm": global_norm(params)})
        return params, opt_state, metrics

    return train_step, opt


# --------------------------------------------------------------------------
# Data parallelism over a mesh
# --------------------------------------------------------------------------

DP_AXES = ("pod", "data")


def shardings(model_cfg: ModelConfig, train_cfg: TrainConfig, mesh,
              pc: Optional[PartitionConstraints] = None):
    """(params, optimizer state) Sharding trees on ``mesh`` under the
    rules of ``pc``, the constraints the step is built with (None: its
    default, ``TRAIN_RULES``): a moment is split as its param."""
    rules = pc.rules if pc is not None else TRAIN_RULES
    specs = model_specs(model_cfg)
    return (shardings_for_specs(specs, rules, mesh),
            shardings_for_specs(opt_state_specs(specs, train_cfg),
                                rules, mesh))


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of every entry of a global batch: block i of the
    data-parallel ranks, i = pod coordinate * data size + data
    coordinate."""
    rows = next(iter(batch.values())).shape[0]
    n = comm.group_size(mesh, DP_AXES)
    if rows % n:
        raise ValueError(f"a global batch of {rows} rows does not split "
                         f"over {n} data-parallel ranks")
    k = rows // n
    i = comm.group_index(mesh, DP_AXES)
    return {key: v[i * k:(i + 1) * k] for key, v in batch.items()}


def rows_for(batch: dict, pc: PartitionConstraints) -> dict:
    """This rank's rows of every entry of a global serving batch under
    ``pc``: :func:`shard_batch`'s block where the binding splits the rows
    (``pc.rows_split``), else all of them (the binding replicates a batch
    that does not divide over the data-parallel ranks)."""
    if not pc.rows_split:
        return dict(batch)
    return shard_batch(batch, pc.mesh)


def _reduce_metrics(metrics: dict, mesh, axes) -> dict:
    """A microbatch's metrics over the data-parallel ranks: the mean of
    the ranks' terms (the global values), ``moe_max_load`` the largest."""
    if not axes:
        return metrics
    out = dict(metrics)
    keys = [k for k in metrics if k != "moe_max_load"]
    means = comm.all_reduce(torch.stack([metrics[k].float() for k in keys]),
                            mesh, axes, "mean")
    out.update(zip(keys, means.unbind()))
    if "moe_max_load" in metrics:
        out["moe_max_load"] = comm.all_reduce(
            metrics["moe_max_load"].float().clone(), mesh, axes, "max")
    return out


def mean_over_data(grads, param_shardings, mesh, roles=None):
    """Gradients of the leaves a rank computed with, whole over "data" ->
    this rank's pieces of their mean over "data", by ``roles``
    (``sharding.tp_roles``; None: every leaf ``"whole"``): each leaf
    through ``comm.grad_piece``, the sync each layer's gather makes in the
    step's backward."""
    fsh = flatten(param_shardings)
    return unflatten({k: comm.grad_piece(
        g, fsh[k], mesh, roles[k] if roles is not None else "whole")
        for k, g in flatten(grads).items()})


def mean_over_pods(pieces, mesh, method: str = "none"):
    """The mean of gradient pieces over "pod": compressed by ``method``
    (:func:`~repro_torch.train.compression.cross_pod_sync`) or, for
    ``"none"``, a plain fp32 mean; the pieces themselves without a live
    pod axis."""
    if not comm.live_axes(mesh, ("pod",)):
        return pieces
    if method in ("", "none"):
        return unflatten({k: comm.all_reduce(g.contiguous(), mesh, ("pod",),
                                             "mean")
                          for k, g in flatten(pieces).items()})
    return cross_pod_sync(pieces, mesh, method)


def make_grads_fn(model_cfg: ModelConfig, train_cfg: TrainConfig, *,
                  pc=None, mesh=None, overlap: bool = False):
    """grads_fn(params, batch) -> (grads, metrics): the gradients the
    train step of the same arguments clips and applies, and its metrics
    before the norms.  With ``mesh``: this rank's pieces of the global
    batch's mean gradient, from this rank's pieces of the params and rows
    of the batch, which the pass gathers layer by layer (each leaf in its
    ``sharding.wire_dtypes`` dtype) and whose gradients its backward syncs
    by role, as the module docstring says; ``overlap``: those exchanges
    overlapped with compute."""
    if mesh is None:
        return lambda params, batch: _grads_and_metrics(
            params, batch, model_cfg, train_cfg, pc)
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh: a DeviceMesh, not {type(mesh).__name__}")
    if train_cfg.grad_compression not in ("", "none", "int8", "int8_ef",
                                          "bf16"):
        raise ValueError(f"grad_compression "
                         f"{train_cfg.grad_compression!r}")
    pc = pc or _default_pc(train_cfg, mesh)
    psh, _ = shardings(model_cfg, train_cfg, mesh, pc)
    wire = wire_dtypes(model_cfg)
    nm = train_cfg.num_microbatches

    def reduce(metrics):
        return _reduce_metrics(metrics, mesh, pc.dp_axes)

    def grads_fn(params, batch):
        rows = next(iter(batch.values())).shape[0]
        if nm > 1 and rows % nm:
            # rank r's rows m, m + nm, ... are then global microbatch m's
            raise ValueError(
                f"this rank's {rows} rows do not split into {nm} "
                f"microbatches: the global batch over the data-parallel "
                f"ranks must be a multiple of num_microbatches")
        src = batch.get("src_frames")
        roles = tp_roles(model_cfg, pc.rules, mesh, pc.sp_pass(
            model_cfg, batch["tokens"].shape[1],
            None if src is None else src.shape[1]))
        grads, metrics = _grads_and_metrics(
            params, batch, model_cfg, train_cfg, pc.with_pieces(
                psh, roles, wire, comm.GradSink() if overlap else None),
            reduce)
        return mean_over_pods(grads, mesh, train_cfg.grad_compression), \
            metrics

    return grads_fn


def _default_pc(train_cfg: TrainConfig, mesh) -> PartitionConstraints:
    return PartitionConstraints(TRAIN_RULES, mesh,
                                seq_parallel=train_cfg.seq_parallel)


def _make_dist_step(model_cfg: ModelConfig, train_cfg: TrainConfig, pc,
                    mesh, overlap: bool = False):
    pc = pc or _default_pc(train_cfg, mesh)
    grads_fn = make_grads_fn(model_cfg, train_cfg, pc=pc, mesh=mesh,
                             overlap=overlap)
    opt = get_optimizer(train_cfg)
    lr_fn = lr_schedule(train_cfg)
    psh, _ = shardings(model_cfg, train_cfg, mesh, pc)
    # with overlap on a live "data" axis, a step in which no exchange ran
    # in flight fails: nothing falls back to the synchronous step unsaid
    watch = overlap and bool(comm.live_axes(mesh, ("data",)))

    def train_step(params, opt_state, batch, step):
        live = watch and not next(iter(flatten(params).values())).is_meta
        before = sum(comm.overlapped().values()) if live else 0
        grads, metrics = grads_fn(params, batch)
        if live and sum(comm.overlapped().values()) == before:
            raise RuntimeError("overlap: no exchange of the step ran in "
                               "flight on a live \"data\" axis")
        if train_cfg.grad_clip_norm > 0:
            grads, gnorm = clip_by_global_norm(
                grads, train_cfg.grad_clip_norm, psh, mesh)
        else:
            gnorm = global_norm(grads, psh, mesh)
        lr = lr_fn(step)
        params, opt_state = opt.update(grads, opt_state, params, lr,
                                       shardings=psh, mesh=mesh)
        del grads
        metrics = dict(metrics)
        metrics.update({"grad_norm": gnorm, "lr": lr,
                        "param_norm": global_norm(params, psh, mesh)})
        return params, opt_state, metrics

    return train_step, opt


def make_eval_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """eval_step(params, batch) -> metrics (the loss, no gradients)."""
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, model_cfg, batch)
        return metrics
    return eval_step


def batch_to_device(np_batch: dict, device: Optional[torch.device]) -> dict:
    """numpy batch -> tensors on ``device``: integer entries (tokens,
    labels, a VLM's ``mrope_pos``) as int64, floating ones (a VLM's
    ``patches``) in their own floating dtype (the model casts them)."""
    out = {}
    for k, v in np_batch.items():
        t = torch.as_tensor(v)
        out[k] = t.to(device=device, dtype=None if t.is_floating_point()
                      else torch.long)
    return out
