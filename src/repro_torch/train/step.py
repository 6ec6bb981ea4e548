"""Train and eval steps on one device (port of ``repro.train.step``).

``make_train_step`` returns ``train_step(params, opt_state, batch, step)
-> (params, opt_state, metrics)``:

* microbatched gradient accumulation (``num_microbatches``) with the
  reference's interleaved split (microbatch m takes rows m, m + nm, ...)
  and fp32 accumulators;
* the ``grad_sync_dtype`` cast of the gradients before they would be
  reduced across data-parallel replicas (one device has no reduction, but
  the rounding is kept so the numbers match the reference);
* global-norm clipping, the learning-rate schedule and the optimizer
  update (AdamW / Adafactor), in place (see :mod:`repro_torch.train.optim`);
* metrics ``loss``, ``grad_norm``, ``lr`` and ``param_norm``.

``batch`` holds (B, S) integer tensors on the params' device, and any
extras (split along the batch like the tokens).  Params are
leaves that need no grad; the step takes gradients of detached views.
Meshes and compressed gradient exchange (``train/compression.py``) belong
to the distributed slice: a mesh raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.params import flatten, unflatten
from repro_torch.models.transformer import loss_fn
from repro_torch.train.optim import (clip_by_global_norm, get_optimizer,
                                     global_norm, lr_schedule)


def _value_and_grad(params, batch, model_cfg, train_cfg):
    """(metrics, fp32 grads as a flat dict) of one (micro)batch."""
    flat = {k: v.detach().requires_grad_() for k, v in flatten(params).items()}
    loss, metrics = loss_fn(unflatten(flat), model_cfg, batch,
                            attn_impl=train_cfg.attn_impl,
                            remat=train_cfg.remat_policy)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return {k: v.detach() for k, v in metrics.items()}, dict(zip(flat, grads))


def _grads_and_metrics(params, batch, model_cfg: ModelConfig,
                       train_cfg: TrainConfig):
    """Microbatched value-and-grad; returns (grads fp32 tree, metrics)."""
    nm = train_cfg.num_microbatches
    sync_dt = getattr(torch, train_cfg.grad_sync_dtype)

    def sync_cast(g):
        return g.float() if sync_dt == torch.float32 \
            else g.to(sync_dt).float()

    if nm <= 1:
        metrics, grads = _value_and_grad(params, batch, model_cfg, train_cfg)
        return unflatten({k: sync_cast(g) for k, g in grads.items()}), \
            metrics

    rows = next(iter(batch.values())).shape[0]
    if rows % nm:
        raise ValueError(f"batch of {rows} rows does not split into {nm} "
                         f"microbatches")
    acc, macc = None, None
    for m in range(nm):
        # interleaved split, as the reference's (B, ...) -> (B/nm, nm, ...)
        mb = {k: v.view(rows // nm, nm, *v.shape[1:])[:, m]
              for k, v in batch.items()}
        metrics, grads = _value_and_grad(params, mb, model_cfg, train_cfg)
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
                    mesh=None):
    """Returns (train_step, optimizer); train_step(params, opt_state, batch,
    step) -> (params, opt_state, metrics), updating params and opt_state in
    place."""
    if mesh is not None:
        raise NotImplementedError("meshes belong to the distributed slice; "
                                  "this step runs on one device")
    opt = get_optimizer(train_cfg)
    lr_fn = lr_schedule(train_cfg)

    def train_step(params, opt_state, batch, step):
        grads, metrics = _grads_and_metrics(params, batch, model_cfg,
                                            train_cfg)
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
