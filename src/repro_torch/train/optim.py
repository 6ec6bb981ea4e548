"""Optimizers as plain functions over dicts of tensors (port of
``repro.train.optim``).

* **AdamW** — fp32 moments ``m``/``v`` of the params' structure plus a
  step ``count``.
* **Adafactor** — factored second moment (row/column means for every leaf
  whose last two dims exceed 1) and bf16 momentum (Shazeer & Stern 2018).

The state's nested layout is the reference's, so a state flattens to the
same "/"-joined keys and checkpoints carry across.  ``count`` is a 0-d int32
tensor on the CPU.  Scalars (bias corrections, the second-moment schedule,
the learning rate) are computed in fp32, as the reference does.

``update`` works in place: it overwrites the params and the state given to
it (where the reference donates their buffers to the jitted step) and
returns them.  Its arithmetic on each leaf runs in place too, so a leaf
needs at most two temporaries of its size (deepseek-v2-236b's expert
stacks are 5 GB each in fp32).  ``clip_by_global_norm`` scales the gradients in place.
Sharding specs (``opt_state_specs``) wait for the distributed slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.params import flatten, tree_map, unflatten


@dataclass(frozen=True)
class Optimizer:
    """init(params)->state; update(grads, state, params, lr)->(params,
    state), both updated in place."""

    init: Callable
    update: Callable
    name: str = ""


# --------------------------------------------------------------------------
# Utilities
# --------------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor on
    the leaves' device)."""
    sq = [x.float().square().sum() for x in flatten(tree).values()]
    return torch.stack(sq).sum().sqrt()


def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf by min(1, max_norm / norm), in place; returns
    (tree, norm).  The scale stays on the device (no host sync)."""
    norm = global_norm(tree)
    scale = (max_norm / norm.clamp_min(1e-9)).clamp_max(1.0)
    for x in flatten(tree).values():
        x.mul_(scale)
    return tree, norm


def lr_schedule(cfg: TrainConfig):
    """Linear warmup -> cosine decay to 10% of peak; step -> lr (float,
    computed in fp32)."""
    def lr(step) -> float:
        s = _f32(step)
        if float(s) < cfg.warmup_steps:
            return float(cfg.learning_rate * s / max(cfg.warmup_steps, 1))
        prog = ((s - cfg.warmup_steps)
                / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0., 1.)
        return float(cfg.learning_rate
                     * (0.1 + 0.45 * (1 + torch.cos(math.pi * prog))))
    return lr


def _count(state) -> int:
    return int(state["count"]) + 1


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


def adamw(cfg: TrainConfig) -> Optimizer:
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay

    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32)}

    def update(grads, state, params, lr):
        count = _count(state)
        c1 = float(1 - b1 ** _f32(count))
        c2 = float(1 - b2 ** _f32(count))
        fg, fm, fv = flatten(grads), flatten(state["m"]), flatten(state["v"])
        for path, p in flatten(params).items():
            g, m, v = fg[path].float(), fm[path], fv[path]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            step = (m / c1).div_((v / c2).sqrt_().add_(eps))
            pf = p.float()
            step.add_(pf, alpha=wd)
            p.copy_(step.mul_(-lr).add_(pf))      # pf - lr * step
            del step                # before the next leaf's temporaries
        state["count"] = torch.tensor(count, dtype=torch.int32)
        return params, state

    return Optimizer(init, update, "adamw")


# --------------------------------------------------------------------------
# Adafactor
# --------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(cfg: TrainConfig, momentum_dtype=torch.bfloat16) -> Optimizer:
    eps2 = 1e-30
    clip_thresh = 1.0
    wd = cfg.weight_decay
    b1 = cfg.beta1                     # bf16 momentum (0 disables)

    def init(params):
        def one(p):
            dev = p.device
            m = torch.zeros_like(p, dtype=momentum_dtype) if b1 \
                else torch.zeros((), dtype=torch.float32, device=dev)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=dev),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32, device=dev),
                        "m": m}
            return {"v": torch.zeros_like(p, dtype=torch.float32), "m": m}
        flat = flatten(params)
        return {"s": unflatten({k: one(p) for k, p in flat.items()}),
                "count": torch.zeros((), dtype=torch.int32)}

    def update(grads, state, params, lr):
        count = _count(state)
        beta2_t = 1.0 - _f32(count) ** -0.8              # schedule
        beta2, rest = float(beta2_t), float(1.0 - beta2_t)
        fg = flatten(grads)
        for path, p in flatten(params).items():
            s = _leaf_state(state["s"], path)
            g = fg[path].float()
            g2 = g.square().add_(eps2)
            if "vr" in s:
                s["vr"].mul_(beta2).add_(g2.mean(dim=-1), alpha=rest)
                s["vc"].mul_(beta2).add_(g2.mean(dim=-2), alpha=rest)
                vr, vc = s["vr"], s["vc"]
                denom = vr.mean(dim=-1, keepdim=True).clamp_min(eps2)
                vhat = (vr[..., None] * vc[..., None, :]).div_(
                    denom[..., None])
                upd = vhat.add_(eps2).rsqrt_().mul_(g)
            else:
                s["v"].mul_(beta2).add_(g2, alpha=rest)
                upd = (s["v"] + eps2).rsqrt_().mul_(g)
            del g2
            # update clipping by RMS (Shazeer & Stern eq. 6)
            rms = torch.sqrt(upd.square().mean() + eps2)
            upd.div_((rms / clip_thresh).clamp_min(1.0))
            if b1:
                upd = s["m"].float().mul_(b1).add_(upd, alpha=1 - b1)
                s["m"] = upd.to(momentum_dtype)
            pf = p.float()
            upd.add_(pf, alpha=wd)
            p.copy_(upd.mul_(-lr).add_(pf))       # pf - lr * upd
            del upd                 # before the next leaf's temporaries
        state["count"] = torch.tensor(count, dtype=torch.int32)
        return params, state

    return Optimizer(init, update, "adafactor")


def _leaf_state(tree, path: str) -> dict:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def get_optimizer(cfg: TrainConfig) -> Optimizer:
    if cfg.optimizer == "adamw":
        return adamw(cfg)
    if cfg.optimizer == "adafactor":
        return adafactor(cfg)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
