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

Under a mesh (:mod:`repro_torch.train.step`) params, gradients and state
are this rank's pieces, split as :func:`opt_state_specs` says (a moment as
its param).  AdamW's arithmetic is elementwise.  Adafactor's factored
means (``vr`` over a row, ``vc`` over a column, the row mean of ``vr``) and
its update's RMS reduce over dimensions a mesh axis may split: ``update``
then takes the leaves' ``shardings`` and the ``mesh`` and adds the pieces'
sums over the ranks that hold the rest of each (the gathered gradient is
never made).  ``global_norm`` and ``clip_by_global_norm`` take the same
two to count every element once, however many ranks hold a copy.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.params import (
    ParamSpec, flatten, spec, tree_map, unflatten)
from repro_torch.parallel import comm


@dataclass(frozen=True)
class Optimizer:
    """init(params)->state; update(grads, state, params, lr)->(params,
    state), both updated in place.  Under a mesh both also take the
    leaves' ``shardings`` (and ``update`` the ``mesh``)."""

    init: Callable
    update: Callable
    name: str = ""


# --------------------------------------------------------------------------
# Utilities
# --------------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def global_norm(tree, shardings=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor on
    the leaves' device).  With ``shardings`` and ``mesh`` the leaves are
    this rank's pieces: a piece counts on the ranks at coordinate 0 of
    every axis that holds copies of it, and the sum is added over the
    mesh."""
    flat = flatten(tree)
    if not comm.axis_sizes(mesh) or not shardings:
        sq = [x.float().square().sum() for x in flat.values()]
        return torch.stack(sq).sum().sqrt()
    coord, fsh = comm.coordinate(mesh), flatten(shardings)
    sq = [x.float().square().sum() for k, x in flat.items()
          if all(coord[a] == 0 for a in fsh[k].replicated_axes)]
    total = torch.stack(sq).sum() if sq else \
        torch.zeros((), device=next(iter(flat.values())).device)
    return comm.all_reduce(total, mesh, tuple(comm.axis_sizes(mesh))).sqrt()


def clip_by_global_norm(tree, max_norm: float, shardings=None, mesh=None):
    """Scale every leaf by min(1, max_norm / norm), in place; returns
    (tree, norm).  The scale stays on the device (no host sync)."""
    norm = global_norm(tree, shardings, mesh)
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

    def init(params, shardings=None):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32)}

    def update(grads, state, params, lr, shardings=None, mesh=None):
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

    def init(params, shardings=None):
        fsh = flatten(shardings) if shardings else {}

        def one(path, p):
            dev = p.device
            m = torch.zeros_like(p, dtype=momentum_dtype) if b1 \
                else torch.zeros((), dtype=torch.float32, device=dev)
            # factored by the whole leaf's shape, not the piece's
            if _factored(fsh[path].shape if fsh else p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=dev),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32, device=dev),
                        "m": m}
            return {"v": torch.zeros_like(p, dtype=torch.float32), "m": m}
        flat = flatten(params)
        return {"s": unflatten({k: one(k, p) for k, p in flat.items()}),
                "count": torch.zeros((), dtype=torch.int32)}

    def update(grads, state, params, lr, shardings=None, mesh=None):
        count = _count(state)
        beta2_t = 1.0 - _f32(count) ** -0.8              # schedule
        beta2, rest = float(beta2_t), float(1.0 - beta2_t)
        fg = flatten(grads)
        fsh = flatten(shardings) if shardings else {}
        for path, p in flatten(params).items():
            s = _leaf_state(state["s"], path)
            g = fg[path].float()
            g2 = g.square().add_(eps2)
            axes = _Axes(fsh.get(path), mesh, p.ndim)
            if "vr" in s:
                s["vr"].mul_(beta2).add_(axes.mean(g2, -1), alpha=rest)
                s["vc"].mul_(beta2).add_(axes.mean(g2, -2), alpha=rest)
                vr, vc = s["vr"], s["vc"]
                denom = axes.mean(vr, -1, leaf_dim=-2,
                                  keepdim=True).clamp_min(eps2)
                vhat = (vr[..., None] * vc[..., None, :]).div_(
                    denom[..., None])
                upd = vhat.add_(eps2).rsqrt_().mul_(g)
            else:
                s["v"].mul_(beta2).add_(g2, alpha=rest)
                upd = (s["v"] + eps2).rsqrt_().mul_(g)
            del g2
            # update clipping by RMS (Shazeer & Stern eq. 6)
            rms = torch.sqrt(axes.mean_all(upd.square()) + eps2)
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


class _Axes:
    """Means over a leaf's dimensions when the leaf is a piece: the
    piece's sum added over the live mesh axes that split the dimension,
    divided by the whole dimension.  With nothing split, ``Tensor.mean``
    itself (the one-device arithmetic, bit for bit)."""

    def __init__(self, sharding, mesh, ndim: int):
        self.sh, self.mesh, self.ndim = sharding, mesh, ndim

    def _live(self, leaf_dims) -> tuple:
        if self.sh is None:
            return ()
        return comm.live_axes(self.mesh, tuple(
            a for d in leaf_dims for a in self.sh.dim_axes(d % self.ndim)))

    def mean(self, x, dim: int, leaf_dim=None, keepdim: bool = False):
        """x.mean(dim) where ``dim`` of x is the leaf's ``leaf_dim``
        (default: the same index)."""
        live = self._live((dim if leaf_dim is None else leaf_dim,))
        if not live:
            return x.mean(dim=dim, keepdim=keepdim)
        n = x.shape[dim] * comm.group_size(self.mesh, live)
        return comm.all_reduce(x.sum(dim=dim, keepdim=keepdim), self.mesh,
                               live).div_(n)

    def mean_all(self, x):
        live = self._live(range(self.ndim))
        if not live:
            return x.mean()
        n = x.numel() * comm.group_size(self.mesh, live)
        return comm.all_reduce(x.sum(), self.mesh, live).div_(n)


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


# --------------------------------------------------------------------------
# Spec-level optimizer state (for sharding the state as its params)
# --------------------------------------------------------------------------


def opt_state_specs(param_specs, cfg: TrainConfig):
    """ParamSpec tree of the optimizer state: moments inherit their
    param's axes (and the parts of its last dimension, ``segments``);
    Adafactor's ``vr`` drops the last, ``vc`` the one before."""
    count = spec((), (), torch.int32, init="zeros")

    def like(s: ParamSpec, dtype, **kw) -> ParamSpec:
        return dataclasses.replace(s, dtype=dtype, init="zeros", scale=None,
                                   value=0.0, **kw)

    if cfg.optimizer == "adamw":
        def mom(s: ParamSpec) -> ParamSpec:
            return like(s, torch.float32)
        return {"m": tree_map(mom, param_specs),
                "v": tree_map(mom, param_specs), "count": count}

    def one(s: ParamSpec):
        m = like(s, torch.bfloat16) \
            if cfg.beta1 else spec((), (), torch.float32, init="zeros")
        if _factored(s.shape):
            return {"vr": spec(s.shape[:-1], s.axes[:-1], torch.float32,
                               init="zeros"),
                    "vc": like(s, torch.float32,
                               shape=s.shape[:-2] + s.shape[-1:],
                               axes=s.axes[:-2] + s.axes[-1:]),
                    "m": m}
        return {"v": like(s, torch.float32), "m": m}
    return {"s": tree_map(one, param_specs), "count": count}
