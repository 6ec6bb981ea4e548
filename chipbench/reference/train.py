"""A training run's first steps, followed in plain fp32.

The port's step (``repro_torch.train``) on the configuration's ``port``
section and the traffic's settings: next-token cross-entropy averaged over
every token of the batch, gradients clipped by their global norm, AdamW
with the port's bias corrections and weight decay, the learning rate
warmed up linearly from 0.  The batch goes through one row at a time,
each row's loss scaled to its share of the batch, so the activations of
one row are live at a time.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from chipbench.reference import data, model, params as rparams


def lr_at(step: int, traffic: dict) -> float:
    """The warmup-then-cosine schedule at ``step``, in fp32 (the port's
    ``lr_schedule``); the benchmark's runs stay inside the warmup."""
    s = torch.tensor(step, dtype=torch.float32)
    warm = traffic["warmup_steps"]
    if float(s) < warm:
        return float(traffic["learning_rate"] * s / max(warm, 1))
    raise ValueError(f"step {step} is past the warmup of {warm} steps")


def batch(seed: int, step: int, port: dict, traffic: dict, device):
    toks = data.token_rows(seed, step, traffic["global_batch"],
                           traffic["seq_len"], port["vocab_size"])
    t = torch.from_numpy(toks.astype(np.int64)).to(device)
    return t[:, :-1], t[:, 1:]


def loss_and_grads(p: dict, tokens, labels, port: dict,
                   mm: model.Products):
    """(mean loss, gradients) over the batch, a row at a time."""
    for t in p.values():
        t.grad = None
    total = labels.numel()
    loss = 0.0
    for r in range(tokens.shape[0]):
        lg = model.logits(p, port, tokens[r:r + 1], mm)
        nll = torch.nn.functional.cross_entropy(
            lg.reshape(-1, lg.shape[-1]), labels[r], reduction="sum") / total
        nll.backward()
        loss += float(nll.detach())
        del lg, nll
    return loss, {k: t.grad for k, t in p.items()}


def follow(port: dict, traffic: dict, seed: int, steps: int, device, *,
           fp8: bool = False) -> dict:
    """The first ``steps`` steps from the seed.  Returns ``losses`` (one a
    step), ``grad`` (each leaf's norm of the clipped gradient the optimizer
    takes at the first step), ``grad_norm`` (the first step's global norm
    before clipping) and ``change`` (each leaf's norm of its change over the
    ``steps`` steps)."""
    mm = model.Products(fp8=fp8)
    p = {k: t.requires_grad_() for k, t in
         rparams.init_params(port, seed, device).items()}
    b1, b2 = traffic["beta1"], traffic["beta2"]
    eps, wd = traffic["eps"], traffic["weight_decay"]
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    losses, first, gnorm0 = [], {}, None
    for step in range(steps):
        tokens, labels = batch(seed, step, port, traffic, device)
        loss, grads = loss_and_grads(p, tokens, labels, port, mm)
        losses.append(loss)
        with torch.no_grad():
            norm = torch.stack([g.square().sum() for g in grads.values()]
                               ).sum().sqrt()
            scale = (traffic["grad_clip_norm"] / norm.clamp_min(1e-9)
                     ).clamp_max(1.0)
            for g in grads.values():
                g.mul_(scale)
            if step == 0:
                gnorm0 = float(norm)
                first = {k: float(g.norm()) for k, g in grads.items()}
                base = {k: t.detach().clone() for k, t in p.items()}
            count = step + 1
            c1 = float(1 - b1 ** torch.tensor(count, dtype=torch.float32))
            c2 = float(1 - b2 ** torch.tensor(count, dtype=torch.float32))
            lr = lr_at(step, traffic)
            for k, t in p.items():
                g = grads[k]
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[k] / c1).div_((v[k] / c2).sqrt_().add_(eps))
                upd.add_(t, alpha=wd)
                t.copy_(upd.mul_(-lr).add_(t))
        del grads
    with torch.no_grad():
        change = {k: float((t - base[k]).norm()) for k, t in p.items()}
    return {"losses": losses, "grad": first, "grad_norm": gnorm0,
            "change": change}


def median(values) -> float:
    s = sorted(values)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def gaps(run: dict, ref: dict) -> dict:
    """The numbers compared, from a run's readings and the reference's:

    * ``loss``: the largest relative gap of a step's loss;
    * ``grad``: the worst leaf's gap between the two norms of the first
      clipped gradient, over the reference's norm of that leaf or of the
      median leaf, whichever is larger;
    * ``change``: the same for each leaf's change over the steps, leaving
      out the leaves whose reference gradient is under a thousandth of the
      median leaf's (moved by round-off alone, under Adam)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                   ref["losses"]))
    med_g = median(ref["grad"].values())
    grad = max(abs(run["grad"][k] - r) / max(r, med_g)
               for k, r in ref["grad"].items())
    moved = [k for k, r in ref["grad"].items() if r >= 1e-3 * med_g]
    med_c = median([ref["change"][k] for k in moved])
    change = max(abs(run["change"][k] - ref["change"][k])
                 / max(ref["change"][k], med_c) for k in moved)
    worst = {
        "grad": max(ref["grad"], key=lambda k: abs(run["grad"][k]
                                                   - ref["grad"][k])
                    / max(ref["grad"][k], med_g)),
        "change": max(moved, key=lambda k: abs(run["change"][k]
                                               - ref["change"][k])
                      / max(ref["change"][k], med_c))}
    if not all(math.isfinite(x) for x in (loss, grad, change)):
        loss = grad = change = math.inf
    return {"loss": loss, "grad": grad, "change": change,
            "left_out": sorted(set(ref["grad"]) - set(moved)),
            "worst": worst}
