"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro.models.moe``).

The reference's grouped dispatch, step for step:

  1. top-k routing -> (token, expert, gate) triples,
  2. stable sort by expert, rank within the expert from cumulative counts,
  3. triples whose rank reaches the capacity are dropped (sent to a dummy
     row ``E * cap``), the rest are scattered into an (E, C, d) buffer,
  4. batched expert FFN (swiglu) over (E, C, d): ``torch.bmm`` over the
     experts, as the reference leaves its einsum to XLA (no Pallas kernel),
  5. gate-weighted ``index_add_`` back to token order, in x's dtype.

``dispatch_groups`` splits the tokens into independent groups with their own
capacity (the reference vmaps over them; here a loop), falling back to one
group when the tokens do not divide or a group would route fewer than 8
triples.  Shared experts add a dense swiglu MLP.  The router runs in fp32
when ``router_dtype == "float32"`` (JAX promotes the bf16 x against the
fp32 router the same way).

Under autograd the dispatch's index write and the combine's ``index_add_``
differentiate as the reference's scatter-set and scatter-add (a dropped
triple, zeroed in the dummy row, gets no gradient); the router's gradient
flows through the gates into the combine and through the probabilities
into the aux loss.

Ties: :func:`route_topk` picks experts by a stable descending sort of the
probabilities, so of two equal probabilities the lower expert index wins, as
``jax.lax.top_k`` orders them.

The expert-parallel all-to-all dispatch (``impl="a2a"``,
``apply_moe_a2a``) needs a device mesh and is not ported (ROADMAP Queue 1,
distributed training).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_mlp, mlp_specs
from repro_torch.models.params import spec


def moe_specs(cfg: ModelConfig):
    m = cfg.moe
    d = cfg.d_model
    out = {
        "router": spec((d, m.num_experts), ("embed", "experts"),
                       scale=0.02),
        "w_gate": spec((m.num_experts, d, m.d_ff_expert),
                       ("experts", "embed", "mlp")),
        "w_up": spec((m.num_experts, d, m.d_ff_expert),
                     ("experts", "embed", "mlp")),
        "w_down": spec((m.num_experts, m.d_ff_expert, d),
                       ("experts", "mlp", "embed")),
    }
    if m.num_shared_experts:
        shared_cfg = dataclasses.replace(cfg, mlp_type="swiglu")
        out["shared"] = mlp_specs(shared_cfg, d_ff=m.d_ff_shared)
    return out


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Per-dispatch-group expert capacity, a multiple of 8 (at least 8)."""
    m = cfg.moe
    c = int(math.ceil(m.top_k * num_tokens * m.capacity_factor
                      / m.num_experts))
    return max(8, ((c + 7) // 8) * 8)


def route_topk(router_logits: torch.Tensor, top_k: int):
    """Softmax-then-top-k routing with renormalized gates.

    router_logits: (T, E) -> (gates (T, k) fp32, experts (T, k) int64,
    probs (T, E) fp32).  Equal probabilities go to the lower expert index
    first."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :top_k], experts[:, :top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return gates, experts, probs


def _dispatch_group(xt, logits, cfg: ModelConfig, cap: int):
    """One group's sort-based dispatch.  xt: (T, d); logits: (T, E).

    Returns (xe (E, C, d), combine state, stats)."""
    m = cfg.moe
    t, d = xt.shape
    e, k = m.num_experts, m.top_k
    dev = xt.device
    gates, experts, probs = route_topk(logits, k)

    flat_e = experts.reshape(-1)                          # (T*k,)
    flat_g = gates.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    tok_sorted = flat_tok[order]
    g_sorted = flat_g[order]
    if flat_e.device.type == "meta":
        # bincount sizes its output from the data, which a meta tensor (a
        # train step's flop count) does not have
        counts = flat_e.new_empty((e,))
    else:
        counts = torch.bincount(flat_e, minlength=e)      # (E,)
    starts = counts.cumsum(0) - counts
    rank = torch.arange(t * k, device=dev) - starts[e_sorted]
    keep = rank < cap
    # dropped triples all land, zeroed, in the dummy row e * cap
    buf_idx = torch.where(keep, e_sorted * cap + rank,
                          torch.full_like(rank, e * cap))

    xbuf = xt.new_zeros((e * cap + 1, d))
    xbuf[buf_idx] = xt[tok_sorted] * keep[:, None].to(xt.dtype)
    xe = xbuf[:e * cap].view(e, cap, d)

    n = max(t * k, 1)
    frac_tokens = counts.float() / n
    stats = {
        "aux_loss": e * (frac_tokens * probs.mean(dim=0)).sum(),
        "dropped": (1.0 - keep.float()).sum() / n,
        "max_load": frac_tokens.max() * e,
    }
    return xe, (buf_idx, tok_sorted, g_sorted), stats


def _combine_group(ye, state, t: int):
    """Scatter one group's expert outputs (E, C, d) back to token order."""
    buf_idx, tok_sorted, g_sorted = state
    e, cap, d = ye.shape
    ybuf = torch.cat([ye.reshape(e * cap, d), ye.new_zeros((1, d))])
    y_sorted = ybuf[buf_idx] * g_sorted[:, None].to(ye.dtype)
    return ye.new_zeros((t, d)).index_add_(0, tok_sorted, y_sorted)


def apply_moe(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (y, aux).  aux carries the load-balance statistics
    ``moe_aux_loss``, ``moe_dropped_frac`` and ``moe_max_load`` (0-dim fp32
    tensors), as the reference's."""
    m = cfg.moe
    if m.impl == "a2a":
        raise NotImplementedError(
            "the all-to-all MoE dispatch (impl='a2a') needs a device mesh: "
            "ROADMAP Queue 1, distributed training")
    dt = x.dtype
    b, s, d = x.shape
    t = b * s
    e = m.num_experts

    g = max(m.dispatch_groups, 1)
    if t % g != 0 or (t // g) * m.top_k < 8:
        g = 1
    tg = t // g
    cap = capacity(cfg, tg)
    xt = x.reshape(g, tg, d)
    rdt = torch.float32 if m.router_dtype == "float32" else dt
    logits = xt.to(rdt) @ p["router"].to(rdt)             # (G, T/G, E)

    groups = [_dispatch_group(xt[i], logits[i], cfg, cap) for i in range(g)]
    # (E, G*C, d): every group's buffer of an expert through one product
    xe = torch.stack([gr[0] for gr in groups], dim=1).view(e, g * cap, d)

    # ---- batched expert FFN (swiglu) ------------------------------------
    h = F.silu(torch.bmm(xe, p["w_gate"].to(dt)))
    h = h * torch.bmm(xe, p["w_up"].to(dt))
    ye = torch.bmm(h, p["w_down"].to(dt)).view(e, g, cap, d)
    del h

    # ---- combine ----------------------------------------------------------
    y = torch.cat([_combine_group(ye[:, i], groups[i][1], tg)
                   for i in range(g)]).view(b, s, d)

    if m.num_shared_experts:
        shared_cfg = dataclasses.replace(cfg, mlp_type="swiglu")
        y = y + apply_mlp(p["shared"], x, shared_cfg)

    stats = [gr[2] for gr in groups]
    aux = {"moe_aux_loss": torch.stack([st["aux_loss"]
                                        for st in stats]).mean(),
           "moe_dropped_frac": torch.stack([st["dropped"]
                                            for st in stats]).mean(),
           "moe_max_load": torch.stack([st["max_load"]
                                        for st in stats]).max()}
    return y, aux


def apply_moe_a2a(p, x, cfg: ModelConfig, mesh):
    """The reference's expert-parallel ragged all-to-all dispatch; it runs
    over a device mesh, which the one-device port does not have yet."""
    raise NotImplementedError(
        "apply_moe_a2a needs a device mesh and torch.distributed: ROADMAP "
        "Queue 1, distributed training")
