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

Under a mesh (``pc.mesh``) each rank holds its own rows of the global batch
(:mod:`repro_torch.train.step`).  The grouped dispatch then computes the
reference's function of the global batch: with one dispatch group (every
shipped config) the experts' counts of all data-parallel ranks are
gathered (E integers a rank), a triple's rank within its expert is its
rank among the triples of every earlier rank plus its own, and the
capacity is that of the global token count, so the same triples are kept
as the reference keeps; with several groups each rank dispatches its own
whole groups.  The statistics come out as this rank's term of the global
value: the mean over the data-parallel ranks of ``moe_aux_loss`` and
``moe_dropped_frac`` and the largest ``moe_max_load`` are the reference's.

``impl="a2a"`` runs :func:`apply_moe_a2a`, the expert-parallel all-to-all
dispatch over the ``"model"`` axis, when the mesh meets its preconditions
(no ``"pod"`` axis, ``num_experts`` and the local token count divisible by
the ``"model"`` size), and otherwise the grouped dispatch, as the
reference does; :func:`dispatch_counts` records which ran.

Under tensor-parallel compute (``tp``, a live "model" axis; a serving
pass takes the same layout, its rows whole over "model") the expert stacks are this rank's pieces where the binding splits
them (``sharding.tp_roles``): its ``E / tp`` experts, or, where the
experts do not divide, every expert's ``d_ff / tp`` hidden columns.
Routing reads the whole sequence (``tp.whole``: the same rows, logits,
routes, capacity and statistics on every "model" rank, the router whole);
the dispatch fills the buffer from ``tp.enter(x, True)`` with this rank's
experts' triples only (or every expert's, for the hidden columns); the
combine is then this rank's partial sum, which leaves through
``tp.leave(y, True)``.  Gradients: the routing path's gradient of x is the
same on every rank and goes back through ``tp.whole`` (this rank's rows of
it, no sum); the dispatch path's is a partial sum, summed by ``enter``'s
backward; the combine's gradient of a gate is a partial sum too (this
rank's experts or columns), so the gates pass ``comm.copy_to_model``,
whose backward sums them over "model" before they reach the router.  The
all-to-all dispatch takes this rank's experts as they are stored where
they are split on ``experts`` (it runs on the whole sequence and returns
it whole); with the hidden columns split it falls back to the grouped
dispatch.  Shared experts follow the MLP's rule: split columns add to the
partial sum, whole ones run on the whole sequence.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_mlp, mlp_specs
from repro_torch.models.params import spec
from repro_torch.parallel import comm

# dispatches run since the last reset, by kind ("grouped" or "a2a"); a
# checkpointed block's re-run dispatches again
_DISPATCHES = {"grouped": 0, "a2a": 0}


def dispatch_counts() -> dict:
    """MoE layer calls by dispatch kind since the last reset."""
    return dict(_DISPATCHES)


def reset_dispatch_counts() -> None:
    for k in _DISPATCHES:
        _DISPATCHES[k] = 0


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


def _bincount(idx, n: int):
    """``torch.bincount(idx, minlength=n)`` for indices below ``n``: (n,)
    counts.  On a meta tensor (a step traced for its counts) the shape
    alone: bincount sizes its output from the data, which a meta tensor
    does not have."""
    if idx.device.type == "meta":
        return idx.new_empty((n,))
    return torch.bincount(idx, minlength=n)


def _dispatch_group(xt, logits, cfg: ModelConfig, cap: int, dp=None,
                    owned=None):
    """One group's sort-based dispatch.  xt: (T, d); logits: (T, E).
    ``dp``: (mesh, data-parallel axes) when this group is this rank's part
    of a group spread over those ranks (the counts of every rank are
    gathered and the ranks within an expert continue from the earlier
    ranks'); ``cap`` is then the global group's capacity.  ``owned``:
    (first, count), the experts whose buffer rows this rank fills (every
    expert's triples are ranked and counted alike; the others land, zeroed,
    in the dummy row); None: all.

    Returns (xe (count, C, d), combine state, stats)."""
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
    counts = _bincount(flat_e, e)                         # (E,)
    starts = counts.cumsum(0) - counts
    rank = torch.arange(t * k, device=dev) - starts[e_sorted]
    if dp is None:
        keep = rank < cap
        n = max(t * k, 1)
        counts_all = counts
        dropped = (1.0 - keep.float()).sum() / n
    else:
        every = comm.stack_over(counts, *dp)              # (ranks, E)
        before = every[:comm.group_index(*dp)].sum(0)
        keep = rank + before[e_sorted] < cap
        counts_all = every.sum(0)
        n = max(t * k * every.shape[0], 1)
        dropped = (counts_all - counts_all.clamp_max(cap)).sum().float() / n
    e0, n_e = owned or (0, e)
    if n_e != e:
        keep = keep & (e_sorted >= e0) & (e_sorted < e0 + n_e)
    # dropped triples (and other ranks' experts') all land, zeroed, in the
    # dummy row n_e * cap
    buf_idx = torch.where(keep, (e_sorted - e0) * cap + rank,
                          torch.full_like(rank, n_e * cap))

    xbuf = xt.new_zeros((n_e * cap + 1, d))
    xbuf[buf_idx] = xt[tok_sorted] * keep[:, None].to(xt.dtype)
    xe = xbuf[:n_e * cap].view(n_e, cap, d)

    frac_tokens = counts_all.float() / n
    stats = {
        # with dp: this rank's term (its tokens' mean probabilities), whose
        # mean over the ranks is the global statistic
        "aux_loss": e * (frac_tokens * probs.mean(dim=0)).sum(),
        "dropped": dropped,
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


def _a2a_fits(x, cfg: ModelConfig, mesh) -> bool:
    """The all-to-all dispatch's preconditions, as the reference checks
    them: no "pod" axis, the experts and this rank's tokens divisible by
    the "model" size."""
    sizes = comm.axis_sizes(mesh)
    tp = sizes.get("model", 1)
    return "pod" not in sizes and cfg.moe.num_experts % tp == 0 and \
        (x.shape[0] * x.shape[1]) % tp == 0


def apply_moe(p, x, cfg: ModelConfig, pc=None, tp=None):
    """x: (B, S, d) -> (y, aux).  aux carries the load-balance statistics
    ``moe_aux_loss``, ``moe_dropped_frac`` and ``moe_max_load`` (0-dim fp32
    tensors), as the reference's.  ``pc``: the partition constraints; with
    a mesh, x holds this rank's rows (see the module docstring).  ``tp``:
    the pass's tensor-parallel layout; x and y are then in its layout and
    the expert stacks this rank's pieces where the binding splits them."""
    m = cfg.moe
    mesh = getattr(pc, "mesh", None)
    specs = moe_specs(cfg) if tp is not None else None
    dim = tp.split_dim(specs["w_gate"]) if tp is not None else None
    split = dim is not None
    xr = x if tp is None else tp.whole(x)       # routing: every rank alike
    if m.impl == "a2a" and mesh is not None and dim in (None, 0) and \
            _a2a_fits(xr, cfg, mesh):
        y, aux = apply_moe_a2a(p, xr, cfg, mesh, local=split, shared=False)
        partial, whole = None, y
    else:
        xd = tp.enter(x, True) if split else xr  # dispatch: partial grads
        owned = None
        if dim == 0:
            n_e = p["w_gate"].shape[0]
            owned = (tp.rank * n_e, n_e)
        y, aux = _apply_grouped(p, xr, xd, cfg, pc, owned,
                                tp if split else None)
        partial, whole = (y, None) if split else (None, y)
    if m.num_shared_experts:
        shared_cfg = dataclasses.replace(cfg, mlp_type="swiglu")
        if tp is not None and tp.splits(specs["shared"]["w_up"]):
            xs = xd if partial is not None else tp.enter(x, True)
            ys = apply_mlp(p["shared"], xs, shared_cfg)
            partial = ys if partial is None else partial + ys
        else:
            ys = apply_mlp(p["shared"], xr, shared_cfg)
            whole = ys if whole is None else whole + ys
    if tp is None:
        return whole, aux
    out = None if whole is None else tp.local(whole)
    if partial is not None:
        red = tp.leave(partial, True)
        out = red if out is None else red + out
    return out, aux


def _apply_grouped(p, xr, xd, cfg: ModelConfig, pc, owned, tp):
    """The grouped dispatch: routes from ``xr``'s rows, fills the buffer
    from ``xd``'s (the same rows; the same tensor without tensor
    parallelism), runs the experts of ``p`` (``owned``: (first, count)
    of this rank's, None: all) and combines.  ``tp`` (the stacks split):
    the gates pass ``comm.copy_to_model``, and y is this rank's partial
    sum.  Returns (y (B, S, d), aux) without shared experts."""
    _DISPATCHES["grouped"] += 1
    m = cfg.moe
    mesh = getattr(pc, "mesh", None)
    dt = xr.dtype
    b, s, d = xr.shape
    t = b * s
    e = m.num_experts if owned is None else owned[1]
    axes = pc.dp_axes if mesh is not None else ()
    ranks = comm.group_size(mesh, axes)

    g = max(m.dispatch_groups, 1)
    if (t * ranks) % g != 0 or (t * ranks // g) * m.top_k < 8:
        g = 1
    dp = None
    if ranks > 1:
        if g == 1:
            dp = (mesh, axes)          # one group over every rank's tokens
        elif g % ranks == 0:
            g //= ranks                # this rank's whole groups
        else:
            raise NotImplementedError(
                f"{g} dispatch groups over {ranks} data-parallel ranks")
    tg = t // g
    cap = capacity(cfg, tg * (ranks if dp else 1))
    xt = xd.reshape(g, tg, d)
    rdt = torch.float32 if m.router_dtype == "float32" else dt
    logits = xr.reshape(g, tg, d).to(rdt) @ p["router"].to(rdt)

    groups = [_dispatch_group(xt[i], logits[i], cfg, cap, dp, owned)
              for i in range(g)]
    # (E, G*C, d): every group's buffer of an expert through one product
    xe = torch.stack([gr[0] for gr in groups], dim=1).view(e, g * cap, d)

    # ---- batched expert FFN (swiglu) ------------------------------------
    h = F.silu(torch.bmm(xe, p["w_gate"].to(dt)))
    h = h * torch.bmm(xe, p["w_up"].to(dt))
    ye = torch.bmm(h, p["w_down"].to(dt)).view(e, g, cap, d)
    del h

    # ---- combine ----------------------------------------------------------
    if tp is not None:
        # a gate's gradient here is this rank's share: summed over "model"
        groups = [(xe_, (idx, tok, comm.copy_to_model(gts, tp.mesh)), st)
                  for xe_, (idx, tok, gts), st in groups]
    y = torch.cat([_combine_group(ye[:, i], groups[i][1], tg)
                   for i in range(g)]).view(b, s, d)

    stats = [gr[2] for gr in groups]
    aux = {"moe_aux_loss": torch.stack([st["aux_loss"]
                                        for st in stats]).mean(),
           "moe_dropped_frac": torch.stack([st["dropped"]
                                            for st in stats]).mean(),
           "moe_max_load": torch.stack([st["max_load"]
                                        for st in stats]).max()}
    return y, aux


def _cap8(n: int) -> int:
    return max(8, ((n + 7) // 8) * 8)


def apply_moe_a2a(p, x, cfg: ModelConfig, mesh, local: bool = False,
                  shared: bool = True):
    """Expert-parallel dispatch with explicit all-to-alls over the "model"
    axis (port of the reference's ``apply_moe_a2a``).

    x: (B_loc, S, d), this rank's rows (one "data" coordinate's; the
    "model" ranks of a coordinate hold the same rows).  Each "model" rank
    dispatches its 1/tp slice of the local tokens, buckets them by the rank
    that owns their expert (capacity ``cap_send`` a destination), sends
    them with ``all_to_all_single``, runs its E/tp local experts (capacity
    ``cap_loc`` an expert), sends the outputs back, combines them and
    gathers the slices over "model".  The capacities are the reference's.
    The router runs in fp32 as the reference's does here.  Shared experts
    and the aux statistics (a routing pass over the rows, summed over the
    "data" ranks; no dropped fraction, 0 as the reference reports) run
    outside the exchange.

    Gradients: the slicing, gathering and exchanges are autograd functions
    (:mod:`repro_torch.parallel.comm`) under which each "model" rank ends
    with the whole gradient of the one loss its coordinate computes: the
    router's logits are made for every local token and sliced, the local
    experts are sliced from the whole stacks.  ``local``: the stacks are
    this rank's experts already (tensor-parallel compute), used as they
    are, so their gradient is this rank's piece.  ``shared``: whether the
    shared experts are added here (the tensor-parallel caller adds them by
    their own binding).

    Preconditions (raise): a mesh with no "pod" axis, num_experts and the
    local token count divisible by the "model" size."""
    if mesh is None:
        raise ValueError("apply_moe_a2a needs a device mesh with a 'model' "
                         "axis (apply_moe runs the grouped dispatch "
                         "without one)")
    if not _a2a_fits(x, cfg, mesh):
        raise ValueError(f"a2a dispatch: mesh {comm.axis_sizes(mesh)} does "
                         f"not fit {cfg.moe.num_experts} experts and "
                         f"{x.shape[0] * x.shape[1]} tokens")
    _DISPATCHES["a2a"] += 1
    m = cfg.moe
    dt = x.dtype
    b, s, d = x.shape
    dev = x.device
    tp = comm.axis_sizes(mesh).get("model", 1)
    e, k = m.num_experts, m.top_k
    e_local = e // tp
    t_loc = b * s
    t_my = t_loc // tp                                   # this rank's slice
    cap_send = _cap8(math.ceil(k * t_my * m.capacity_factor / tp))
    cap_loc = capacity(cfg, t_loc)                       # per local expert

    xt_all = x.reshape(t_loc, d)
    xt = comm.to_shard(xt_all, mesh, "model")
    logits = comm.to_shard(xt_all.float() @ p["router"].float(), mesh,
                           "model")
    gates, experts, _ = route_topk(logits, k)

    # ---- bucket my tokens by destination rank ------------------------------
    flat_e = experts.reshape(-1)                         # (t_my*k,)
    dst = torch.div(flat_e, e_local, rounding_mode="floor")
    flat_tok = torch.arange(t_my, device=dev).repeat_interleave(k)
    order = torch.sort(dst, stable=True).indices
    dst_s, tok_s, exp_s = dst[order], flat_tok[order], flat_e[order]
    gate_s = gates.reshape(-1)[order]
    counts = _bincount(dst, tp)
    rank = torch.arange(t_my * k, device=dev) - \
        (counts.cumsum(0) - counts)[dst_s]
    keep = rank < cap_send
    slot = torch.where(keep, dst_s * cap_send + rank,
                       torch.full_like(rank, tp * cap_send))

    send_x = xt.new_zeros((tp * cap_send + 1, d))
    send_x[slot] = xt[tok_s] * keep[:, None].to(dt)
    send_le = torch.full((tp * cap_send + 1,), e_local, dtype=torch.long,
                         device=dev)
    send_le[slot] = torch.where(keep, exp_s % e_local,
                                torch.full_like(exp_s, e_local))
    recv_x = comm.all_to_all(send_x[:-1], mesh, "model")
    rle = comm.all_to_all(send_le[:-1], mesh, "model")  # e_local = padding

    # ---- local expert compute ----------------------------------------------
    order2 = torch.sort(rle, stable=True).indices
    rle_s = rle[order2]
    c2 = _bincount(rle, e_local + 1)[:e_local]
    rank2 = torch.arange(tp * cap_send, device=dev) - \
        (c2.cumsum(0) - c2)[rle_s.clamp_max(e_local - 1)]
    keep2 = (rle_s < e_local) & (rank2 < cap_loc)
    slot2 = torch.where(keep2, rle_s * cap_loc + rank2,
                        torch.full_like(rank2, e_local * cap_loc))
    xbuf = recv_x.new_zeros((e_local * cap_loc + 1, d))
    xbuf[slot2] = recv_x[order2] * keep2[:, None].to(dt)
    xe = xbuf[:-1].view(e_local, cap_loc, d)

    wg, wu, wd = ((p[w] if local else comm.to_shard(p[w], mesh, "model"))
                  .to(dt) for w in ("w_gate", "w_up", "w_down"))
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    ye = torch.bmm(h, wd)
    del h

    # ---- return path ---------------------------------------------------------
    ybuf = torch.cat([ye.reshape(e_local * cap_loc, d), ye.new_zeros((1, d))])
    y_recv = ye.new_zeros((tp * cap_send, d)).index_copy(0, order2,
                                                         ybuf[slot2])
    back = comm.all_to_all(y_recv, mesh, "model")
    ybuf2 = torch.cat([back, back.new_zeros((1, d))])
    y_sorted = ybuf2[slot] * (gate_s * keep.float())[:, None].to(dt)
    y_my = xt.new_zeros((t_my, d)).index_add_(0, tok_s, y_sorted)
    y = comm.from_shard(y_my, mesh, "model").view(b, s, d)

    if shared and m.num_shared_experts:
        shared_cfg = dataclasses.replace(cfg, mlp_type="swiglu")
        y = y + apply_mlp(p["shared"], x, shared_cfg)
    return y, _a2a_aux(p, x, cfg, mesh)


def _a2a_aux(p, x, cfg: ModelConfig, mesh) -> dict:
    """The reference's aux statistics of the a2a path, from a routing pass
    over every token of the global batch: the mean probabilities of this
    rank's rows, averaged over the "data" ranks.  The aux loss is
    e * sum(mean^2); its term here has that value, and the gradient of the
    ranks' mean of terms is the gradient of the global loss (the global
    mean enters as a constant beside this rank's own mean)."""
    e = cfg.moe.num_experts
    logits = x @ p["router"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    mine = probs.reshape(-1, e).mean(dim=0)
    mean = comm.all_reduce(mine.detach().clone(), mesh, ("data",), "mean")
    aux = e * (mean * mean).sum() + \
        e * (2 * mean * (mine - mine.detach())).sum()
    return {"moe_aux_loss": aux,
            "moe_dropped_frac": torch.zeros((), device=x.device),
            "moe_max_load": mean.max() * e}
