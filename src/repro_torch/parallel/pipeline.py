"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro.parallel.pipeline``), forward and backward.

Stage s (the rank at coordinate s of the ``"pipe"`` axis) holds slice s of
the stacked params.  Microbatches tick through ``num_microbatches + stages
- 1`` steps: at tick t stage s works on microbatch t - s, stage 0 takes it
from the batch, every other stage from what the stage before it sent at the
previous tick (``batch_isend_irecv``: neighbour-only traffic), and the last
stage keeps its outputs.  The reference's ticks where a stage holds no
microbatch compute what nothing reads; here they are skipped.  At the end
the last stage's outputs are broadcast to every stage (the reference uses a
masked ``psum``).  The bubble fraction is (S-1)/(M+S-1); pick M >= 4*S.

The backward is what ``jax.grad`` takes through the reference's
``ppermute`` hand-offs and masked ``psum``.  The whole schedule is one
autograd function, so its exchanges run in the order the schedule fixes,
the same on every rank (one function a hand-off would leave that order to
the autograd engine, which may differ between ranks and deadlock).  Where
grad mode is on and ``x`` or a stacked param requires grad, the forward
keeps each microbatch's local graph (``stage_fn`` may checkpoint inside);
the backward walks GPipe's reverse schedule over the same skipped ticks:
stage s takes the gradient of microbatch j's output from stage s+1 (the
last stage from the output's gradient, taken once: every rank computes the
same loss from the replicated output), runs that microbatch's local
backward and sends its input's gradient to stage s-1.  Stage 0's input
gradients are broadcast, so every rank holds the whole ``dx`` (``x`` is
replicated, the reference's ``in_specs P()``); rank s holds the gradient
of slice s of each stacked param (the reference's ``P("pipe")`` shard of
it) and zeros in the other slices.  The forward's exchanges are reported
under the purpose ``"pipe_act"``, the backward's under ``"pipe_grad"``
(``comm.purpose``).  Under ``torch.no_grad`` the forward keeps nothing.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.parallel import comm


class _Schedule(NamedTuple):
    stage_fn: Callable
    spec: object                        # the stacked params' tree structure
    stages: int
    stage: int
    microbatches: int
    group: object                       # None for one stage
    ranks: list                         # the axis' global ranks, in order
    keep: bool                          # keep the local graphs


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh, axis: str = "pipe", num_microbatches: int = 4):
    """Run ``x`` through ``stages`` sequential stages, pipelined.

    stage_fn(params_slice, x_mb) -> y_mb   (one stage's compute; y_mb of
    x_mb's shape and dtype, as the reference's ring hand-off needs, so the
    gradients sent back share them too)
    stage_params: tree with a leading stage dimension (the axis' size);
    this rank reads slice s (a view).
    x: (B, ...) the whole batch on every rank; B must divide into
    ``num_microbatches``.  Returns y: (B, ...) after all stages, on every
    rank.  The call is a collective, and so is a backward through its
    output: every rank of the axis runs both, with ``x`` and the stacked
    params requiring grad alike on every rank."""
    stages = comm.axis_sizes(mesh)[axis]
    if x.shape[0] % num_microbatches:
        raise ValueError(f"batch {x.shape[0]} does not split into "
                         f"{num_microbatches} microbatches")
    s = comm.coordinate(mesh)[axis]
    leaves, spec = tree_flatten(stage_params)
    keep = torch.is_grad_enabled() and (
        x.requires_grad or any(v.requires_grad for v in leaves))
    group = mesh.get_group(axis) if stages > 1 else None
    ranks = dist.get_process_group_ranks(group) if group is not None else []
    sched = _Schedule(stage_fn, spec, stages, s, num_microbatches, group,
                      ranks, keep)
    return _Pipeline.apply(sched, x, *[v[s] for v in leaves])


def _exchange(sched: _Schedule, send, dst: int, recv, src: int) -> None:
    """One tick's hand-off: ``send`` to stage ``dst``, ``recv`` from stage
    ``src`` (either may be None)."""
    if send is not None or recv is not None:
        comm.send_recv(send, sched.ranks[dst % sched.stages], recv,
                       sched.ranks[src % sched.stages], sched.group,
                       sched.stages)


class _Pipeline(torch.autograd.Function):
    """The schedule, forward and reverse; inputs ``x`` and this rank's
    slices of the stacked params' leaves."""

    @staticmethod
    def forward(ctx, sched: _Schedule, x, *mine):
        stages, s, m = sched.stages, sched.stage, sched.microbatches
        xs = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        params = [p.detach().requires_grad_(p.requires_grad and sched.keep)
                  for p in mine]
        local = tree_unflatten(params, sched.spec)
        outputs = torch.zeros_like(xs)
        kept = [None] * m
        state = None
        with comm.purpose("pipe_act"):
            for t in range(m + stages - 1):
                send = None
                if 0 <= t - s < m:
                    xin = xs[t] if s == 0 else state
                    if sched.keep:
                        xin = xin.detach().requires_grad_(
                            s > 0 or x.requires_grad)
                    with torch.set_grad_enabled(sched.keep):
                        y = sched.stage_fn(local, xin)
                    if sched.keep:
                        kept[t - s] = (xin, y)
                    y = y.detach()
                    if s == stages - 1:
                        outputs[t - s] = y
                    else:
                        send = y
                recv = None
                if s > 0 and 0 <= t + 1 - s < m:
                    state = recv = torch.empty_like(xs[0])
                _exchange(sched, send, s + 1, recv, s - 1)
            if sched.group is not None:
                comm.broadcast(outputs, sched.ranks[-1], sched.group,
                               stages)
        ctx.sched, ctx.params = sched, params
        ctx.kept = kept if sched.keep else None
        ctx.x_grad = x.requires_grad
        return outputs.reshape(x.shape)

    @staticmethod
    def backward(ctx, grad_out):
        sched, kept, params = ctx.sched, ctx.kept, ctx.params
        if kept is None:
            raise RuntimeError("pipeline_apply's backward ran twice, or "
                               "its forward kept no graph")
        ctx.kept = None
        stages, s, m = sched.stages, sched.stage, sched.microbatches
        gys = grad_out.reshape((m, grad_out.shape[0] // m)
                               + tuple(grad_out.shape[1:]))
        wanted = [p for p in params if p.requires_grad]
        acc = [None] * len(wanted)
        dx = torch.zeros_like(gys) if ctx.x_grad else None
        rev = stages - 1 - s                # the stage's place from the end
        g_state = None
        with comm.purpose("pipe_grad"):
            for u in range(m + stages - 1):
                send = None
                if 0 <= u - rev < m:
                    j = m - 1 - (u - rev)
                    xin, y = kept[j]
                    kept[j] = None
                    gy = gys[j] if s == stages - 1 else g_state
                    inputs = ([xin] if xin.requires_grad else []) + wanted
                    grads = torch.autograd.grad(
                        y, inputs, gy, allow_unused=True) \
                        if y.requires_grad else [None] * len(inputs)
                    if xin.requires_grad:
                        gx, grads = grads[0], grads[1:]
                        gx = torch.zeros_like(xin) if gx is None else gx
                        if s > 0:
                            send = gx
                        else:
                            dx[j] = gx
                    for i, g in enumerate(grads):
                        # the microbatches' sum in fp32 at least
                        if g is not None:
                            acc[i] = g.to(torch.promote_types(
                                g.dtype, torch.float32)) if acc[i] is None \
                                else acc[i].add_(g)
                recv = None
                if s < stages - 1 and 0 <= u + 1 - rev < m:
                    g_state = recv = torch.empty_like(gys[0])
                _exchange(sched, send, s - 1, recv, s + 1)
            if dx is not None and sched.group is not None:
                comm.broadcast(dx, sched.ranks[0], sched.group, stages)
        done = iter(acc)
        dparams = []
        for p in params:
            g = next(done) if p.requires_grad else None
            dparams.append(None if g is None else g.to(p.dtype))
        return (None, None if dx is None else dx.reshape(grad_out.shape),
                *dparams)


def bubble_fraction(stages: int, num_microbatches: int) -> float:
    """Pipeline bubble overhead (the napkin-math term used in §Perf)."""
    return (stages - 1) / (num_microbatches + stages - 1)
