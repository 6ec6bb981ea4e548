"""Collectives over the named axes of a device mesh (``torch.distributed``).

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` whose
dimensions carry the reference's axis names (``"pod"``, ``"data"``,
``"model"``, ``"pipe"``); the rank's process group along one axis is
``mesh.get_group(axis)``, whose group ranks follow the axis coordinate.
The reference's collectives inside ``shard_map`` (``psum``, ``all_gather``,
``psum_scatter``, ``all_to_all``) become the helpers here.

An axis of size 1 is skipped: no collective runs and no copy is made, so on
a one-rank mesh every helper returns its input (the data-parallel step on
one card holds no second copy of the parameters or gradients).  The
autograd functions (:func:`to_shard`, :func:`from_shard`,
:func:`all_to_all`) keep the rule the distributed step relies on: ranks
that differ only in their ``"model"`` coordinate compute one loss, and each
holds that loss's whole gradient.

Every collective of the port goes through this module, so a counter
installed with :func:`set_counter` (``launch.cost_analysis``) is told of
each one: its kind (the reference's names: ``"all-reduce"``,
``"all-gather"``, ``"reduce-scatter"``, ``"all-to-all"``,
``"collective-permute"``, and ``"broadcast"``), its operand's and output's
bytes and its group's size.  A group of one rank reports nothing, since
nothing crosses a wire there.  On a meta operand (a step traced for its
counts) the exchange itself is skipped: there is nothing to send, and the
outputs keep their shapes.  With no counter installed a helper pays one
``None`` check.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, or of a plain ``{name: size}``
    dict (a mesh's shape without processes, as the sharding binding
    takes); ``{}`` for no mesh."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def coordinate(mesh) -> dict:
    """{axis name: this rank's coordinate}; ``{}`` for no mesh."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def live_axes(mesh, axes) -> tuple:
    """The axes of ``axes`` that the mesh has with a size above 1."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in axes if sizes.get(a, 1) > 1)


def group_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in axes)


def group_index(mesh, axes) -> int:
    """This rank's index over ``axes`` flattened, the first axis major (the
    order of a dimension sharded over several axes)."""
    sizes, coord = axis_sizes(mesh), coordinate(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes.get(a, 1) + coord.get(a, 0)
    return idx


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

_counter = None


def set_counter(counter):
    """Install (or clear, with ``None``) the object told of every
    collective, ``counter.collective(kind, operand_bytes, output_bytes,
    group_size)``; returns the previous one."""
    global _counter
    prev = _counter
    _counter = counter
    return prev


def report(kind: str, operand: torch.Tensor, output_bytes: int,
           n: int) -> bool:
    """Tell the installed counter, if any, of one collective of ``n`` ranks
    (none for one rank); returns whether the exchange is to be skipped (a
    meta operand)."""
    if _counter is not None and n > 1:
        _counter.collective(kind, operand.numel() * operand.element_size(),
                            output_bytes, n)
    return operand.is_meta


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum"):
    """Reduce ``t`` in place over ``axes`` (``"sum"``, ``"mean"`` or
    ``"max"``); returns it."""
    live = live_axes(mesh, axes)
    for a in live:
        if _counter is not None and report(
                "all-reduce", t, t.numel() * t.element_size(),
                axis_sizes(mesh)[a]):
            continue
        dist.all_reduce(t, op=_OPS["sum" if op == "mean" else op],
                        group=mesh.get_group(a))
    if op == "mean" and live:
        t.div_(group_size(mesh, live))
    return t


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0):
    """The pieces of ``t`` over one axis, concatenated along ``dim`` in
    coordinate order."""
    n = axis_sizes(mesh).get(axis, 1)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    if _counter is None or not report(
            "all-gather", x, out.numel() * out.element_size(), n):
        dist.all_gather_into_tensor(out, x, group=mesh.get_group(axis))
    return out.movedim(0, dim).contiguous()


def gather_over_group(t: torch.Tensor, group) -> torch.Tensor:
    """(ranks, *t.shape): ``t`` of every rank of a process group, in rank
    order."""
    n = dist.get_world_size(group)
    x = t.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    if _counter is None or not report(
            "all-gather", x, out.numel() * out.element_size(), n):
        dist.all_gather_into_tensor(out, x, group=group)
    return out.view((n,) + tuple(t.shape))


def all_reduce_over_group(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of a process group; returns it."""
    if _counter is None or not report(
            "all-reduce", t, t.numel() * t.element_size(),
            dist.get_world_size(group)):
        dist.all_reduce(t, group=group)
    return t


def send_recv(send, dst: int, recv, src: int, group, n: int) -> None:
    """Send ``send`` to global rank ``dst`` and receive into ``recv`` from
    global rank ``src`` over ``group`` of ``n`` ranks (either may be
    ``None``): a pipeline's neighbour hand-off, reported by its sender as
    a ``"collective-permute"``."""
    ops = []
    if send is not None and (_counter is None or not report(
            "collective-permute", send, send.numel() * send.element_size(),
            n)):
        ops.append(dist.P2POp(dist.isend, send.contiguous(), dst, group))
    if recv is not None and (_counter is None or not recv.is_meta):
        ops.append(dist.P2POp(dist.irecv, recv, src, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def broadcast(t: torch.Tensor, src: int, group, n: int) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank of ``group`` (``n``
    ranks), in place; returns it."""
    if _counter is None or not report(
            "broadcast", t, t.numel() * t.element_size(), n):
        dist.broadcast(t, src=src, group=group)
    return t


def stack_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """(group size, *t.shape): ``t`` of every rank over ``axes``, indexed
    as :func:`group_index` orders them."""
    out = t[None]
    for a in reversed(axes):
        n = axis_sizes(mesh).get(a, 1)
        if n > 1:
            out = all_gather(out[None], mesh, a, 0).flatten(0, 1)
    return out


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int):
    """The sum of ``t`` over one axis, of which this rank keeps its chunk
    along ``dim`` (``t.shape[dim]`` divided by the axis size)."""
    n = axis_sizes(mesh).get(axis, 1)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    if _counter is None or not report(
            "reduce-scatter", x, out.numel() * out.element_size(), n):
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                   group=mesh.get_group(axis))
    return out.movedim(0, dim)


def chunk(t: torch.Tensor, mesh, axis: str, dim: int):
    """This rank's chunk of ``t`` along ``dim`` over one axis (a view)."""
    n = axis_sizes(mesh).get(axis, 1)
    if n == 1:
        return t
    k = t.shape[dim] // n
    return t.narrow(dim, coordinate(mesh)[axis] * k, k)


class _ToShard(torch.autograd.Function):
    """Forward: this rank's chunk; backward: the chunks' gradients gathered,
    so every rank of the axis holds the whole gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return chunk(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _FromShard(torch.autograd.Function):
    """Forward: the chunks gathered; backward: this rank's chunk of the
    gradient (every rank of the axis holds the same one)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (chunk(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None,
                None, None)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` in equal chunks along dim 0; its gradient is
    the same exchange, which sends each chunk back where it came from."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _exchange(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.mesh, ctx.axis), None, None


def _exchange(x, mesh, axis: str):
    x = x.contiguous()
    out = torch.empty_like(x)
    if _counter is None or not report(
            "all-to-all", x, out.numel() * out.element_size(),
            axis_sizes(mesh).get(axis, 1)):
        dist.all_to_all_single(out, x, group=mesh.get_group(axis))
    return out


def to_shard(x, mesh, axis: str, dim: int = 0):
    """Replicated over ``axis`` -> this rank's chunk (see :class:`_ToShard`)."""
    if axis_sizes(mesh).get(axis, 1) == 1:
        return x
    return _ToShard.apply(x, mesh, axis, dim)


def from_shard(x, mesh, axis: str, dim: int = 0):
    """Chunks over ``axis`` -> gathered (see :class:`_FromShard`)."""
    if axis_sizes(mesh).get(axis, 1) == 1:
        return x
    return _FromShard.apply(x, mesh, axis, dim)


def all_to_all(x, mesh, axis: str):
    """Chunk j of dim 0 to the rank at coordinate j of ``axis``, with
    gradients.  Runs on a one-rank axis too (the exchange is a copy), so
    the all-to-all dispatch takes its collective path on one card."""
    if x.requires_grad:
        return _AllToAll.apply(x, mesh, axis)
    return _exchange(x, mesh, axis)
