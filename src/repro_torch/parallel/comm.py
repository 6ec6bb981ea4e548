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
outputs keep their shapes.

Tensor-parallel compute (Megatron-style) adds the four region operations,
autograd functions over ``"model"``: :func:`copy_to_model` (identity
forward, all-reduce backward) before a column-parallel product,
:func:`reduce_from_model` (all-reduce forward, identity backward) after a
row-parallel one, and their sequence-parallel forms :func:`gather_seq`
(all-gather along the sequence forward, reduce-scatter backward) and
:func:`scatter_seq` (reduce-scatter forward, all-gather backward).  With
them the rule above still holds: ranks that differ only in ``"model"``
compute one loss, and each holds that loss's whole gradient of the
activations (under sequence parallelism, of its own rows of the residual
stream).

The recurrent families add exchanges along the last dimension:
:func:`gather_shared_columns` (all-gather forward, reduce-scatter backward:
Mamba2's B and C, which every head reads), :func:`scatter_columns`
(reduce-scatter forward, all-gather backward), :func:`gather_columns`
(all-gather forward, this rank's columns backward) and, under sequence
parallelism, :func:`columns_to_rows` (an all-to-all each way): RWKV6's
channel mix, whose row-parallel output meets a column-split gate.

FSDP adds one more, :func:`gather_piece`: a param's stored piece gathered
into the leaf a pass computes with (forward), this rank's piece of its
gradient's mean over "data" (backward, :func:`grad_piece`), so a pass that
gathers each layer inside the layer's call holds one layer gathered at a
time and its gradients come back as pieces.

**Host staging.**  gloo's CUDA support is partial, so a collective over a
gloo group with an operand on a CUDA device copies its operand to the
host, exchanges there and copies the result back (:func:`_run`), through
page-locked host buffers (copied faster than pageable ones) kept by size
until the next :func:`reset_staged`; the bytes it moves each way are
counted (:func:`staged`, and by purpose :func:`staged_by_purpose`).  Under
NCCL, or on CPU tensors, nothing is staged.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

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
_PURPOSES: list = []


def set_counter(counter):
    """Install (or clear, with ``None``) the object told of every
    collective, ``counter.collective(kind, operand_bytes, output_bytes,
    group_size, purpose)``; returns the previous one."""
    global _counter
    prev = _counter
    _counter = counter
    return prev


@contextmanager
def purpose(name: str):
    """The collectives reported inside are told to the counter as
    ``name``'s (the innermost name wins): ``"param_gather"`` and
    ``"grad_scatter"`` (a param's gather and its gradient's sync,
    :func:`gather_piece`), ``"model_sum"`` (row-parallel and vocabulary
    sums), ``"bc_gather"`` (Mamba2's B and C), ``"norm_stat"`` (a norm's
    row statistic over columns split over "model"), ``"channel_mix"``
    (RWKV6's channel-mix columns), serving's ``"query_gather"`` and
    ``"partial_merge"``, and a pipeline's ``"pipe_act"`` (the forward's
    hand-offs and the outputs' broadcast) and ``"pipe_grad"`` (the
    backward's hand-offs and the input gradient's broadcast)."""
    _PURPOSES.append(name)
    try:
        yield
    finally:
        _PURPOSES.pop()


def report(kind: str, operand: torch.Tensor, output_bytes: int,
           n: int) -> bool:
    """Tell the installed counter, if any, of one collective of ``n`` ranks
    (none for one rank), with its :func:`purpose` (None outside one);
    returns whether the exchange is to be skipped (a meta operand)."""
    if _counter is not None and n > 1:
        _counter.collective(kind, operand.numel() * operand.element_size(),
                            output_bytes, n,
                            _PURPOSES[-1] if _PURPOSES else None)
    return operand.is_meta


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# collectives staged through the host, and the bytes they moved between
# the device and the host (both ways), since the last reset; and the same
# by purpose
_STAGED = {"collectives": 0, "bytes": 0}
_STAGED_BY: dict = {}
# page-locked host buffers of the staged exchanges, by (role, elements,
# dtype): a run's exchanges repeat a few sizes layer after layer
_HOST: dict = {}


def staged() -> dict:
    """Collectives staged through the host (a gloo group with CUDA
    operands) and the bytes they copied, since the last reset."""
    return dict(_STAGED)


def staged_by_purpose() -> dict:
    """{purpose (:func:`purpose`; ``"other"`` outside one): {"collectives",
    "bytes"}} of what :func:`staged` counts."""
    return {k: dict(v) for k, v in _STAGED_BY.items()}


def reset_staged() -> None:
    """Zero the counts and free the staging buffers."""
    for k in _STAGED:
        _STAGED[k] = 0
    _STAGED_BY.clear()
    _HOST.clear()


def _host(t: torch.Tensor, role: str) -> torch.Tensor:
    """A page-locked host buffer of ``t``'s shape and dtype for ``role``
    (``"in"`` or ``"out"``), reused by later exchanges of the same size."""
    key = (role, t.numel(), t.dtype)
    buf = _HOST.get(key)
    if buf is None:
        buf = _HOST[key] = torch.empty(t.numel(), dtype=t.dtype,
                                       pin_memory=True)
    return buf.view(t.shape)


def _run(fn, group, out: torch.Tensor, inp=None, **kw) -> None:
    """``fn(out, inp, group=group)`` (or ``fn(out, group=group)`` in place
    when ``inp`` is None), staged through the host where the group is gloo
    and the operand on a CUDA device (gloo's CUDA support is partial): the
    operand is copied to the host, exchanged there and the result copied
    back."""
    if not (out.is_cuda and dist.get_backend(group) == "gloo"):
        if inp is None:
            fn(out, group=group, **kw)
        else:
            fn(out, inp, group=group, **kw)
        return
    if inp is None:
        host = _host(out, "out").copy_(out)
        fn(host, group=group, **kw)
        moved = 2 * _nbytes(out)
    else:
        # the output is only written: a host buffer, not a copy of it
        host = _host(out, "out")
        fn(host, _host(inp, "in").copy_(inp), group=group, **kw)
        moved = _nbytes(inp) + _nbytes(out)
    out.copy_(host)
    _count_staged(moved)


def _count_staged(moved: int) -> None:
    """One staged exchange of ``moved`` bytes between the device and the
    host, under the current purpose."""
    by = _STAGED_BY.setdefault(_PURPOSES[-1] if _PURPOSES else "other",
                               {"collectives": 0, "bytes": 0})
    for counts in (_STAGED, by):
        counts["collectives"] += 1
        counts["bytes"] += moved


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum"):
    """Reduce ``t`` in place over ``axes`` (``"sum"``, ``"mean"`` or
    ``"max"``); returns it."""
    live = live_axes(mesh, axes)
    for a in live:
        if report("all-reduce", t, _nbytes(t), axis_sizes(mesh)[a]):
            continue
        _run(dist.all_reduce, mesh.get_group(a), t,
             op=_OPS["sum" if op == "mean" else op])
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
    if not report("all-gather", x, _nbytes(out), n):
        _run(dist.all_gather_into_tensor, mesh.get_group(axis), out, x)
    return out.movedim(0, dim).contiguous()


def gather_over_group(t: torch.Tensor, group) -> torch.Tensor:
    """(ranks, *t.shape): ``t`` of every rank of a process group, in rank
    order."""
    n = dist.get_world_size(group)
    x = t.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    if not report("all-gather", x, _nbytes(out), n):
        _run(dist.all_gather_into_tensor, group, out, x)
    return out.view((n,) + tuple(t.shape))


def all_reduce_over_group(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of a process group; returns it."""
    if not report("all-reduce", t, _nbytes(t), dist.get_world_size(group)):
        _run(dist.all_reduce, group, t)
    return t


def send_recv(send, dst: int, recv, src: int, group, n: int) -> None:
    """Send ``send`` to global rank ``dst`` and receive into ``recv`` from
    global rank ``src`` over ``group`` of ``n`` ranks (either may be
    ``None``): a pipeline's neighbour hand-off, reported by its sender as
    a ``"collective-permute"``.  Staged through the host as :func:`_run`
    stages a collective where the group is gloo and a tensor on a CUDA
    device (one staged exchange: the bytes sent and received)."""
    staging = dist.get_backend(group) == "gloo" and any(
        t is not None and t.is_cuda for t in (send, recv))
    ops, moved, host = [], 0, None
    if send is not None and not report("collective-permute", send,
                                       _nbytes(send), n):
        buf = send.contiguous()
        if staging:
            buf = _host(buf, "in").copy_(buf)
            moved += _nbytes(buf)
        ops.append(dist.P2POp(dist.isend, buf, dst, group))
    if recv is not None and not recv.is_meta:
        host = _host(recv, "out") if staging else recv
        ops.append(dist.P2POp(dist.irecv, host, src, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if host is not None and host is not recv:
        recv.copy_(host)
        moved += _nbytes(recv)
    if moved:
        _count_staged(moved)


def broadcast(t: torch.Tensor, src: int, group, n: int) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank of ``group`` (``n``
    ranks), in place; returns it."""
    if not report("broadcast", t, _nbytes(t), n):
        _run(dist.broadcast, group, t, src=src)
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
    if not report("reduce-scatter", x, _nbytes(out), n):
        _run(dist.reduce_scatter_tensor, mesh.get_group(axis), out, x,
             op=dist.ReduceOp.SUM)
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
    if not report("all-to-all", x, _nbytes(out),
                  axis_sizes(mesh).get(axis, 1)):
        _run(dist.all_to_all_single, mesh.get_group(axis), out, x)
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


# --------------------------------------------------------------------------
# A param's piece, gathered for compute (FSDP)
# --------------------------------------------------------------------------


def segment_columns(segments: tuple, idx: int, n: int) -> list:
    """The columns of a last dimension made of parts of widths
    ``segments`` that the piece ``idx`` of ``n`` holds: the ``idx``-th of
    ``n`` equal chunks of each part, in part order (``sharding.Sharding``'s
    ``segments``: Mamba2's ``[z_r | x_r | BC_r | dt_r]``)."""
    out, lo = [], 0
    for w in segments:
        k = w // n
        out.extend(range(lo + idx * k, lo + (idx + 1) * k))
        lo += w
    return out


def take_columns(t: torch.Tensor, cols: list) -> torch.Tensor:
    """``t[..., cols]`` (a copy; shapes only on a meta tensor)."""
    if t.is_meta:
        return t.new_empty(tuple(t.shape[:-1]) + (len(cols),))
    return t.index_select(-1, torch.as_tensor(cols, device=t.device))


def merge_segments(t: torch.Tensor, segments: tuple, n: int):
    """The ``n`` pieces of a segmented last dimension
    (:func:`segment_columns`), concatenated in piece order -> the
    dimension in its own order."""
    if n == 1:
        return t
    order = [c for i in range(n) for c in segment_columns(segments, i, n)]
    inv = [0] * len(order)
    for j, c in enumerate(order):
        inv[c] = j
    return take_columns(t, inv)


def gather_dims(piece: torch.Tensor, sh, mesh, skip: tuple = ()):
    """The leaf from the pieces of the ranks that hold it: each dimension
    gathered over the axes ``sh`` (a ``sharding.Sharding``) splits it
    over, the innermost axis first (``piece`` itself where nothing is
    gathered); a segmented last dimension (``sh.segments``) is put back in
    its own order.  Axes in ``skip`` are not gathered: the result is then
    this rank's piece over them."""
    out = piece
    last = len(sh.shape) - 1
    for i in range(len(sh.shape)):
        axes = sh.dim_axes(i)
        kept = [a for a in axes if a not in skip]
        for a in reversed(kept):
            out = all_gather(out, mesh, a, i)
        if i == last and sh.segments and kept:
            if len(kept) != len(axes):
                raise NotImplementedError(
                    f"a segmented dimension gathered over {kept} of {axes}")
            out = merge_segments(out, sh.segments, group_size(mesh, axes))
    return out


def grad_piece(g: torch.Tensor, sh, mesh, role: str) -> torch.Tensor:
    """A gradient of the leaf a rank computed with (``role``, as
    ``sharding.tp_roles`` says) -> this rank's piece of its mean over
    "data", for a leaf stored as ``sh`` says.  A ``"partial"`` gradient is
    first summed over "model".  Ranks that differ only in "model" then
    hold the same ``"whole"`` gradient, so the dimensions "model" splits
    are cut locally (a ``"split"`` gradient is this rank's piece of them
    already); "data" reduce-scatters the dimension it splits (or
    all-reduces a leaf it does not split), then divides by its size.
    A segmented last dimension (``sh.segments``) is cut as the piece is
    (:func:`segment_columns`).  Never writes into ``g``."""
    if role == "partial" and live_axes(mesh, (MODEL,)):
        g = all_reduce(g.clone(memory_format=torch.contiguous_format), mesh,
                       (MODEL,))
    data_dim = None
    for i in range(g.ndim):
        live = live_axes(mesh, sh.dim_axes(i))
        if len(live) > 1:
            raise NotImplementedError(f"dimension {i} of a {sh.shape} leaf "
                                      f"split over {live}")
        if live == ("data",):
            if sh.segments and i == g.ndim - 1:
                raise NotImplementedError("a segmented dimension split over "
                                          "\"data\"")
            data_dim = i
        elif live and role != "split":
            if sh.segments and i == g.ndim - 1:
                axes = sh.dim_axes(i)
                g = take_columns(g, segment_columns(
                    sh.segments, group_index(mesh, axes),
                    group_size(mesh, axes)))
            else:
                g = chunk(g, mesh, live[0], i)
    if not live_axes(mesh, ("data",)):
        return g
    if data_dim is None:
        g = all_reduce(g.clone(memory_format=torch.contiguous_format), mesh,
                       ("data",))
    else:
        g = reduce_scatter(g, mesh, "data", data_dim)
    return g.div_(axis_sizes(mesh)["data"])


class _GatherPiece(torch.autograd.Function):
    """Forward: the leaf a rank computes with, from its stored piece
    (:func:`gather_dims`, a ``"split"`` leaf not over "model"); backward:
    this rank's piece of the gradient's mean over "data"
    (:func:`grad_piece`), in fp32 and returned in the piece's dtype."""

    @staticmethod
    def forward(ctx, piece, sh, mesh, role):
        ctx.sh, ctx.mesh, ctx.role, ctx.dtype = sh, mesh, role, piece.dtype
        with purpose("param_gather"):
            out = gather_dims(piece, sh, mesh,
                              (MODEL,) if role == "split" else ())
        return piece.view_as(piece) if out is piece else out

    @staticmethod
    def backward(ctx, g):
        with purpose("grad_scatter"):
            g = grad_piece(g.float(), ctx.sh, ctx.mesh, ctx.role)
        return g.to(ctx.dtype), None, None, None


def gather_piece(piece: torch.Tensor, sh, mesh, role: str) -> torch.Tensor:
    """This rank's stored piece of a param (``sh``: its
    ``sharding.Sharding``) -> the leaf its pass computes with, as
    ``role`` says (``sharding.tp_roles``: a ``"split"`` leaf gathered over
    every axis but "model", any other whole), with the gradient of
    :class:`_GatherPiece`: each call's backward syncs its own gradient
    over "data" (``"grad_scatter"``), so a pass that gathers a layer's
    leaves inside the layer's call holds one layer gathered at a time, and
    its gradients come back as pieces.  A leaf no live axis splits (a
    norm's scale) goes through it too: its gather is the identity and its
    backward an all-reduce over "data", one a call (not one a step).
    Where nothing crosses a live axis (every axis of a one-rank mesh) it
    returns ``piece`` itself."""
    crosses = live_axes(mesh, ("data",)) or any(
        a != MODEL or role != "split" for a in live_axes(mesh, sh.axes)) or \
        (role == "partial" and live_axes(mesh, (MODEL,)))
    return _GatherPiece.apply(piece, sh, mesh, role) if crosses else piece


# --------------------------------------------------------------------------
# Tensor-parallel regions over "model"
# --------------------------------------------------------------------------

MODEL = "model"
SEQ_DIM = 1                     # (B, S, ...) activations


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity (each model rank feeds its column-parallel
    piece); backward: the pieces' gradients summed over "model"."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, (MODEL,)), None


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the row-parallel partial sums summed over "model";
    backward: the identity (every rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.contiguous().clone(), mesh, (MODEL,))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    """Forward: this rank's rows of the sequence gathered over "model";
    backward: the gradient summed over "model", this rank keeping its
    rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather(x, mesh, MODEL, SEQ_DIM)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, MODEL, SEQ_DIM).contiguous(), None


class _ScatterSeq(torch.autograd.Function):
    """Forward: the partial sums summed over "model", this rank keeping
    its rows of the sequence (a reduce-scatter); backward: the rows'
    gradients gathered."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return reduce_scatter(x, mesh, MODEL, SEQ_DIM).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, MODEL, SEQ_DIM), None


def _model_live(mesh) -> bool:
    return axis_sizes(mesh).get(MODEL, 1) > 1


def copy_to_model(x, mesh):
    """Before a column-parallel product (see :class:`_CopyToModel`)."""
    return _CopyToModel.apply(x, mesh) if _model_live(mesh) else x


def reduce_from_model(x, mesh):
    """After a row-parallel product (see :class:`_ReduceFromModel`)."""
    if not _model_live(mesh):
        return x
    with purpose("model_sum"):
        return _ReduceFromModel.apply(x, mesh)


def gather_seq(x, mesh):
    """(B, S / tp, ...) rows -> (B, S, ...) before a column-parallel
    product under sequence parallelism (see :class:`_GatherSeq`)."""
    return _GatherSeq.apply(x, mesh) if _model_live(mesh) else x


def scatter_seq(x, mesh):
    """(B, S, ...) partial sums -> this rank's (B, S / tp, ...) rows of
    their sum after a row-parallel product (see :class:`_ScatterSeq`)."""
    return _ScatterSeq.apply(x, mesh) if _model_live(mesh) else x


# --------------------------------------------------------------------------
# Column exchanges over "model" (the recurrent families)
# --------------------------------------------------------------------------

COL_DIM = -1                    # (..., columns) activations


class _GatherSharedColumns(torch.autograd.Function):
    """Forward: this rank's columns gathered over "model" (every rank then
    reads all of them); backward: the gradient summed over "model", this
    rank keeping its columns (a reduce-scatter): each rank's use of the
    whole is a partial sum of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh, ctx.name = mesh, name
        with purpose(name):
            return all_gather(x, mesh, MODEL, COL_DIM)

    @staticmethod
    def backward(ctx, g):
        with purpose(ctx.name):
            return (reduce_scatter(g, ctx.mesh, MODEL, COL_DIM).contiguous(),
                    None, None)


class _ScatterColumns(torch.autograd.Function):
    """Forward: partial sums over "model" -> this rank's columns of their
    sum (a reduce-scatter); backward: the columns' gradients gathered."""

    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh, ctx.name = mesh, name
        with purpose(name):
            return reduce_scatter(x, mesh, MODEL, COL_DIM).contiguous()

    @staticmethod
    def backward(ctx, g):
        with purpose(ctx.name):
            return all_gather(g, ctx.mesh, MODEL, COL_DIM), None, None


class _GatherColumns(torch.autograd.Function):
    """Forward: this rank's columns gathered over "model"; backward: this
    rank's columns of the gradient, which every rank holds whole (its
    downstream is the same on every "model" rank)."""

    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh = mesh
        with purpose(name):
            return all_gather(x, mesh, MODEL, COL_DIM)

    @staticmethod
    def backward(ctx, g):
        return (chunk(g, ctx.mesh, MODEL, COL_DIM).contiguous(), None,
                None)


def _columns_to_rows(x, mesh):
    """(B, S, c) this rank's columns of every row -> (B, S / n, n c) every
    rank's columns (in coordinate order) of this rank's rows."""
    n = axis_sizes(mesh)[MODEL]
    b, s, c = x.shape
    got = _exchange(x.reshape(b, n, s // n, c).transpose(0, 1), mesh, MODEL)
    return got.permute(1, 2, 0, 3).reshape(b, s // n, n * c)


def _rows_to_columns(x, mesh):
    """The inverse of :func:`_columns_to_rows`."""
    n = axis_sizes(mesh)[MODEL]
    b, r, nc = x.shape
    got = _exchange(x.reshape(b, r, n, nc // n).permute(2, 0, 1, 3), mesh,
                    MODEL)
    return got.transpose(0, 1).reshape(b, n * r, nc // n)


class _ColumnsToRows(torch.autograd.Function):
    """Forward: this rank's columns of the whole sequence -> every column
    of this rank's rows (an all-to-all over "model"); backward: the
    inverse exchange (each rank holds its rows' whole gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh, ctx.name = mesh, name
        with purpose(name):
            return _columns_to_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        with purpose(ctx.name):
            return _rows_to_columns(g, ctx.mesh), None, None


def gather_shared_columns(x, mesh, name: str = "bc_gather"):
    """(..., c / tp) -> (..., c): columns every "model" rank reads whole,
    each rank's use a partial sum of their gradient (Mamba2's B and C,
    read by every head: see :class:`_GatherSharedColumns`), reported as
    ``name``'s."""
    return _GatherSharedColumns.apply(x, mesh, name) if _model_live(mesh) \
        else x


def scatter_columns(x, mesh, name: str = "channel_mix"):
    """(..., c) partial sums -> this rank's (..., c / tp) columns of their
    sum (see :class:`_ScatterColumns`), reported as ``name``'s."""
    return _ScatterColumns.apply(x, mesh, name) if _model_live(mesh) else x


def gather_columns(x, mesh, name: str = "channel_mix"):
    """(..., c / tp) this rank's columns -> (..., c) on every rank, whose
    gradient each rank holds whole (see :class:`_GatherColumns`), reported
    as ``name``'s."""
    return _GatherColumns.apply(x, mesh, name) if _model_live(mesh) else x


def columns_to_rows(x, mesh, name: str = "channel_mix"):
    """(B, S, c / tp) this rank's columns -> (B, S / tp, c): the
    sequence-parallel layout's rows, whole (see :class:`_ColumnsToRows`),
    reported as ``name``'s: under sequence parallelism in place of
    :func:`gather_columns` and a cut to this rank's rows, 1 / tp of the
    bytes each way."""
    return _ColumnsToRows.apply(x, mesh, name) if _model_live(mesh) else x
