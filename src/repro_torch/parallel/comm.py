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
time and its gradients come back as pieces.  A leaf every use of which
casts it to the pass's compute dtype first is gathered in that dtype (its
``wire`` dtype): the piece is cast before the exchange and the leaf cast
back after it, which moves no bit of the pass and halves the bytes of an
fp32 matrix gathered for a bf16 pass.

**Exchanges in flight** (the overlapped step, ``--overlap-flags``).
:func:`start` issues an exchange and returns a :class:`Pending`, whose
:meth:`Pending.wait` gives its output: a layer's gathers are issued before
the layer ahead of it computes (``sharding.LayerGathers``), and each
gradient's sync runs while the backward goes on, its result credited to
the leaf's gradient by a :class:`GradSink` once the backward has ended.
They run on a second process group per axis (:func:`overlap_groups`), so
each group's exchanges keep the one order every rank issues them in, apart
from the collectives the compute path runs on the mesh's own groups.  Over
gloo they run, in issue order, on one worker thread; a CUDA operand is
copied to the host there on a side stream, after an event marks it ready on
the compute stream, the exchange runs on the host copy, and its result is
copied back on the same stream, which the compute stream waits for at
:meth:`Pending.wait`.  Over NCCL they are
issued on the side stream (ProcessGroupNCCL runs each group's collectives
on its one internal stream, in issue order); events order the two streams
both ways and ``record_stream`` covers every tensor the side stream reads
or writes.  On a meta operand an issued exchange is reported and skipped at
once, as every helper does.  The collectives run in flight are counted by
purpose (:func:`overlapped`).

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
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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
# what an exchange in flight runs under, per thread: its purpose and the
# mesh's overlap groups (:func:`_job`)
_local = threading.local()
_LOCK = threading.Lock()


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
    backward's hand-offs and the input gradient's broadcast).  An exchange
    in flight keeps the purpose it was issued under (:func:`start`)."""
    _PURPOSES.append(name)
    try:
        yield
    finally:
        _PURPOSES.pop()


def _purpose():
    """The current purpose: an exchange in flight's own, else the innermost
    :func:`purpose` (None outside one)."""
    own = getattr(_local, "purpose", None)
    if own is not None:
        return own
    return _PURPOSES[-1] if _PURPOSES else None


def report(kind: str, operand: torch.Tensor, output_bytes: int,
           n: int) -> bool:
    """Tell the installed counter, if any, of one collective of ``n`` ranks
    (none for one rank), with its :func:`purpose` (None outside one), and
    count it by purpose where it runs in flight (:func:`overlapped`);
    returns whether the exchange is to be skipped (a meta operand)."""
    if _counter is not None and n > 1 and not getattr(_local, "mute",
                                                      False):
        _counter.collective(kind, operand.numel() * operand.element_size(),
                            output_bytes, n, _purpose())
    if n > 1 and not operand.is_meta and getattr(_local, "groups", None) \
            is not None:
        with _LOCK:
            key = _purpose() or "other"
            _OVERLAPPED[key] = _OVERLAPPED.get(key, 0) + 1
    return operand.is_meta


def _group(mesh, axis: str):
    """The process group of ``axis``: inside an exchange in flight, the
    axis's overlap group (:func:`overlap_groups`), else the mesh's own."""
    groups = getattr(_local, "groups", None)
    if groups is not None and axis in groups:
        return groups[axis]
    return mesh.get_group(axis)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# collectives staged through the host, and the bytes they moved between
# the device and the host (both ways), since the last reset; and the same
# by purpose
_STAGED = {"collectives": 0, "bytes": 0}
_STAGED_BY: dict = {}
# page-locked host buffers of the staged exchanges, by (role, elements,
# dtype), each lent to one exchange at a time (:func:`_host`): a run's
# exchanges repeat a few sizes layer after layer, and an exchange in flight
# may have the same sizes as one on the compute path
_HOST: dict = {}
_LENT: set = set()
# collectives run in flight, by purpose, since the last reset
_OVERLAPPED: dict = {}


def staged() -> dict:
    """Collectives staged through the host (a gloo group with CUDA
    operands) and the bytes they copied, since the last reset."""
    return dict(_STAGED)


def staged_by_purpose() -> dict:
    """{purpose (:func:`purpose`; ``"other"`` outside one): {"collectives",
    "bytes"}} of what :func:`staged` counts."""
    return {k: dict(v) for k, v in _STAGED_BY.items()}


def overlapped() -> dict:
    """{purpose: collectives run in flight} (:func:`start`; ``"other"``
    outside a purpose) since the last :func:`reset_staged`."""
    with _LOCK:
        return dict(_OVERLAPPED)


def reset_staged() -> None:
    """Zero the counts (staged and in flight) and free the staging
    buffers."""
    with _LOCK:
        for k in _STAGED:
            _STAGED[k] = 0
        _STAGED_BY.clear()
        _OVERLAPPED.clear()
        _HOST.clear()
        _LENT.clear()


def _host(t: torch.Tensor, role: str) -> torch.Tensor:
    """A page-locked host buffer of ``t``'s shape and dtype for ``role``
    (``"in"`` or ``"out"``), lent to the caller until :func:`_give_back`
    and reused by later exchanges of the same size."""
    key = (role, t.numel(), t.dtype)
    with _LOCK:
        bufs = _HOST.setdefault(key, [])
        buf = next((b for b in bufs if id(b) not in _LENT), None)
        if buf is None:
            buf = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
            bufs.append(buf)
        _LENT.add(id(buf))
    return buf.view(t.shape)


def _give_back(*views) -> None:
    """Return :func:`_host` buffers (their views) for reuse."""
    with _LOCK:
        for v in views:
            if v is not None:
                _LENT.discard(id(v._base if v._base is not None else v))


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
    host = src = None
    try:
        if inp is None:
            host = _host(out, "out").copy_(out)
            fn(host, group=group, **kw)
            moved = 2 * _nbytes(out)
        else:
            # the output is only written: a host buffer, not a copy of it
            host = _host(out, "out")
            src = _host(inp, "in").copy_(inp)
            fn(host, src, group=group, **kw)
            moved = _nbytes(inp) + _nbytes(out)
        out.copy_(host)
    finally:
        _give_back(host, src)
    _count_staged(moved)


def _count_staged(moved: int) -> None:
    """One staged exchange of ``moved`` bytes between the device and the
    host, under the current purpose."""
    with _LOCK:
        by = _STAGED_BY.setdefault(_purpose() or "other",
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
        _run(dist.all_reduce, _group(mesh, a), t,
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
        _run(dist.all_gather_into_tensor, _group(mesh, axis), out, x)
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
    ops, moved, host, sent = [], 0, None, None
    try:
        if send is not None and not report("collective-permute", send,
                                           _nbytes(send), n):
            buf = send.contiguous()
            if staging:
                buf = sent = _host(buf, "in").copy_(buf)
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
    finally:
        _give_back(sent, host if host is not recv else None)
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
        _run(dist.reduce_scatter_tensor, _group(mesh, axis), out, x,
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
        _run(dist.all_to_all_single, _group(mesh, axis), out, x)
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


def gathered_axes(sh, mesh, role: str) -> tuple:
    """The live axes a leaf's gather (:func:`gather_dims`) crosses: every
    live axis ``sh`` splits it over, but "model" for a ``"split"`` one."""
    return tuple(a for a in live_axes(mesh, sh.axes)
                 if a != MODEL or role != "split")


def _gathered_shape(piece: torch.Tensor, sh, mesh, role: str) -> tuple:
    """The shape :func:`gather_dims` makes of ``piece``."""
    sizes, skip = axis_sizes(mesh), (MODEL,) if role == "split" else ()
    return tuple(d * math.prod(sizes.get(a, 1) for a in sh.dim_axes(i)
                               if a not in skip)
                 for i, d in enumerate(piece.shape))


class _GatherPiece(torch.autograd.Function):
    """Forward: the leaf a rank computes with, from its stored piece
    (:func:`gather_dims`, a ``"split"`` leaf not over "model"), moved in
    ``wire`` (None: its own dtype) and returned in the piece's, or, given
    ``pending`` (:func:`start_gather`), that exchange's output; backward:
    this rank's piece of the gradient's mean over "data"
    (:func:`grad_piece`), in fp32 and returned in the piece's dtype, or,
    given a ``sink`` (:class:`GradSink`), that sync issued in flight and
    nothing returned to autograd (the sink credits it to the leaf once the
    backward has ended)."""

    @staticmethod
    def forward(ctx, piece, sh, mesh, role, wire, pending, sink):
        ctx.sh, ctx.mesh, ctx.role, ctx.dtype = sh, mesh, role, piece.dtype
        ctx.sink = sink
        if sink is not None:
            ctx.target = GradSink.target(piece)
        if pending is not None:
            out = pending.wait()
        else:
            with purpose("param_gather"):
                out = gather_dims(piece.to(wire or piece.dtype), sh, mesh,
                                  (MODEL,) if role == "split" else ())
        if out is piece:
            return piece.view_as(piece)
        # the round trip through a narrower wire dtype is exact for a leaf
        # every use of which casts it to that dtype
        return out.to(piece.dtype, memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        if ctx.sink is not None:
            ctx.sink.start(ctx.target, g, ctx.sh, ctx.mesh, ctx.role,
                           ctx.dtype)
            return None, None, None, None, None, None, None
        with purpose("grad_scatter"):
            g = grad_piece(g.float(), ctx.sh, ctx.mesh, ctx.role)
        return g.to(ctx.dtype), None, None, None, None, None, None


def _crosses(sh, mesh, role: str) -> bool:
    """Whether a leaf's gather or its gradient's sync crosses a live axis
    (else :func:`gather_piece` is the identity)."""
    return bool(live_axes(mesh, ("data",)) or gathered_axes(sh, mesh, role)
                or (role == "partial" and live_axes(mesh, (MODEL,))))


def gather_piece(piece: torch.Tensor, sh, mesh, role: str, wire=None,
                 pending=None, sink=None) -> torch.Tensor:
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
    returns ``piece`` itself.  ``wire``: the dtype the gather moves (the
    pass's compute dtype for a leaf every use of which casts it to that
    dtype first; only where some axis is gathered); ``pending``: the
    gather already issued (:func:`start_gather`); ``sink``: the
    :class:`GradSink` that takes the gradient's sync in flight."""
    if not _crosses(sh, mesh, role):
        return piece
    if not gathered_axes(sh, mesh, role):
        wire = None
    return _GatherPiece.apply(piece, sh, mesh, role, wire, pending, sink)


def start_gather(piece: torch.Tensor, sh, mesh, role: str, wire=None):
    """:func:`gather_piece`'s gather issued in flight (:func:`start`; a
    :class:`Pending` of the leaf in ``wire``, which ``gather_piece(...,
    pending=)`` takes), or None where it gathers over no live axis."""
    if not gathered_axes(sh, mesh, role):
        return None
    x = piece.detach().to(wire or piece.dtype)
    skip = (MODEL,) if role == "split" else ()
    one = _one_gather(sh, mesh, skip)
    if one is None:
        return start(lambda o, t: o.copy_(gather_dims(t, sh, mesh, skip)),
                     x.new_empty(_gathered_shape(piece, sh, mesh, role)),
                     mesh, "param_gather", (x,))
    # the operand in the order it is exchanged in, made here (on the
    # compute path), so the exchange moves contiguous bytes only
    axis, dim = one
    x = x.movedim(dim, 0).contiguous()
    n = axis_sizes(mesh)[axis]
    return start(lambda o, t: _all_gather_into(o, t, mesh, axis),
                 x.new_empty((n * x.shape[0],) + tuple(x.shape[1:])), mesh,
                 "param_gather", (x,), dim)


def _one_gather(sh, mesh, skip: tuple):
    """(axis, dim) where :func:`gather_dims` makes one all-gather, along
    one dimension of a leaf whose parts it need not put back in order;
    else None."""
    hits = [(a, i) for i in range(len(sh.shape)) for a in sh.dim_axes(i)
            if a not in skip and axis_sizes(mesh).get(a, 1) > 1]
    if len(hits) != 1 or (sh.segments and hits[0][1] == len(sh.shape) - 1):
        return None
    return hits[0]


def _all_gather_into(o: torch.Tensor, t: torch.Tensor, mesh, axis: str):
    """:func:`all_gather` along dimension 0 into ``o``."""
    if not report("all-gather", t, _nbytes(o), axis_sizes(mesh)[axis]):
        _run(dist.all_gather_into_tensor, _group(mesh, axis), o, t)


def _mean_into(o: torch.Tensor, t: torch.Tensor, mesh, axis: str,
               scatter: bool):
    """This rank's chunk along dimension 0 of the mean of ``t`` over
    ``axis`` (``scatter``: a reduce-scatter; else the whole mean, an
    all-reduce), into ``o``: :func:`grad_piece`'s exchange."""
    n = axis_sizes(mesh)[axis]
    if not scatter:
        all_reduce(o.copy_(t), mesh, (axis,))
    elif not report("reduce-scatter", t, _nbytes(o), n):
        _run(dist.reduce_scatter_tensor, _group(mesh, axis), o, t,
             op=dist.ReduceOp.SUM)
    o.div_(n)


# --------------------------------------------------------------------------
# Exchanges in flight
# --------------------------------------------------------------------------

_EXECUTOR = None                # the gloo worker, made at its first exchange
_SIDE: dict = {}                # device index -> side stream
_OVERLAP_GROUPS: dict = {}      # id(mesh) -> (mesh, {axis: group})
# a test hook: seconds each exchange in flight waits before it runs, which
# makes an output read before its wait visible
_DELAY_S = 0.0


# a traced step's exchanges in flight (meta), in issue order: each runs when
# it, or one issued after it, is waited
_TRACED: list = []


class Pending:
    """An exchange in flight (:func:`start`): :meth:`wait` returns ``out``
    (its dimension 0 moved to ``dim``) once the exchange has written it
    (the calling thread's current stream ordered after the write)."""

    def __init__(self, out: torch.Tensor, future=None, event=None,
                 run=None, dim: int = 0):
        self.out, self._future, self._event = out, future, event
        self._run, self.dim = run, dim

    def wait(self) -> torch.Tensor:
        if self._run is not None:
            # one worker runs them in issue order: those before this one
            # have ended
            while _TRACED:
                p = _TRACED.pop(0)
                p._run()
                p._run = None
                if p is self:
                    break
        if self._future is not None:
            event = self._future.result()
            self._future = None
            self._event = event or self._event
        if self._event is not None:
            torch.cuda.current_stream(self.out.device).wait_event(
                self._event)
            self._event = None
        # an exchange along its first dimension: its output's dimension 0
        # is the result's ``dim``
        return self.out.movedim(0, self.dim) if self.dim else self.out


def overlap_started() -> bool:
    """Whether any exchange has run in flight in this process: a worker
    thread, a side stream or an overlap group made (a one-rank mesh makes
    none)."""
    return _EXECUTOR is not None or bool(_SIDE) or bool(_OVERLAP_GROUPS)


def overlap_groups(mesh) -> dict:
    """{axis: this rank's second process group along it} for each live
    axis of ``mesh``, made at the first exchange in flight and kept: the
    groups the exchanges in flight run on, of the backend of the mesh's
    own.  Made by ``dist.new_group`` for every group of every live axis in
    mesh order, which every rank of the world reaches at the same point of
    the same step, so the mesh must span the world."""
    got = _OVERLAP_GROUPS.get(id(mesh))
    if got is not None and got[0] is mesh:
        return got[1]
    me, groups = dist.get_rank(), {}
    for d, a in enumerate(mesh.mesh_dim_names):
        n = mesh.shape[d]
        if n == 1:
            continue
        backend = dist.get_backend(mesh.get_group(a))
        for ranks in mesh.mesh.movedim(d, -1).reshape(-1, n).tolist():
            g = dist.new_group(ranks, backend=backend)
            if me in ranks:
                groups[a] = g
    _OVERLAP_GROUPS[id(mesh)] = (mesh, groups)
    return groups


def _side(device: torch.device):
    """The side stream of a CUDA device, made once."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SIDE:
        _SIDE[idx] = torch.cuda.Stream(device=idx)
    return _SIDE[idx]


def _worker() -> ThreadPoolExecutor:
    global _EXECUTOR
    if _EXECUTOR is None:
        _EXECUTOR = ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix="comm-in-flight")
    return _EXECUTOR


@contextmanager
def _job(groups: dict, name):
    """The calling thread runs an exchange in flight: its collectives run
    on ``groups`` (:func:`overlap_groups`) under the purpose ``name``."""
    _local.groups, _local.purpose = groups, name
    try:
        with torch.no_grad():
            yield
    finally:
        _local.groups = _local.purpose = None


def start(fn, out: torch.Tensor, mesh, name: str, args=(),
          dim: int = 0) -> Pending:
    """Issue ``fn(out, *args)`` in flight, ``fn`` an exchange over
    ``mesh``'s live axes (a call of the helpers above) that writes its
    result into ``out`` from its operands ``args``, under the purpose
    ``name``; ``out`` is allocated by the caller on its current stream,
    and the calling thread must not overwrite ``args`` before the wait.
    ``dim``: the result's dimension that is ``out``'s dimension 0
    (:class:`Pending`).

    Over gloo with CUDA operands the worker copies ``args`` to page-locked
    host buffers (on the side stream, once the compute stream has made
    them), runs ``fn`` there into another (gloo's own path) and copies
    that into ``out``: an exchange in flight takes no device memory but
    ``out`` and, until they are copied, ``args``, and stages each operand
    and result once (:func:`staged`).

    On a meta ``out`` (a step traced for its counts) the exchange runs,
    reported and skipped, when it or one issued after it is waited (the
    worker runs them in issue order), ``args`` held until then: the
    timing of a worker the exchanges keep busy, as host staging does, so
    the trace's peak holds what such a step holds (the gradients whose
    syncs are queued, the layer gathered ahead)."""
    held = list(args)
    if out.is_meta:
        def run():
            with purpose(name), torch.no_grad():
                fn(out, *held)
            held.clear()
        _TRACED.append(Pending(out, run=run, dim=dim))
        return _TRACED[-1]
    groups = overlap_groups(mesh)
    ready = None
    if out.is_cuda:
        # the operands are ready once the compute stream's work so far is
        ready = torch.cuda.Event()
        ready.record()
        side = _side(out.device)
        for t in (out, *held):
            t.record_stream(side)
    backend = dist.get_backend(next(iter(groups.values()))) if groups \
        else "gloo"
    if backend == "nccl":
        side.wait_event(ready)
        with torch.cuda.stream(side), _job(groups, name):
            fn(out, *held)
        held.clear()
        done = torch.cuda.Event()
        done.record(side)
        return Pending(out, event=done, dim=dim)

    def job():
        if _DELAY_S:
            time.sleep(_DELAY_S)
        with _job(groups, name):
            if ready is None:
                fn(out, *held)
                held.clear()
                return None
            with torch.cuda.device(out.device), torch.cuda.stream(side):
                side.wait_event(ready)
                host = [_host(t, "in").copy_(t) for t in held]
                moved = sum(_nbytes(t) for t in held) + _nbytes(out)
                held.clear()
                result = _host(out, "out")
                try:
                    fn(result, *host)
                    out.copy_(result)
                finally:
                    _give_back(result, *host)
                done = torch.cuda.Event()
                done.record(side)
            _count_staged(moved)
            return done
    return Pending(out, future=_worker().submit(job), dim=dim)


def _one_mean(g: torch.Tensor, sh, mesh, role: str, dtype):
    """(dim, scatter) where :func:`grad_piece` of ``g`` is one exchange
    over "data" of an fp32 gradient, with nothing cut or summed over
    another axis: a reduce-scatter along ``dim`` (``scatter``) or an
    all-reduce (dim 0); else None."""
    live = live_axes(mesh, sh.axes)
    if dtype != torch.float32 or live not in ((), ("data",)) or \
            not live_axes(mesh, ("data",)) or \
            (role == "partial" and live_axes(mesh, (MODEL,))):
        return None
    dims = [i for i in range(g.ndim) if "data" in sh.dim_axes(i)]
    if not dims:
        return 0, False
    if sh.segments and dims[0] == g.ndim - 1:
        return None
    return dims[0], True


class GradSink:
    """The gradients' syncs of an overlapped pass: :class:`_GatherPiece`'s
    backward issues each one in flight (:meth:`start`) and returns nothing
    to autograd, so no gradient is read before its exchange ends;
    :meth:`collect`, after the backward, waits for each in issue order and
    credits it to its leaf's gradient at the place of the piece that was
    gathered (a layer's row of a stacked leaf), the first credit of a place
    copied and each later one added, the order in which autograd sums a
    leaf's gradients (a hybrid's shared blocks, gathered at each use)."""

    def __init__(self):
        self.pending: list = []

    @staticmethod
    def target(piece: torch.Tensor) -> tuple:
        """(leaf, size, stride, offset): where ``piece`` (a leaf the pass
        was handed, or a view of one: a layer's row) lies in its leaf."""
        base = piece._base if piece._base is not None else piece
        if not base.is_contiguous():
            raise ValueError(f"a gathered piece of a {tuple(base.shape)} "
                             f"leaf that is not contiguous")
        return base, tuple(piece.shape), piece.stride(), \
            piece.storage_offset() - base.storage_offset()

    def start(self, target: tuple, g: torch.Tensor, sh, mesh, role: str,
              dtype) -> None:
        """Issue the sync of ``g`` (:func:`grad_piece`) for the piece at
        ``target``, into a buffer of the layout the synchronous sync gives
        (its shape and strides, found on a meta copy: a reduction over the
        gradient, its norm's or the optimizer's, sums in the order of its
        layout)."""
        one = _one_mean(g, sh, mesh, role, dtype)
        if one is not None:
            # the operand in the order it is exchanged in, made here (on
            # the compute path): the result is the synchronous sync's,
            # dimension 0 of the reduce-scatter's output at its place
            dim, scatter = one
            x = g.float().movedim(dim, 0).contiguous()
            n = axis_sizes(mesh)["data"] if scatter else 1
            out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
            self.pending.append((target, start(
                lambda o, t: _mean_into(o, t, mesh, "data", scatter), out,
                mesh, "grad_scatter", (x,), dim)))
            return

        def sync(o, t):
            o.copy_(grad_piece(t.float(), sh, mesh, role).to(dtype))
        _local.mute = True
        try:
            like = grad_piece(g.detach().to("meta").float(), sh, mesh,
                              role).to(dtype)
        finally:
            _local.mute = False
        out = torch.empty_strided(like.shape, like.stride(), dtype=dtype,
                                  device=g.device)
        self.pending.append((target, start(sync, out, mesh, "grad_scatter",
                                           (g,))))

    def collect(self, leaves: dict, grads: dict) -> dict:
        """``grads`` ({key: autograd's gradient of ``leaves[key]``, None
        where every use went through the sink}) with every sync issued
        since the last call waited and credited."""
        keys = {id(v): k for k, v in leaves.items()}
        acc, seen = {}, set()
        for (base, size, stride, offset), p in self.pending:
            k = keys[id(base)]
            if grads.get(k) is not None:
                raise RuntimeError(f"{k}: a gradient both from autograd "
                                   f"and in flight")
            g = p.wait()
            if size == tuple(base.shape) and offset == 0:
                # the piece is the leaf: its gradient as autograd keeps it
                if k in acc:
                    acc[k].add_(g)
                else:
                    acc[k] = g
                continue
            if k not in acc:
                # a stacked leaf: autograd stacks its rows' gradients
                acc[k] = torch.zeros_like(
                    base, memory_format=torch.contiguous_format)
            place = acc[k].as_strided(size, stride, offset)
            if (k, offset, size) in seen:
                place.add_(g)
            else:
                place.copy_(g)
                seen.add((k, offset, size))
        self.pending.clear()
        out = dict(grads)
        out.update(acc)
        missing = [k for k, v in out.items() if v is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        return out


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
