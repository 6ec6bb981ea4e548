"""Per-rank cost and memory of one eager step: the port's counterpart of
``repro.launch.hlo_analysis`` (the walker of a compiled step's HLO).

A step here is a Python function that runs eagerly, so there is no compiled
artifact to read.  :func:`analyze_step` instead runs one call of the step on
meta tensors (shapes only: nothing is computed, allocated or launched)
inside :class:`StepCounter`, a ``TorchDispatchMode`` that sees every
operation the call dispatches, the backward's included, and counts, for
this rank's program:

* ``flops``: the products as ``torch.utils.flop_counter`` counts them (the
  count :func:`~repro_torch.train.step.count_step_flops` gives, so
  ``hw_flops_util`` keeps its meaning), plus each hand-written kernel's call
  at its cost model (the ``flops`` of the wrapper's ``cost_estimate``);
* ``elementwise_flops`` and ``transcendentals``, apart, at the reference's
  weights: 1 an output element of a pointwise operation, 5 for one of its
  transcendental set (``exp``, ``log``, ``tanh``, ``pow``, ``rsqrt``, ...),
  the input's elements for a reduction;
* ``bytes``: every operation that launches a kernel counts each input read
  once (an expanded input its source's bytes, a gather its rows) and each
  output written once; an in-place operation counts its operand once read
  and once written; view and metadata operations and bare allocations
  count nothing.  A kernel wrapper's call counts as **one** operation at its
  cost model's bytes, and none of the operations inside it.  In eager
  PyTorch each operation is one launch, so ``bytes_fused`` equals
  ``bytes``: there is no fusion to model;
* ``collective_operand_bytes``, ``collective_wire_bytes`` and
  ``by_collective``, as :mod:`repro_torch.parallel.comm` reports each
  collective (the reference's operand and wire formulas, :func:`wire_bytes`),
  and ``by_purpose``, the operand bytes by what the exchange is for
  (``comm.purpose``: the params' gathers, their gradients' syncs
  (``"grad_scatter"``), the row-parallel and vocabulary sums over "model",
  a serving pass's query gather and partial merge over a cache split by
  its slots, a pipeline's hand-offs and broadcasts forward (``"pipe_act"``)
  and backward (``"pipe_grad"``); ``"other"``);
* nothing for the host's own scalars: an operation on CPU tensors alone
  (the learning-rate schedule, the optimizer's step count) is not the
  device's work;
* memory: the arguments' bytes, the largest sum of storages born in the
  call and alive at once (frees seen through weak references to each
  storage, so autograd's frees of saved tensors count), and the scratch a
  kernel holds while it runs (``.hold``; and the temporary of the one aten
  CUDA kernel seen to hold one, the softmax backward); each storage rounded
  up to the CUDA caching allocator's 512-byte blocks.

The step's collectives are reported by ``comm`` and skipped on meta
operands, so a step traced under a real process group (the training loop
on a mesh) exchanges nothing; the dry run lays its production meshes out on
a "fake" process group (:func:`repro_torch.launch.mesh.fake_world`).

A step of many microbatches runs one body many times; :func:`extrapolate`
takes the counts of the same step traced at 2 and 3 microbatches to any
count, as the reference's walker multiplies a scan body by its trip count.
"""

from __future__ import annotations

import gc
import sys
import weakref
from contextlib import contextmanager
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops
from repro_torch.parallel import comm

DEVICE = "meta (no device)"
FUSION_NOTE = ("eager PyTorch launches one kernel an operation: bytes_fused "
               "equals bytes")
ALLOC_BLOCK = 512                       # the caching allocator's rounding

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

# the reference's ``_TRANSCENDENTAL`` set, by aten name (in-place forms too)
_TRANSCENDENTAL = frozenset(
    f"aten::{n}{s}" for n in (
        "exp", "exp2", "log", "log2", "log10", "tanh", "pow", "rsqrt",
        "sqrt", "sigmoid", "sin", "cos", "erf", "expm1", "log1p", "atan2",
        "silu", "gelu")
    for s in ("", "_"))
# fused aten kernels with no pointwise or reduction tag: (flops, of which
# transcendental) an element, at the weights of their decomposition (a
# softmax: max, subtract, exp, sum, divide)
_COMPOSITE = {"aten::_softmax": (9, 1), "aten::_log_softmax": (9, 1),
              "aten::_softmax_backward_data": (4, 0),
              "aten::_log_softmax_backward_data": (8, 1),
              "aten::native_layer_norm": (8, 0),
              "aten::native_layer_norm_backward": (12, 0)}
# CUDA kernels that hold a temporary of their output's size while they run:
# the softmax backward forms grad * output before its row sums (seen on the
# H100 as a peak inside the call one output above the allocated bytes after
# it); the temporary is written and read once more
_TEMPS = frozenset({"aten::_softmax_backward_data"})
# operations that launch nothing or only allocate
_FREE = frozenset({
    "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::new_empty", "aten::new_empty_strided", "aten::detach",
    "aten::alias", "aten::lift_fresh", "aten::_local_scalar_dense",
    "aten::set_", "aten::resize_", "aten::sym_size", "aten::sym_stride",
    "aten::sym_numel", "aten::sym_storage_offset", "aten::is_same_size",
    "aten::_has_same_storage_numel", "prim::device", "prim::layout",
    "aten::is_contiguous", "aten::size", "aten::stride", "aten::dim",
    "aten::numel", "aten::storage_offset"})
# factories shaped like their input, which they do not read
_LIKE = frozenset(f"aten::{n}_like" for n in (
    "zeros", "ones", "full", "rand", "randn", "randint"))
# in-place operations that write their operand without reading it
_WRITE_ONLY = frozenset({"aten::copy_", "aten::fill_", "aten::zero_",
                         "aten::normal_", "aten::uniform_",
                         "aten::random_"})
# reads of rows of their first input: it counts the rows read (the output's
# bytes), not the whole tensor
_GATHERS = frozenset({"aten::embedding", "aten::index_select",
                      "aten::gather", "aten::index"})
# in-place writes of rows: the operand is read and written where the
# updates land, not whole
_SCATTERS = frozenset({"aten::index_put_", "aten::_index_put_impl_",
                       "aten::index_add_", "aten::scatter_",
                       "aten::scatter_add_", "aten::index_copy_"})


def wire_bytes(kind: str, operand_bytes: float, output_bytes: float,
               group: int) -> float:
    """Bytes one rank puts on the wire for a collective over ``group``
    ranks, by the reference's formulas: a ring all-reduce 2 (g-1)/g of the
    operand, an all-gather (g-1)/g of the output, a reduce-scatter or an
    all-to-all (g-1)/g of the operand, a permute the operand (a broadcast,
    which the reference has not, (g-1)/g of the operand)."""
    frac = (group - 1) / group if group > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * frac * operand_bytes
    if kind == "all-gather":
        return frac * output_bytes
    if kind in ("reduce-scatter", "all-to-all", "broadcast"):
        return frac * operand_bytes
    if kind == "collective-permute":
        return float(operand_bytes)
    raise ValueError(f"unknown collective {kind!r}")


def _alloc(nbytes: int) -> int:
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK if nbytes else 0


def _span(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` reads: an expanded (stride 0)
    dimension reads its source once."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _device_tensors(tree) -> list:
    """The tensors of a tree that are not host (CPU) tensors."""
    return [t for t in _tensors(tree) if t.device.type != "cpu"]


class _OpInfo:
    """What the counter needs of one aten overload, worked out once."""

    __slots__ = ("name", "free", "view", "product", "pointwise",
                 "reduction", "composite", "write_only", "gather",
                 "scatter", "like", "temp", "out_args")

    def __init__(self, func):
        name = func._schema.name
        self.name = name
        self.view = bool(getattr(func, "is_view", False))
        self.free = name in _FREE
        self.product = flop_registry.get(func._overloadpacket)
        tags = func.tags
        w = 5 if name in _TRANSCENDENTAL else 1
        self.pointwise = w if torch.Tag.pointwise in tags else 0
        self.reduction = torch.Tag.reduction in tags
        self.composite = _COMPOSITE.get(name)
        self.write_only = name in _WRITE_ONLY
        self.gather = name in _GATHERS
        self.scatter = name in _SCATTERS
        self.like = name in _LIKE
        self.temp = name in _TEMPS
        self.out_args = tuple(
            a.name for a in func._schema.arguments
            if a.kwarg_only and a.alias_info is not None
            and a.alias_info.is_write)


class StepCounter(TorchDispatchMode):
    """Counts one rank's step as it dispatches (see the module docstring).

    Installed by :meth:`counting` as the dispatch mode, the kernels' marker
    session (:func:`repro_torch.kernels.ops.set_kernel_markers`, whose
    ``region`` / ``hold`` it answers) and the collectives' counter
    (:func:`repro_torch.parallel.comm.set_counter`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.elementwise_flops = 0.0
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.collective_operand_bytes = 0.0
        self.collective_wire_bytes = 0.0
        self.by_collective: dict = {}
        self.by_purpose: dict = {}
        self.kernels: dict = {}
        self.ops = 0
        self.live = 0                   # bytes of device storages alive
        self.peak = 0                   # the most of ``live`` (+ scratch)
        self.arg_bytes = 0              # the arguments' storages at start
        self.held_max = 0               # the largest scratch held
        self._inside = 0                # depth inside a kernel's call
        self._held = 0
        # storage key -> (bytes, weakref, an argument's): every device
        # storage alive, the arguments' included, so that one the step
        # drops (a state entry it replaces) is freed as on the card
        self._born: dict = {}
        self._info: dict = {}
        self._modules = len(sys.modules)

    # -- the three faces --------------------------------------------------

    @contextmanager
    def counting(self, args=()):
        """Count what runs inside; ``args``' storages are the arguments,
        alive from the start."""
        for t in _device_tensors(args):
            self._track(t.untyped_storage(), True)
        self.arg_bytes = self.live
        self._modules = len(sys.modules)
        prev_markers = ops.set_kernel_markers(self)
        prev_counter = comm.set_counter(self)
        try:
            with self:
                yield self
        finally:
            comm.set_counter(prev_counter)
            ops.set_kernel_markers(prev_markers)

    @contextmanager
    def region(self, name: str, counters=None):
        """A kernel wrapper's call: one operation of the cost model's flops
        and bytes; the operations inside count nothing but their memory."""
        c = counters or {}
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += float(c.get("flops", 0.0))
        k["bytes"] += float(c.get("bytes", 0.0))
        if not self._inside:
            self.flops += float(c.get("flops", 0.0))
            self.bytes += float(c.get("bytes", 0.0))
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1
            if self._held:
                self.peak = max(self.peak, self.live + self._held)
                self.held_max = max(self.held_max, self._held)
                self._held = 0

    def hold(self, nbytes: int) -> None:
        """The next kernel call holds ``nbytes`` of scratch while it runs."""
        self._held += _alloc(int(nbytes))

    def collective(self, kind: str, operand_bytes: int, output_bytes: int,
                   group: int, purpose: Optional[str] = None) -> None:
        wire = wire_bytes(kind, operand_bytes, output_bytes, group)
        self.collective_operand_bytes += operand_bytes
        self.collective_wire_bytes += wire
        self.by_collective[kind] = self.by_collective.get(kind, 0.0) \
            + operand_bytes
        key = purpose or "other"
        self.by_purpose[key] = self.by_purpose.get(key, 0.0) + operand_bytes
        # the exchange reads its operand and writes its output on the card
        self.bytes += operand_bytes + output_bytes

    # -- dispatch ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _OpInfo(func)
        # each operation is one kernel on the card: it runs as itself (no
        # decomposition into parts, which the card would not launch)
        out = func(*args, **kwargs)
        if len(sys.modules) != self._modules:
            # a module imported for the first time inside the call (a meta
            # kernel's lazy import): the import machinery's tracebacks hold
            # the calling frames, and with them their tensors, in a cycle
            # until the collector runs; on the card that import happened
            # long before, so collect it now
            self._modules = len(sys.modules)
            gc.collect()
        outs = [t for t in _tensors(out) if t.is_meta]
        for t in outs:
            self._birth(t)
        if info.temp and outs:
            temp = sum(_alloc(t.untyped_storage().nbytes()) for t in outs)
            self.peak = max(self.peak, self.live + temp)
            self.held_max = max(self.held_max, temp)
            if not self._inside:
                self.bytes += 2 * sum(_span(t) for t in outs)
        if not self._inside and not info.free and not info.view and (
                outs or any(t.is_meta for t in _tensors((args, kwargs)))):
            self._count(info, args, kwargs, out, outs)
        return out

    def _birth(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st._cdata not in self._born:
            self._track(st, False)

    def _track(self, st, is_arg: bool) -> None:
        key = st._cdata
        if key in self._born:
            return
        n = _alloc(st.nbytes())
        self._born[key] = (n, weakref.ref(st, self._freer(key)), is_arg)
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def _freer(self, key):
        def free(_):
            entry = self._born.pop(key, None)
            if entry is not None:
                self.live -= entry[0]
        return free

    def _count(self, info: _OpInfo, args, kwargs, out, outs) -> None:
        self.ops += 1
        ins = [] if info.like else _tensors(
            (args, {k: v for k, v in kwargs.items()
                    if k not in info.out_args}))
        if info.product is not None:
            self.flops += float(info.product(*args, **kwargs, out_val=out))
        n_out = sum(t.numel() for t in outs)
        if info.pointwise:
            self.elementwise_flops += info.pointwise * n_out
            if info.pointwise > 1:
                self.transcendentals += n_out
        elif info.reduction and ins:
            self.elementwise_flops += ins[0].numel()
        elif info.composite is not None:
            w, tr = info.composite
            self.elementwise_flops += w * n_out
            self.transcendentals += tr * n_out
        out_keys = {t.untyped_storage()._cdata for t in outs}
        read, seen = 0, set()
        for i, t in enumerate(ins):
            key = (t.untyped_storage()._cdata, t.storage_offset(),
                   tuple(t.shape), t.stride())
            if key in seen:
                continue
            seen.add(key)
            if i == 0 and info.write_only and key[0] in out_keys:
                continue                # written, not read
            if i == 0 and info.gather:
                read += min(_span(t), sum(_span(o) for o in outs))
            elif i == 0 and info.scatter and len(ins) > 1:
                read += min(_span(t), _span(ins[-1]))
            else:
                read += _span(t)
        if info.scatter and len(ins) > 1:
            written = min(sum(_span(o) for o in outs), _span(ins[-1]))
        else:
            written = sum(_span(o) for o in outs)
        self.bytes += read + written

    # -- the record -------------------------------------------------------

    def memory(self, args, out) -> dict:
        """The reference's memory block (per rank): ``argument_bytes``
        (at the start), ``output_bytes`` (every output storage),
        ``alias_bytes`` (outputs that are arguments, updated in place),
        ``temp_bytes`` (the peak beyond the arguments and the new outputs,
        scratch included), ``peak_bytes`` (the most held at once, the
        arguments still alive included) and ``held_bytes``, the largest
        kernel scratch."""
        out_st = {}
        for t in _device_tensors(out):
            st = t.untyped_storage()
            out_st[st._cdata] = _alloc(st.nbytes())
        alias = sum(v for k, v in out_st.items()
                    if k in self._born and self._born[k][2])
        output = sum(out_st.values())
        return {"argument_bytes": self.arg_bytes, "output_bytes": output,
                "alias_bytes": alias,
                "temp_bytes": max(0, self.peak - self.arg_bytes
                                  - (output - alias)),
                "peak_bytes": self.peak, "held_bytes": self.held_max}

    def per_device(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_fused": self.bytes,
                "elementwise_flops": self.elementwise_flops,
                "transcendentals": self.transcendentals,
                "collective_operand_bytes": self.collective_operand_bytes,
                "collective_wire_bytes": self.collective_wire_bytes,
                "by_collective": dict(self.by_collective),
                "by_purpose": dict(self.by_purpose),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "operations": self.ops}


def meta_like(tree):
    """Meta tensors of a tree's shapes, dtypes and strides.  Leaves that
    are not tensors pass as they are, and so (copied) does a 0-d tensor on
    the CPU: a host scalar the step reads (the optimizer's step count)."""
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_like(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        if tree.dim() == 0 and tree.device.type == "cpu":
            return tree.clone()
        return torch.empty_strided(tree.shape, tree.stride(),
                                   dtype=tree.dtype, device="meta")
    return tree


def analyze_step(fn, args: tuple, *, num_partitions: int = 1) -> dict:
    """Trace ``fn(*args)`` once (``args`` on meta tensors, or made so) and
    return the reference's schema: ``num_partitions``, ``per_device``
    (this rank's counts), ``global`` (per-device x ``num_partitions``) and
    ``memory``, with the ``device`` it was counted on and the fusion note."""
    args = meta_like(args)
    counter = StepCounter()
    with counter.counting(args):
        out = fn(*args)
    return record(counter.per_device(), counter.memory(args, out),
                  num_partitions)


def record(per_device: dict, memory: dict, num_partitions: int,
           trips: Optional[dict] = None) -> dict:
    g = {k: per_device[k] * num_partitions
         for k in ("flops", "bytes", "bytes_fused", "elementwise_flops",
                   "collective_operand_bytes", "collective_wire_bytes")}
    return {"num_partitions": num_partitions, "per_device": per_device,
            "global": g, "memory": memory, "trip_counts": trips or {},
            "device": DEVICE, "fusion": FUSION_NOTE}


_LINEAR = ("flops", "bytes", "bytes_fused", "elementwise_flops",
           "transcendentals", "collective_operand_bytes",
           "collective_wire_bytes", "operations")


def argument_bytes(args) -> int:
    """The memory block's ``argument_bytes`` of these arguments."""
    return sum(_alloc(st.nbytes()) for st in {
        t.untyped_storage()._cdata: t.untyped_storage()
        for t in _device_tensors(args)}.values())


def extrapolate(at2: dict, at3: dict, n: int, args=None) -> dict:
    """The record of a step of ``n`` microbatches from the same step's
    records at 2 and 3: each count is a fixed part plus one body a
    microbatch, so count(n) = count(2) + (n - 2) (count(3) - count(2));
    what the call makes beyond its arguments is the larger of the two (a
    microbatch's temporaries are freed before the next one's).  ``args``:
    the whole step's arguments, whose bytes are taken as they are (else
    extrapolated too)."""
    def lin(a, b):
        return a + (n - 2) * (b - a)
    p2, p3 = at2["per_device"], at3["per_device"]
    per = {k: lin(p2[k], p3[k]) for k in _LINEAR}
    for key in ("by_collective", "by_purpose"):
        per[key] = {k: lin(p2[key].get(k, 0.0), p3[key].get(k, 0.0))
                    for k in set(p2[key]) | set(p3[key])}
    per["kernels"] = {
        k: {f: lin(p2["kernels"].get(k, {}).get(f, 0),
                   p3["kernels"][k][f]) for f in ("calls", "flops",
                                                  "bytes")}
        for k in p3["kernels"]}
    m2, m3 = at2["memory"], at3["memory"]
    # the arguments hold the rows of every microbatch; what the call makes
    # beyond them is the larger of the two traces'
    mem = {k: lin(m2[k], m3[k]) for k in ("argument_bytes", "output_bytes",
                                          "alias_bytes")}
    if args is not None:
        mem["argument_bytes"] = argument_bytes(args)
    mem.update({k: max(m2[k], m3[k]) for k in ("temp_bytes", "held_bytes")})
    mem["peak_bytes"] = mem["argument_bytes"] + max(
        m2["peak_bytes"] - m2["argument_bytes"],
        m3["peak_bytes"] - m3["argument_bytes"])
    return record(per, mem, at2["num_partitions"],
                  {"microbatches": n, "traced": [2, 3]})
