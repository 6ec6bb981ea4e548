"""Logical-axis sharding rules (port of ``repro.parallel.sharding``).

Models name their dimensions with logical axes (``"embed"``, ``"heads"``,
``"mlp"``, ...); a :class:`ShardingRules` table maps each to one or more
mesh axes.  :func:`logical_to_pspec` binds a leaf's axes to a spec as the
reference does, in pure Python over the mesh's axis names and sizes: the
same priority order (``cache_seq`` / ``seq`` last), each mesh axis used at
most once, a dimension that its mesh axes do not divide replicated, and
trailing ``None`` entries trimmed.  A spec is a tuple with one entry a
dimension, each ``None``, a mesh axis name or a tuple of names, so it
compares entry by entry with the reference's ``PartitionSpec``.

:class:`Sharding` adds what a rank needs to hold its piece: the slice of
each dimension it owns (the first of several mesh axes major, as a JAX
``NamedSharding`` lays them out).  :func:`shard_tree` and
:func:`gather_tree` move a tree between whole leaves and this rank's shards.

:class:`PartitionConstraints` carries the rules and the mesh to the model
as its ``pc`` argument.  Its activation methods are the identity: under
data parallelism each rank runs the whole model on its own rows, with
plain local tensors that have no layout to constrain.  Tensor-parallel
compute (Megatron-style sharded products under ``"model"``) and sequence
parallelism are not ported (ROADMAP Queue 1, item 4's remainder): asking
for sequence parallelism raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.models.params import ParamSpec, flatten, tree_map, unflatten
from repro_torch.parallel import comm

UNPORTED = ("tensor-parallel compute and sequence parallelism are not "
            "ported: ROADMAP Queue 1, item 4 (what stays out)")


def _flatten_mesh_axes(entry) -> tuple:
    """A rule entry is None, a mesh-axis name, or a tuple of names."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


@dataclass(frozen=True)
class ShardingRules:
    """Map logical axis name -> mesh axis name(s) (or None = replicate)."""

    rules: dict = field(default_factory=dict)

    def mesh_axes_for(self, logical: Optional[str]):
        if logical is None:
            return None
        return self.rules.get(logical)

    def with_overrides(self, **overrides) -> "ShardingRules":
        d = dict(self.rules)
        d.update(overrides)
        return ShardingRules(d)


# The reference's tables: FSDP weights over "data", TP over "model",
# "batch" over the pure data-parallel axes ("pod" only on a multi-pod mesh).
TRAIN_RULES = ShardingRules({
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": ("model",),
    "layers": None,
    "norm": None,
    "q_lora": None,
    "kv_lora": None,
    "cache_seq": None,
    "state": None,
    "inner": "model",
    "ssm_heads": "model",
    "frames": None,
})

SERVE_RULES = TRAIN_RULES.with_overrides(cache_seq="model")


def rules_for(kind: str) -> ShardingRules:
    return TRAIN_RULES if kind == "train" else SERVE_RULES


# Axes with higher numbers bind after the rest: "cache_seq" / "seq" take a
# mesh axis only when no other dimension claimed it.
_AXIS_PRIORITY = {"cache_seq": 1, "seq": 1}


def logical_to_pspec(axes: tuple, shape: tuple, rules: ShardingRules,
                     mesh) -> tuple:
    """Bind logical axes to a spec with the reference's divisibility
    fallback.  ``mesh``: a DeviceMesh or a ``{axis: size}`` dict."""
    sizes = comm.axis_sizes(mesh)
    used = set()
    out: list = [None] * len(axes)
    order = sorted(range(len(axes)),
                   key=lambda i: _AXIS_PRIORITY.get(axes[i] or "", 0))
    for i in order:
        dim, logical = shape[i], axes[i]
        names = [a for a in _flatten_mesh_axes(rules.mesh_axes_for(logical))
                 if a in sizes and a not in used]
        prod = 1
        for a in names:
            prod *= sizes[a]
        if names and dim % prod == 0 and dim >= prod:
            used.update(names)
            out[i] = tuple(names) if len(names) > 1 else names[0]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@dataclass(frozen=True)
class Sharding:
    """A leaf's global ``shape`` and its ``spec`` on a mesh of ``sizes``."""

    spec: tuple
    shape: tuple
    sizes: tuple          # ((axis, size), ...) of the mesh

    def dim_axes(self, i: int) -> tuple:
        """The mesh axes dimension ``i`` is split over (first major)."""
        return _flatten_mesh_axes(self.spec[i]) if i < len(self.spec) \
            else ()

    @property
    def axes(self) -> tuple:
        """Every mesh axis the leaf is split over."""
        return tuple(a for i in range(len(self.shape))
                     for a in self.dim_axes(i))

    @property
    def replicated_axes(self) -> tuple:
        """The mesh axes that hold copies of the same piece."""
        return tuple(a for a, _ in self.sizes if a not in self.axes)

    def local_shape(self) -> tuple:
        sizes = dict(self.sizes)
        out = []
        for i, d in enumerate(self.shape):
            n = 1
            for a in self.dim_axes(i):
                n *= sizes[a]
            out.append(d // n)
        return tuple(out)

    def slices(self, coord: dict) -> tuple:
        """The slice of each dimension held at mesh coordinate ``coord``."""
        sizes = dict(self.sizes)
        out = []
        for i, d in enumerate(self.shape):
            idx, n = 0, 1
            for a in self.dim_axes(i):
                idx = idx * sizes[a] + coord.get(a, 0)
                n *= sizes[a]
            k = d // n
            out.append(slice(idx * k, (idx + 1) * k))
        return tuple(out)


def sharding_for(s: ParamSpec, rules: ShardingRules, mesh) -> Sharding:
    return Sharding(logical_to_pspec(s.axes, s.shape, rules, mesh),
                    tuple(s.shape), tuple(comm.axis_sizes(mesh).items()))


def shardings_for_specs(specs, rules: ShardingRules, mesh):
    """A :class:`Sharding` tree matching a ParamSpec tree."""
    return tree_map(lambda s: sharding_for(s, rules, mesh), specs)


def shard_leaf(full: torch.Tensor, sh: Sharding, mesh) -> torch.Tensor:
    """This rank's piece of a whole leaf: a copy of its slice, or the leaf
    itself where nothing splits it."""
    if not comm.live_axes(mesh, sh.axes):
        return full
    return full[sh.slices(comm.coordinate(mesh))].clone()


def gather_leaf(piece: torch.Tensor, sh: Sharding, mesh) -> torch.Tensor:
    """The whole leaf from the pieces of the ranks that hold it: each split
    dimension gathered over its axes, the innermost axis first (the leaf
    itself where nothing splits it)."""
    out = piece
    for i in range(len(sh.shape)):
        for a in reversed(sh.dim_axes(i)):
            out = comm.all_gather(out, mesh, a, i)
    return out


def _pairs(tree, shardings) -> dict:
    sh = flatten(shardings)
    return {k: (v, sh[k]) for k, v in flatten(tree).items()}


def shard_tree(tree, shardings, mesh):
    """Whole leaves -> this rank's pieces (``shardings`` a Sharding tree of
    the same structure)."""
    return unflatten({k: shard_leaf(v, s, mesh)
                      for k, (v, s) in _pairs(tree, shardings).items()})


def gather_tree(tree, shardings, mesh):
    """This rank's pieces -> whole leaves (a collective: every rank of the
    mesh calls it)."""
    return unflatten({k: gather_leaf(v, s, mesh)
                      for k, (v, s) in _pairs(tree, shardings).items()})


# --------------------------------------------------------------------------
# Activation partition constraints
# --------------------------------------------------------------------------


class PartitionConstraints:
    """The rules and the mesh handed to models as ``pc``.

    The activation methods (``act``, ``tokens``, ``heads``, ...) are the
    identity (see the module docstring).  Models read the mesh from here:
    the MoE layer for its dispatch, the loss for its data-parallel
    normalisation (:attr:`dp_axes`)."""

    def __init__(self, rules: ShardingRules, mesh=None,
                 seq_parallel: bool = False):
        if seq_parallel:
            raise NotImplementedError(f"sequence parallelism: {UNPORTED}")
        self.rules = rules
        self.mesh = mesh

    @property
    def dp_axes(self) -> tuple:
        """The data-parallel axes ``("pod", "data")`` this mesh has with a
        size above 1: ranks that differ on them hold different rows."""
        return comm.live_axes(self.mesh, ("pod", "data"))

    def act(self, x, *logical_axes):
        if len(logical_axes) != x.ndim:
            raise ValueError(f"{len(logical_axes)} axes for rank-{x.ndim}")
        return x

    def tokens(self, x):                       # (B, S, d)
        return x

    def tokens_sp(self, x):
        raise NotImplementedError(f"sequence-parallel regions: {UNPORTED}")

    def heads(self, x):                        # (B, S, H, D)
        return x

    def kv(self, x):                           # (B, S, KV, D)
        return x

    def kv_cache(self, x):                     # (B, S_cache, KV, D)
        return x

    def expert_buffer(self, x):                # (E, C, d)
        return x

    def grouped_expert_buffer(self, x):        # (G, E, C, d)
        return x

    def logits(self, x):                       # (B, S, vocab)
        return x


class NullConstraints(PartitionConstraints):
    """No mesh: the one-device model."""

    def __init__(self):
        super().__init__(TRAIN_RULES, mesh=None)
