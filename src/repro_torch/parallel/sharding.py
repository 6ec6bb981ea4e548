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
as its ``pc`` argument, and, where a pass is handed this rank's stored
pieces of the params, their :class:`Pieces`: the shardings and roles by
which the pass gathers each layer's leaves inside that layer's call
(:func:`gathered`), as the reference's scan body gathers its FSDP pieces
under XLA.  Under data parallelism each rank runs the model on
its own rows, with plain local tensors that have no layout to constrain.
On a mesh with a live ``"model"`` axis the attention families (the
dense, MoE and VLM decoders with GQA or MLA attention, and the
encoder-decoder: :func:`tp_covers`) compute tensor-parallel in every mode:
:meth:`PartitionConstraints.tensor_parallel` gives the pass its
:class:`TensorParallel` layout, whose regions
(:mod:`repro_torch.parallel.comm`) each block enters and leaves.  A leaf
whose logical axes bind ``"model"`` is computed as this rank's piece
(column-parallel query heads, MLA's ``wq_b`` / ``wkv_b`` heads and MLP
columns, row-parallel outputs, the vocabulary, the MoE's experts or, where
the experts do not divide, their hidden columns); with ``seq_parallel`` the
residual stream between blocks holds this rank's rows of the sequence (and
an encoder's of the source frames), where the sequence divides by the
``"model"`` size (the reference's ``tokens`` fallback otherwise).
:func:`tp_roles` says, leaf by leaf, how the step gathers it and syncs
its gradient.  The two recurrent families (the Mamba2 hybrid and RWKV6)
compute whole, and sequence parallelism on them raises (ROADMAP Queue 1,
item 2).

Serving on a mesh takes the same layout in prefill and decode (no sequence
parallelism: ``SERVE_RULES`` leaves ``seq`` unbound).  A serving
:class:`PartitionConstraints` also carries the pass's global ``batch`` and
cache length ``max_len``: the rows split over ("pod", "data") where the
binding divides them, else every data-parallel rank takes them all
(:attr:`PartitionConstraints.rows_split`); the KV cache lies as
:func:`cache_shardings` binds it, its ``kv_heads`` on "model" where they
divide (``"heads"``; an encoder-decoder's cross K/V too), else its
``cache_seq`` (``"seq"``: a rank holds ``1 / tp`` of the slots of every KV
head, or of MLA's latent ``ckv`` / ``krope``), and whole over "model" for
the families tensor-parallel compute does not cover
(:func:`kv_cache_layout`).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.models.params import ParamSpec, flatten, tree_map, unflatten
from repro_torch.parallel import comm

UNPORTED = ("tensor-parallel compute and sequence parallelism are ported "
            "for the attention families only (the Mamba2 hybrid and RWKV6 "
            "keep every leaf whole): ROADMAP Queue 1, item 2")


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

    def layer(self, stacked: int = 1) -> "Sharding":
        """The Sharding of one layer of a leaf whose ``stacked`` leading
        dimensions stack layers (never split: ``"layers": None``), so a
        layer's piece is a row of the stacked piece."""
        if any(self.dim_axes(i) for i in range(stacked)):
            raise ValueError(f"a {self.shape} leaf split over its stacked "
                             f"dimensions: {self.spec}")
        return Sharding(self.spec[stacked:], self.shape[stacked:],
                        self.sizes)

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
    return unflatten({k: comm.gather_dims(v, s, mesh)
                      for k, (v, s) in _pairs(tree, shardings).items()})


# --------------------------------------------------------------------------
# Tensor-parallel compute
# --------------------------------------------------------------------------

ROLES = ("split", "whole", "partial")


def tp_covers(cfg) -> bool:
    """Whether the model computes tensor-parallel under a live "model"
    axis: every family but the two recurrent ones (``dense``, ``moe`` and
    ``vlm`` with GQA or MLA attention, and the ``encdec``).  The Mamba2
    hybrid and RWKV6 keep every leaf whole (ROADMAP Queue 1, item 2)."""
    return cfg.family not in ("hybrid", "ssm")


def binds_model(s: ParamSpec, rules: ShardingRules, mesh) -> bool:
    """Whether ``logical_to_pspec`` binds a live "model" axis to one of the
    leaf's dimensions."""
    if comm.axis_sizes(mesh).get("model", 1) == 1:
        return False
    return "model" in (a for e in logical_to_pspec(s.axes, s.shape, rules,
                                                   mesh)
                       for a in _flatten_mesh_axes(e))


# MLA's leaves that every rank computes whole on the entered input, for its
# own heads only (``q_lora`` / ``kv_lora``, never bound)
_MLA_LATENT = ("wq_a", "q_norm", "wkv_a", "kv_norm")


def _leaf_role(key: str, s: ParamSpec, specs: dict, rules, mesh,
               seq_parallel: bool) -> str:
    name = key.rsplit("/", 2)
    parent, leaf = (name[-2], name[-1]) if len(name) > 1 else ("", key)
    if parent in ("attn", "cross"):
        block = key.rsplit("/", 1)[0]
        mla = f"{block}/wq_b" in specs
        heads = binds_model(specs[f"{block}/{'wq_b' if mla else 'wq'}"],
                            rules, mesh)
        if leaf in ("wq", "wo", "wq_b", "wkv_b"):
            return "split" if heads else "whole"
        if leaf in _MLA_LATENT:
            return "partial" if heads else "whole"
        if binds_model(s, rules, mesh):
            return "split"
        # the reference's kv_heads fallback: each rank projects the KV
        # heads its query heads read from the replicated leaf
        return "partial" if heads else "whole"
    if parent == "moe":
        # the expert stacks are this rank's experts, or (where the experts
        # do not divide) their hidden columns, as the binding says; the
        # router stays whole: every "model" rank routes every token alike
        if leaf == "router":
            return "whole"
        return "split" if binds_model(s, rules, mesh) else "whole"
    if parent in ("mlp", "embed") or (parent == "shared"
                                      and key.split("/")[-3] == "moe"):
        return "split" if binds_model(s, rules, mesh) else "whole"
    if parent in ("ln1", "ln2", "ln_cross", "final_norm"):
        # under sequence parallelism a norm sees this rank's rows only
        return "partial" if seq_parallel else "whole"
    return "whole"


def tp_roles(cfg, rules: ShardingRules, mesh,
             seq_parallel: bool = False) -> dict:
    """{flat key: role} of every leaf of ``model_specs(cfg)`` under
    tensor-parallel compute on ``mesh`` (``seq_parallel``: whether this
    pass runs sequence-parallel, i.e. asked for and the sequence divides
    by the "model" size):

    * ``"split"``: ``logical_to_pspec`` binds "model" to one of its
      dimensions; the rank computes with its piece (gathered over the
      other axes only), and its gradient is already that piece's (the
      MoE's expert stacks on their ``experts`` or, where those do not
      divide, their ``mlp`` dimension; its shared experts as an MLP; MLA's
      ``wq_b``, ``wkv_b`` and ``wo`` on their heads; a cross-attention's
      leaves as a self-attention's);
    * ``"whole"``: gathered whole and computed whole, as without tensor
      parallelism; its gradient is the same on every "model" rank, which
      keeps its chunk locally (the MoE router, even where its ``experts``
      dimension binds "model": routing is a softmax over every expert;
      attention whose ``heads`` fell back to replication; an expert stack
      neither of whose dimensions divides; every leaf of a family
      :func:`tp_covers` does not cover, and every leaf without a live
      "model" axis);
    * ``"partial"``: replicated over "model", but each rank uses part of
      it (``wk`` / ``wv`` under the ``kv_heads`` fallback), computes it
      whole for its own heads only (MLA's ``wq_a``, ``q_norm``, ``wkv_a``
      and ``kv_norm`` where the heads split) or sees part of the rows (a
      norm's scale and bias under sequence parallelism, ``ln_cross`` and
      an encoder's included); its gradient is summed over "model" before
      the data-parallel mean."""
    from repro_torch.models.transformer import model_specs
    specs = flatten(model_specs(cfg))
    if not (tp_covers(cfg) and comm.axis_sizes(mesh).get("model", 1) > 1):
        return {k: "whole" for k in specs}
    return {k: _leaf_role(k, s, specs, rules, mesh, seq_parallel)
            for k, s in specs.items()}


# --------------------------------------------------------------------------
# The serving cache over a mesh
# --------------------------------------------------------------------------


def without_axis(rules: ShardingRules, axis: str) -> ShardingRules:
    """``rules`` with ``axis`` taken out of every entry."""
    out = {}
    for k, e in rules.rules.items():
        left = tuple(a for a in _flatten_mesh_axes(e) if a != axis)
        out[k] = None if not left else (left[0] if isinstance(e, str)
                                         else left)
    return ShardingRules(out)


def cache_rules(cfg, rules: ShardingRules) -> ShardingRules:
    """The rules a serving cache is stored under: ``rules`` with ``embed``
    unbound (an RWKV6 token shift's width stays whole: the reference
    stores it split over "data" where the rows leave that axis free, a
    layout no rank computes with), and for a family :func:`tp_covers` does
    not cover without "model" too (its "model" ranks compute whole, so
    their caches stay whole over it)."""
    rules = rules.with_overrides(embed=None)
    return rules if tp_covers(cfg) else without_axis(rules, "model")


def cache_shardings(cfg, rules: ShardingRules, mesh, batch: int,
                    max_len: int):
    """A Sharding tree of ``cache_specs(cfg, batch, max_len)`` on ``mesh``
    (:func:`cache_rules`): what each rank allocates."""
    from repro_torch.models.transformer import cache_specs
    return shardings_for_specs(cache_specs(cfg, batch, max_len),
                               cache_rules(cfg, rules), mesh)


def kv_cache_layout(cfg, rules: ShardingRules, mesh, max_len: int,
                    cross: bool = False) -> str:
    """How a decoder's attention cache of ``max_len`` lies over "model":
    ``"heads"`` where its ``kv_heads`` take "model" (each rank projects
    and caches its own KV heads: the reference's in-place ``"dus"`` write),
    ``"seq"`` where its ``cache_seq`` does (a rank holds ``1 / tp`` of the
    slots of every KV head, or of MLA's latent ``ckv`` and ``krope``, which
    have no head dimension: the reference's ``"onehot"`` write, which only
    the rank holding the slot makes), ``"whole"`` where neither does (no
    live "model" axis, a family :func:`tp_covers` does not cover, or
    dimensions that do not divide).  ``cross``: an encoder-decoder's
    cross K/V cache in place of its self cache (its ``cache_seq`` is the
    source frames)."""
    if comm.axis_sizes(mesh).get("model", 1) == 1 or not tp_covers(cfg):
        return "whole"
    from repro_torch.models.transformer import cache_specs
    kv = next(s for k, s in flatten(cache_specs(cfg, 1, max_len)).items()
              if k.endswith(("/k", "/ckv"))
              and k.startswith("cross/") == cross)
    spec = logical_to_pspec(kv.axes, kv.shape, rules, mesh)
    for logical, name in (("kv_heads", "heads"), ("cache_seq", "seq")):
        i = kv.axes.index(logical) if logical in kv.axes else len(spec)
        if i < len(spec) and "model" in _flatten_mesh_axes(spec[i]):
            return name
    return "whole"


@dataclass(frozen=True)
class TensorParallel:
    """One pass's layout over "model": ``size`` ranks, this one at
    ``rank``; ``sp``: the residual stream between blocks holds this rank's
    ``S / size`` rows of the sequence (train mode only); ``cache``: how
    the KV cache a prefill or decode pass writes lies over "model"
    (:func:`kv_cache_layout`; None in train mode), ``cross`` how an
    encoder-decoder's cross K/V cache does.

    A block's sublayer runs between :meth:`enter` and :meth:`leave`: a
    split one (its leaves bind "model") on this rank's heads or columns,
    its row-parallel output summed over "model"; a whole one on the whole
    sequence, as without tensor parallelism."""

    mesh: object
    rules: ShardingRules
    size: int
    rank: int
    sp: bool
    cache: Optional[str] = None
    cross: Optional[str] = None

    def split_dim(self, s: ParamSpec) -> Optional[int]:
        """The dimension of ``s`` bound to "model" (None: none is)."""
        spec = logical_to_pspec(s.axes, s.shape, self.rules, self.mesh)
        return next((i for i, e in enumerate(spec)
                     if "model" in _flatten_mesh_axes(e)), None)

    def splits(self, s: ParamSpec) -> bool:
        return self.split_dim(s) is not None

    def whole(self, x):
        """This rank's rows -> the whole sequence (backward: this rank's
        rows of the gradient every rank holds whole)."""
        if not self.sp:
            return x
        return comm.from_shard(x, self.mesh, "model", comm.SEQ_DIM)

    def local(self, x):
        """The whole sequence -> this rank's rows (backward: the rows'
        gradients gathered)."""
        if not self.sp:
            return x
        return comm.to_shard(x, self.mesh, "model", comm.SEQ_DIM)

    def reduce(self, y):
        """Partial sums over "model" -> their sum in this pass's layout."""
        return comm.scatter_seq(y, self.mesh) if self.sp else \
            comm.reduce_from_model(y, self.mesh)

    def enter(self, h, split: bool):
        """A sublayer's input in this pass's layout -> the whole sequence
        its products read."""
        if not split:
            return self.whole(h)
        return comm.gather_seq(h, self.mesh) if self.sp else \
            comm.copy_to_model(h, self.mesh)

    def leave(self, y, split: bool):
        """A sublayer's output -> this pass's layout."""
        return self.reduce(y) if split else self.local(y)


# --------------------------------------------------------------------------
# A pass on pieces (FSDP)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Pieces:
    """What a pass on a mesh was handed: this rank's stored pieces of the
    params, each as its Sharding in ``shardings`` says, computed with as
    its role in ``roles`` says (both flat-keyed, :func:`tp_roles`).  The
    pass gathers each layer's leaves inside that layer's call and the
    leaves outside the layer stacks once a pass, each through
    ``comm.gather_piece``, whose backward returns this rank's piece of the
    gradient's mean over "data"."""

    shardings: dict
    roles: dict
    mesh: object

    def gather(self, tree, prefix: str, stacked: int = 0):
        """The leaves the pass computes with from ``tree``, pieces of the
        subtree ``prefix`` (of one layer of it where ``stacked`` leading
        layer dimensions were indexed away)."""
        return unflatten({k: comm.gather_piece(
            v, self.shardings[f"{prefix}/{k}"].layer(stacked), self.mesh,
            self.roles[f"{prefix}/{k}"]) for k, v in flatten(tree).items()})


def gathered(tree, prefix: str, pc, stacked: int = 0):
    """``pc.pieces.gather(...)`` (:class:`Pieces`) where the pass was handed
    pieces, else ``tree`` (the leaves the pass computes with already)."""
    plan = getattr(pc, "pieces", None)
    return tree if plan is None else plan.gather(tree, prefix, stacked)


# --------------------------------------------------------------------------
# Activation partition constraints
# --------------------------------------------------------------------------


class PartitionConstraints:
    """The rules and the mesh handed to models as ``pc``.

    Models read the mesh from here: the MoE layer for its dispatch, the
    loss for its data-parallel normalisation (:attr:`dp_axes`), a pass its
    tensor-parallel layout (:meth:`tensor_parallel`).  Of the activation
    methods, ``tokens`` and ``tokens_sp`` take a whole (B, S, d) sequence
    to this rank's layout (its rows under sequence parallelism); the others
    are the identity: a rank's tensors are plain local ones.

    ``batch`` and ``max_len`` (serving): the pass's global rows and its
    cache's global length.  A rank's tensors hold its pieces, so these are
    what says how the global ones were cut: the rows by the binding of
    ``"batch"`` at ``batch`` (:attr:`rows_split`), the cache by
    :func:`cache_shardings`.  A train step leaves both None: its rows
    always split (``train.step.shard_batch``).

    ``pieces`` (:class:`Pieces`, set by :meth:`with_pieces`: the train
    step's ``make_grads_fn`` and ``serve.engine.make_serve_fns`` do): the
    params the pass receives are this rank's stored pieces, gathered layer
    by layer in the pass; None: they are the leaves it computes with."""

    def __init__(self, rules: ShardingRules, mesh=None,
                 seq_parallel: bool = False, batch: Optional[int] = None,
                 max_len: Optional[int] = None):
        self.rules = rules
        self.mesh = mesh
        self.seq_parallel = seq_parallel
        self.batch = batch
        self.max_len = max_len
        self.pieces: Optional[Pieces] = None

    def with_pieces(self, shardings, roles: dict) -> "PartitionConstraints":
        """These constraints for a pass handed this rank's pieces of the
        params, stored as the Sharding tree ``shardings`` says and computed
        with by ``roles`` (:func:`tp_roles`)."""
        out = copy.copy(self)
        out.pieces = Pieces(flatten(shardings), dict(roles), self.mesh)
        return out

    @property
    def rows_split(self) -> bool:
        """Whether ranks that differ in ("pod", "data") hold different rows:
        always for a train step (``batch`` None); for a serving pass where
        the binding splits ``batch`` rows over them, as the reference's
        ``batch`` rule does where they divide (else it replicates them)."""
        if self.batch is None or not comm.live_axes(self.mesh,
                                                    ("pod", "data")):
            return True
        return bool(logical_to_pspec(("batch",), (self.batch,), self.rules,
                                     self.mesh))

    @property
    def local_rows(self) -> Optional[int]:
        """This rank's rows of a serving pass (None without ``batch``)."""
        if self.batch is None:
            return None
        if not self.rows_split:
            return self.batch
        return self.batch // comm.group_size(self.mesh, ("pod", "data"))

    @property
    def model_size(self) -> int:
        return comm.axis_sizes(self.mesh).get("model", 1)

    def sp_for(self, s: int) -> bool:
        """Whether a pass over ``s`` tokens runs sequence-parallel: asked
        for, a live "model" axis, and ``s`` divisible by its size (the
        reference's ``tokens`` fallback)."""
        tp = self.model_size
        return self.seq_parallel and tp > 1 and s % tp == 0

    def sp_pass(self, cfg, s: int, s_src: Optional[int] = None) -> bool:
        """Whether a train pass over ``s`` tokens runs sequence-parallel
        (:meth:`sp_for`); an encoder-decoder's only where its ``s_src``
        source frames divide too, so one layout holds for the whole pass
        (its encoder's rows and its decoder's)."""
        return self.sp_for(s) and (cfg.family != "encdec" or s_src is None
                                   or self.sp_for(s_src))

    def tensor_parallel(self, cfg, s: int, mode: str = "train",
                        s_src: Optional[int] = None
                        ) -> Optional[TensorParallel]:
        """A pass's layout over ``s`` tokens (an encoder-decoder's over
        ``s_src`` source frames besides: :meth:`sp_pass`) in ``mode``;
        None where the model computes whole (no live "model" axis, or a
        family :func:`tp_covers` does not cover).  Sequence parallelism on
        such a family raises; a prefill or decode pass runs without it, its
        cache laid out by :func:`kv_cache_layout` (which needs
        ``max_len``)."""
        if self.seq_parallel and not tp_covers(cfg):
            raise NotImplementedError(
                f"seq_parallel for family {cfg.family!r}: {UNPORTED}")
        if self.model_size == 1 or not tp_covers(cfg):
            return None
        cache = cross = None
        if mode != "train":
            if self.max_len is None:
                raise ValueError("a prefill or decode pass on a live "
                                 "\"model\" axis needs pc.max_len, the "
                                 "cache's global length")
            cache = kv_cache_layout(cfg, self.rules, self.mesh,
                                    self.max_len)
            if cfg.family == "encdec":
                cross = kv_cache_layout(cfg, self.rules, self.mesh,
                                        self.max_len, cross=True)
        return TensorParallel(self.mesh, self.rules, self.model_size,
                              comm.coordinate(self.mesh)["model"],
                              mode == "train" and self.sp_pass(cfg, s, s_src),
                              cache, cross)

    @property
    def dp_axes(self) -> tuple:
        """The data-parallel axes ``("pod", "data")`` this mesh has with a
        size above 1 over which ranks hold different rows (none where a
        serving pass's rows are replicated: :attr:`rows_split`)."""
        if not self.rows_split:
            return ()
        return comm.live_axes(self.mesh, ("pod", "data"))

    def act(self, x, *logical_axes):
        if len(logical_axes) != x.ndim:
            raise ValueError(f"{len(logical_axes)} axes for rank-{x.ndim}")
        return x

    def tokens(self, x):                       # (B, S, d)
        """The whole sequence -> this rank's layout: its rows where the
        pass runs sequence-parallel (:meth:`sp_for`), else ``x``."""
        if x.ndim == 3 and self.sp_for(x.shape[1]):
            return self.tokens_sp(x)
        return x

    def tokens_sp(self, x):
        """The whole sequence -> this rank's rows (a sequence-parallel
        region; backward: the rows' gradients gathered)."""
        return comm.to_shard(x, self.mesh, "model", comm.SEQ_DIM)

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
