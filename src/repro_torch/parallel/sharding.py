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
``NamedSharding`` lays them out).  A leaf whose last dimension
concatenates parts (a ParamSpec's ``segments``: Mamba2's ``in_proj`` is
``[z | x | B C | dt]``, its ``conv_w``, ``conv_b`` and conv cache ``[x | B
C]``) binds that dimension only where every part divides, and its piece
holds the same chunk of each part (``[z_r | x_r | BC_r | dt_r]``: a narrow
Mamba2 of rank r's heads, of the width of the reference's contiguous
piece); :meth:`Sharding.cut` cuts such a piece and ``comm.gather_dims``
puts the parts back, and :meth:`Sharding.slices` refuses the leaf, so no
site can cut it as a contiguous slice.  :func:`shard_tree` and
:func:`gather_tree` move a tree between whole leaves and this rank's
shards.

:class:`PartitionConstraints` carries the rules and the mesh to the model
as its ``pc`` argument, and, where a pass is handed this rank's stored
pieces of the params, their :class:`Pieces`: the shardings and roles by
which the pass gathers each layer's leaves inside that layer's call
(:func:`gathered`), as the reference's scan body gathers its FSDP pieces
under XLA.  Under data parallelism each rank runs the model on
its own rows, with plain local tensors that have no layout to constrain.
On a mesh with a live ``"model"`` axis every family computes
tensor-parallel in every mode:
:meth:`PartitionConstraints.tensor_parallel` gives the pass its
:class:`TensorParallel` layout, whose regions
(:mod:`repro_torch.parallel.comm`) each block enters and leaves.  A leaf
whose logical axes bind ``"model"`` is computed as this rank's piece
(column-parallel query heads, MLA's ``wq_b`` / ``wkv_b`` heads and MLP
columns, row-parallel outputs, the vocabulary, the MoE's experts or, where
the experts do not divide, their hidden columns, Mamba2's and RWKV6's heads
and RWKV6's channel-mix columns); with ``seq_parallel`` the residual stream
between blocks holds this rank's rows of the sequence (and an encoder's of
the source frames), where the sequence divides by the ``"model"`` size
(the reference's ``tokens`` fallback otherwise).  :func:`tp_roles` says,
leaf by leaf, how the step gathers it and syncs its gradient; a leaf is
``"whole"`` only by its binding (no live "model" axis, or dimensions that
do not divide).

Serving on a mesh takes the same layout in prefill and decode (no sequence
parallelism: ``SERVE_RULES`` leaves ``seq`` unbound).  A serving
:class:`PartitionConstraints` also carries the pass's global ``batch`` and
cache length ``max_len``: the rows split over ("pod", "data") where the
binding divides them, else every data-parallel rank takes them all
(:attr:`PartitionConstraints.rows_split`); the KV cache lies as
:func:`cache_shardings` binds it, its ``kv_heads`` on "model" where they
divide (``"heads"``; an encoder-decoder's cross K/V and a hybrid's shared
attention blocks too), else its ``cache_seq`` (``"seq"``: a rank holds ``1
/ tp`` of the slots of every KV head, or of MLA's latent ``ckv`` /
``krope``), and ``"whole"`` for a family with no attention cache
(:func:`kv_cache_layout`); Mamba2's SSM state and RWKV6's WKV state split
by heads, the conv cache as its parts, RWKV6's token shifts whole.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.models.params import ParamSpec, flatten, tree_map, unflatten
from repro_torch.parallel import comm

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
                     mesh, segments: tuple = ()) -> tuple:
    """Bind logical axes to a spec with the reference's divisibility
    fallback.  ``mesh``: a DeviceMesh or a ``{axis: size}`` dict.
    ``segments``: the widths of the parts the last dimension concatenates,
    each of which must divide for that dimension to bind."""
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
        parts = segments if segments and i == len(axes) - 1 else (dim,)
        if names and dim >= prod and all(w % prod == 0 for w in parts):
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
    # the parts of a split last dimension (ParamSpec.segments; () where
    # the last dimension is not split or is plain): a piece holds the same
    # chunk of each
    segments: tuple = ()

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
                        self.sizes, self.segments)

    def slices(self, coord: dict) -> tuple:
        """The slice of each dimension held at mesh coordinate ``coord``;
        a leaf with a segmented last dimension has none (:meth:`cut`)."""
        if self.segments:
            raise ValueError(f"a {self.shape} leaf split by its parts "
                             f"{self.segments} is no slice: Sharding.cut")
        return self._slices(coord)

    def _dim_index(self, i: int, coord: dict) -> tuple:
        """(index, count) of the piece of dimension ``i`` at ``coord``."""
        sizes = dict(self.sizes)
        idx, n = 0, 1
        for a in self.dim_axes(i):
            idx = idx * sizes[a] + coord.get(a, 0)
            n *= sizes[a]
        return idx, n

    def columns(self, coord: dict) -> list:
        """The last dimension's indices held at ``coord`` (its parts'
        chunks, in part order, for a segmented leaf)."""
        idx, n = self._dim_index(len(self.shape) - 1, coord)
        return comm.segment_columns(self.segments or (self.shape[-1],),
                                    idx, n)

    def cut(self, full, coord: dict):
        """The piece held at ``coord`` of a whole leaf (a torch tensor or
        a numpy array): a view of its slice, or, for a segmented leaf, a
        copy of its slice of the leading dimensions and its
        :meth:`columns` of the last."""
        if not self.segments:
            return full[self._slices(coord)]
        t = full[self._slices(coord)[:-1]]
        cols = self.columns(coord)
        if isinstance(t, torch.Tensor):
            return comm.take_columns(t, cols)
        return t[..., cols]

    def _slices(self, coord: dict) -> tuple:
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


def pspec_of(s: ParamSpec, rules: ShardingRules, mesh) -> tuple:
    """:func:`logical_to_pspec` of a ParamSpec, its parts included."""
    return logical_to_pspec(s.axes, s.shape, rules, mesh, s.segments)


def sharding_for(s: ParamSpec, rules: ShardingRules, mesh) -> Sharding:
    """The Sharding of a ParamSpec: its binding, and its ``segments``
    where that splits the last dimension over more than one rank (a
    one-rank split cuts nothing)."""
    spec = pspec_of(s, rules, mesh)
    sizes = comm.axis_sizes(mesh)
    split_last = bool(spec) and len(spec) == len(s.shape) and math.prod(
        sizes[a] for a in _flatten_mesh_axes(spec[-1])) > 1
    return Sharding(spec, tuple(s.shape), tuple(sizes.items()),
                    s.segments if split_last else ())


def shardings_for_specs(specs, rules: ShardingRules, mesh):
    """A :class:`Sharding` tree matching a ParamSpec tree."""
    return tree_map(lambda s: sharding_for(s, rules, mesh), specs)


def shard_leaf(full: torch.Tensor, sh: Sharding, mesh) -> torch.Tensor:
    """This rank's piece of a whole leaf: a copy of its cut
    (:meth:`Sharding.cut`), or the leaf itself where nothing splits it."""
    if not comm.live_axes(mesh, sh.axes):
        return full
    return sh.cut(full, comm.coordinate(mesh)).clone()


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


def binds_model(s: ParamSpec, rules: ShardingRules, mesh) -> bool:
    """Whether the binding of ``s`` (:func:`pspec_of`) puts a live "model"
    axis on one of its dimensions."""
    if comm.axis_sizes(mesh).get("model", 1) == 1:
        return False
    return "model" in (a for e in pspec_of(s, rules, mesh)
                       for a in _flatten_mesh_axes(e))


# MLA's leaves that every rank computes whole on the entered input, for its
# own heads only (``q_lora`` / ``kv_lora``, never bound)
_MLA_LATENT = ("wq_a", "q_norm", "wkv_a", "kv_norm")


# Mamba2's leaves (a hybrid's ``groups`` and ``rem``): computed on this
# rank's heads where ``in_proj``'s parts all split
MAMBA2 = ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D",
          "norm_scale", "out_proj")
# RWKV6's time mix: the leaves of this rank's heads (where ``bonus_u``'s
# heads split), and those every rank computes whole on the entered input,
# for its own heads only (no dimension binds "model": their gradients are
# partial sums); its channel mix alike, on this rank's columns (where
# ``cm_wk``'s hidden columns and ``cm_wr``'s output columns split)
RWKV_TIME = ("wr", "wk", "wv", "wg", "wo", "bonus_u", "ln_x_scale",
             "ln_x_bias")
RWKV_TIME_WHOLE = ("mu_x", "mu_rkvwg", "mix_w1", "mix_w2", "w0", "decay_w1",
                   "decay_w2")
RWKV_CHANNEL = ("cm_wk", "cm_wv", "cm_wr")
RWKV_CHANNEL_WHOLE = ("cm_mu_k", "cm_mu_r")
RWKV_NORMS = ("ln_tm_scale", "ln_tm_bias", "ln_cm_scale", "ln_cm_bias")


def recurrent_splits(cfg, split) -> dict:
    """Which recurrent mixers of ``cfg`` compute on this rank's heads or
    columns, by ``split`` (a ParamSpec -> whether its binding puts "model"
    on it): ``"mamba2"`` (``in_proj``'s parts all divide, and its heads
    read one B / C group, as zamba2's do: a rank's heads of several groups
    would need their groups' columns cut, which no config asks for),
    ``"time_mix"`` (RWKV6's heads) and ``"channel_mix"`` (its hidden and
    output columns).  The one rule :func:`tp_roles` and the model
    share."""
    from repro_torch.models.ssm import mamba2_specs, rwkv6_specs
    if cfg.family == "hybrid":
        return {"mamba2": cfg.ssm.n_groups == 1 and
                split(mamba2_specs(cfg)["in_proj"])}
    if cfg.family == "ssm":
        p = rwkv6_specs(cfg)
        return {"time_mix": split(p["bonus_u"]),
                "channel_mix": split(p["cm_wk"]) and split(p["cm_wr"])}
    return {}


def _recurrent_role(leaf: str, parent: str, s: ParamSpec, splits: dict,
                    rules, mesh, seq_parallel: bool) -> Optional[str]:
    """The role of a Mamba2 or RWKV6 leaf (None: not one)."""
    if parent in ("groups", "rem") and leaf in MAMBA2:
        return "split" if splits["mamba2"] and binds_model(s, rules, mesh) \
            else "whole"
    if parent == "ln" or (parent == "layers" and leaf in RWKV_NORMS):
        return "partial" if seq_parallel else "whole"
    if parent != "layers":
        return None
    for mixer, own, whole in (("time_mix", RWKV_TIME, RWKV_TIME_WHOLE),
                              ("channel_mix", RWKV_CHANNEL,
                               RWKV_CHANNEL_WHOLE)):
        if leaf in own:
            return "split" if splits[mixer] and binds_model(s, rules, mesh) \
                else "whole"
        if leaf in whole:
            return "partial" if splits[mixer] else "whole"
    return None


def _leaf_role(key: str, s: ParamSpec, specs: dict, rules, mesh,
               seq_parallel: bool, splits: dict) -> str:
    name = key.rsplit("/", 2)
    parent, leaf = (name[-2], name[-1]) if len(name) > 1 else ("", key)
    if splits:
        role = _recurrent_role(leaf, parent, s, splits, rules, mesh,
                               seq_parallel)
        if role is not None:
            return role
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
      leaves as a self-attention's; Mamba2's leaves on this rank's heads,
      ``in_proj``, ``conv_w`` and ``conv_b`` as their parts' chunks;
      RWKV6's :data:`RWKV_TIME` on its heads and :data:`RWKV_CHANNEL` on
      its columns);
    * ``"whole"``: gathered whole and computed whole, as without tensor
      parallelism; its gradient is the same on every "model" rank, which
      keeps its chunk locally (the MoE router, even where its ``experts``
      dimension binds "model": routing is a softmax over every expert;
      attention whose ``heads`` fell back to replication; an expert stack
      neither of whose dimensions divides; a recurrent mixer's leaves
      where its heads or parts do not divide (:func:`recurrent_splits`),
      and every leaf without a live "model" axis);
    * ``"partial"``: replicated over "model", but each rank uses part of
      it (``wk`` / ``wv`` under the ``kv_heads`` fallback), computes it
      whole for its own heads only (MLA's ``wq_a``, ``q_norm``, ``wkv_a``
      and ``kv_norm`` where the heads split; RWKV6's
      :data:`RWKV_TIME_WHOLE` and :data:`RWKV_CHANNEL_WHOLE` where its
      heads or columns split) or sees part of the rows (a norm's scale and
      bias under sequence parallelism, ``ln_cross``, an encoder's, a
      Mamba2 block's ``ln`` and RWKV6's LayerNorms included); its gradient
      is summed over "model" before the data-parallel mean."""
    from repro_torch.models.transformer import model_specs
    specs = flatten(model_specs(cfg))
    if comm.axis_sizes(mesh).get("model", 1) == 1:
        return {k: "whole" for k in specs}
    splits = recurrent_splits(cfg, lambda s: binds_model(s, rules, mesh))
    return {k: _leaf_role(k, s, specs, rules, mesh, seq_parallel, splits)
            for k, s in specs.items()}


def wire_dtypes(cfg) -> dict:
    """{flat key: the dtype a gather of the leaf moves} of every leaf of
    ``model_specs(cfg)``: the pass's compute dtype (``cfg.dtype``) for a
    leaf every use of which casts it to that dtype first (the matrices, and
    the embedding table, whose ``table[tokens].to(dt)`` equals
    ``table.to(dt)[tokens]``), which ``params.compute_dtype_for`` casts;
    None (its own dtype) for the leaves read in fp32 (``fp32_leaves``: the
    norms' scales and biases, Mamba2's ``A_log`` and ``dt_bias``, RWKV6's
    decay and bonus, the MoE router: the all-to-all dispatch reads it in
    fp32 whatever ``router_dtype`` says).  A pass
    gathers a leaf in its wire dtype and casts it back at once, an exact
    round trip, so the pass's bits do not move and only the bytes of the
    exchange do."""
    from repro_torch.models.params import compute_dtype_for, fp32_leaves
    from repro_torch.models.transformer import model_specs
    dt, keep = getattr(torch, cfg.dtype), fp32_leaves(cfg)
    out = {}
    for k, s in flatten(model_specs(cfg)).items():
        wire = compute_dtype_for(k, s.dtype, dt, keep + ("router",))
        out[k] = wire if wire != s.dtype else None
    return out


# --------------------------------------------------------------------------
# The serving cache over a mesh
# --------------------------------------------------------------------------


def cache_shardings(cfg, rules: ShardingRules, mesh, batch: int,
                    max_len: int):
    """A Sharding tree of ``cache_specs(cfg, batch, max_len)`` on ``mesh``:
    what each rank allocates.  The cache is stored under ``rules`` with
    ``embed`` unbound (an RWKV6 token shift's width stays whole: the
    reference stores it split over "data" where the rows leave that axis
    free, a layout no rank computes with).  A hybrid whose Mamba2 layers
    compute whole (:func:`recurrent_splits`: ``in_proj``'s parts do not
    all divide) keeps their conv and SSM caches whole (their ``inner`` and
    ``ssm_heads`` unbound), whatever their own dimensions would take."""
    from repro_torch.models.transformer import cache_specs
    specs = cache_specs(cfg, batch, max_len)
    crules = rules.with_overrides(embed=None)
    out = flatten(shardings_for_specs(specs, crules, mesh))
    if cfg.family == "hybrid" and not recurrent_splits(
            cfg, lambda s: binds_model(s, rules, mesh))["mamba2"]:
        whole = crules.with_overrides(inner=None, ssm_heads=None)
        for k, s in flatten(specs).items():
            if k.endswith(("/conv", "/ssm")):
                out[k] = sharding_for(s, whole, mesh)
    return unflatten(out)


def kv_cache_layout(cfg, rules: ShardingRules, mesh, max_len: int,
                    cross: bool = False) -> str:
    """How a decoder's attention cache of ``max_len`` lies over "model":
    ``"heads"`` where its ``kv_heads`` take "model" (each rank projects
    and caches its own KV heads: the reference's in-place ``"dus"`` write),
    ``"seq"`` where its ``cache_seq`` does (a rank holds ``1 / tp`` of the
    slots of every KV head, or of MLA's latent ``ckv`` and ``krope``, which
    have no head dimension: the reference's ``"onehot"`` write, which only
    the rank holding the slot makes), ``"whole"`` where neither does (no
    live "model" axis, dimensions that do not divide, or no attention
    cache: RWKV6's).  ``cross``: an encoder-decoder's cross K/V cache in
    place of its self cache (its ``cache_seq`` is the source frames)."""
    if comm.axis_sizes(mesh).get("model", 1) == 1:
        return "whole"
    from repro_torch.models.transformer import cache_specs
    kv = next((s for k, s in flatten(cache_specs(cfg, 1, max_len)).items()
               if k.endswith(("/k", "/ckv"))
               and k.startswith("cross/") == cross), None)
    if kv is None:
        return "whole"
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
        spec = pspec_of(s, self.rules, self.mesh)
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
    its role in ``roles`` says (both flat-keyed, :func:`tp_roles`), and
    gathered in its dtype in ``wire`` (:func:`wire_dtypes`; a key not
    there: its own).  The pass gathers each layer's leaves inside that
    layer's call and the leaves outside the layer stacks once a pass, each
    through ``comm.gather_piece``, whose backward returns this rank's piece
    of the gradient's mean over "data".  ``sink`` (a ``comm.GradSink``:
    the overlapped step): the gradients' syncs run in flight, collected
    after the backward, and a loop's next layer is gathered while the
    layer before it computes (:class:`LayerGathers`)."""

    shardings: dict
    roles: dict
    mesh: object
    wire: dict = field(default_factory=dict)
    sink: object = None

    def gather(self, tree, prefix: str, stacked: int = 0, pending=None):
        """The leaves the pass computes with from ``tree``, pieces of the
        subtree ``prefix`` (of one layer of it where ``stacked`` leading
        layer dimensions were indexed away); ``pending``: its gathers
        already issued (:meth:`start`)."""
        pending = pending or {}
        return unflatten({k: comm.gather_piece(
            v, self.shardings[f"{prefix}/{k}"].layer(stacked), self.mesh,
            self.roles[f"{prefix}/{k}"], self.wire.get(f"{prefix}/{k}"),
            pending.get(k), self.sink) for k, v in flatten(tree).items()})

    def start(self, tree, prefix: str, stacked: int = 0) -> dict:
        """:meth:`gather`'s exchanges issued in flight: {leaf: a
        ``comm.Pending``} of the leaves that gather over a live axis."""
        out = {}
        for k, v in flatten(tree).items():
            key = f"{prefix}/{k}"
            p = comm.start_gather(v, self.shardings[key].layer(stacked),
                                  self.mesh, self.roles[key],
                                  self.wire.get(key))
            if p is not None:
                out[k] = p
        return out


def gathered(tree, prefix: str, pc, stacked: int = 0):
    """``pc.pieces.gather(...)`` (:class:`Pieces`) where the pass was handed
    pieces, else ``tree`` (the leaves the pass computes with already)."""
    plan = getattr(pc, "pieces", None)
    return tree if plan is None else plan.gather(tree, prefix, stacked)


class LayerGathers:
    """The gathers of a loop's layers in one pass: ``entries`` are (the
    layer's pieces, prefix, stacked dimensions, whether its call is
    checkpointed: remat on), the loop
    runs entry ``i`` as ``self.call(i, fn, *args)`` and ``fn`` takes its
    leaves as ``self(i, tree)``.  Without a ``sink`` on the pass's
    :class:`Pieces` that is :func:`gathered`, and ``call`` is ``fn(*args)``.

    With one (the overlapped step) every gather of the loop is issued in
    flight ahead of its use and waited for outside the (checkpointed)
    call, so a recompute makes the very operations of its forward: ``call``
    issues entry i's gather (unless issued) and entry i + 1's, so the next
    layer's exchange runs while layer i computes, and waits for entry i's;
    and, for a checkpointed entry, it hooks the call's
    outputs, so that when the backward reaches them (before it recomputes
    entry i) entry i's gather is issued again and the previous checkpointed
    entry's with it, which runs while entry i recomputes and takes its
    backward, and entry i's is waited for.  A pass so holds at most
    one layer gathered beyond the one that computes, and every rank issues
    the same gathers in the same order: the loop's, then the backward's,
    which autograd walks alike on every rank."""

    def __init__(self, pc, entries: list):
        plan = getattr(pc, "pieces", None)
        self.pc, self.entries = pc, entries
        self.plan = plan if plan is not None and plan.sink is not None \
            else None
        self.pending: dict = {}
        self.hooked: set = set()

    def issue(self, j) -> None:
        """Issue entry ``j``'s gather unless it is in flight (None:
        nothing)."""
        if j is not None and j not in self.pending:
            tree, prefix, stacked, _ = self.entries[j]
            self.pending[j] = self.plan.start(tree, prefix, stacked)

    def wait(self, i: int) -> None:
        """Wait for entry ``i``'s gathers, outside its call: the call then
        makes the same operations in the forward and in a recompute."""
        for p in self.pending[i].values():
            p.wait()

    def previous(self, i: int):
        """The checkpointed entry before entry ``i`` (None: none)."""
        return next((j for j in range(i - 1, -1, -1)
                     if self.entries[j][3]), None)

    def call(self, i: int, fn, *args):
        """``fn(*args)``, entry ``i``'s call in the forward, with its
        gathers issued ahead (see the class docstring)."""
        if self.plan is None:
            return fn(*args)
        self.issue(i)
        self.issue(i + 1 if i + 1 < len(self.entries) else None)
        self.wait(i)
        out = fn(*args)
        if self.entries[i][3] and torch.is_grad_enabled():
            def reached(_):
                if i not in self.hooked:
                    self.hooked.add(i)
                    self.issue(i)
                    self.issue(self.previous(i))
                    self.wait(i)
            for t in _tensors_of(out):
                if t.requires_grad:
                    t.register_hook(reached)
        return out

    def __call__(self, i: int, tree):
        """Entry ``i``'s leaves: its gather in flight waited, else gathered
        now."""
        _, prefix, stacked, _ = self.entries[i]
        if self.plan is None:
            return gathered(tree, prefix, self.pc, stacked)
        return self.plan.gather(tree, prefix, stacked,
                                self.pending.pop(i, None))


def _tensors_of(out) -> list:
    """The tensors of a call's outputs (a tensor, or tuples and dicts of
    them and of other values)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors_of(o)]
    return []


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

    def with_pieces(self, shardings, roles: dict, wire=None,
                    sink=None) -> "PartitionConstraints":
        """These constraints for a pass handed this rank's pieces of the
        params, stored as the Sharding tree ``shardings`` says, computed
        with by ``roles`` (:func:`tp_roles`) and gathered in ``wire``
        (:func:`wire_dtypes`; None: each in its own dtype); ``sink``: the
        overlapped step's ``comm.GradSink`` (see :class:`Pieces`)."""
        out = copy.copy(self)
        out.pieces = Pieces(flatten(shardings), dict(roles), self.mesh,
                            dict(wire or {}), sink)
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
        None where the model computes whole (no live "model" axis).  A
        prefill or decode pass runs without sequence parallelism, its
        cache laid out by :func:`kv_cache_layout` (which needs
        ``max_len``)."""
        if self.model_size == 1:
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
