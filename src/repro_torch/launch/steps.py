"""Step bundles and abstract input specs (port of ``repro.launch.steps``).

Everything here is spec-level: no allocation.  Input specs carry *logical
axes* (the same ParamSpec mechanism as the model's weights), so one rule
table gives every rank's piece of every input.  A :class:`StepBundle` is
a cell's step function with the specs and shardings of its arguments;
:func:`trace_bundle` stands in for the reference's ``lower_bundle`` plus
``compile``: it runs the step once on meta tensors of this rank's pieces
under :func:`~repro_torch.launch.cost_analysis.analyze_step` and returns
its counts.

What a mesh can do here is what the port's steps can do:

* the train bundle uses :func:`~repro_torch.train.step.make_train_step`
  with the mesh and the train config's ``seq_parallel``: data parallelism
  with sharded storage, each layer's params gathered inside its call,
  tensor-parallel compute under "model" for the dense and GQA-MoE
  families (the other families' "model" ranks gather whole layers and
  compute the same loss);
* the prefill and decode bundles use
  :func:`~repro_torch.serve.engine.make_serve_fns` with the mesh
  (``SERVE_RULES``, the cell's global batch and cache length): each rank
  takes its pieces of the params (gathered for compute by role one layer
  at a time inside the call), its rows of the batch where they divide over ("pod", "data")
  (all of them where they do not: ``long_500k``'s one row) and its piece
  of the cache, laid out as ``sharding.cache_shardings`` binds it.  A
  decode bundle records the reference's ``cache_update`` choice
  (:func:`reference_cache_update`: ``"dus"`` where the KV heads take
  "model", ``"onehot"`` where the cache's slots do) beside the port's
  layout (``sharding.kv_cache_layout``); both bundles record the layout
  and whether the rows split (``StepBundle.serve``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch import cost_analysis
from repro_torch.models.params import (
    ParamSpec, compute_dtype_for, flatten, fp32_leaves, spec, unflatten)
from repro_torch.models.transformer import cache_specs, model_specs
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (
    PartitionConstraints, ShardingRules, cache_shardings, kv_cache_layout,
    rules_for, shardings_for_specs)
from repro_torch.serve.engine import make_serve_fns
from repro_torch.train.optim import opt_state_specs
from repro_torch.train.step import make_train_step


# --------------------------------------------------------------------------
# Param / cache spec variants
# --------------------------------------------------------------------------


def serve_param_specs(cfg: ModelConfig, keep: tuple = ()):
    """Serving weights in bf16 (fp32 master copies are a training
    concern).  ``keep``: the last keys left in their dtype; the
    reference's specs keep none, the port's served model keeps the leaves
    it reads in fp32 (``models.params.fp32_leaves``: the norm scales its
    RMSNorm kernel takes in fp32, the decays), as the bundles use."""
    flat = flatten(model_specs(cfg))
    out = {}
    for path, s in flat.items():
        dt = s.dtype
        if s.dtype.is_floating_point:
            dt = compute_dtype_for(path, s.dtype, torch.bfloat16, keep) \
                if keep else torch.bfloat16
        out[path] = dataclasses.replace(s, dtype=dt)
    return unflatten(out)


# --------------------------------------------------------------------------
# Input specs (ParamSpec trees with logical axes)
# --------------------------------------------------------------------------


def _extras_specs(cfg: ModelConfig, shape: ShapeConfig, *, decode: bool):
    out = {}
    if cfg.family == "vlm":
        if not decode:
            p = min(cfg.vlm_num_patches, max(shape.seq_len - 2, 1))
            out["patches"] = spec((shape.global_batch, p, cfg.d_model),
                                  ("batch", None, None), torch.bfloat16)
        out["mrope_pos"] = spec(
            (shape.global_batch, 1 if decode else shape.seq_len, 3),
            ("batch", None, None), torch.int32)
    if cfg.family == "encdec" and not decode:
        out["src_frames"] = spec(
            (shape.global_batch, cfg.encdec_source_len, cfg.d_model),
            ("batch", None, None), torch.bfloat16)
    return out


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": spec((b, s), ("batch", "seq"), torch.int32),
            "labels": spec((b, s), ("batch", "seq"), torch.int32),
            **_extras_specs(cfg, shape, decode=False)}


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": spec((b, s), ("batch", "seq"), torch.int32),
            **_extras_specs(cfg, shape, decode=False)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = shape.global_batch
    return {"tokens": spec((b, 1), ("batch", None), torch.int32),
            **_extras_specs(cfg, shape, decode=True)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Stand-ins for every model input of the (arch x shape) cell, keyed
    by step-function argument."""
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)


# --------------------------------------------------------------------------
# Bundles
# --------------------------------------------------------------------------


@dataclasses.dataclass
class StepBundle:
    """A cell's step: ``fn(*args)`` with ``abstract_args`` the argument
    spec trees (global shapes; an int stands for a host scalar) and
    ``in_shardings`` their Sharding trees on ``mesh`` (None: whole).
    ``status`` is ``"unported"`` (with ``reason``) for a cell the port's
    step cannot run; ``fn`` is then None.  ``serve``: a prefill or decode
    bundle's layout (``cache_layout``, ``rows``, ``tp_compute`` and, for
    decode, the reference's ``cache_update``)."""

    fn: object
    abstract_args: tuple
    in_shardings: tuple
    donate_argnums: tuple = ()
    name: str = ""
    kind: str = ""
    mesh: object = None
    status: str = "ok"
    reason: str = ""
    train_cfg: Optional[TrainConfig] = None
    remake: object = None           # train: microbatches -> StepBundle
    serve: Optional[dict] = None


def make_pc(rules: ShardingRules, mesh, seq_parallel: bool = False,
            batch: Optional[int] = None,
            max_len: Optional[int] = None) -> Optional[PartitionConstraints]:
    """The partition constraints a step is built with (None without a
    mesh; ``batch``, ``max_len``: a serving cell's global rows and cache
    length).  The reference's ``enable`` switch of its activation
    constraints has no counterpart: a rank's tensors are plain local
    ones."""
    if mesh is None:
        return None
    return PartitionConstraints(rules, mesh, seq_parallel=seq_parallel,
                                batch=batch, max_len=max_len)


def reference_cache_update(cfg: ModelConfig, mesh) -> str:
    """The reference decode bundle's cache write: ``"dus"`` (in place)
    where the KV heads take "model" (or there is none), ``"onehot"`` where
    they do not divide and the cache's slots carry it; MLA's latent cache
    counts as not split by heads (``repro.launch.steps``)."""
    tp = comm.axis_sizes(mesh).get("model", 1)
    kv_sharded = (cfg.attention_type != "mla"
                  and cfg.num_kv_heads % tp == 0 and cfg.num_kv_heads >= tp)
    return "dus" if kv_sharded or tp == 1 else "onehot"


def _moe_localized(cfg: ModelConfig, mesh) -> ModelConfig:
    """Locality-aware MoE dispatch, as the reference sets it: one dispatch
    group per data-parallel shard, and the all-to-all dispatch where the
    expert count divides the "model" axis on a single-pod mesh (a
    DeviceMesh or a ``{axis: size}`` dict)."""
    if cfg.moe is None:
        return cfg
    sizes = comm.axis_sizes(mesh)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    tp = sizes.get("model", 1)
    impl = "a2a" if ("pod" not in sizes
                     and cfg.moe.num_experts % tp == 0) else "grouped"
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=dp,
                                     impl=impl))


def _shard(spec_tree, rules, mesh):
    return None if mesh is None else shardings_for_specs(spec_tree, rules,
                                                         mesh)


def build_train_bundle(cfg: ModelConfig, shape: ShapeConfig,
                       train_cfg: TrainConfig, mesh,
                       rules: Optional[ShardingRules] = None,
                       overlap: bool = False) -> StepBundle:
    """``overlap``: the step with its exchanges overlapped
    (``make_train_step(..., overlap=)``), whose trace holds the layer
    gathered ahead."""
    rules = rules or rules_for("train")
    lcfg = _moe_localized(cfg, mesh) if mesh is not None else cfg
    pc = make_pc(rules, mesh, seq_parallel=train_cfg.seq_parallel)
    pspecs = model_specs(lcfg)
    ospecs = opt_state_specs(pspecs, train_cfg)
    ispecs = train_input_specs(lcfg, shape)
    step_fn, _ = make_train_step(lcfg, train_cfg, pc=pc, mesh=mesh,
                                 overlap=overlap)

    def remake(nm: int) -> StepBundle:
        return build_train_bundle(
            cfg, shape, dataclasses.replace(train_cfg, num_microbatches=nm),
            mesh, rules, overlap)
    return StepBundle(
        fn=step_fn, abstract_args=(pspecs, ospecs, ispecs, 0),
        in_shardings=(_shard(pspecs, rules, mesh),
                      _shard(ospecs, rules, mesh),
                      _shard(ispecs, rules, mesh), None),
        donate_argnums=(0, 1), name=f"train:{cfg.name}:{shape.name}",
        kind="train", mesh=mesh, train_cfg=train_cfg, remake=remake)


def _serve_bundle(kind: str, cfg: ModelConfig, shape: ShapeConfig, mesh,
                  rules: Optional[ShardingRules]) -> StepBundle:
    """A prefill or decode bundle: ``make_serve_fns(cfg, pc=)`` on the
    cell's mesh (the MoE localised as the train bundle's), bf16 serving
    weights and a cache of ``shape.seq_len`` (decode writes its new token
    in the last slot)."""
    rules = rules or rules_for("serve")
    lcfg = _moe_localized(cfg, mesh) if mesh is not None else cfg
    b, s = shape.global_batch, shape.seq_len
    pc = make_pc(rules, mesh, batch=b, max_len=s)
    pspecs = serve_param_specs(lcfg, fp32_leaves(lcfg))
    cspecs = cache_specs(lcfg, b, s)
    ispecs = (prefill_input_specs if kind == "prefill"
              else decode_input_specs)(lcfg, shape)
    extras = {k: v for k, v in ispecs.items() if k != "tokens"}
    prefill, decode = make_serve_fns(lcfg, pc=pc)
    serve = None
    if mesh is not None:
        sharded = pc.model_size > 1
        serve = {"cache_layout": kv_cache_layout(lcfg, rules, mesh, s),
                 "rows": "split" if pc.rows_split else "replicated",
                 "rows_per_rank": pc.local_rows,
                 "tp_compute": "sharded" if sharded else "whole"}
        if kind == "decode":
            serve["cache_update"] = reference_cache_update(lcfg, mesh)
    csh = None if mesh is None else cache_shardings(lcfg, rules, mesh, b, s)
    if kind == "prefill":
        def fn(params, tokens, cache, extras):
            with torch.no_grad():
                return prefill(params, tokens, cache, extras)
        args = (pspecs, ispecs["tokens"], cspecs, extras)
        shards = (_shard(pspecs, rules, mesh),
                  _shard(ispecs["tokens"], rules, mesh), csh,
                  _shard(extras, rules, mesh))
        donate = (2,)
    else:
        def fn(params, cache, tokens, pos, extras):
            with torch.no_grad():
                return decode(params, cache, tokens, pos, extras)
        args = (pspecs, cspecs, ispecs["tokens"], s - 1, extras)
        shards = (_shard(pspecs, rules, mesh), csh,
                  _shard(ispecs["tokens"], rules, mesh), None,
                  _shard(extras, rules, mesh))
        donate = (1,)
    return StepBundle(fn=fn, abstract_args=args, in_shardings=shards,
                      donate_argnums=donate, name=f"{kind}:{cfg.name}:"
                      f"{shape.name}", kind=kind, mesh=mesh, serve=serve)


def build_prefill_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh,
                         rules: Optional[ShardingRules] = None) -> StepBundle:
    return _serve_bundle("prefill", cfg, shape, mesh, rules)


def build_decode_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh,
                        rules: Optional[ShardingRules] = None) -> StepBundle:
    return _serve_bundle("decode", cfg, shape, mesh, rules)


def build_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 train_cfg: Optional[TrainConfig] = None,
                 rules: Optional[ShardingRules] = None,
                 overlap: bool = False) -> StepBundle:
    """The cell's bundle on ``mesh`` (a DeviceMesh, or None for one
    device); ``overlap``: a train step's exchanges overlapped."""
    if shape.kind == "train":
        return build_train_bundle(cfg, shape, train_cfg or TrainConfig(),
                                  mesh, rules, overlap)
    if shape.kind == "prefill":
        return build_prefill_bundle(cfg, shape, mesh, rules)
    return build_decode_bundle(cfg, shape, mesh, rules)


# --------------------------------------------------------------------------
# Tracing
# --------------------------------------------------------------------------


def _meta_leaf(s: ParamSpec, sh) -> torch.Tensor:
    """This rank's piece of a spec: meta, integer inputs as int64 (as
    ``train.step.batch_to_device`` makes the batch); a 0-d leaf (the
    optimizer's step count, which the update reads on the host) a zero on
    the CPU."""
    if not s.shape:
        return torch.zeros((), dtype=s.dtype)
    shape = sh.local_shape() if sh is not None else s.shape
    dtype = s.dtype if s.dtype.is_floating_point or \
        s.dtype == torch.bool else torch.int64
    return torch.empty(shape, dtype=dtype, device="meta")


def rank_args(bundle: StepBundle) -> tuple:
    """Meta tensors of this rank's pieces of the bundle's arguments."""
    out = []
    for specs, shs in zip(bundle.abstract_args, bundle.in_shardings):
        if isinstance(specs, ParamSpec):
            out.append(_meta_leaf(specs, shs))
        elif isinstance(specs, dict):
            out.append(_meta_tree(specs, shs))
        else:
            out.append(specs)
    return tuple(out)


def _meta_tree(specs, shs):
    if isinstance(specs, dict):
        return {k: _meta_tree(v, None if shs is None else shs[k])
                for k, v in specs.items()}
    return _meta_leaf(specs, shs)


def trace_bundle(bundle: StepBundle, *, extrapolate_above: int = 3) -> dict:
    """The bundle's step traced on this rank's meta pieces
    (:func:`~repro_torch.launch.cost_analysis.analyze_step`): the
    reference's ``analyze_hlo`` schema plus the memory block.

    A train step of more than ``extrapolate_above`` microbatches is traced
    at 2 and 3 microbatches of the same rows each and taken to its count by
    :func:`~repro_torch.launch.cost_analysis.extrapolate` (its body runs
    once a microbatch, as a scan's runs once a trip).  A prefill or decode
    record's memory block adds ``params_bytes`` and ``cache_bytes``, this
    rank's pieces of each."""
    if bundle.status != "ok":
        raise ValueError(f"{bundle.name}: {bundle.status} ({bundle.reason})")
    n = math.prod(comm.axis_sizes(bundle.mesh).values())
    if bundle.kind == "train":
        nm = bundle.train_cfg.num_microbatches
        if nm > extrapolate_above:
            at = [_trace_train(bundle.remake(k), k, nm, n) for k in (2, 3)]
            return cost_analysis.extrapolate(at[0], at[1], nm,
                                             rank_args(bundle))
    args = rank_args(bundle)
    out = cost_analysis.analyze_step(bundle.fn, args, num_partitions=n)
    if bundle.kind != "train":
        # a rank's pieces of the params and of the cache, apart
        cache = args[2] if bundle.kind == "prefill" else args[1]
        out["memory"]["params_bytes"] = cost_analysis.argument_bytes(
            args[0])
        out["memory"]["cache_bytes"] = cost_analysis.argument_bytes(cache)
    return out


def _trace_train(bundle: StepBundle, k: int, nm: int, n: int) -> dict:
    """The train bundle at ``k`` microbatches on ``k / nm`` of its rows."""
    params, opt_state, batch, step = rank_args(bundle)
    rows = next(iter(batch.values())).shape[0]
    cut = {key: v[:rows // nm * k] for key, v in batch.items()}
    return cost_analysis.analyze_step(bundle.fn,
                                      (params, opt_state, cut, step),
                                      num_partitions=n)
