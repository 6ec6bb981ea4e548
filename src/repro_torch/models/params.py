"""Parameter specification system (port of ``repro.models.params``).

Models declare their parameters as nested dicts of :class:`ParamSpec`
(shape, dtype, logical axis names, initializer).  The layouts are the JAX
package's einsum layouts with the stacked leading layer axis, so weights
carry across frameworks 1:1 (see :mod:`repro_torch.models.bridge`).

Initialization draws normal * ``1/sqrt(fan_in)`` like the reference, from a
``torch.Generator`` on the target device.  Each leaf is seeded from
``seed`` and a CRC of its "/"-joined path, so an init is reproducible across
processes and independent of leaf order.  A stacked leaf (leading axis
``layers`` or ``inner_layers``) is drawn one layer at a time from its
generator, each slice in fp32 and stored at once in the leaf's dtype, so
its fp32 draw never sits whole on the device (mixtral's stacked ``w_gate``
at 16 layers is 30 GB in fp32).  Its random bits differ from JAX's: tests
carry JAX parameters across instead of comparing two inits.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, replace
from typing import Any, Optional

import torch

from repro_torch import resolve_device

# Leaves the model reads in fp32, by last key, so a one-time compute-dtype
# cast leaves them alone: norm parameters (``apply_norm``,
# ``rmsnorm_gated``, MLA's ``q_norm`` / ``kv_norm``), the Mamba2 decay
# parameters (``mamba2_block`` computes dt and A in fp32) and RWKV6's decay
# and bonus (``w0``, ``decay_w2``, ``bonus_u``, read in fp32 by
# ``rwkv6_time_mix``) ...
FP32_LEAVES = ("scale", "bias", "norm_scale", "A_log", "dt_bias", "q_norm",
               "kv_norm", "w0", "decay_w2", "bonus_u")
# ... and every leaf of RWKV6's LayerNorms, by prefix.
FP32_PREFIXES = ("ln_tm_", "ln_cm_", "ln_x_")
# leading axes that ``stack_specs`` adds: such leaves are drawn by slices
STACK_AXES = ("layers", "inner_layers")


@dataclass(frozen=True)
class ParamSpec:
    """Specification of one parameter tensor."""

    shape: tuple
    axes: tuple                     # logical axis name (or None) per dim
    dtype: Any = torch.float32
    init: str = "normal"            # normal | zeros | ones | constant
    scale: Optional[float] = None   # stddev override for "normal"
    value: float = 0.0              # for "constant"
    # the widths of the concatenated parts of the last dimension (Mamba2's
    # in_proj: z, x, B and C, dt); a mesh axis that splits the dimension
    # splits each part (``parallel.sharding.Sharding.cut``); () for a plain
    # dimension
    segments: tuple = ()

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"shape {self.shape} and axes {self.axes} rank mismatch")
        if self.segments and sum(self.segments) != self.shape[-1]:
            raise ValueError(f"segments {self.segments} do not add up to "
                             f"the last dimension of {self.shape}")


def spec(shape, axes, dtype=torch.float32, init="normal", scale=None,
         value=0.0, segments=()) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), dtype, init, scale, value,
                     tuple(segments))


def tree_map(fn, tree):
    """Apply ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flatten(tree, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf} (the checkpoint's key convention)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested dict."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def stack_specs(tree, n: int, axis_name: str = "layers"):
    """Prepend a stacked-layer dimension to every spec in a tree."""
    return tree_map(
        lambda s: replace(s, shape=(n,) + s.shape,
                          axes=(axis_name,) + s.axes), tree)


def _fan_in(shape) -> int:
    if len(shape) == 0:
        return 1
    if len(shape) == 1:
        return shape[0]
    # all dims but the last are fan-in ((in, out...) weight layout)
    return int(math.prod(shape[:-1]))


def fp32_leaves(cfg=None) -> tuple:
    """The last keys a model of ``cfg`` reads in fp32: ``FP32_LEAVES``, and
    the MoE ``router`` when the config routes in fp32 (``router_dtype``)."""
    moe = getattr(cfg, "moe", None)
    if moe is not None and moe.router_dtype == "float32":
        return FP32_LEAVES + ("router",)
    return FP32_LEAVES


def compute_dtype_for(path: str, dtype: torch.dtype,
                      compute_dtype: Optional[torch.dtype],
                      keep: tuple = FP32_LEAVES) -> torch.dtype:
    """Storage dtype of a leaf after the optional one-time compute cast:
    matrices and the embedding take ``compute_dtype``; a leaf whose last
    key is in ``keep`` (:func:`fp32_leaves`) or starts with one of
    ``FP32_PREFIXES`` stays."""
    leaf = path.rsplit("/", 1)[-1]
    if compute_dtype is None or leaf in keep or \
            leaf.startswith(FP32_PREFIXES):
        return dtype
    return compute_dtype


def _init_leaf(s: ParamSpec, path: str, seed: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """One leaf in ``dtype``; a "normal" leaf is drawn in fp32 from its own
    generator, a stacked one slice by slice along the stack axis (the
    fan-in still counts that axis, as JAX's does)."""
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device).to(dtype)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device).to(dtype)
    if s.init == "constant":
        return torch.full(s.shape, s.value, dtype=s.dtype,
                          device=device).to(dtype)
    std = s.scale if s.scale is not None else 1.0 / math.sqrt(
        max(_fan_in(s.shape), 1))
    gen = torch.Generator(device=device)
    gen.manual_seed(zlib.crc32(f"{seed}:{path}".encode()))

    def draw(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(std)

    if len(s.shape) < 2 or s.axes[0] not in STACK_AXES:
        return draw(s.shape).to(dtype)
    out = torch.empty(s.shape, dtype=dtype, device=device)
    for i in range(s.shape[0]):
        out[i] = draw(s.shape[1:])
    return out


def init_params(specs, seed: int = 0, device=None,
                compute_dtype: Optional[torch.dtype] = None,
                keep: tuple = FP32_LEAVES):
    """Initialize concrete parameters on ``device``, one leaf at a time.

    ``compute_dtype`` casts each matrix once as it is made (the leaves
    ``keep`` names stay fp32, see :func:`compute_dtype_for`), so a bf16
    model never holds its fp32 copy whole, nor a stacked leaf's."""
    device = resolve_device(device)
    out = {}
    for path, s in flatten(specs).items():
        out[path] = _init_leaf(
            s, path, seed, device,
            compute_dtype_for(path, s.dtype, compute_dtype, keep))
    return unflatten(out)
