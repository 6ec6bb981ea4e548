"""Weights carried across from the JAX package.

:func:`params_from_numpy` takes the JAX parameters as numpy arrays, either
the nested dict or the "/"-joined flat keys of the JAX checkpoint format, and
returns the port's nested dict of tensors.  The layouts match 1:1 (no
transposes).  :func:`load_npz_checkpoint` reads the params of that
checkpoint format (``step_<n>/params.npz`` + ``manifest.json``, read by
:mod:`repro_torch.ckpt.checkpoint`), so a JAX-trained checkpoint serves in
the port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt.checkpoint import read_group
from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import (
    compute_dtype_for, flatten, fp32_leaves, unflatten)
from repro_torch.models.transformer import model_specs


def params_from_numpy(tree_or_flat: dict, cfg: ModelConfig, device=None,
                      compute_dtype: Optional[torch.dtype] = None) -> dict:
    """numpy params (nested or flat "/"-keyed) -> the port's params.

    Every leaf of the model's spec tree must be present with its spec's
    shape.  ``compute_dtype`` casts matrices and the embedding once (the
    same numbers as the reference's cast at each use); the leaves the
    model reads in fp32 (norm scales, Mamba2 ``A_log``/``dt_bias``, RWKV6's
    decay and bonus) stay fp32 (``params.fp32_leaves(cfg)``)."""
    device = resolve_device(device)
    flat = flatten(tree_or_flat) if any(
        isinstance(v, dict) for v in tree_or_flat.values()) else tree_or_flat
    specs = flatten(model_specs(cfg))
    missing = sorted(set(specs) - set(flat))
    extra = sorted(set(flat) - set(specs))
    if missing or extra:
        raise KeyError(f"params do not match {cfg.name}: missing {missing}, "
                       f"unexpected {extra}")
    keep = fp32_leaves(cfg)
    out = {}
    for path, s in specs.items():
        arr = np.asarray(flat[path])
        if tuple(arr.shape) != s.shape:
            raise ValueError(f"{path}: shape {arr.shape}, expected {s.shape}")
        t = torch.from_numpy(np.array(arr)).to(device)   # writable copy
        out[path] = t.to(compute_dtype_for(path, t.dtype, compute_dtype,
                                           keep))
    return unflatten(out)


def load_npz_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """Flat "/"-keyed numpy params of a checkpoint (latest step by
    default)."""
    return read_group(ckpt_dir, "params", step)[1]
