"""Served weights, made by the benchmark on the card from the seed.

One draw a leaf of the port's layout (``reference.params.leaves``: whole
stacks at once), straight in bf16, the type they are served in, from one
``torch.Generator`` on the device: normal with standard deviation
``1 / sqrt(fan in)`` of one layer's matrix (the stacked axes left out;
the embedding ``1 / sqrt(d_model)``, as the output head it is when tied,
so the logits have unit scale at any width; the conv 0.5); norms and
Mamba2's decay parameters as the port's initialiser sets them, in fp32,
where the port reads them.  The program and the reference are handed these
same tensors.
"""

from __future__ import annotations

import math

import torch

from chipbench.reference import params as rparams

# leaves the port reads in fp32, by last key (its ``params.FP32_LEAVES``)
FP32 = ("scale", "bias", "norm_scale", "A_log", "dt_bias")


def make(port: dict, seed: int, device) -> dict:
    """path -> tensor of every parameter."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for path, leaf in rparams.leaves(port).items():
        fp32 = path.rsplit("/", 1)[-1] in FP32
        dtype = torch.float32 if fp32 else torch.bfloat16
        if leaf.init != "normal":
            out[path] = rparams.init_leaf(leaf, path, seed, device).to(dtype)
            continue
        layer = leaf.shape[leaf.stack_dims:]
        std = 1.0 / math.sqrt(leaf.shape[-1]) \
            if path == "embed/embedding" else leaf.scale \
            if leaf.scale is not None else \
            1.0 / math.sqrt(max(math.prod(layer[:-1]), 1))
        out[path] = torch.randn(leaf.shape, generator=gen, dtype=dtype,
                                device=device).mul_(std)
    return out


def nested(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return out
