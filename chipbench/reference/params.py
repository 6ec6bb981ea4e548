"""The parameters a run starts from, worked out again from the seed.

A frozen copy of the port's layout and initialiser
(``repro_torch.models.params.init_params`` over ``transformer.model_specs``).
A family's module (``families/<family>.py``) lists its leaves from the
pieces here; each leaf has its path, shape and init kind; a "normal" leaf is drawn in fp32 from a ``torch.Generator``
on the device, seeded with the CRC-32 of ``"<seed>:<path>"``, with standard
deviation ``scale`` or ``1 / sqrt(fan in)`` where the fan in is the product
of every dimension but the last, the stacked layer axes included (as the
port and the JAX package count it); a stacked leaf is drawn one slice of
its leading axis at a time.  On the same device the draws are the port's
bit for bit.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass

import torch

from chipbench import common


@dataclass(frozen=True)
class Leaf:
    shape: tuple
    stack_dims: int = 0             # leading axes that stack layers
    init: str = "normal"            # normal | zeros | ones | constant
    scale: float | None = None
    value: float = 0.0

    @property
    def stacked(self) -> bool:
        return self.stack_dims > 0


def padded_vocab(port: dict) -> int:
    v, to = port["vocab_size"], port["vocab_pad_to"]
    return (v + to - 1) // to * to


def embedding(port: dict) -> dict:
    """The input table, the final norm and an untied output head."""
    d = port["d_model"]
    out = {"embed/embedding": Leaf((padded_vocab(port), d), scale=0.02),
           "final_norm/scale": Leaf((d,), init="ones")}
    if not port["tie_embeddings"]:
        out["embed/lm_head"] = Leaf((d, padded_vocab(port)))
    return out


def attn_block(port: dict) -> dict:
    """One pre-norm block of GQA attention and a SwiGLU MLP."""
    d, h = port["d_model"], port["num_heads"]
    kv, hd, ff = port["num_kv_heads"], port["head_dim"], port["d_ff"]
    return {"ln1/scale": Leaf((d,), init="ones"),
            "attn/wq": Leaf((d, h, hd)), "attn/wk": Leaf((d, kv, hd)),
            "attn/wv": Leaf((d, kv, hd)), "attn/wo": Leaf((h, hd, d)),
            "ln2/scale": Leaf((d,), init="ones"),
            "mlp/w_gate": Leaf((d, ff)), "mlp/w_up": Leaf((d, ff)),
            "mlp/w_down": Leaf((ff, d))}


def stack(block: dict, prefix: str, *counts: int) -> dict:
    """A block's leaves stacked over ``counts`` layers, under ``prefix``."""
    return {f"{prefix}/{k}": Leaf(tuple(counts) + leaf.shape, len(counts),
                                  leaf.init, leaf.scale, leaf.value)
            for k, leaf in block.items()}


def leaves(port: dict) -> dict:
    """path -> :class:`Leaf` of every parameter of the configuration."""
    return common.family(port).leaves(port)


def _fan_in(shape) -> int:
    if len(shape) == 0:
        return 1
    if len(shape) == 1:
        return shape[0]
    return int(math.prod(shape[:-1]))


def init_leaf(leaf: Leaf, path: str, seed: int,
              device: torch.device) -> torch.Tensor:
    """One leaf in fp32 on ``device``."""
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, device=device)
    if leaf.init == "constant":
        return torch.full(leaf.shape, leaf.value, device=device)
    std = leaf.scale if leaf.scale is not None else \
        1.0 / math.sqrt(max(_fan_in(leaf.shape), 1))
    gen = torch.Generator(device=device)
    gen.manual_seed(zlib.crc32(f"{seed}:{path}".encode()))

    def draw(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(std)

    if len(leaf.shape) < 2 or not leaf.stacked:
        return draw(leaf.shape)
    out = torch.empty(leaf.shape, device=device)
    for i in range(leaf.shape[0]):
        out[i] = draw(leaf.shape[1:])
    return out


def init_params(port: dict, seed: int, device) -> dict:
    """path -> fp32 tensor of every parameter."""
    device = torch.device(device)
    return {path: init_leaf(leaf, path, seed, device)
            for path, leaf in leaves(port).items()}
