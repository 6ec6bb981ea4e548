"""The served tokens of finished requests, judged by the fp32 reference.

For each request: the sequence the engine's batch gave it (its prompt
right-aligned behind BOS padding, token 0, to the batch's prompt length,
attended as the port's engine attends it) followed by its served tokens
but the last, through the reference's full forward pass; at each position
that produced a served token, the gap by which that token's logit lies
below the reference's best (over the padded head, as the engine's argmax
runs).  The control reads, at the same positions of the same sequences,
the gap of the token that the fp8 forward puts first.
"""

from __future__ import annotations

import numpy as np
import torch

from chipbench.reference import model, params as rparams


def sequence(prompt, plen: int, served) -> np.ndarray:
    pad = np.zeros(plen - len(prompt), np.int64)
    return np.concatenate([pad, np.asarray(prompt, np.int64),
                           np.asarray(served[:-1], np.int64)])


@torch.no_grad()
def gaps(params: dict, port: dict, served: list, device, *,
         control: bool = False) -> list:
    """Per request (prompt, batch prompt length, served tokens): the
    widest gap of its served tokens (or, with ``control``, of the fp8
    forward's first choices)."""
    exact = model.Products()
    low = model.Products(fp8=True)
    v = rparams.padded_vocab(port)
    out = []
    for prompt, plen, toks in served:
        seq = torch.from_numpy(sequence(prompt, plen, toks)).to(device)
        rows = slice(plen - 1, plen - 1 + len(toks))
        ref = model.logits(params, port, seq[None], exact, vocab=v)[0, rows]
        if control:
            pick = model.logits(params, port, seq[None], low,
                                vocab=v)[0, rows].argmax(-1)
        else:
            pick = torch.as_tensor(np.asarray(toks, np.int64),
                                   device=device)
        gap = ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]
        out.append(float(gap.max()))
        del ref
    return out
