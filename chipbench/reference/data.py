"""The token rows a training run sees, worked out again from the seed.

A frozen copy of the port's ``SyntheticTokenSource`` (``repro_torch.data``):
tokens drawn from a clipped Zipf law with a few document boundaries (token
0), keyed by (seed, step).  Step k's batch holds ``rows`` rows of
``seq_len + 1`` tokens; the model reads the first ``seq_len`` and predicts
the last ``seq_len``.
"""

from __future__ import annotations

import numpy as np


def token_rows(seed: int, step: int, rows: int, seq_len: int, vocab: int,
               zipf_a: float = 1.2) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = rng.zipf(zipf_a, size=(rows, seq_len + 1))
    toks = np.minimum(toks, vocab - 1).astype(np.int32)
    doc = rng.random((rows, seq_len + 1)) < (1.0 / 512)
    return np.where(doc, 0, toks)
