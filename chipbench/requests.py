"""The one generator of serving traffic, driven by a mix's parameters.

A mix file (``traffic/<name>.json``, ``"kind": "serve"``) gives the prompt
lengths (lognormal: ``prompt_median``, ``prompt_sigma``, clipped to
``prompt_min`` .. ``prompt_max``), the new tokens (uniform over
``new_min`` .. ``new_max``), the kind of arrivals (``arrivals``: the
module ``arrivals/<kind>.py``, with its ``count`` of requests in a run and
the ``gaps`` between them, from the mix's own parameters such as
``rate``) and ``shape_seed``.

The sizes, their order and the gaps between arrivals are drawn from
``shape_seed`` alone, so every seed of a run serves the same requests at
the same times; the run's seed draws the prompts' tokens (and the weights).
The order is not the seed's to shuffle: under static batching it decides
which prompts share a batch, so their padding, and so the work and the
queue (two orders of the same sizes read TTFT tails 20% apart).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from chipbench import common


@dataclass
class Planned:
    index: int
    due_s: float                # after the start of the window
    prompt: np.ndarray          # int32 token ids
    new_tokens: int
    rid: int = -1               # the engine's id, once submitted


def plan(mix: dict, seed: int, seconds: float, vocab: int) -> list:
    arrivals = common.arrivals(mix)
    n = arrivals.count(mix, seconds)
    base = np.random.default_rng(mix["shape_seed"])
    lens = np.exp(np.log(mix["prompt_median"])
                  + mix["prompt_sigma"] * base.standard_normal(n))
    lens = np.clip(np.rint(lens), mix["prompt_min"],
                   mix["prompt_max"]).astype(int)
    news = base.integers(mix["new_min"], mix["new_max"] + 1, n)
    gaps = arrivals.gaps(mix, n, base)
    rng = np.random.default_rng(seed)
    due = np.cumsum(gaps)
    return [Planned(i, float(due[i]),
                    rng.integers(1, vocab, size=int(lens[i]),
                                 dtype=np.int32),
                    int(news[i]))
            for i in range(n)]
