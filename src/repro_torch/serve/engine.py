"""Serving layer: prefill/decode steps + a batched request engine (port of
``repro.serve.engine``).

:class:`ServingEngine` batches requests, right-aligns prompts, runs one
batched prefill and greedy decode against the KV cache, and reports the
same per-batch and per-request metrics and marker regions as the reference.
The hooks are duck-typed: ``usermetric`` has ``.metric(name, fields,
tags=)`` (and optionally ``.markers``); ``markers`` has ``.region(name,
counters=)`` returning a context manager with ``.add(**counters)``, and
``.record(name, seconds, counters=)`` — ``repro.core``'s ``UserMetric`` and
``MarkerSession`` fit, but the port does not import them.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import forward, init_cache


def make_serve_fns(cfg: ModelConfig):
    """Returns (prefill_fn, decode_fn).

    prefill(params, tokens, cache, extras=None) -> (last_logits, cache)
    decode(params, cache, tokens, pos, extras=None) -> (logits, cache)

    ``extras`` are the modality inputs :func:`forward` takes (a VLM's
    ``patches`` and ``mrope_pos``; an encoder-decoder's ``src_frames`` at
    prefill, whose cross K/V decode then reads from the cache).  Only these
    functions take them: :class:`ServingEngine` calls them without, as the
    reference's engine does, so a VLM and an encoder-decoder are served
    through them and not the engine.
    """

    def prefill(params, tokens, cache, extras=None):
        logits, cache = forward(params, cfg, tokens=tokens, mode="prefill",
                                cache=cache, extras=extras)
        return logits[:, -1], cache

    def decode(params, cache, tokens, pos, extras=None):
        logits, cache = forward(params, cfg, tokens=tokens, mode="decode",
                                cache=cache, pos=pos, extras=extras)
        return logits[:, -1], cache

    return prefill, decode


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    submitted_at: float = field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    output: list = field(default_factory=list)


class ServingEngine:
    """Static-batch engine: collect up to ``max_batch`` requests, left-pad
    prompts to a common length, batched prefill, batched greedy decode.

    Padding note: prompts are right-aligned so every row's *last* prompt
    token lands at position plen-1 (where the first sampled logit is read);
    the left padding is BOS (token 0) and is attended — the reference
    engine's documented simplification, kept so the two agree.  Greedy
    argmax runs over the padded vocabulary, as in the reference.  It passes
    no extras, as the reference's engine: an M-RoPE model raises a
    ``KeyError`` for its missing ``mrope_pos``, an encoder-decoder for its
    missing ``src_frames`` (serve them through :func:`make_serve_fns`).
    """

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_len: int = 256, usermetric=None, markers=None,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = resolve_device(device)
        self.um = usermetric
        self.markers = markers if markers is not None else (
            getattr(usermetric, "markers", None)
            if usermetric is not None else None)
        self._queue: list = []
        self._next_rid = 0
        self.prefill, self.decode = make_serve_fns(cfg)

    # -- request api -----------------------------------------------------------

    def submit(self, prompt_tokens, max_new_tokens: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, np.asarray(prompt_tokens, np.int32),
                                   max_new_tokens))
        return rid

    def _metric(self, name, value, **tags):
        if self.um is not None:
            self.um.metric(name, value, tags=tags or None)

    # -- batch step ---------------------------------------------------------------

    @torch.inference_mode()
    def run_batch(self) -> list:
        """Serve one batch from the queue; returns finished Requests."""
        if not self._queue:
            return []
        reqs = self._queue[:self.max_batch]
        self._queue = self._queue[self.max_batch:]
        b = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((b, plen), np.int64)
        for i, r in enumerate(reqs):                 # right-align prompts
            toks[i, plen - len(r.prompt):] = r.prompt

        m = self.markers
        t0 = time.monotonic()
        with (m.region("serve:prefill",
                       counters={"tokens": float(b * plen)})
              if m else nullcontext()):
            cache = init_cache(self.cfg, b, self.max_len, device=self.device)
            last_logits, cache = self.prefill(
                self.params, torch.from_numpy(toks).to(self.device), cache)
            next_tok = torch.argmax(last_logits, dim=-1)
            tk0 = next_tok.cpu().numpy()     # sync: real prefill time
        prefill_s = time.monotonic() - t0
        self._metric("serve_prefill", {"batch": b, "prompt_len": plen,
                                       "prefill_time_s": prefill_s})
        now = time.monotonic()
        for i, r in enumerate(reqs):
            r.first_token_at = now
            r.output.append(int(tk0[i]))

        max_new = max(r.max_new_tokens for r in reqs)
        pos = plen
        t_dec = time.monotonic()
        dec_region = m.region("serve:decode") if m else nullcontext()
        with dec_region:
            for _ in range(max_new - 1):
                logits, cache = self.decode(self.params, cache,
                                            next_tok[:, None], pos)
                next_tok = torch.argmax(logits, dim=-1)
                pos += 1
                tk = next_tok.cpu().numpy()
                for i, r in enumerate(reqs):
                    if len(r.output) < r.max_new_tokens:
                        r.output.append(int(tk[i]))
            n_tok = sum(len(r.output) for r in reqs)
            if m:
                dec_region.add(tokens=float(n_tok - b))
        decode_s = time.monotonic() - t_dec
        self._metric("serve_decode", {
            "batch": b, "new_tokens": n_tok,
            "decode_time_s": decode_s,
            "tokens_per_s": n_tok / max(decode_s, 1e-9)})
        done = []
        now = time.monotonic()
        for r in reqs:
            r.finished_at = now
            self._metric("serve_request", {
                "ttft_s": r.first_token_at - r.submitted_at,
                "latency_s": r.finished_at - r.submitted_at,
                "new_tokens": len(r.output)}, rid=str(r.rid))
            if m:
                # externally timed: a request's latency spans queueing,
                # not a code block on this thread
                m.record("serve:request", r.finished_at - r.submitted_at,
                         counters={"tokens": float(len(r.output))})
            done.append(r)
        return done

    def run_until_empty(self) -> list:
        out = []
        while self._queue:
            out.extend(self.run_batch())
        return out
