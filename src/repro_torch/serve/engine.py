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

:func:`make_serve_fns` also serves on a mesh (``pc``): each rank passes
its pieces of the params, rows and cache (:func:`serve_shardings`,
:func:`init_cache_piece`, ``train.step.rows_for``) and gets its logits
columns back (:func:`gather_logits`); the pass gathers each layer's
params inside the layer's call, so one layer's are live at a time.  The
engine stays mesh-free, as the reference's is.
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
from repro_torch.models.params import flatten, unflatten
from repro_torch.models.transformer import (
    cache_specs, forward, init_cache, model_specs)
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (
    cache_shardings, shardings_for_specs, tp_roles, wire_dtypes)


def make_serve_fns(cfg: ModelConfig, *, pc=None):
    """Returns (prefill_fn, decode_fn).

    prefill(params, tokens, cache, extras=None) -> (last_logits, cache)
    decode(params, cache, tokens, pos, extras=None) -> (logits, cache)

    ``extras`` are the modality inputs :func:`forward` takes (a VLM's
    ``patches`` and ``mrope_pos``; an encoder-decoder's ``src_frames`` at
    prefill, whose cross K/V decode then reads from the cache).  Only these
    functions take them: :class:`ServingEngine` calls them without, as the
    reference's engine does, so a VLM and an encoder-decoder are served
    through them and not the engine.

    ``pc`` (a :class:`~repro_torch.parallel.sharding.PartitionConstraints`
    with the pass's global ``batch`` and cache length ``max_len``) on a
    mesh with an axis above 1: each rank passes its pieces, as
    :func:`serve_shardings` cuts them: the params stored under
    ``pc.rules`` (``SERVE_RULES``), its rows of the batch and its extras
    (``train.step.rows_for``) and its piece of the cache, which it
    allocates alone.  Each call runs under ``no_grad`` on the pieces
    (``pc.with_pieces``): each layer's params are gathered for compute by
    role inside the layer's loop step and freed after it (a ``"split"``
    leaf over every axis but "model": ``sharding.tp_roles``; each in its
    ``sharding.wire_dtypes`` dtype), the
    embedding and final norm once a call; it returns this rank's
    last-position logits (its columns of the vocabulary where that splits:
    :func:`gather_logits`) and its cache piece, written in place.  A
    piece whose shape is not its binding's raises ``ValueError``.
    """
    if pc is None or not comm.live_axes(pc.mesh, tuple(comm.axis_sizes(
            pc.mesh))):
        def prefill(params, tokens, cache, extras=None):
            logits, cache = forward(params, cfg, tokens=tokens,
                                    mode="prefill", cache=cache,
                                    extras=extras, pc=pc)
            return _last(logits), cache

        def decode(params, cache, tokens, pos, extras=None):
            logits, cache = forward(params, cfg, tokens=tokens,
                                    mode="decode", cache=cache, pos=pos,
                                    extras=extras, pc=pc)
            return logits[:, -1], cache

        return prefill, decode

    if pc.batch is None or pc.max_len is None:
        raise ValueError("serving on a mesh needs pc.batch and pc.max_len, "
                         "the pass's global rows and cache length")
    psh, csh = serve_shardings(cfg, pc)
    lpc = pc.with_pieces(psh, tp_roles(cfg, pc.rules, pc.mesh),
                         wire_dtypes(cfg))

    def check(params, cache, tokens):
        _check_pieces("params", params, psh)
        _check_pieces("cache", cache, csh)
        if tokens.shape[0] != pc.local_rows:
            raise ValueError(f"tokens: {tokens.shape[0]} rows, this rank's "
                             f"piece of {pc.batch} has {pc.local_rows}")

    def prefill(params, tokens, cache, extras=None):
        check(params, cache, tokens)
        with torch.no_grad():
            logits, cache = forward(params, cfg, tokens=tokens,
                                    mode="prefill", cache=cache,
                                    extras=extras, pc=lpc)
        return _last(logits), cache

    def decode(params, cache, tokens, pos, extras=None):
        check(params, cache, tokens)
        with torch.no_grad():
            logits, cache = forward(params, cfg, tokens=tokens,
                                    mode="decode", cache=cache, pos=pos,
                                    extras=extras, pc=lpc)
        return logits[:, -1], cache

    return prefill, decode


def _last(logits):
    """The last position's logits (B, V) in storage of their own: a view
    of the prompt's (B, S, V) logits would keep all of them alive while
    decode runs."""
    return logits[:, -1].clone()


def serve_shardings(cfg: ModelConfig, pc) -> tuple:
    """(params, cache) Sharding trees of a serving pass on ``pc``'s mesh:
    the params as ``pc.rules`` store them, the cache of ``pc.batch`` rows
    and ``pc.max_len`` slots as ``sharding.cache_shardings`` lays it out
    (``.local_shape()`` is what a rank allocates, ``.cut(whole, coord)``
    its piece of the global leaf)."""
    return (shardings_for_specs(model_specs(cfg), pc.rules, pc.mesh),
            cache_shardings(cfg, pc.rules, pc.mesh, pc.batch, pc.max_len))


def init_cache_piece(cfg: ModelConfig, pc, dtype=torch.bfloat16,
                     device=None):
    """This rank's zero piece of the serving cache of ``pc.batch`` rows and
    ``pc.max_len`` slots: each leaf at its binding's local shape
    (:func:`serve_shardings`), in :func:`init_cache`'s dtypes."""
    specs = flatten(cache_specs(cfg, pc.batch, pc.max_len, dtype))
    shards = flatten(serve_shardings(cfg, pc)[1])
    device = resolve_device(device)
    return unflatten({k: torch.zeros(shards[k].local_shape(), dtype=s.dtype,
                                     device=device)
                      for k, s in specs.items()})


def _check_pieces(what: str, tree, shardings) -> None:
    want = flatten(shardings)
    got = flatten(tree)
    if set(got) != set(want):
        raise ValueError(f"{what}: leaves {sorted(set(got) ^ set(want))} "
                         f"differ from the binding's")
    for k, t in got.items():
        if tuple(t.shape) != want[k].local_shape():
            raise ValueError(f"{what} piece {k}: shape {tuple(t.shape)}, "
                             f"its binding's {want[k].local_shape()}")


def gather_logits(cfg: ModelConfig, logits, pc=None):
    """(B, vocab_padded) logits from a rank's (B, vocab_padded / tp)
    columns (what the serving functions return where the vocabulary
    splits over "model"), gathered over "model"; ``logits`` themselves
    where they are whole."""
    if pc is None or logits.shape[-1] == cfg.vocab_padded:
        return logits
    return comm.all_gather(logits.contiguous(), pc.mesh, "model",
                           logits.ndim - 1)


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
