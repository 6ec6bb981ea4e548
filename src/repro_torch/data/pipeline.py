"""Token data pipeline (port of ``repro.data.pipeline``; numpy only).

A copy of the reference's classes, so the port imports nothing of the JAX
package; given the same seed and step they give byte-identical batches.

* :class:`SyntheticTokenSource` — deterministic Zipf-ish token stream keyed
  by (seed, step); reproducible across restarts, so checkpoint-resume
  replays the exact same batches.
* :class:`MemmapTokenSource` — windows of a flat binary token file
  (uint16 / uint32), keyed by (seed, step) the same way.
* :func:`make_batch_fn` — step -> host-local {"tokens", "labels"} batch.
* :class:`DataLoader` — per-host row sharding + background prefetch thread;
  the measured queue wait is exported as the ``data_wait_s`` raw event.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np


class SyntheticTokenSource:
    """Deterministic pseudo-corpus: tokens ~ clipped Zipf, documents of
    varying length separated by token 0 (acts as BOS)."""

    def __init__(self, vocab_size: int, seed: int = 0, zipf_a: float = 1.2):
        self.vocab_size = vocab_size
        self.seed = seed
        self.zipf_a = zipf_a

    def batch(self, step: int, batch_size: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        toks = rng.zipf(self.zipf_a, size=(batch_size, seq_len + 1))
        toks = np.minimum(toks, self.vocab_size - 1).astype(np.int32)
        # sprinkle document boundaries
        doc = rng.random((batch_size, seq_len + 1)) < (1.0 / 512)
        toks = np.where(doc, 0, toks)
        return toks


class MemmapTokenSource:
    """Windows from a flat binary token file: each row seq_len + 1 tokens
    from a start drawn from (seed, step), widened to int32."""

    def __init__(self, path: str, dtype=np.uint16, seed: int = 0):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.seed = seed

    def batch(self, step: int, batch_size: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        n = len(self.tokens) - (seq_len + 1)
        starts = rng.integers(0, max(n, 1), size=batch_size)
        return np.stack([
            np.asarray(self.tokens[s:s + seq_len + 1], dtype=np.int32)
            for s in starts])


def make_batch_fn(source, cfg, shape, extras_fn: Optional[Callable] = None):
    """step -> host-local batch dict {"tokens", "labels", extras...}."""
    def fn(step: int, host_rows: slice) -> dict:
        toks = source.batch(step, shape.global_batch, shape.seq_len)
        toks = toks[host_rows]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if extras_fn is not None:
            batch.update(extras_fn(step, toks.shape[0]))
        return batch
    return fn


class DataLoader:
    """Background-prefetching, host-sharded loader.

    host_index/host_count shard the *rows* of the global batch: each process
    constructs only its slice.
    """

    def __init__(self, batch_fn: Callable, *, host_index: int = 0,
                 host_count: int = 1, global_batch: int = 0,
                 prefetch: int = 2, start_step: int = 0):
        assert global_batch % max(host_count, 1) == 0, \
            "global batch must divide host count"
        rows = global_batch // host_count
        self._slice = slice(host_index * rows, (host_index + 1) * rows)
        self._batch_fn = batch_fn
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = start_step
        self.wait_time_s = 0.0          # exported as data_wait_s
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._batch_fn(step, self._slice)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        t0 = time.monotonic()
        step, batch = self._q.get()
        self.wait_time_s = time.monotonic() - t0
        return step, batch

    def __iter__(self) -> Iterator:
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
