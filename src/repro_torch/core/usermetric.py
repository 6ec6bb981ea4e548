"""libusermetric: application-level metrics and events (copy of
``repro.core.usermetric.UserMetric``).

Buffers points in the line-protocol model and hands them to a sink in
batches; default tags (always ``hostname``) are added to every point.  The
sink is a callable taking a list of :class:`Point` or an object with
``.write(points)``, for the port :class:`repro_torch.core.httpd.HttpSink`.
A failing sink never crashes an implicit flush (from ``metric`` or
``event``): the points are put back at the front of the buffer, which is
bounded, so a dead sink drops the oldest points past the bound.  An
explicit :meth:`UserMetric.flush` re-buffers and raises.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional, Union

from repro_torch.core.line_protocol import Point, now_ns


class UserMetric:
    """Buffered, batched metric/event emitter with default tags."""

    def __init__(self, sink, *, default_tags: Optional[dict] = None,
                 batch_size: int = 64, flush_interval_s: float = 5.0,
                 hostname: Optional[str] = None,
                 auto_flush_thread: bool = False,
                 max_buffered_points: int = 65536):
        self._sink = sink.write if hasattr(sink, "write") else sink
        self.default_tags = dict(default_tags or {})
        self.default_tags.setdefault(
            "hostname", hostname or socket.gethostname())
        self.batch_size = batch_size
        self.flush_interval_s = flush_interval_s
        self.max_buffered_points = int(max_buffered_points)
        self._buf: list = []
        self._lock = threading.Lock()
        self._last_flush = time.monotonic()
        self._sent_points = 0
        self._sent_batches = 0
        self._dropped_points = 0
        self._failed_flushes = 0
        self._join_timeouts = 0
        self._stop = threading.Event()
        self._thread = None
        self._markers = None            # lazy MarkerSession (see .markers)
        if auto_flush_thread:
            self._thread = threading.Thread(target=self._flush_loop,
                                            daemon=True)
            self._thread.start()

    # -- emit -----------------------------------------------------------------

    def metric(self, name: str, value: Union[float, int, dict],
               tags: Optional[dict] = None, ts: Optional[int] = None):
        """Numeric metric; ``value`` may be a dict of field -> value."""
        fields = value if isinstance(value, dict) else {"value": value}
        fields = {k: (float(v) if not isinstance(v, (bool, int, str))
                      else v) for k, v in fields.items()}
        self._push(Point(name, self._tags(tags), fields,
                         ts if ts is not None else now_ns()))

    def event(self, name: str, text: str, tags: Optional[dict] = None,
              ts: Optional[int] = None):
        """String-valued event (start/end markers of a run)."""
        self._push(Point(name, self._tags(tags), {"event": text},
                         ts if ts is not None else now_ns()))

    @property
    def markers(self):
        """Lazy marker session emitting through this UserMetric as the
        ``marker`` measurement (:mod:`repro_torch.core.marker`)."""
        with self._lock:
            mk = self._markers
        if mk is None:
            from repro_torch.core.marker import MarkerSession
            mk = MarkerSession(self)
            with self._lock:
                if self._markers is None:
                    self._markers = mk
                mk = self._markers
        return mk

    # -- buffering ------------------------------------------------------------

    def _tags(self, tags):
        out = dict(self.default_tags)
        if tags:
            out.update(tags)
        return out

    def _push(self, p: Point):
        flush_now = False
        with self._lock:
            self._buf.append(p)
            if len(self._buf) >= self.batch_size or \
                    time.monotonic() - self._last_flush \
                    >= self.flush_interval_s:
                flush_now = True
        if flush_now:
            self._flush(raise_errors=False)

    def flush(self):
        """Explicit flush: pending marker deltas are drained into the buffer
        first; sink failures re-buffer AND raise."""
        with self._lock:
            mk = self._markers
        if mk is not None:
            mk.flush()
        self._flush(raise_errors=True)

    def _flush(self, raise_errors: bool):
        with self._lock:
            buf, self._buf = self._buf, []
            self._last_flush = time.monotonic()
        if not buf:
            return
        try:
            self._sink(buf)
        except Exception:
            with self._lock:
                self._failed_flushes += 1
                self._buf[:0] = buf
                excess = len(self._buf) - self.max_buffered_points
                if excess > 0:
                    del self._buf[:excess]
                    self._dropped_points += excess
            if raise_errors:
                raise
            return
        with self._lock:
            self._sent_points += len(buf)
            self._sent_batches += 1

    def _flush_loop(self):
        while not self._stop.wait(self.flush_interval_s):
            self._flush(raise_errors=False)     # retry next interval

    def close(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2 * self.flush_interval_s)
            if self._thread.is_alive():
                with self._lock:
                    self._join_timeouts += 1
        self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"sent_points": self._sent_points,
                    "sent_batches": self._sent_batches,
                    "dropped_points": self._dropped_points,
                    "failed_flushes": self._failed_flushes,
                    "join_timeouts": self._join_timeouts,
                    "buffered": len(self._buf)}
