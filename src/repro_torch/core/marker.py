"""Marker regions on the job side (copy of the emit side of
``repro.core.marker``).

:class:`MarkerSession` is the LMS analogue of the LIKWID marker API: per
process, with thread-local region stacks, it accumulates per region the
call count, inclusive and exclusive seconds and user-supplied work counters
(flops, bytes, tokens, ...).  Deltas since the last flush leave through a
``UserMetric``-shaped emitter as the ``marker`` measurement (tag
``region``; fields ``time_s``, ``excl_time_s``, ``calls`` and the
counters), so a stack that sums them per window gets exact totals.

:func:`calibrate` stores the machine's peaks as a ``marker`` point of the
reserved region :data:`CALIB_REGION` (fields ``peak_flops``, ``peak_bw``),
which is where the stack's roofline queries read the peaks of a job's
device.  Re-registering the stack's ROOFLINE group, building roofline
queries and rules are the stack's side and are not copied.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from repro_torch.core.line_protocol import now_ns

__all__ = ["CALIB_REGION", "MARKER_MEASUREMENT", "MarkerSession", "Region",
           "calibrate"]

MARKER_MEASUREMENT = "marker"
# reserved region name carrying machine-peak calibration points
CALIB_REGION = "_calib"


class _Frame:
    """One open region on one thread's stack."""

    __slots__ = ("name", "t0", "child_s", "counters")

    def __init__(self, name: str, t0: float):
        self.name = name
        self.t0 = t0
        self.child_s = 0.0          # inclusive seconds of finished children
        self.counters = None


class Region:
    """Context manager handle; ``seconds`` holds the inclusive wall time
    after exit.  The region stops (and is accounted) even when the body
    raises."""

    __slots__ = ("_session", "name", "counters", "seconds", "_frame")

    def __init__(self, session: "MarkerSession", name: str,
                 counters: Optional[dict]):
        self._session = session
        self.name = name
        self.counters = dict(counters) if counters else None
        self.seconds = None
        self._frame = None

    def add(self, **counters):
        """Add work counters from inside the region body."""
        if self.counters is None:
            self.counters = {}
        for k, v in counters.items():
            self.counters[k] = self.counters.get(k, 0.0) + float(v)
        return self

    def __enter__(self):
        self._frame = self._session.start_region(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.seconds = self._session._stop_frame(self._frame, self.counters)
        self._frame = None
        return False


class MarkerSession:
    """pylikwid-style marker session over an LMS emitter.

    ``emitter`` is anything with ``.metric(name, fields, tags=, ts=)`` (a
    :class:`~repro_torch.core.usermetric.UserMetric`); ``None`` accumulates
    only.  ``clock`` is injectable for deterministic tests.  Region stacks
    are thread-local; the accumulators are shared under a lock.
    """

    def __init__(self, emitter=None, *, emit_interval_s: float = 5.0,
                 measurement: str = MARKER_MEASUREMENT,
                 clock: Callable[[], float] = time.monotonic):
        self._emitter = emitter
        self.emit_interval_s = float(emit_interval_s)
        self.measurement = measurement
        self._clock = clock
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._pending: dict = {}        # region -> delta acc since flush
        self._totals: dict = {}         # region -> lifetime acc
        self._last_emit = clock()
        self._closed = False

    # -- region stack (thread-local) ----------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def start_region(self, name: str) -> _Frame:
        """Open a region on the calling thread; returns its frame token."""
        fr = _Frame(str(name), self._clock())
        self._stack().append(fr)
        return fr

    def stop_region(self, name: Optional[str] = None,
                    counters: Optional[dict] = None) -> float:
        """Close the innermost open region; returns inclusive seconds.  A
        ``name`` that is not the innermost region's raises."""
        st = self._stack()
        if not st:
            raise ValueError(f"stop_region({name!r}): no region open "
                             "on this thread")
        if name is not None and st[-1].name != name:
            raise ValueError(f"stop_region({name!r}): innermost open "
                             f"region is {st[-1].name!r}")
        return self._stop_frame(st[-1], counters)

    def _stop_frame(self, frame: _Frame, counters: Optional[dict]) -> float:
        """Close ``frame`` (and any regions leaked open inside it)."""
        st = self._stack()
        if frame not in st:
            raise ValueError(f"region {frame.name!r} is not open "
                             "on this thread")
        now = self._clock()
        while st[-1] is not frame:
            self._pop(st, now, None)
        incl = self._pop(st, now, counters)
        self._maybe_emit(now)
        return incl

    def _pop(self, st: list, now: float, counters: Optional[dict]) -> float:
        fr = st.pop()
        incl = max(now - fr.t0, 0.0)
        excl = max(incl - fr.child_s, 0.0)
        if st:
            st[-1].child_s += incl
        merged = fr.counters
        if counters:
            merged = dict(merged) if merged else {}
            for k, v in counters.items():
                merged[k] = merged.get(k, 0.0) + float(v)
        self._accumulate(fr.name, 1, incl, excl, merged)
        return incl

    def region(self, name: str, counters: Optional[dict] = None) -> Region:
        """``with session.region("fwd", counters={"flops": f}):``; the
        counters are credited once per call, on exit."""
        return Region(self, name, counters)

    def record(self, name: str, seconds: float,
               counters: Optional[dict] = None, calls: int = 1):
        """Account an externally timed region without entering the stack:
        inclusive == exclusive == ``seconds``."""
        s = float(seconds)
        self._accumulate(str(name), calls, s, s,
                         dict(counters) if counters else None)
        self._maybe_emit(self._clock())

    # -- accumulators ---------------------------------------------------------

    @staticmethod
    def _merge(acc: dict, calls: int, incl: float, excl: float,
               counters: Optional[dict]):
        acc["calls"] = acc.get("calls", 0.0) + float(calls)
        acc["time_s"] = acc.get("time_s", 0.0) + incl
        acc["excl_time_s"] = acc.get("excl_time_s", 0.0) + excl
        if counters:
            for k, v in counters.items():
                acc[k] = acc.get(k, 0.0) + float(v)

    def _accumulate(self, name: str, calls: int, incl: float, excl: float,
                    counters: Optional[dict]):
        with self._lock:
            self._merge(self._pending.setdefault(name, {}), calls, incl,
                        excl, counters)
            self._merge(self._totals.setdefault(name, {}), calls, incl,
                        excl, counters)

    def _maybe_emit(self, now: float):
        if self._emitter is None:
            return
        with self._lock:
            due = now - self._last_emit >= self.emit_interval_s
        if due:
            self.flush()

    def snapshot(self) -> dict:
        """Lifetime per-region totals (never reset by flush)."""
        with self._lock:
            return {name: dict(acc) for name, acc in self._totals.items()}

    def open_regions(self) -> list:
        """Names of regions open on the calling thread, outermost first."""
        return [fr.name for fr in self._stack()]

    # -- emission -------------------------------------------------------------

    def flush(self, ts: Optional[int] = None) -> dict:
        """Drain pending deltas; emit one ``marker`` point per region, all
        with one timestamp.  Returns ``{region: fields}`` of what was
        emitted."""
        with self._lock:
            pending, self._pending = self._pending, {}
            self._last_emit = self._clock()
        if not pending:
            return {}
        t = ts if ts is not None else now_ns()
        out = {}
        for name in sorted(pending):
            fields = {k: float(v) for k, v in pending[name].items()}
            out[name] = fields
            if self._emitter is not None:
                self._emitter.metric(self.measurement, fields,
                                     tags={"region": name}, ts=t)
        if out and self._emitter is not None:
            # the emitter's internal flush, not its public one (which would
            # drain this session again); failures re-buffer there
            push = getattr(self._emitter, "_flush", None)
            if push is not None:
                push(raise_errors=False)
        return out

    def close(self) -> dict:
        """Final flush (the emitter is shared and stays open)."""
        self._closed = True
        return self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def calibrate(emitter, peak_flops: float, peak_bw: float, *,
              ts: Optional[int] = None):
    """Store the machine's peaks (FLOP/s, memory bytes/s) as a ``marker``
    point of region :data:`CALIB_REGION` and flush it at once."""
    emitter.metric(MARKER_MEASUREMENT,
                   {"peak_flops": float(peak_flops),
                    "peak_bw": float(peak_bw)},
                   tags={"region": CALIB_REGION},
                   ts=ts if ts is not None else now_ns())
    flush = getattr(emitter, "flush", None)
    if flush is not None:
        flush()
