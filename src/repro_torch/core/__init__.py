"""The job side of the LIKWID Monitoring Stack, for the port.

The paper splits a monitored job from the stack that stores and analyses
its metrics: the job's libraries push line protocol over HTTP to a router
in another process.  This package is the port's copy of that job side
(the port imports nothing of ``repro``):

* :mod:`~repro_torch.core.line_protocol`: ``Point`` and the encoder;
* :mod:`~repro_torch.core.perf_groups`: the LIKWID-style groups, with no
  hardware constants (the job passes its device's peaks as events);
* :mod:`~repro_torch.core.usermetric`, :mod:`~repro_torch.core.host_agent`,
  :mod:`~repro_torch.core.marker`: the emitters;
* :mod:`~repro_torch.core.httpd`: the HTTP client;
* :class:`RemoteStack`: the object ``train()``, ``ServingEngine`` and the
  CLIs take as their stack, for a stack served elsewhere (a ``repro.core``
  ``MonitoringStack`` with ``serve_http=True`` is one).
"""

from __future__ import annotations

import math
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Optional

from repro_torch.core.host_agent import HostAgent
from repro_torch.core.httpd import Finding, HttpSink
from repro_torch.core.line_protocol import (
    Point, decode_line, encode_batch, encode_point, now_ns)
from repro_torch.core.marker import (
    CALIB_REGION, MARKER_MEASUREMENT, MarkerSession, calibrate)
from repro_torch.core.perf_groups import GROUPS, derive_all, formula_for
from repro_torch.core.usermetric import UserMetric

__all__ = [
    "CALIB_REGION", "Finding", "GROUPS", "HostAgent", "HttpSink",
    "MARKER_MEASUREMENT", "MarkerSession", "Point", "RemoteStack",
    "UserMetric", "calibrate", "decode_line", "derive_all", "encode_batch",
    "encode_point", "formula_for", "now_ns",
]

BATCH_SIZE = 64           # points an emitter buffers before it posts
FLUSH_INTERVAL_S = 5.0    # a usermetric posts at least this often
POLL_INTERVAL_S = 1.0     # /alerts is read at most this often
TIMEOUT_S = 10.0          # per HTTP request


class RemoteStack:
    """A monitoring stack that runs elsewhere, reached at ``url``.

    The counterpart of ``repro.core.MonitoringStack`` for a job whose stack
    is another process: the same ``job`` / ``host_agent`` / ``usermetric``
    / ``marker_session`` / ``on_finding`` / ``findings`` / ``close``
    surface, over HTTP.  The router tags a point with the live job when it
    arrives, so :meth:`job` flushes every agent and usermetric it handed
    out (marker deltas included) before it posts ``/job/end``.

    Emitters buffer ``BATCH_SIZE`` points (``FLUSH_INTERVAL_S`` at most for
    the usermetrics) before they post, so a step loop posts now and then,
    not every step.  Findings come from the stack's ``/alerts``:
    :meth:`poll_findings` feeds the ``on_finding`` callbacks with the
    job's new ones, asking at most every ``POLL_INTERVAL_S``.
    """

    def __init__(self, url: str):
        self.sink = HttpSink(url, timeout_s=TIMEOUT_S)
        self._lock = threading.Lock()
        self._agents: list = []
        self._usermetrics: list = []
        self._finding_cbs: list = []
        self._seen: set = set()
        self._last_poll = -math.inf
        self._poll_failures = 0
        self.job_id: Optional[str] = None      # the live or last job

    @property
    def url(self) -> str:
        return self.sink.url

    # -- components -----------------------------------------------------------

    def usermetric(self, host: Optional[str] = None, **tags) -> UserMetric:
        um = UserMetric(self.sink, hostname=host, default_tags=tags or None,
                        batch_size=BATCH_SIZE,
                        flush_interval_s=FLUSH_INTERVAL_S)
        with self._lock:
            self._usermetrics.append(um)
        return um

    def host_agent(self, hostname: str, **consts) -> HostAgent:
        agent = HostAgent(self.sink, hostname, consts or None,
                          batch_size=BATCH_SIZE)
        with self._lock:
            self._agents.append(agent)
        return agent

    def marker_session(self, host: Optional[str] = None,
                       **tags) -> MarkerSession:
        """A marker session emitting through a fresh usermetric."""
        return self.usermetric(host=host, **tags).markers

    def flush(self) -> None:
        """Post everything the handed-out emitters hold; raises if the
        stack does not take it."""
        with self._lock:
            emitters = self._usermetrics + self._agents
        for e in emitters:
            e.flush()

    # -- job lifecycle --------------------------------------------------------

    @contextmanager
    def job(self, job_id: Optional[str] = None, *, user: str = "user",
            hosts: Optional[list] = None, tags: Optional[dict] = None):
        """``/job/start`` on entry (raises when the stack is unreachable),
        a flush of every emitter, then ``/job/end`` on exit."""
        job_id = job_id or uuid.uuid4().hex[:8]
        self.sink.job_start(job_id, user, hosts or ["host0"], tags)
        self.job_id = job_id
        try:
            yield job_id
        finally:
            try:
                self.flush()
            finally:
                self.sink.job_end(job_id)

    # -- findings -------------------------------------------------------------

    def on_finding(self, cb):
        self._finding_cbs.append(cb)
        return cb

    def findings(self) -> list:
        """Every alert the stack holds for the job (active and resolved),
        after posting what the emitters hold."""
        self.flush()
        return self.sink.alerts(self.job_id)

    def poll_findings(self, force: bool = False) -> list:
        """Read the job's alerts (at most every ``POLL_INTERVAL_S`` unless
        ``force``) and call the ``on_finding`` callbacks with the new ones.
        A failed read is counted (``stats["poll_failures"]``), as a failed
        implicit flush is, and does not stop the job."""
        now = time.monotonic()
        if not force and now - self._last_poll < POLL_INTERVAL_S:
            return []
        self._last_poll = now
        try:
            found = self.sink.alerts(self.job_id)
        except Exception:
            self._poll_failures += 1
            return []
        new = []
        for f in found:
            key = (f.rule, f.host, f.start_ns)
            if key not in self._seen:
                self._seen.add(key)
                new.append(f)
        for f in new:
            for cb in self._finding_cbs:
                try:
                    cb(f)
                except Exception:
                    pass
        return new

    def report_url(self, job_id: Optional[str] = None) -> str:
        return self.sink.report_url(job_id or self.job_id)

    # -- accounting -----------------------------------------------------------

    @property
    def stats(self) -> dict:
        """What the client posted (requests, points, bytes, seconds, failed
        requests) and the emitters' failed flushes and dropped points."""
        with self._lock:
            ums, agents = list(self._usermetrics), list(self._agents)
        out = dict(self.sink.stats)
        out["failed_flushes"] = sum(u.stats["failed_flushes"] for u in ums) \
            + sum(a.emit_stats["failed_flushes"] for a in agents)
        out["dropped_points"] = sum(u.stats["dropped_points"] for u in ums) \
            + sum(a.emit_stats["dropped_points"] for a in agents)
        out["poll_failures"] = self._poll_failures
        return out

    def close(self) -> None:
        """Post what is left and stop the emitters."""
        with self._lock:
            ums = list(self._usermetrics)
        for um in ums:
            um.close()
        self.flush()
