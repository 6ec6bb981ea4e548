"""HTTP client of the LMS (the client half of ``repro.core.httpd``).

The job side talks to a stack that runs in another process through the
stack's HTTP face:

    POST /write?db=<db>     line protocol, batched (:meth:`HttpSink.write`)
    POST /job/start         JSON {jobid, user, hosts, tags}
    POST /job/end           JSON {jobid}
    GET  /ping              204 when the stack is up
    GET  /alerts?jobid=&state=all   the job's alert episodes
    GET  /query?m=&field=&agg=      one aggregate of a stored field
    GET  /jobs/<id>/report  the job's footprint report

Every call raises on a refused connection, a timeout or an HTTP error, so a
wrong or dead stack URL shows at once.  :class:`Finding` is the job side's
record of an alert, with the fields of the stack's own finding records.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.line_protocol import Point, encode_batch


@dataclass
class Finding:
    """One alert episode the stack's analysis raised for a job."""

    rule: str
    severity: str
    host: str
    start_ns: int
    end_ns: int
    evidence: str = ""

    @property
    def duration_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @classmethod
    def from_alert(cls, d: dict) -> "Finding":
        """From one ``/alerts`` entry; a firing alert ends at its last
        violating sample so far."""
        end = d.get("end_ns")
        return cls(d["rule"], d.get("severity", "warning"),
                   d.get("host", ""), int(d["start_ns"]),
                   int(end if end is not None else d["last_ns"]),
                   d.get("evidence", ""))


class HttpSink:
    """Batched line-protocol POST client, plus the job signals and the
    read calls a job needs.  ``stats`` counts what was posted: requests,
    points, bytes, seconds spent posting and failed requests."""

    def __init__(self, url: str, db: str = "global", timeout_s: float = 5.0):
        self.url = url.rstrip("/")
        self.db = db
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._stats = {"posts": 0, "points": 0, "bytes": 0, "seconds": 0.0,
                       "failed": 0}

    def _request(self, path: str, data: Optional[bytes] = None,
                 content_type: str = "application/json"):
        req = urllib.request.Request(
            self.url + path, data=data,
            method="GET" if data is None else "POST",
            headers={"Content-Type": content_type} if data is not None
            else {})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return r.status, r.read()

    def write(self, points):
        if isinstance(points, Point):
            points = [points]
        data = encode_batch(points).encode()
        t0 = time.perf_counter()
        try:
            status, _ = self._request(
                f"/write?db={urllib.parse.quote(self.db)}", data,
                "text/plain")
        except Exception:
            with self._lock:
                self._stats["failed"] += 1
                self._stats["seconds"] += time.perf_counter() - t0
            raise
        with self._lock:
            s = self._stats
            s["posts"] += 1
            s["points"] += len(points)
            s["bytes"] += len(data)
            s["seconds"] += time.perf_counter() - t0
        return status

    def job_start(self, jobid: str, user: str, hosts: list,
                  tags: Optional[dict] = None):
        self._post_json("/job/start", {"jobid": jobid, "user": user,
                                       "hosts": hosts, "tags": tags or {}})

    def job_end(self, jobid: str):
        self._post_json("/job/end", {"jobid": jobid})

    def _post_json(self, path: str, payload: dict):
        return self._request(path, json.dumps(payload).encode())[0]

    def _get_json(self, path: str) -> dict:
        return json.loads(self._request(path)[1] or b"{}")

    def ping(self) -> bool:
        """True when the stack answers ``/ping``; raises when it does not
        answer at all."""
        return self._request("/ping")[0] == 204

    def alerts(self, jobid: Optional[str] = None,
               state: str = "all") -> list:
        """The stack's alert episodes (of ``jobid``), as :class:`Finding`."""
        q = {"db": self.db, "state": state}
        if jobid:
            q["jobid"] = jobid
        got = self._get_json("/alerts?" + urllib.parse.urlencode(q))
        return [Finding.from_alert(a) for a in got.get("alerts", [])]

    def aggregate(self, measurement: str, field: str, agg: str = "mean",
                  tags: Optional[dict] = None) -> dict:
        """One aggregate of a stored field (``GET /query``), by group
        (``""`` for all)."""
        q = {"db": self.db, "m": measurement, "field": field, "agg": agg}
        q.update({f"tag_{k}": v for k, v in (tags or {}).items()})
        return self._get_json("/query?" + urllib.parse.urlencode(q)).get(
            "result", {})

    def report_url(self, jobid: str) -> str:
        return f"{self.url}/jobs/{urllib.parse.quote(jobid, safe='')}/report"

    def report(self, jobid: str) -> dict:
        """The stack's footprint report of a job."""
        return self._get_json(self.report_url(jobid)[len(self.url):]).get(
            "report", {})

    @property
    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)
