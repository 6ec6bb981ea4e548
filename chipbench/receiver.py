"""A stand-in for the monitoring stack's HTTP face, run as a child process.

A frozen copy of ``chip_smoke.py``'s ``Receiver`` and of the line-protocol
decoder it uses (``repro_torch.core.line_protocol.decode_line``): it serves
``/ping``, ``/write``, ``/job/start``, ``/job/end`` and ``/alerts`` (no
alerts) on ``127.0.0.1`` and a free port, and keeps every point it was sent.
It imports nothing but the standard library, so it loads in a fraction of a
second and shares no interpreter with the monitored job.

Run::

    python3 chipbench/receiver.py

It prints ``PORT <n>`` once it listens.  ``GET /summary`` returns what
arrived as JSON: every point (measurement, tags, fields), the job signals in
order, the lines it could not decode and the count of ``/write`` requests;
``POST /quit`` stops it.
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class LineProtocolError(ValueError):
    pass


def _unescape(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            out.append(s[i + 1])
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def _parse_ts(s: str) -> int:
    try:
        return int(s)
    except ValueError:
        raise LineProtocolError(f"bad timestamp {s!r}") from None


def _split_unescaped(s: str, sep: str, maxsplit: int = -1) -> list:
    """Split on ``sep`` outside escapes and double quotes."""
    out, cur = [], []
    in_quotes = False
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            cur.append(c)
            cur.append(s[i + 1])
            i += 2
            continue
        if c == '"':
            in_quotes = not in_quotes
            cur.append(c)
        elif c == sep and not in_quotes and maxsplit != 0:
            out.append("".join(cur))
            cur = []
            if maxsplit > 0:
                maxsplit -= 1
        else:
            cur.append(c)
        i += 1
    out.append("".join(cur))
    return out


_TRUE = frozenset(("t", "T", "true", "True"))
_FALSE = frozenset(("f", "F", "false", "False"))


def _parse_field_value(s: str):
    if s.startswith('"'):
        if not s.endswith('"') or len(s) < 2:
            raise LineProtocolError(f"bad string field {s!r}")
        body = s[1:-1]
        out, i = [], 0
        special = {"n": "\n", "r": "\r"}
        while i < len(body):
            if body[i] == "\\" and i + 1 < len(body):
                out.append(special.get(body[i + 1], body[i + 1]))
                i += 2
            else:
                out.append(body[i])
                i += 1
        return "".join(out)
    if s.endswith("i"):
        try:
            return int(s[:-1])
        except ValueError:
            raise LineProtocolError(f"bad integer field {s!r}") from None
    try:
        return float(s)          # also accepts nan / inf / -inf
    except ValueError:
        pass
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    raise LineProtocolError(f"bad field value {s!r}")


def decode_line(line: str) -> dict:
    """One line -> {"measurement", "tags", "fields", "timestamp"}."""
    line = line.strip()
    if not line or line.startswith("#"):
        raise LineProtocolError("empty/comment line")
    head_fields = [h for h in _split_unescaped(line, " ") if h != ""]
    if len(head_fields) < 2:
        raise LineProtocolError(f"no fields in {line!r}")
    head, fields_str = head_fields[0], head_fields[1]
    ts = _parse_ts(head_fields[2]) if len(head_fields) >= 3 else None

    head_parts = _split_unescaped(head, ",")
    measurement = _unescape(head_parts[0])
    if not measurement:
        raise LineProtocolError("empty measurement")
    tags = {}
    for t in head_parts[1:]:
        kv = _split_unescaped(t, "=")
        if len(kv) != 2:
            raise LineProtocolError(f"bad tag {t!r}")
        tags[_unescape(kv[0])] = _unescape(kv[1])

    fields = {}
    for f in _split_unescaped(fields_str, ","):
        kv = _split_unescaped(f, "=", maxsplit=1)
        if len(kv) != 2:
            raise LineProtocolError(f"bad field {f!r}")
        fields[_unescape(kv[0])] = _parse_field_value(kv[1])
    return {"measurement": measurement, "tags": tags, "fields": fields,
            "timestamp": ts}


class Receiver:
    """The HTTP face; :meth:`summary` is what arrived."""

    def __init__(self, port: int = 0):
        self.points = []
        self.signals = []               # ["start" | "end", jobid]
        self.bad_lines = []
        self.writes = 0
        self.lock = threading.Lock()
        rec = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code, payload=None):
                body = b"" if code == 204 else json.dumps(
                    payload or {}).encode()
                self.send_response(code)
                if code != 204:
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/ping":
                    self._reply(204)
                elif path == "/alerts":
                    self._reply(200, {"alerts": []})
                elif path == "/summary":
                    self._reply(200, rec.summary())
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                body = self.rfile.read(int(self.headers["Content-Length"]))
                if path == "/write":
                    n = 0
                    with rec.lock:
                        rec.writes += 1
                        for line in body.decode().split("\n"):
                            if not line.strip():
                                continue
                            try:
                                rec.points.append(decode_line(line))
                                n += 1
                            except ValueError as e:
                                rec.bad_lines.append(f"{line!r}: {e}")
                    self._reply(200, {"written": n, "errors": []})
                elif path in ("/job/start", "/job/end"):
                    with rec.lock:
                        rec.signals.append([path.rsplit("/", 1)[1],
                                            json.loads(body)["jobid"]])
                    self._reply(200, {"ok": True})
                elif path == "/quit":
                    self._reply(200, {"ok": True})
                    threading.Thread(target=rec.httpd.shutdown,
                                     daemon=True).start()
                else:
                    self._reply(404, {"error": "not found"})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def summary(self) -> dict:
        with self.lock:
            return {"points": list(self.points),
                    "signals": list(self.signals),
                    "bad_lines": list(self.bad_lines),
                    "writes": self.writes}


def main() -> int:
    rec = Receiver()
    print(f"PORT {rec.port}", flush=True)
    try:
        rec.httpd.serve_forever()
    finally:
        rec.httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
