"""InfluxDB line protocol, the LMS wire format (copy of the encoder and the
line decoder of ``repro.core.line_protocol``).

    measurement[,tag_key=tag_val...] field_key=field_val[,...] [timestamp_ns]

The port's job side encodes what it sends with :func:`encode_point` /
:func:`encode_batch`, byte for byte as the stack's own encoder does (a test
holds the two together), so a ``repro.core`` stack ingests it unchanged.
:func:`decode_line` is here so that a receiver without the stack (the chip
smoke test's) can read back what it was sent.  The stack's batch decoder,
with its fast path and head cache, is the stack's and is not copied.

Field values: floats (``1.0``, and the extensions ``nan`` / ``inf`` /
``-inf``), integers (``42i``), booleans (``t``/``f``) and strings
(``"..."`` with ``\\"``, ``\\n`` and ``\\r`` escapes).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional, Union

FieldValue = Union[float, int, bool, str]


@dataclass
class Point:
    """One measurement line."""

    measurement: str
    tags: dict = field(default_factory=dict)
    fields: dict = field(default_factory=dict)
    timestamp: Optional[int] = None        # ns since epoch


def now_ns() -> int:
    return time.time_ns()


# --------------------------------------------------------------------------
# Escaping (InfluxDB 1.x rules)
# --------------------------------------------------------------------------

_MEAS_ESC = {",": "\\,", " ": "\\ "}
_TAG_ESC = {",": "\\,", " ": "\\ ", "=": "\\="}


def _escape(s: str, table: dict) -> str:
    out = s.replace("\\", "\\\\")
    for raw, esc in table.items():
        out = out.replace(raw, esc)
    return out


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


def _encode_field_value(v: FieldValue) -> str:
    if isinstance(v, bool):
        return "t" if v else "f"
    if isinstance(v, int):
        return f"{v}i"
    if isinstance(v, float):
        if math.isnan(v):
            return "nan"
        if math.isinf(v):
            return "inf" if v > 0 else "-inf"
        return repr(v)
    if isinstance(v, str):
        body = (v.replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n").replace("\r", "\\r"))
        return '"' + body + '"'
    raise TypeError(f"unsupported field value {v!r}")


def encode_point(p: Point) -> str:
    parts = [_escape(p.measurement, _MEAS_ESC)]
    for k in sorted(p.tags):
        v = p.tags[k]
        parts.append(f",{_escape(str(k), _TAG_ESC)}="
                     f"{_escape(str(v), _TAG_ESC)}")
    if not p.fields:
        raise ValueError("point must have at least one field")
    fields = ",".join(
        f"{_escape(str(k), _TAG_ESC)}={_encode_field_value(v)}"
        for k, v in sorted(p.fields.items()))
    line = "".join(parts) + " " + fields
    if p.timestamp is not None:
        line += f" {int(p.timestamp)}"
    return line


def encode_batch(points: Iterable[Point]) -> str:
    """Concatenate lines for batched transmission."""
    return "\n".join(encode_point(p) for p in points)


# --------------------------------------------------------------------------
# Parsing
# --------------------------------------------------------------------------


class LineProtocolError(ValueError):
    pass


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


def _parse_field_value(s: str) -> FieldValue:
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


def decode_line(line: str) -> Point:
    """One line -> :class:`Point` (escape-aware; raises
    :class:`LineProtocolError` on a malformed line)."""
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
    return Point(measurement, tags, fields, ts)
