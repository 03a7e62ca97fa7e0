"""Redis (RESP) wire-protocol parser + stitcher: captured bytes ->
redis_events.

Reference parity: the socket tracer's redis protocol pair
(``src/stirling/source_connectors/socket_tracer/
protocols/redis/parse.cc`` — RESP value parsing — and ``stitcher``/
``cmd_args.cc`` — command classification + arg formatting). Capture
arrives as byte chunks from any tap and flows through an incremental
per-connection state machine; partial values survive across ``feed``.

Protocol essentials (RESP2/RESP3, public spec):
- Every value starts with a type byte: '+' simple string, '-' error,
  ':' integer, '$' bulk string (length then payload + CRLF; -1 = null),
  '*' array (element count then nested values; -1 = null). RESP3 adds
  '_' null, '#' bool, ',' double, '(' big number, '=' verbatim string,
  '%' map, '~' set, '>' push.
- A client request is an array of bulk strings (or an inline text
  line); the first element is the command, optionally two-word
  (CONFIG GET, XINFO STREAM, ...).
- Responses pair with requests positionally (pipelining preserves
  order). '>' push frames (and pub/sub 'message' arrays) arrive
  without a request and are emitted as standalone PUSH records — the
  reference handles published messages the same way.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from .conn_table import ConnectionTable

#: Commands whose first argument completes the command name
#: (redis command table's container commands).
_TWO_WORD = frozenset({
    "ACL", "CLIENT", "CLUSTER", "COMMAND", "CONFIG", "DEBUG", "FUNCTION",
    "LATENCY", "MEMORY", "OBJECT", "PUBSUB", "SCRIPT", "SLOWLOG", "XGROUP",
    "XINFO",
})

_MAX_BULK = 1 << 20      # payloads past this are skipped, not buffered
_MAX_VALUE_BYTES = 256   # per-value cap in formatted output


class _Incomplete(Exception):
    pass


class _RESPParser:
    """Incremental RESP value parser for one direction."""

    MAX_BUF = 4 << 20

    def __init__(self):
        self._buf = b""
        self._skip = 0  # bytes of an oversized bulk still to discard
        self.oversized = 0
        self.resync = 0

    def feed(self, data: bytes):
        """Consume bytes; return a list of complete top-level values.

        An oversized bulk string parses as the '<oversized>' sentinel
        (its payload is discarded incrementally so framing never
        desyncs)."""
        self._buf += data
        out = []
        while True:
            if self._skip:
                drop = min(self._skip, len(self._buf))
                self._buf = self._buf[drop:]
                self._skip -= drop
                if self._skip:
                    break
                continue
            if not self._buf:
                break
            try:
                val, pos = self._value(0, top=True)
            except _Incomplete:
                if len(self._buf) > self.MAX_BUF:
                    # Unparseable giant buffer: drop it rather than grow
                    # without bound (a lost capture byte can do this).
                    self._buf = b""
                    self.resync += 1
                break
            out.append(val)
            self._buf = self._buf[pos:]
        return out

    # -- single-value parse (raises _Incomplete to wait for more bytes) ------
    def _line(self, pos: int):
        end = self._buf.find(b"\r\n", pos)
        if end < 0:
            raise _Incomplete  # feed()'s MAX_BUF guard bounds the wait
        return self._buf[pos:end], end + 2

    def _value(self, pos: int, top: bool = False):
        if pos >= len(self._buf):
            raise _Incomplete
        t = self._buf[pos:pos + 1]
        if t in (b"+", b"-", b":", b"_", b"#", b",", b"("):
            line, pos2 = self._line(pos + 1)
            text = line.decode("utf-8", "replace")
            if t == b"+":
                return text, pos2
            if t == b"-":
                return ("err", text), pos2
            if t == b":":
                return _int_or(text), pos2
            if t == b"_":
                return None, pos2
            if t == b"#":
                return text == "t", pos2
            return text, pos2  # double / big number as text
        if t in (b"$", b"="):
            line, pos2 = self._line(pos + 1)
            n = _int_or(line.decode("latin-1"), None)
            if n is None:
                raise _Incomplete
            if n < 0:
                return None, pos2
            if len(self._buf) >= pos2 + n + 2:
                if n > _MAX_BULK:
                    self.oversized += 1
                    return "<oversized>", pos2 + n + 2
                payload = self._buf[pos2:pos2 + n]
                return payload.decode("utf-8", "replace"), pos2 + n + 2
            if n > _MAX_BULK and top:
                # Top-level giant bulk (GET of a multi-MB key): complete
                # it as a sentinel NOW and discard its payload
                # incrementally, so the buffer never holds the body.
                # Nested giant bulks (inside an array) can't skip without
                # corrupting the outer parse — they either arrive fully
                # (branch above) or hit the MAX_BUF resync drop.
                self.oversized += 1
                self._skip = pos2 + n + 2 - len(self._buf)
                self._buf = b""
                return "<oversized>", 0
            raise _Incomplete
        if t in (b"*", b"%", b"~", b">"):
            line, pos2 = self._line(pos + 1)
            n = _int_or(line.decode("latin-1"), None)
            if n is None:
                raise _Incomplete
            if n < 0:
                return None, pos2
            if t == b"%":
                n *= 2  # maps carry n key-value pairs
            if n > 1 << 20:
                raise _Incomplete  # absurd count: wait, then resync-drop
            items = []
            for _ in range(n):
                v, pos2 = self._value(pos2)
                items.append(v)
            if t == b">":
                return ("push", items), pos2
            return items, pos2
        # Inline command (plain text line) — the spec's legacy form.
        line, pos2 = self._line(pos)
        return [w.decode("utf-8", "replace") for w in line.split()], pos2


def _int_or(s, default=0):
    try:
        return int(s)
    except ValueError:
        return default


def _fmt(val, depth: int = 0) -> str:
    """Human-readable response rendering (cmd_args.cc FormatToJSON
    analog, without the JSON escape machinery)."""
    if val is None:
        return "<null>"
    if isinstance(val, bool):
        return "true" if val else "false"
    if isinstance(val, tuple) and len(val) == 2 and val[0] == "err":
        return f"-{val[1]}"
    if isinstance(val, tuple) and len(val) == 2 and val[0] == "push":
        return "[" + ", ".join(_fmt(v, depth + 1) for v in val[1][:16]) + "]"
    if isinstance(val, list):
        if depth >= 3:
            return f"[{len(val)} items]"
        body = ", ".join(_fmt(v, depth + 1) for v in val[:16])
        more = f", +{len(val) - 16}" if len(val) > 16 else ""
        return f"[{body}{more}]"
    s = str(val)
    return s if len(s) <= _MAX_VALUE_BYTES else s[:_MAX_VALUE_BYTES] + "..."


class _Conn:
    last_ts = 0

    def __init__(self):
        self.req = _RESPParser()
        self.resp = _RESPParser()
        self.pending: deque = deque()  # (cmd, args, ts)


class RedisStitcher:
    """Pairs RESP requests with positional responses; emits redis_events
    records."""

    PENDING_PER_CONN = 512  # pipelining runs deep on redis

    def __init__(self, service: str = "", pod: str = ""):
        self.service = service
        self.pod = pod
        self._conns = ConnectionTable(_Conn)
        self.records: list[dict] = []
        self.parse_errors = 0

    def feed(
        self, conn_id, data: bytes, is_request: bool,
        ts_ns: Optional[int] = None,
    ) -> int:
        ts = ts_ns if ts_ns is not None else time.time_ns()
        c = self._conns.get(conn_id, ts)
        emitted = 0
        if is_request:
            for val in c.req.feed(data):
                if not isinstance(val, list) or not val:
                    self.parse_errors += 1
                    continue
                words = [str(w) for w in val]
                cmd = words[0].upper()
                rest = words[1:]
                if cmd in _TWO_WORD and rest:
                    cmd = f"{cmd} {rest[0].upper()}"
                    rest = rest[1:]
                args = " ".join(
                    w if len(w) <= 64 else w[:64] + "..." for w in rest[:16]
                )
                if len(c.pending) >= self.PENDING_PER_CONN:
                    self.parse_errors += len(c.pending) + 1
                    self._conns.kill(conn_id)
                    return emitted
                c.pending.append((cmd, args, ts))
            return emitted
        for val in c.resp.feed(data):
            if isinstance(val, tuple) and len(val) == 2 and val[0] == "push":
                # RESP3 push / pub-sub delivery: no request to pair.
                self._emit("PUSH", "", ts, ts, _fmt(val))
                emitted += 1
                continue
            if not c.pending:
                # Pub/sub 'message' arrays on RESP2 subscribers also
                # arrive unrequested.
                if isinstance(val, list) and val and str(val[0]).lower() in (
                    "message", "pmessage", "smessage"
                ):
                    self._emit("PUSH", "", ts, ts, _fmt(val))
                    emitted += 1
                else:
                    self.parse_errors += 1
                continue
            cmd, args, req_ts = c.pending.popleft()
            self._emit(cmd, args, req_ts, ts, _fmt(val))
            emitted += 1
        return emitted

    def _emit(self, cmd, args, req_ts, resp_ts, resp):
        self.records.append({
            "time_": req_ts,
            "req_cmd": cmd,
            "req_args": args,
            "resp": resp,
            "latency_ns": max(resp_ts - req_ts, 0),
            "service": self.service,
            "pod": self.pod,
        })

    def drain(self) -> list[dict]:
        out, self.records = self.records, []
        return out
