"""PostgreSQL wire-protocol parser + stitcher: captured bytes ->
pgsql_events.

Reference parity: the socket tracer's pgsql protocol pair
(``src/stirling/source_connectors/socket_tracer/
protocols/pgsql/parse.cc`` — message framing — and ``stitcher.cc`` —
pairing query/extended-protocol exchanges). Capture arrives as byte
chunks from any tap; partial messages survive across ``feed`` calls.

Protocol essentials (PostgreSQL frontend/backend protocol v3, public
spec):
- After startup, every message is a 1-byte type tag + u32 big-endian
  length (length counts itself, not the tag).
- The startup packet and SSLRequest have NO tag (just length+payload);
  the server answers SSLRequest with a bare 'S'/'N' byte.
- Frontend: 'Q' simple query (SQL text), 'P' Parse (stmt\\0 sql\\0...),
  'B' Bind, 'E' Execute, 'S' Sync, 'X' Terminate.
- Backend: 'T' RowDescription, 'D' DataRow, 'C' CommandComplete (tag
  text like "SELECT 3"), 'E' ErrorResponse (\\0-separated fields, each
  1-byte code + text; 'M' = human message), 'Z' ReadyForQuery.

Stitching granularity is the sync point (stitcher.cc handles the same
grouping): a request unit is one 'Q', or an extended-protocol run
P/B/E/... closed by 'S'; the response unit is everything up to the next
'Z' (ReadyForQuery), summarized as the CommandComplete tags (plus
row count) or the error message.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from .conn_table import ConnectionTable


class _Framer:
    """Incremental tagged-message framing for one direction."""

    MAX_BUF = 1 << 20

    def __init__(self, frontend: bool):
        self._buf = b""
        self.frontend = frontend
        self._startup_done = not frontend
        self._skip = 0  # bytes of an oversized message still to discard
        self.oversized = 0

    def feed(self, data: bytes):
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
            if self.frontend and not self._startup_done:
                # Startup / SSLRequest / CancelRequest: length-prefixed,
                # no tag. An SSLRequest (code 80877103) is typically
                # followed by the real StartupMessage (protocol v3) on
                # plaintext connections — stay in startup mode until the
                # StartupMessage itself has been consumed.
                if len(self._buf) < 8:
                    break
                ln = int.from_bytes(self._buf[:4], "big")
                code = int.from_bytes(self._buf[4:8], "big")
                if ln < 8 or ln > self.MAX_BUF:
                    self._startup_done = True  # already tagged traffic
                    continue
                if len(self._buf) < ln:
                    break
                self._buf = self._buf[ln:]
                if code >> 16 == 3:  # StartupMessage (major version 3)
                    self._startup_done = True
                continue
            if not self._buf:
                break
            tag = self._buf[0:1]
            if not self.frontend and tag in (b"N", b"S") and len(self._buf) >= 5:
                # Could be an SSLRequest answer (bare byte) — but 'S' is
                # no backend message start and 'N' (NoticeResponse) has a
                # length; disambiguate by checking the would-be length.
                ln = int.from_bytes(self._buf[1:5], "big")
                if ln < 4 or ln > self.MAX_BUF:
                    self._buf = self._buf[1:]
                    continue
            if len(self._buf) < 5:
                break
            ln = int.from_bytes(self._buf[1:5], "big")
            if ln < 4:
                self._buf = self._buf[1:]  # resync: skip a garbage byte
                continue
            if ln > self.MAX_BUF:
                # Oversized message (e.g. a giant COPY payload): discard
                # its remaining bytes incrementally — truncating the
                # buffer mid-message would desync framing forever.
                self.oversized += 1
                drop = min(1 + ln, len(self._buf))
                self._skip = 1 + ln - drop
                self._buf = self._buf[drop:]
                if self._skip:
                    break
                continue
            if len(self._buf) < 1 + ln:
                break
            out.append((tag.decode("latin-1"), self._buf[5:1 + ln]))
            self._buf = self._buf[1 + ln:]
        return out


def _cstr(b: bytes, off: int = 0) -> str:
    end = b.find(b"\0", off)
    return b[off:end if end >= 0 else len(b)].decode("utf-8", "replace")


def _error_message(body: bytes) -> str:
    """ErrorResponse fields: code byte + cstring, repeated, \\0 end."""
    msg, sev = "", ""
    i = 0
    while i < len(body) and body[i] != 0:
        code = chr(body[i])
        end = body.find(b"\0", i + 1)
        if end < 0:
            break
        text = body[i + 1:end].decode("utf-8", "replace")
        if code == "M":
            msg = text
        elif code == "S":
            sev = text
        i = end + 1
    return f"{sev}: {msg}" if sev else msg


class _Conn:
    last_ts = 0

    def __init__(self):
        self.req = _Framer(frontend=True)
        self.resp = _Framer(frontend=False)
        self.pending: deque = deque()  # (req_cmd, sql, ts)
        self.open_unit = None  # extended-protocol run being assembled
        self.resp_parts: list = []
        self.resp_rows = 0
        self.resp_err = ""


class PgSQLStitcher:
    """Pairs sync-point exchanges; emits pgsql_events records."""

    PENDING_PER_CONN = 256

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
            for tag, body in c.req.feed(data):
                emitted += self._frontend(conn_id, c, tag, body, ts)
            return emitted
        for tag, body in c.resp.feed(data):
            emitted += self._backend(c, tag, body, ts)
        return emitted

    def _push_pending(self, conn_id, c: _Conn, unit) -> bool:
        if len(c.pending) >= self.PENDING_PER_CONN:
            self.parse_errors += len(c.pending) + 1
            self._conns.kill(conn_id)
            return False
        c.pending.append(unit)
        return True

    def _frontend(self, conn_id, c: _Conn, tag, body, ts) -> int:
        if tag == "Q":
            self._push_pending(conn_id, c, ("QUERY", _cstr(body), ts))
            return 0
        if tag == "P":
            # Parse: statement name \0 query \0 n_params...
            name_end = body.find(b"\0")
            sql = _cstr(body, name_end + 1) if name_end >= 0 else ""
            c.open_unit = ["EXECUTE", sql, ts]
            return 0
        if tag in ("B", "D", "E", "H", "F"):
            if c.open_unit is None:
                c.open_unit = ["EXECUTE", "", ts]
            return 0
        if tag == "S":
            unit = c.open_unit or ["SYNC", "", ts]
            c.open_unit = None
            self._push_pending(conn_id, c, tuple(unit))
            return 0
        if tag == "X":
            return 0  # Terminate: nothing to pair
        return 0

    def _backend(self, c: _Conn, tag, body, ts) -> int:
        if tag == "C":
            c.resp_parts.append(_cstr(body))
            return 0
        if tag == "D":
            c.resp_rows += 1
            return 0
        if tag == "E":
            c.resp_err = _error_message(body)
            return 0
        if tag == "Z":
            return self._finish(c, ts)
        return 0  # T/1/2/3/N/A/K/R/S...: shape-only messages

    def _finish(self, c: _Conn, ts: int) -> int:
        parts, rows, err = c.resp_parts, c.resp_rows, c.resp_err
        c.resp_parts, c.resp_rows, c.resp_err = [], 0, ""
        if not c.pending:
            return 0  # ReadyForQuery after connection startup
        req_cmd, sql, req_ts = c.pending.popleft()
        if err:
            resp = err
        elif parts:
            resp = "; ".join(parts)
        else:
            resp = f"rows={rows}" if rows else ""
        self.records.append({
            "time_": req_ts,
            "req_cmd": req_cmd,
            "req": sql,
            "resp": resp,
            "latency_ns": max(ts - req_ts, 0),
            "service": self.service,
            "pod": self.pod,
        })
        return 1

    def drain(self) -> list[dict]:
        out, self.records = self.records, []
        return out
