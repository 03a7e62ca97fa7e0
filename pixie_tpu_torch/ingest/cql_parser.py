"""Cassandra CQL wire-protocol parser + stitcher: captured bytes ->
cql_events.

Reference parity: the socket tracer's cass protocol pair
(``src/stirling/source_connectors/socket_tracer/
protocols/cass/`` — frame decode + stream-id matching). Capture arrives
as byte chunks from any tap; partial frames survive across ``feed``.

Protocol essentials (CQL binary protocol v3/v4/v5, public spec):
- Every frame: version (1 byte; high bit set = response), flags
  (1 byte; 0x01 = compressed body), stream id (i16 big-endian),
  opcode (1 byte), body length (u32 big-endian), body.
- Requests and responses pair BY STREAM ID (clients multiplex many
  in-flight queries per connection). Server push EVENT frames use
  stream id -1 and have no request.
- QUERY/PREPARE bodies start with a "long string" (u32 length + utf8)
  holding the CQL text; EXECUTE starts with "short bytes" (u16 length)
  holding the prepared-statement id; RESULT bodies start with an i32
  kind (Void/Rows/SetKeyspace/Prepared/SchemaChange); ERROR bodies are
  i32 code + string message.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Optional

from .conn_table import ConnectionTable

# Opcodes (protocol spec §2.4; cass/types.h ReqOp/RespOp).
OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_OPTIONS = 0x05
OP_SUPPORTED = 0x06
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_PREPARE = 0x09
OP_EXECUTE = 0x0A
OP_REGISTER = 0x0B
OP_EVENT = 0x0C
OP_BATCH = 0x0D
OP_AUTH_CHALLENGE = 0x0E
OP_AUTH_RESPONSE = 0x0F
OP_AUTH_SUCCESS = 0x10

OP_NAMES = {
    OP_ERROR: "ERROR", OP_STARTUP: "STARTUP", OP_READY: "READY",
    OP_AUTHENTICATE: "AUTHENTICATE", OP_OPTIONS: "OPTIONS",
    OP_SUPPORTED: "SUPPORTED", OP_QUERY: "QUERY", OP_RESULT: "RESULT",
    OP_PREPARE: "PREPARE", OP_EXECUTE: "EXECUTE", OP_REGISTER: "REGISTER",
    OP_EVENT: "EVENT", OP_BATCH: "BATCH",
    OP_AUTH_CHALLENGE: "AUTH_CHALLENGE", OP_AUTH_RESPONSE: "AUTH_RESPONSE",
    OP_AUTH_SUCCESS: "AUTH_SUCCESS",
}

_RESULT_KINDS = {1: "Void", 2: "Rows", 3: "SetKeyspace", 4: "Prepared",
                 5: "SchemaChange"}

_HDR = 9  # version + flags + stream + opcode + length


class _Framer:
    """Incremental CQL frame splitter for one direction."""

    MAX_BODY = 4 << 20

    def __init__(self):
        self._buf = b""
        self._skip = 0
        self._skip_hdr = None
        self.oversized = 0

    def feed(self, data: bytes):
        """Yield (version, flags, stream, opcode, body|None) frames —
        body None marks an oversized frame whose payload was dropped."""
        self._buf += data
        out = []
        while True:
            if self._skip:
                drop = min(self._skip, len(self._buf))
                self._buf = self._buf[drop:]
                self._skip -= drop
                if self._skip:
                    break
                out.append((*self._skip_hdr, None))
                continue
            if len(self._buf) < _HDR:
                break
            ver = self._buf[0]
            flags = self._buf[1]
            stream = int.from_bytes(self._buf[2:4], "big", signed=True)
            opcode = self._buf[4]
            ln = int.from_bytes(self._buf[5:9], "big")
            if (ver & 0x7F) not in (3, 4, 5) or opcode > 0x10:
                self._buf = self._buf[1:]  # garbage: resync byte-wise
                continue
            if ln > self.MAX_BODY:
                # Giant body (huge batch / result page): keep the header
                # for pairing, discard the payload incrementally.
                self.oversized += 1
                self._skip_hdr = (ver, flags, stream, opcode)
                drop = min(_HDR + ln, len(self._buf))
                self._skip = _HDR + ln - drop
                self._buf = self._buf[drop:]
                if self._skip:
                    break
                out.append((*self._skip_hdr, None))
                continue
            if len(self._buf) < _HDR + ln:
                break
            out.append(
                (ver, flags, stream, opcode, self._buf[_HDR:_HDR + ln])
            )
            self._buf = self._buf[_HDR + ln:]
        return out


def _long_string(body: bytes) -> str:
    if len(body) < 4:
        return ""
    n = int.from_bytes(body[:4], "big")
    return body[4:4 + min(n, len(body) - 4)].decode("utf-8", "replace")


_COMPRESSED = object()  # flags & 0x01: body is lz4/snappy, not parsed
# (oversized frames keep the framer's body=None convention)


def _req_summary(opcode: int, body) -> str:
    if body is None:
        return "<oversized>"
    if body is _COMPRESSED:
        return "<compressed>"
    if opcode in (OP_QUERY, OP_PREPARE):
        q = _long_string(body)
        return q if len(q) <= 1024 else q[:1024] + "..."
    if opcode == OP_EXECUTE:
        if len(body) >= 2:
            n = int.from_bytes(body[:2], "big")
            return "id=" + body[2:2 + min(n, 16)].hex()
        return ""
    if opcode == OP_BATCH:
        # batch type (1) + query count (u16).
        if len(body) >= 3:
            n = int.from_bytes(body[1:3], "big")
            return f"queries={n}"
        return ""
    return ""


def _resp_summary(opcode: int, body) -> str:
    if body is None:
        return "<oversized>"
    if body is _COMPRESSED:
        return "<compressed>"
    if opcode == OP_RESULT:
        if len(body) >= 4:
            kind = int.from_bytes(body[:4], "big")
            name = _RESULT_KINDS.get(kind, f"kind={kind}")
            if kind == 2 and len(body) >= 12:
                # Rows: i32 metadata flags then i32 column count.
                ncols = int.from_bytes(body[8:12], "big")
                return f"Rows cols={ncols}"
            return name
        return "Result"
    if opcode == OP_ERROR:
        if len(body) >= 6:
            code = int.from_bytes(body[:4], "big")
            n = int.from_bytes(body[4:6], "big")
            msg = body[6:6 + min(n, 256)].decode("utf-8", "replace")
            return f"({code:#06x}) {msg}"
        return "Error"
    return OP_NAMES.get(opcode, "")


class _Conn:
    last_ts = 0

    def __init__(self):
        self.req = _Framer()
        self.resp = _Framer()
        # stream id -> (req_op, req_body, ts); insertion-ordered so
        # overflow evicts the oldest in-flight stream.
        self.pending: OrderedDict = OrderedDict()


class CQLStitcher:
    """Pairs CQL frames by stream id; emits cql_events records."""

    PENDING_PER_CONN = 512

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
            for ver, flags, stream, opcode, body in c.req.feed(data):
                if ver & 0x80:
                    self.parse_errors += 1  # response bits on req stream
                    continue
                if flags & 0x01 and body is not None:
                    body = _COMPRESSED  # summary-only, distinct sentinel
                while len(c.pending) >= self.PENDING_PER_CONN:
                    c.pending.popitem(last=False)
                    self.parse_errors += 1
                c.pending[stream] = (opcode, _req_summary(opcode, body), ts)
            return emitted
        for ver, flags, stream, opcode, body in c.resp.feed(data):
            if not ver & 0x80:
                self.parse_errors += 1
                continue
            if flags & 0x01 and body is not None:
                body = _COMPRESSED
            if opcode == OP_EVENT:
                # Server push (topology/status/schema change): no
                # request to pair; stream id is -1 by spec.
                self._emit(OP_EVENT, "", ts, ts, opcode,
                           _resp_summary(opcode, body))
                emitted += 1
                continue
            req = c.pending.pop(stream, None)
            if req is None:
                self.parse_errors += 1
                continue
            req_op, req_body, req_ts = req
            self._emit(req_op, req_body, req_ts, ts, opcode,
                       _resp_summary(opcode, body))
            emitted += 1
        return emitted

    def _emit(self, req_op, req_body, req_ts, resp_ts, resp_op, resp_body):
        self.records.append({
            "time_": req_ts,
            "req_op": int(req_op),
            "req_body": req_body,
            "resp_op": int(resp_op),
            "resp_body": resp_body,
            "latency_ns": max(resp_ts - req_ts, 0),
            "service": self.service,
            "pod": self.pod,
        })

    def drain(self) -> list[dict]:
        out, self.records = self.records, []
        return out
