"""HTTP/1.x stream parser: raw captured bytes -> http_events records.

Reference parity: the socket tracer's HTTP protocol parser
(``src/stirling/source_connectors/socket_tracer/
protocols/http/parse.cc`` + ``stitcher.cc``): incremental parsing of
captured request and response byte streams per connection, then
request/response stitching into trace records with latency. Without
eBPF capture in scope, the parser consumes byte chunks from any tap
(pcap export, proxy log, test fixtures) through the same incremental
state machine: partial messages survive across ``feed`` calls, pipelined
messages in one chunk all parse, and stitching pairs FIFO per
connection (HTTP/1.1 ordering guarantee).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from .conn_table import ConnectionTable
from typing import Optional

_MAX_BUF = 1 << 20  # per-direction cap; a stuck stream drops oldest bytes


@dataclass
class HTTPMessage:
    is_request: bool
    method: str = ""
    path: str = ""
    status: int = 0
    headers: dict = field(default_factory=dict)
    body: bytes = b""
    ts_ns: int = 0


class _StreamParser:
    """Incremental parser for one direction of one connection."""

    def __init__(self, is_request: bool):
        self.is_request = is_request
        self._buf = b""

    def feed(self, data: bytes, ts_ns: int) -> list[HTTPMessage]:
        self._buf += data
        if len(self._buf) > _MAX_BUF:
            self._buf = self._buf[-_MAX_BUF:]
        out = []
        while True:
            msg, consumed = self._parse_one(ts_ns)
            if msg is None:
                break
            self._buf = self._buf[consumed:]
            out.append(msg)
        return out

    def _parse_one(self, ts_ns: int):
        # Garbage-resync loop, not recursion: a chunk of binary data on a
        # tapped connection can hold thousands of CRLFCRLF-delimited
        # blocks (parse.cc's recovery on garbage bytes skips them all).
        while True:
            head_end = self._buf.find(b"\r\n\r\n")
            if head_end < 0:
                return None, 0
            head = self._buf[:head_end].decode("latin-1")
            lines = head.split("\r\n")
            start = lines[0].split(" ", 2)
            msg = HTTPMessage(is_request=self.is_request, ts_ns=ts_ns)
            try:
                if self.is_request:
                    if len(start) < 3 or not start[2].startswith("HTTP/"):
                        raise ValueError(start)
                    msg.method, msg.path = start[0], start[1]
                else:
                    if len(start) < 2 or not start[0].startswith("HTTP/"):
                        raise ValueError(start)
                    msg.status = int(start[1])
                break
            except ValueError:
                self._parse_errors = getattr(self, "_parse_errors", 0) + 1
                self._buf = self._buf[head_end + 4:]
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            msg.headers[k.strip().lower()] = v.strip()

        body_start = head_end + 4
        clen = msg.headers.get("content-length")
        if clen is not None and clen.isdigit():
            n = int(clen)
            if len(self._buf) < body_start + n:
                return None, 0  # body incomplete: wait for more bytes
            msg.body = self._buf[body_start:body_start + n]
            return msg, body_start + n
        if msg.headers.get("transfer-encoding", "").lower() == "chunked":
            end = self._buf.find(b"0\r\n\r\n", body_start)
            if end < 0:
                return None, 0
            msg.body = self._buf[body_start:end]
            return msg, end + 5
        return msg, body_start  # no body (the telemetry common case)


class _HTTPConn:
    last_ts = 0

    def __init__(self):
        self.req = _StreamParser(True)
        self.resp = _StreamParser(False)
        self.pending: deque = deque()


class HTTPStitcher:
    """Pairs requests with responses per connection; emits http_events
    records (``stitcher.cc`` ProcessMessages)."""

    # Per-connection pending requests are capped so a request flood
    # with no responses can't grow without bound; idle-connection expiry
    # lives in the shared ConnectionTable.
    PENDING_PER_CONN = 512

    def __init__(self, service: str = "", pod: str = ""):
        self.service = service
        self.pod = pod
        self._conns = ConnectionTable(_HTTPConn)
        self.records: list[dict] = []
        self.parse_errors = 0

    def feed(
        self, conn_id, data: bytes, is_request: bool,
        ts_ns: Optional[int] = None,
    ) -> int:
        """Feed one captured chunk; returns records emitted."""
        ts = ts_ns if ts_ns is not None else time.time_ns()
        c = self._conns.get(conn_id, ts)
        req_p, resp_p, pending = c.req, c.resp, c.pending
        emitted = 0
        if is_request:
            for m in req_p.feed(data, ts):
                if len(pending) >= self.PENDING_PER_CONN:
                    # Pairing is positional, so dropping any one entry
                    # would silently mispair every later response on this
                    # connection. Kill the connection instead (the
                    # reference disables a ConnTracker it can no longer
                    # trust): its state is discarded and the drops are
                    # counted; later chunks start a fresh tracker.
                    self.parse_errors += len(pending) + 1
                    self._conns.kill(conn_id)
                    return emitted
                pending.append(m)
        else:
            for m in resp_p.feed(data, ts):
                if not pending:
                    self.parse_errors += 1  # response with no request
                    continue
                req = pending.popleft()
                self.records.append({
                    "time_": req.ts_ns,
                    "latency_ns": max(m.ts_ns - req.ts_ns, 0),
                    "resp_status": m.status,
                    "req_method": req.method,
                    "req_path": req.path,
                    "resp_body_bytes": len(m.body),
                    "service": self.service,
                    "pod": self.pod,
                })
                emitted += 1
        return emitted

    def drain(self) -> list[dict]:
        out, self.records = self.records, []
        return out
