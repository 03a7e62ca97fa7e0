"""Mux (Twitter Finagle) wire-protocol parser: captured bytes ->
mux_events.

Reference parity: the socket tracer's mux protocol
(``src/stirling/source_connectors/socket_tracer/
protocols/mux/`` and ``mux_table.h`` kMuxElements: req_type + latency).

Protocol essentials (Mux protocol, public Finagle spec):
- Every message: u32 big-endian length, then a 1-byte SIGNED type and a
  3-byte tag; the remaining (length - 4) bytes are the body.
- Transmit types are positive (Tdispatch=2, Treq=1, Tping=65,
  Tdiscarded=66, Tlease=67, Tinit=68, ...); the matching reply is the
  NEGATED type (Rdispatch=-2, Rping=-65, ...). Requests pair with
  replies BY TAG (concurrent dispatches multiplex one connection).
- Tag 0 is reserved; Tlease/Tdiscarded are one-way.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Optional

from .conn_table import ConnectionTable

#: type value -> name (mux spec; mux/types.h Type enum).
TYPES = {
    1: "Treq", 2: "Tdispatch", 64: "Tdrain", 65: "Tping", 66: "Tdiscarded",
    67: "Tlease", 68: "Tinit", 127: "Rerr",
}
#: Special encodings outside the +T/-R pairing: old-style Rerr (127),
#: modern Rerr (-128), and old-style Tdiscarded (-62 — a TRANSMIT type
#: despite the sign).
_SPECIAL = {127, -128, -62}
_ONE_WAY = {66, 67}  # Tdiscarded / Tlease have no reply


class _Framer:
    MAX_BODY = 4 << 20

    def __init__(self):
        self._buf = b""
        self._skip = 0
        self._skip_hdr = None
        self.oversized = 0

    def feed(self, data: bytes):
        """Yield (type, tag) headers (bodies are not needed for the
        event table; oversized bodies skip incrementally)."""
        self._buf += data
        out = []
        while True:
            if self._skip:
                drop = min(self._skip, len(self._buf))
                self._buf = self._buf[drop:]
                self._skip -= drop
                if self._skip:
                    break
                out.append(self._skip_hdr)
                continue
            if len(self._buf) < 8:
                break
            ln = int.from_bytes(self._buf[:4], "big")
            if ln < 4:
                self._buf = self._buf[1:]  # garbage: resync byte-wise
                continue
            typ = int.from_bytes(self._buf[4:5], "big", signed=True)
            tag = int.from_bytes(self._buf[5:8], "big")
            if abs(typ) not in TYPES and typ not in _SPECIAL:
                self._buf = self._buf[1:]
                continue
            if ln > self.MAX_BODY:
                self.oversized += 1
                self._skip_hdr = (typ, tag)
                drop = min(4 + ln, len(self._buf))
                self._skip = 4 + ln - drop
                self._buf = self._buf[drop:]
                if self._skip:
                    break
                out.append(self._skip_hdr)
                continue
            if len(self._buf) < 4 + ln:
                break
            out.append((typ, tag))
            self._buf = self._buf[4 + ln:]
        return out


class _Conn:
    last_ts = 0

    def __init__(self):
        self.req = _Framer()
        self.resp = _Framer()
        self.pending: OrderedDict = OrderedDict()  # tag -> (type, ts)


class MuxStitcher:
    """Pairs Tmsg/Rmsg by tag; emits mux_events records."""

    PENDING_PER_CONN = 512

    def __init__(self, service: str = "", pod: str = ""):
        self.service = service
        self.pod = pod
        self._conns = ConnectionTable(_Conn)
        self.records: list[dict] = []
        self.parse_errors = 0

    def feed(self, conn_id, data: bytes, is_request: bool,
             ts_ns: Optional[int] = None) -> int:
        ts = ts_ns if ts_ns is not None else time.time_ns()
        c = self._conns.get(conn_id, ts)
        emitted = 0
        if is_request:
            for typ, tag in c.req.feed(data):
                if typ == -62:
                    typ = 66  # old-style Tdiscarded: one-way transmit
                if typ <= 0:
                    self.parse_errors += 1
                    continue
                if typ in _ONE_WAY:
                    self._emit(typ, ts, ts)
                    emitted += 1
                    continue
                while len(c.pending) >= self.PENDING_PER_CONN:
                    c.pending.popitem(last=False)
                    self.parse_errors += 1
                c.pending[tag] = (typ, ts)
            return emitted
        for typ, tag in c.resp.feed(data):
            # Replies are negated transmit types; Rerr arrives as -128
            # (modern) or 127 (old-style) and still answers its tag.
            if typ >= 0 and typ != 127:
                self.parse_errors += 1
                continue
            req = c.pending.pop(tag, None)
            if req is None:
                self.parse_errors += 1
                continue
            req_type, req_ts = req
            self._emit(req_type, req_ts, ts)
            emitted += 1
        return emitted

    def _emit(self, req_type, req_ts, resp_ts):
        self.records.append({
            "time_": req_ts,
            "req_type": int(req_type),
            "latency_ns": max(resp_ts - req_ts, 0),
            "service": self.service,
            "pod": self.pod,
        })

    def drain(self) -> list[dict]:
        out, self.records = self.records, []
        return out
