"""AMQP 0-9-1 wire-protocol parser: captured bytes -> amqp_events.

Reference parity: the socket tracer's amqp protocol scaffolding
(``src/stirling/source_connectors/socket_tracer/
protocols/amqp/types.h`` — frame types kMethod/kHeader/kBody/
kHeartbeat). The reference's table is still WIP; this emits
method-level events with synchronous-method latency pairing, the shape
its other protocol tables share.

Protocol essentials (AMQP 0-9-1, public spec):
- Connection opens with the literal ``AMQP\\x00\\x00\\x09\\x01``.
- Every frame: type (1: method, 2: header, 3: body, 8: heartbeat),
  channel (u16 BE), payload size (u32 BE), payload, 0xCE frame-end.
- A method payload starts class-id (u16) + method-id (u16). Synchronous
  methods (queue.declare, basic.get, ...) are answered on the SAME
  channel by their ``*-ok`` counterpart; basic.publish/deliver are
  asynchronous (no reply).
"""

from __future__ import annotations

import time
from typing import Optional

from .conn_table import ConnectionTable

_PREAMBLE = b"AMQP\x00\x00\x09\x01"
FRAME_METHOD, FRAME_HEADER, FRAME_BODY, FRAME_HEARTBEAT = 1, 2, 3, 8

#: (class_id, method_id) -> name (spec §1.1 class/method tables).
METHODS = {
    (10, 10): "connection.start", (10, 11): "connection.start-ok",
    (10, 30): "connection.tune", (10, 31): "connection.tune-ok",
    (10, 40): "connection.open", (10, 41): "connection.open-ok",
    (10, 50): "connection.close", (10, 51): "connection.close-ok",
    (20, 10): "channel.open", (20, 11): "channel.open-ok",
    (20, 20): "channel.flow", (20, 21): "channel.flow-ok",
    (20, 40): "channel.close", (20, 41): "channel.close-ok",
    (40, 10): "exchange.declare", (40, 11): "exchange.declare-ok",
    (40, 20): "exchange.delete", (40, 21): "exchange.delete-ok",
    (50, 10): "queue.declare", (50, 11): "queue.declare-ok",
    (50, 20): "queue.bind", (50, 21): "queue.bind-ok",
    (50, 30): "queue.purge", (50, 31): "queue.purge-ok",
    (50, 40): "queue.delete", (50, 41): "queue.delete-ok",
    (50, 50): "queue.unbind", (50, 51): "queue.unbind-ok",
    (60, 10): "basic.qos", (60, 11): "basic.qos-ok",
    (60, 20): "basic.consume", (60, 21): "basic.consume-ok",
    (60, 30): "basic.cancel", (60, 31): "basic.cancel-ok",
    (60, 40): "basic.publish", (60, 50): "basic.return",
    (60, 60): "basic.deliver",
    (60, 70): "basic.get", (60, 71): "basic.get-ok",
    (60, 72): "basic.get-empty",
    (60, 80): "basic.ack", (60, 90): "basic.reject",
    (60, 110): "basic.recover", (60, 111): "basic.recover-ok",
    (85, 10): "confirm.select", (85, 11): "confirm.select-ok",
    (90, 10): "tx.select", (90, 11): "tx.select-ok",
    (90, 20): "tx.commit", (90, 21): "tx.commit-ok",
    (90, 30): "tx.rollback", (90, 31): "tx.rollback-ok",
}
#: Async methods never awaited (publish/deliver/ack...).
_ASYNC = {(60, 40), (60, 50), (60, 60), (60, 80), (60, 90)}


class _Framer:
    MAX_BODY = 4 << 20

    def __init__(self):
        self._buf = b""
        self._preamble_done = False
        self._skip = 0
        self.oversized = 0

    def feed(self, data: bytes):
        """Yield (frame_type, channel, class_id, method_id) — method ids
        are (0, 0) for non-method frames."""
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
            if not self._preamble_done:
                if _PREAMBLE.startswith(self._buf[:len(_PREAMBLE)]):
                    # Buffer is a (possibly partial) preamble prefix:
                    # wait for the rest before deciding.
                    if len(self._buf) < len(_PREAMBLE):
                        break
                    self._buf = self._buf[len(_PREAMBLE):]
                self._preamble_done = True
                continue
            if len(self._buf) < 7:
                break
            ftype = self._buf[0]
            channel = int.from_bytes(self._buf[1:3], "big")
            size = int.from_bytes(self._buf[3:7], "big")
            if ftype not in (FRAME_METHOD, FRAME_HEADER, FRAME_BODY,
                             FRAME_HEARTBEAT):
                self._buf = self._buf[1:]  # garbage: resync byte-wise
                continue
            if size > self.MAX_BODY:
                # Oversized body frame: header info is enough to emit.
                self.oversized += 1
                out.append((ftype, channel, 0, 0))
                drop = min(7 + size + 1, len(self._buf))
                self._skip = 7 + size + 1 - drop
                self._buf = self._buf[drop:]
                continue
            if len(self._buf) < 7 + size + 1:
                break
            payload = self._buf[7:7 + size]
            self._buf = self._buf[7 + size + 1:]  # +1: 0xCE frame end
            if ftype == FRAME_METHOD and len(payload) >= 4:
                cid = int.from_bytes(payload[0:2], "big")
                mid = int.from_bytes(payload[2:4], "big")
                out.append((ftype, channel, cid, mid))
            else:
                out.append((ftype, channel, 0, 0))
        return out


class _Conn:
    last_ts = 0

    def __init__(self):
        self.req = _Framer()
        self.resp = _Framer()
        # channel -> (class_id, method_id, ts) awaiting its *-ok.
        self.pending: dict = {}


class AMQPStitcher:
    """Emits method events; synchronous methods pair with their -ok
    reply on the same channel for latency."""

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
        framer = c.req if is_request else c.resp
        emitted = 0
        for ftype, channel, cid, mid in framer.feed(data):
            if ftype != FRAME_METHOD:
                continue  # header/body/heartbeat frames carry no event
            name = METHODS.get((cid, mid), f"class{cid}.method{mid}")
            if is_request:
                if (cid, mid) in _ASYNC or (cid, mid) not in METHODS:
                    self._emit(channel, name, ts, 0)
                    emitted += 1
                else:
                    prev = c.pending.pop(channel, None)
                    if prev is not None:
                        # Unanswered sync method (lost capture): emit it.
                        self._emit(channel, prev[2], prev[3], 0)
                        emitted += 1
                        self.parse_errors += 1
                    c.pending[channel] = (cid, mid, name, ts)
            else:
                req = c.pending.get(channel)
                if req is not None and mid in (req[1] + 1, req[1] + 2):
                    # *-ok (and basic.get-empty = get + 2) answers it.
                    del c.pending[channel]
                    self._emit(channel, req[2], req[3],
                               max(ts - req[3], 0), resp=name)
                    emitted += 1
                else:
                    # Server-initiated method (deliver, close, start...).
                    self._emit(channel, name, ts, 0)
                    emitted += 1
        return emitted

    def _emit(self, channel, method, ts, latency, resp: str = ""):
        self.records.append({
            "time_": ts,
            "channel": int(channel),
            "method": method,
            "resp": resp,
            "latency_ns": int(latency),
            "service": self.service,
            "pod": self.pod,
        })

    def drain(self) -> list[dict]:
        out, self.records = self.records, []
        return out
