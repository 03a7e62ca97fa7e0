"""MySQL wire-protocol parser + stitcher: captured bytes -> mysql_events.

Reference parity: the socket tracer's MySQL protocol pair
(``src/stirling/source_connectors/socket_tracer/
protocols/mysql/parse.cc`` — packet framing + command classification —
and ``stitcher.cc`` — request/response pairing with resultset
consumption). Like the HTTP parser here, capture arrives as byte chunks
from any tap (proxy, pcap export, fixtures) and flows through an
incremental per-connection state machine; partial packets survive
across ``feed`` calls.

Protocol essentials (MySQL client/server protocol, public spec):
- Every packet: 3-byte little-endian payload length + 1-byte sequence
  id, then the payload.
- A client COMMAND packet has sequence id 0; its first payload byte is
  the command code (COM_QUERY=0x03 carries SQL text). Client packets
  with seq > 0 belong to the login/auth handshake and are skipped.
- A response begins with an OK (0x00), ERR (0xff: error code u16 +
  '#' + 5-byte sqlstate + message) or EOF (0xfe, payload < 9 bytes)
  packet, or a column-count packet opening a resultset; a resultset
  runs column definitions then rows, each section closed by EOF (or a
  terminating OK with the DEPRECATE_EOF capability).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from .conn_table import ConnectionTable

# Command codes (protocol constants; mysql/types.h Command enum).
COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_FIELD_LIST = 0x04
COM_PING = 0x0E
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_SEND_LONG_DATA = 0x18
COM_STMT_CLOSE = 0x19
MAX_COMMAND = 0x1F

#: Commands whose body is a single human-readable string.
_STRING_BODY = {COM_QUERY, COM_STMT_PREPARE, COM_INIT_DB, COM_FIELD_LIST}
#: Commands the server never answers (stitcher.cc kNoResponse set).
_NO_RESPONSE = {COM_QUIT, COM_STMT_SEND_LONG_DATA, COM_STMT_CLOSE}

# RespStatus enum values (mysql/types.h RespStatus ordering).
RESP_UNKNOWN = 0
RESP_NONE = 1
RESP_OK = 2
RESP_ERR = 3


class _Framer:
    """Incremental MySQL packet framing for one direction."""

    MAX_BUF = 1 << 20

    def __init__(self):
        self._buf = b""
        self._skip = 0  # bytes of an oversized packet still to discard
        self._skip_head = None  # its first payload byte, when seen
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
                # The oversized packet's place in the stream is marked so
                # the stitcher keeps request/response pairing aligned.
                out.append((None, self._skip_head))
                continue
            if len(self._buf) < 4:
                break
            plen = int.from_bytes(self._buf[:3], "little")
            if 4 + plen > self.MAX_BUF:
                # Protocol allows 16MB packets; discard incrementally —
                # truncating the buffer mid-packet desyncs framing
                # forever. The marker keeps pairing aligned and carries
                # the first payload byte (the command/response head).
                self.oversized += 1
                self._skip_head = self._buf[4] if len(self._buf) > 4 else None
                drop = min(4 + plen, len(self._buf))
                self._skip = 4 + plen - drop
                self._buf = self._buf[drop:]
                if self._skip:
                    break
                out.append((None, self._skip_head))
                continue
            if len(self._buf) < 4 + plen:
                break
            out.append((self._buf[3], self._buf[4:4 + plen]))
            self._buf = self._buf[4 + plen:]
        return out


class _Conn:
    last_ts = 0

    def __init__(self):
        self.req = _Framer()
        self.resp = _Framer()
        self.pending: deque = deque()  # (cmd, body, ts)
        # Resultset consumption state: None = expecting a response head;
        # otherwise {"eofs", "rows", "cols", "defs_seen", "mode"}.
        self.rs = None
        # Prepare-OK definition packets still to consume (None = not in
        # a prepare followup; 0 = defs done, trailing EOF may remain).
        self.prep_skip = None


class MySQLStitcher:
    """Pairs command packets with their responses; emits mysql_events
    records (``stitcher.cc`` ProcessMySQLPackets)."""

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
            for seq, payload in c.req.feed(data):
                if seq is None:
                    # Oversized command packet (e.g. a multi-MB INSERT):
                    # body lost, but the slot must pair with its response.
                    self.parse_errors += 1
                    head = payload
                    cmd = head if head is not None and head <= MAX_COMMAND else COM_QUERY
                    if cmd not in _NO_RESPONSE:
                        c.pending.append((cmd, "<oversized>", ts))
                    continue
                if seq != 0 or not payload:
                    continue  # login/auth handshake continuation
                cmd = payload[0]
                if cmd > MAX_COMMAND:
                    self.parse_errors += 1
                    continue
                body = (
                    payload[1:].decode("utf-8", "replace")
                    if cmd in _STRING_BODY
                    else ""
                )
                if cmd in _NO_RESPONSE:
                    self._emit(cmd, body, ts, ts, RESP_NONE, "")
                    emitted += 1
                    continue
                if len(c.pending) >= self.PENDING_PER_CONN:
                    # Positional pairing: overflow kills the tracker (the
                    # same policy as the HTTP stitcher).
                    self.parse_errors += len(c.pending) + 1
                    self._conns.kill(conn_id)
                    return emitted
                c.pending.append((cmd, body, ts))
            return emitted
        for seq, payload in c.resp.feed(data):
            if seq is None:
                # Oversized response packet: the framer's marker carries
                # the head byte (or None) as ``payload`` — an int, which
                # the state machine must never see. Normalize here: an
                # oversized ERR at head position keeps its classification
                # (huge error messages exist); everything else flows
                # through the payload-None sentinel the handlers treat as
                # "one packet of unknown body" (a row inside a resultset,
                # a definition inside a prepare followup, unknown at head).
                self.parse_errors += 1
                if (
                    c.rs is None and c.prep_skip is None and c.pending
                    and payload == 0xFF
                ):
                    emitted += self._finish(c, ts, RESP_ERR, "<oversized>")
                else:
                    emitted += self._response_packet(c, None, ts)
                continue
            emitted += self._response_packet(c, payload, ts)
        return emitted

    # -- response state machine ----------------------------------------------
    def _response_packet(self, c: _Conn, payload, ts: int) -> int:
        if not c.pending and c.prep_skip is None:
            return 0  # server greeting / unsolicited: connection setup
        if c.prep_skip is not None:
            return self._prepare_followup(c, payload, ts)
        if c.rs is not None:
            return self._resultset_packet(c, payload, ts)
        if payload is None:  # oversized packet where a head was expected
            return self._finish(c, ts, RESP_UNKNOWN, "<oversized>")
        head = payload[0] if payload else -1
        cmd, _body, _rts = c.pending[0]
        if head == 0xFF:
            code = int.from_bytes(payload[1:3], "little") if len(payload) >= 3 else 0
            msg = payload[9:].decode("utf-8", "replace") if len(payload) > 9 else ""
            return self._finish(c, ts, RESP_ERR, f"({code}) {msg}".strip())
        if head == 0x00:
            if cmd == COM_STMT_PREPARE and len(payload) >= 9:
                # Prepare-OK carries num_columns/num_params (u16 each);
                # their definition packets follow and must be consumed or
                # they would be misread as the NEXT command's response.
                n_cols = int.from_bytes(payload[5:7], "little")
                n_params = int.from_bytes(payload[7:9], "little")
                n = self._finish(c, ts, RESP_OK, "")
                if n_cols or n_params:
                    c.prep_skip = n_cols + n_params
                return n
            return self._finish(c, ts, RESP_OK, "")
        if head == 0xFE and len(payload) < 9:
            return self._finish(c, ts, RESP_OK, "")
        if cmd == COM_STMT_PREPARE:
            # Anything else is a protocol surprise — classify unknown.
            return self._finish(c, ts, RESP_UNKNOWN, "")
        # Column-count packet: a resultset begins. The framing mode
        # (classic EOFs vs DEPRECATE_EOF) reveals itself after the
        # definitions: classic sends an EOF there.
        ncols = payload[0] if payload else 0
        c.rs = {"cols": int(ncols), "defs_seen": 0, "eofs": 0, "rows": 0,
                "mode": None}
        return 0

    def _prepare_followup(self, c: _Conn, payload, ts: int) -> int:
        """Consume a Prepare-OK's parameter/column definition packets
        (EOF separators included, in classic framing)."""
        if payload is not None and payload[:1] == b"\xfe" and len(payload) < 9:
            if c.prep_skip <= 0:
                c.prep_skip = None  # trailing EOF closed the last section
            return 0
        if c.prep_skip is not None and c.prep_skip > 0:
            c.prep_skip -= 1
            if c.prep_skip == 0:
                # Definitions done; a trailing EOF may still follow (and
                # is absorbed above); anything else re-enters normally.
                c.prep_skip = 0
            return 0
        # prep_skip exhausted and a non-EOF packet arrived: this packet
        # belongs to the next response — reprocess it.
        c.prep_skip = None
        return self._response_packet(c, payload, ts)

    def _resultset_packet(self, c: _Conn, payload, ts: int) -> int:
        rs = c.rs
        if payload is None:  # oversized packet: count as one row/def
            if rs["defs_seen"] < rs["cols"]:
                rs["defs_seen"] += 1
            else:
                rs["rows"] += 1
            return 0
        head = payload[0] if payload else -1
        if head == 0xFF:
            code = int.from_bytes(payload[1:3], "little") if len(payload) >= 3 else 0
            msg = payload[9:].decode("utf-8", "replace") if len(payload) > 9 else ""
            return self._finish(c, ts, RESP_ERR, f"({code}) {msg}".strip())
        in_defs = rs["defs_seen"] < rs["cols"]
        if head == 0xFE and len(payload) < 9:
            # An EOF right after the definitions marks classic framing
            # (defs EOF + rows EOF); the second one ends the resultset.
            if rs["mode"] is None:
                rs["mode"] = "classic"
            rs["eofs"] += 1
            if rs["eofs"] >= 2 or rs["mode"] == "deprecate_eof":
                return self._finish(
                    c, ts, RESP_OK, f"Resultset rows={rs['rows']}"
                )
            return 0
        if (
            head == 0xFE and not in_defs and len(payload) < 32
            and rs["mode"] != "classic"
        ):
            # DEPRECATE_EOF (MySQL >= 5.7.5 default): rows end with an
            # OK packet whose header byte is 0xFE. Distinguished from a
            # data row by its short length (heuristic — the capability
            # flags live in the handshake, which taps often miss);
            # classic mode never takes this branch (its explicit final
            # EOF is authoritative).
            return self._finish(
                c, ts, RESP_OK, f"Resultset rows={rs['rows']}"
            )
        if in_defs:
            rs["defs_seen"] += 1
            if rs["defs_seen"] == rs["cols"]:
                # Next packet decides the framing mode: EOF = classic,
                # a row = DEPRECATE_EOF.
                pass
        else:
            if rs["mode"] is None:
                rs["mode"] = "deprecate_eof"
            rs["rows"] += 1
        return 0

    def _finish(self, c: _Conn, ts: int, status: int, resp_body: str) -> int:
        c.rs = None
        if not c.pending:
            return 0
        cmd, body, req_ts = c.pending.popleft()
        self._emit(cmd, body, req_ts, ts, status, resp_body)
        return 1

    def _emit(self, cmd, body, req_ts, resp_ts, status, resp_body):
        self.records.append({
            "time_": req_ts,
            "req_cmd": int(cmd),
            "query_str": body,
            "resp_status": int(status),
            "resp_body": resp_body,
            "latency_ns": max(resp_ts - req_ts, 0),
            "service": self.service,
            "pod": self.pod,
        })

    def drain(self) -> list[dict]:
        out, self.records = self.records, []
        return out
