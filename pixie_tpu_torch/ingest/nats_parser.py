"""NATS wire-protocol parser: captured bytes -> nats_events.beta.

Reference parity: the socket tracer's nats protocol
(``src/stirling/source_connectors/socket_tracer/
protocols/nats/`` and ``nats_table.h`` kNATSElements: cmd / body /
resp). Capture arrives as byte chunks from any tap; partial commands
survive across ``feed`` calls.

Protocol essentials (NATS client protocol, public spec):
- Text commands terminated by CRLF: CONNECT {json}, INFO {json},
  SUB <subject> [queue] <sid>, UNSUB <sid> [max], PING, PONG,
  +OK, -ERR 'message'.
- PUB <subject> [reply-to] <#bytes>\\r\\n<payload>\\r\\n and the server's
  MSG <subject> <sid> [reply-to] <#bytes>\\r\\n<payload>\\r\\n carry a
  length-prefixed binary payload after the command line (HPUB/HMSG add
  a headers section; the total-size field still bounds the skip).
- Responses (+OK/-ERR) appear only in verbose mode and apply to the
  PREVIOUS client command; the reference emits one event per command
  with the response attached when present.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Optional

from .conn_table import ConnectionTable

_PAYLOAD_CMDS = {"PUB", "MSG", "HPUB", "HMSG"}
_MAX_SHOWN_PAYLOAD = 128
_MAX_BUF = 1 << 20


class _Framer:
    """Incremental NATS command framing for one direction."""

    def __init__(self):
        self._buf = b""
        self._skip = 0  # payload bytes of an oversized message to drop
        self._skip_cmd = None
        self.oversized = 0

    def feed(self, data: bytes):
        """Yield (cmd, args_line, payload|None) tuples."""
        self._buf += data
        out = []
        while True:
            if self._skip:
                drop = min(self._skip, len(self._buf))
                self._buf = self._buf[drop:]
                self._skip -= drop
                if self._skip:
                    break
                out.append((self._skip_cmd[0], self._skip_cmd[1], None))
                continue
            end = self._buf.find(b"\r\n")
            if end < 0:
                if len(self._buf) > _MAX_BUF:
                    self._buf = b""  # unparseable garbage: resync-drop
                break
            line = self._buf[:end]
            head, _, rest = line.partition(b" ")
            cmd = head.decode("latin-1").upper()
            if cmd in _PAYLOAD_CMDS:
                parts = rest.split()
                try:
                    nbytes = int(parts[-1])
                except (ValueError, IndexError):
                    self._buf = self._buf[end + 2:]
                    continue
                total = end + 2 + nbytes + 2
                if nbytes > _MAX_BUF:
                    self.oversized += 1
                    self._skip_cmd = (cmd, rest.decode("utf-8", "replace"))
                    drop = min(total, len(self._buf))
                    self._skip = total - drop
                    self._buf = self._buf[drop:]
                    if self._skip:
                        break
                    out.append((cmd, self._skip_cmd[1], None))
                    continue
                if len(self._buf) < total:
                    break
                payload = self._buf[end + 2:end + 2 + nbytes]
                self._buf = self._buf[total:]
                out.append((cmd, rest.decode("utf-8", "replace"), payload))
                continue
            self._buf = self._buf[end + 2:]
            out.append((cmd, rest.decode("utf-8", "replace"), b""))
        return out


def _body(cmd: str, args: str, payload) -> str:
    """JSON body the reference's nats events carry (options + payload)."""
    fields: dict = {}
    parts = args.split()
    # Size-field count per command: PUB/MSG end with <#bytes>; the
    # headers variants end with <#header-bytes> <#total-bytes> — the
    # reply-to presence test must skip the right number of trailers.
    n_sizes = 2 if cmd in ("HPUB", "HMSG") else 1
    if cmd in ("PUB", "HPUB") and parts:
        fields["subject"] = parts[0]
        if len(parts) > 1 + n_sizes:
            fields["reply_to"] = parts[1]
    elif cmd in ("MSG", "HMSG") and len(parts) >= 2:
        fields["subject"] = parts[0]
        fields["sid"] = parts[1]
        if len(parts) > 2 + n_sizes:
            fields["reply_to"] = parts[2]
    elif cmd == "SUB" and parts:
        fields["subject"] = parts[0]
        fields["sid"] = parts[-1]
        if len(parts) == 3:
            fields["queue_group"] = parts[1]
    elif cmd == "UNSUB" and parts:
        fields["sid"] = parts[0]
    elif cmd in ("CONNECT", "INFO"):
        try:
            fields = json.loads(args)
        except ValueError:
            fields = {"raw": args[:256]}
    if payload is None:
        fields["payload"] = "<oversized>"
    elif payload:
        fields["payload"] = payload[:_MAX_SHOWN_PAYLOAD].decode(
            "utf-8", "replace"
        )
    return json.dumps(fields, sort_keys=True)


class NATSStitcher:
    """Emits one nats event per command; verbose-mode +OK/-ERR attach to
    the preceding client command (nats stitcher semantics)."""

    PENDING_PER_CONN = 64
    #: A held command older than this is assumed unanswered (non-verbose
    #: server) and emitted with no response — pending survives drain()
    #: so a +OK arriving in the NEXT capture batch still pairs.
    PENDING_TTL_NS = 1_000_000_000

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
        # Age out held commands whose verbose-mode reply never came.
        while c.pending and ts - c.pending[0]["time_"] > self.PENDING_TTL_NS:
            self.records.append(c.pending.popleft())
            emitted += 1
        for cmd, args, payload in framer.feed(data):
            if cmd in ("+OK", "-ERR") and not is_request:
                # Attach to the oldest unanswered client command.
                if c.pending:
                    rec = c.pending.popleft()
                    rec["resp"] = "OK" if cmd == "+OK" else f"ERR {args}"
                    rec["latency_ns"] = max(ts - rec["time_"], 0)
                    self.records.append(rec)
                    emitted += 1
                else:
                    self.parse_errors += 1
                continue
            if not cmd or (cmd[0] not in "+-" and not cmd.isalpha()):
                self.parse_errors += 1
                continue
            rec = {
                "time_": ts,
                "cmd": cmd,
                "body": _body(cmd, args, payload),
                "resp": "",
                "latency_ns": 0,
                "service": self.service,
                "pod": self.pod,
            }
            if is_request and cmd == "CONNECT":
                # The CONNECT options say whether the server will answer
                # commands at all (verbose mode); non-verbose connections
                # never hold.
                try:
                    c.verbose = bool(json.loads(args).get("verbose", True))
                except ValueError:
                    pass
                if c.verbose is False:
                    while c.pending:
                        self.records.append(c.pending.popleft())
                        emitted += 1
            if (
                is_request
                and c.verbose is not False
                and cmd in ("CONNECT", "PUB", "HPUB", "SUB", "UNSUB")
            ):
                # May receive a verbose-mode +OK/-ERR; hold briefly.
                if len(c.pending) >= self.PENDING_PER_CONN:
                    self.records.append(c.pending.popleft())
                    emitted += 1
                c.pending.append(rec)
            else:
                self.records.append(rec)
                emitted += 1
        return emitted

    def drain(self) -> list[dict]:
        """Completed records only: in-flight held commands stay pending
        (the tap drains every transfer cycle — a +OK in the next batch
        must still pair; the feed-time TTL bounds how long they wait)."""
        out, self.records = self.records, []
        return out


class _Conn:
    last_ts = 0

    def __init__(self):
        self.req = _Framer()
        self.resp = _Framer()
        self.pending: deque = deque()
        self.verbose = None  # unknown until CONNECT (None = hold)
