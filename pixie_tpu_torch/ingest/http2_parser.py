"""HTTP/2 wire-protocol parser: captured bytes -> http_events records.

Reference parity: the socket tracer's http2 protocol
(``src/stirling/source_connectors/socket_tracer/
protocols/http2/`` — which does NOT parse wire HPACK at all: it attaches
uprobes inside Go/gRPC runtimes and reads the ALREADY-DECODED header
fields, because its kernel capture cannot see through TLS). This parser
handles the plaintext/h2c + decrypted-tap case the capture-tap feeds:
real frame framing and real HPACK header decoding (static + dynamic
tables, integer/string literals). Huffman-coded string literals decode
to the ``<huffman>`` placeholder — a documented limitation, one step
past the reference's no-wire-parsing baseline.

Protocol essentials (RFC 7540/7541, public spec):
- Client connection preface: ``PRI * HTTP/2.0\\r\\n\\r\\nSM\\r\\n\\r\\n``.
- Every frame: length (u24 BE), type (u8), flags (u8), R + stream id
  (u31 BE), payload.
- HEADERS (+ CONTINUATION until END_HEADERS) carry an HPACK block;
  requests use :method/:path pseudo-headers, responses :status.
  Requests pair with responses BY STREAM ID.
"""

from __future__ import annotations

import time
from typing import Optional

from .conn_table import ConnectionTable

_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

F_DATA, F_HEADERS, F_PRIORITY, F_RST, F_SETTINGS = 0, 1, 2, 3, 4
F_PUSH, F_PING, F_GOAWAY, F_WINDOW, F_CONT = 5, 6, 7, 8, 9
FLAG_END_STREAM, FLAG_END_HEADERS, FLAG_PADDED, FLAG_PRIORITY = 1, 4, 8, 0x20

#: RFC 7541 Appendix A static table (1-based).
_STATIC = [
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""), ("access-control-allow-origin", ""),
    ("age", ""), ("allow", ""), ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""), ("content-location", ""),
    ("content-range", ""), ("content-type", ""), ("cookie", ""), ("date", ""),
    ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""),
    ("if-range", ""), ("if-unmodified-since", ""), ("last-modified", ""),
    ("link", ""), ("location", ""), ("max-forwards", ""),
    ("proxy-authenticate", ""), ("proxy-authorization", ""), ("range", ""),
    ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""), ("via", ""),
    ("www-authenticate", ""),
]


class HPACKDecoder:
    """Per-direction HPACK decoding context (RFC 7541)."""

    def __init__(self, max_size: int = 4096):
        self.dynamic: list[tuple[str, str]] = []
        self.max_size = max_size
        self.size = 0

    def _entry(self, idx: int):
        if 1 <= idx <= len(_STATIC):
            return _STATIC[idx - 1]
        d = idx - len(_STATIC) - 1
        if 0 <= d < len(self.dynamic):
            return self.dynamic[d]
        raise ValueError(f"HPACK index {idx} out of range")

    def _add(self, name: str, value: str):
        self.dynamic.insert(0, (name, value))
        self.size += len(name) + len(value) + 32
        while self.size > self.max_size and self.dynamic:
            n, v = self.dynamic.pop()
            self.size -= len(n) + len(v) + 32

    @staticmethod
    def _int(data: bytes, pos: int, prefix: int):
        mask = (1 << prefix) - 1
        v = data[pos] & mask
        pos += 1
        if v < mask:
            return v, pos
        shift = 0
        while pos < len(data):
            b = data[pos]
            pos += 1
            v += (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        return v, pos

    def _string(self, data: bytes, pos: int):
        huffman = bool(data[pos] & 0x80)
        n, pos = self._int(data, pos, 7)
        raw = data[pos:pos + n]
        pos += n
        if huffman:
            # Huffman decoding needs the RFC 7541 Appendix B code table;
            # keep framing/table state exact and surface a placeholder.
            return "<huffman>", pos
        return raw.decode("utf-8", "replace"), pos

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        out = []
        pos = 0
        while pos < len(block):
            b = block[pos]
            if b & 0x80:  # indexed
                idx, pos = self._int(block, pos, 7)
                out.append(self._entry(idx))
            elif b & 0x40:  # literal with incremental indexing
                idx, pos = self._int(block, pos, 6)
                name = self._entry(idx)[0] if idx else None
                if name is None:
                    name, pos = self._string(block, pos)
                value, pos = self._string(block, pos)
                self._add(name, value)
                out.append((name, value))
            elif b & 0x20:  # dynamic table size update
                self.max_size, pos = self._int(block, pos, 5)
                while self.size > self.max_size and self.dynamic:
                    n, v = self.dynamic.pop()
                    self.size -= len(n) + len(v) + 32
            else:  # literal without indexing / never indexed
                idx, pos = self._int(block, pos, 4)
                name = self._entry(idx)[0] if idx else None
                if name is None:
                    name, pos = self._string(block, pos)
                value, pos = self._string(block, pos)
                out.append((name, value))
        return out


class _Framer:
    MAX_BODY = 4 << 20

    def __init__(self, client_side: bool):
        self._buf = b""
        self._preface_done = not client_side
        self._skip = 0
        self._skip_hdr = None
        self.oversized = 0

    def feed(self, data: bytes):
        """Yield (type, flags, stream, payload|None) frames."""
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
            if not self._preface_done:
                if _PREFACE.startswith(self._buf[:len(_PREFACE)]):
                    # Partial preface prefix: wait for the rest before
                    # deciding (a 2-byte first chunk must not misparse).
                    if len(self._buf) < len(_PREFACE):
                        break
                    self._buf = self._buf[len(_PREFACE):]
                self._preface_done = True
                continue
            if len(self._buf) < 9:
                break
            ln = int.from_bytes(self._buf[:3], "big")
            ftype = self._buf[3]
            flags = self._buf[4]
            stream = int.from_bytes(self._buf[5:9], "big") & 0x7FFFFFFF
            if ftype > F_CONT:
                self._buf = self._buf[1:]  # garbage: resync byte-wise
                continue
            if ln > self.MAX_BODY:
                self.oversized += 1
                self._skip_hdr = (ftype, flags, stream)
                drop = min(9 + ln, len(self._buf))
                self._skip = 9 + ln - drop
                self._buf = self._buf[drop:]
                if self._skip:
                    break
                out.append((*self._skip_hdr, None))
                continue
            if len(self._buf) < 9 + ln:
                break
            out.append((ftype, flags, stream, self._buf[9:9 + ln]))
            self._buf = self._buf[9 + ln:]
        return out


def _strip_headers_payload(flags: int, payload: bytes) -> bytes:
    """Remove padding/priority sections from a HEADERS payload."""
    pos = 0
    pad = 0
    if flags & FLAG_PADDED and len(payload) > 0:
        pad = payload[0]
        pos = 1
    if flags & FLAG_PRIORITY:
        pos += 5
    end = len(payload) - pad
    return payload[pos:max(pos, end)]


class _Stream:
    __slots__ = ("method", "path", "req_ts", "status", "body_bytes")

    def __init__(self):
        self.method = ""
        self.path = ""
        self.req_ts = 0
        self.status = 0
        self.body_bytes = 0


class _Conn:
    last_ts = 0

    def __init__(self):
        self.req = _Framer(client_side=True)
        self.resp = _Framer(client_side=False)
        self.req_hpack = HPACKDecoder()
        self.resp_hpack = HPACKDecoder()
        self.streams: dict[int, _Stream] = {}
        # CONTINUATION accumulation per direction: (stream, flags, block)
        self.frag: dict[bool, tuple] = {}


class HTTP2Stitcher:
    """Pairs request/response HEADERS by stream id; emits http_events
    records (the HTTPStitcher record shape, so the tap merges both)."""

    MAX_STREAMS = 1024

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
        for ftype, flags, stream, payload in framer.feed(data):
            if payload is None:
                self.parse_errors += 1
                continue
            if ftype == F_RST:
                # Cancelled stream (gRPC deadline-exceeded etc.): drop
                # its state so it can't linger to the MAX_STREAMS cap.
                c.streams.pop(stream, None)
                continue
            if ftype == F_DATA and not is_request:
                st = c.streams.get(stream)
                if st is not None:
                    st.body_bytes += len(payload)
                    if flags & FLAG_END_STREAM:
                        emitted += self._finish(c, stream, ts)
                continue
            if ftype not in (F_HEADERS, F_CONT):
                continue
            if ftype == F_HEADERS:
                block = _strip_headers_payload(flags, payload)
            else:
                prev = c.frag.pop(is_request, None)
                if prev is None or prev[0] != stream:
                    self.parse_errors += 1
                    continue
                block = prev[2] + payload
                flags |= prev[1] & FLAG_END_STREAM
            if not flags & FLAG_END_HEADERS:
                c.frag[is_request] = (stream, flags, block)
                continue
            dec = c.req_hpack if is_request else c.resp_hpack
            try:
                headers = dict(dec.decode(block))
            except (ValueError, IndexError):
                self.parse_errors += 1
                continue
            if is_request:
                if len(c.streams) >= self.MAX_STREAMS:
                    c.streams.pop(next(iter(c.streams)))
                    self.parse_errors += 1
                st = c.streams.setdefault(stream, _Stream())
                st.method = headers.get(":method", "")
                st.path = headers.get(":path", "")
                st.req_ts = ts
            else:
                st = c.streams.get(stream)
                if st is None:
                    self.parse_errors += 1
                    continue
                try:
                    st.status = int(headers.get(":status", "0"))
                except ValueError:
                    st.status = 0
                if flags & FLAG_END_STREAM:
                    emitted += self._finish(c, stream, ts)
        return emitted

    def _finish(self, c: _Conn, stream: int, ts: int) -> int:
        st = c.streams.pop(stream, None)
        if st is None:
            return 0
        self.records.append({
            "time_": st.req_ts or ts,
            "req_method": st.method,
            "req_path": st.path,
            "resp_status": st.status,
            "resp_body_bytes": st.body_bytes,
            "latency_ns": max(ts - st.req_ts, 0) if st.req_ts else 0,
            "service": self.service,
            "pod": self.pod,
        })
        return 1

    def drain(self) -> list[dict]:
        out, self.records = self.records, []
        return out
