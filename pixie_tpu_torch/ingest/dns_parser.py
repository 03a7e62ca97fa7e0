"""DNS wire-format parser: raw UDP payloads -> dns_events records.

Reference parity: the socket tracer's DNS protocol parser
(``src/stirling/source_connectors/socket_tracer/
protocols/dns/parse.cc``): decode the 12-byte header + question/answer
sections (with name compression), pair queries to responses by
transaction id, and emit records whose header/body columns are the JSON
encodings the reference's dns_events table carries.
"""

from __future__ import annotations

import json
import struct
import time
from typing import Optional

_HDR = struct.Struct(">HHHHHH")

_QTYPE = {1: "A", 2: "NS", 5: "CNAME", 6: "SOA", 12: "PTR", 15: "MX",
          16: "TXT", 28: "AAAA", 33: "SRV", 255: "ANY"}


class DNSParseError(ValueError):
    pass


def _read_name(buf: bytes, off: int, depth: int = 0) -> tuple[str, int]:
    """Decode a (possibly compressed) domain name; returns (name, next)."""
    if depth > 16:
        raise DNSParseError("compression loop")
    labels = []
    while True:
        if off >= len(buf):
            raise DNSParseError("truncated name")
        n = buf[off]
        if n == 0:
            return ".".join(labels), off + 1
        if n & 0xC0 == 0xC0:  # compression pointer
            if off + 1 >= len(buf):
                raise DNSParseError("truncated pointer")
            ptr = ((n & 0x3F) << 8) | buf[off + 1]
            name, _ = _read_name(buf, ptr, depth + 1)
            labels.append(name)
            return ".".join(labels), off + 2
        off += 1
        labels.append(buf[off:off + n].decode("latin-1"))
        off += n


def parse_dns(payload: bytes) -> dict:
    """One UDP message -> {txid, is_response, rcode, queries, answers}."""
    if len(payload) < _HDR.size:
        raise DNSParseError("short header")
    txid, flags, qd, an, _ns, _ar = _HDR.unpack_from(payload, 0)
    off = _HDR.size
    queries = []
    for _ in range(qd):
        name, off = _read_name(payload, off)
        if off + 4 > len(payload):
            raise DNSParseError("truncated question")
        qtype, _qclass = struct.unpack_from(">HH", payload, off)
        off += 4
        queries.append({"name": name, "type": _QTYPE.get(qtype, str(qtype))})
    answers = []
    for _ in range(an):
        name, off = _read_name(payload, off)
        if off + 10 > len(payload):
            raise DNSParseError("truncated answer")
        rtype, _rc, _ttl, rdlen = struct.unpack_from(">HHIH", payload, off)
        off += 10
        rdata = payload[off:off + rdlen]
        off += rdlen
        ans = {"name": name, "type": _QTYPE.get(rtype, str(rtype))}
        if rtype == 1 and rdlen == 4:
            ans["addr"] = ".".join(str(b) for b in rdata)
        elif rtype == 28 and rdlen == 16:
            ans["addr"] = rdata.hex()
        answers.append(ans)
    return {
        "txid": txid,
        "is_response": bool(flags & 0x8000),
        "rcode": flags & 0x000F,
        "queries": queries,
        "answers": answers,
    }


class DNSStitcher:
    """Pairs queries with responses by transaction id; emits dns_events
    records (header/body JSON columns, the reference table's encoding)."""

    # Unanswered queries expire after this long (the reference socket
    # tracer similarly ages out connection-tracker state); the map is also
    # hard-capped so a txid flood can't grow it without bound.
    PENDING_TTL_NS = 30 * 1_000_000_000
    PENDING_MAX = 4096

    def __init__(self, pod: str = ""):
        self.pod = pod
        self._pending: dict[int, tuple[dict, int]] = {}
        self.records: list[dict] = []
        self.parse_errors = 0

    def _expire(self, now_ns: int) -> None:
        cutoff = now_ns - self.PENDING_TTL_NS
        if len(self._pending) > 64:
            self._pending = {
                txid: v for txid, v in self._pending.items() if v[1] >= cutoff
            }
        while len(self._pending) >= self.PENDING_MAX:
            self._pending.pop(next(iter(self._pending)))

    def feed(self, payload: bytes, ts_ns: Optional[int] = None) -> int:
        ts = ts_ns if ts_ns is not None else time.time_ns()
        try:
            msg = parse_dns(payload)
        except DNSParseError:
            self.parse_errors += 1
            return 0
        if not msg["is_response"]:
            self._expire(ts)
            self._pending[msg["txid"]] = (msg, ts)
            return 0
        req = self._pending.pop(msg["txid"], None)
        if req is None:
            self.parse_errors += 1
            return 0
        req_msg, req_ts = req
        self.records.append({
            "time_": req_ts,
            "req_header": json.dumps({"txid": msg["txid"]}),
            "req_body": json.dumps({"queries": req_msg["queries"]}),
            "resp_header": json.dumps({"rcode": msg["rcode"]}),
            "resp_body": json.dumps({"answers": msg["answers"]}),
            "latency_ns": max(ts - req_ts, 0),
            "pod": self.pod,
        })
        return 1

    def drain(self) -> list[dict]:
        out, self.records = self.records, []
        return out
