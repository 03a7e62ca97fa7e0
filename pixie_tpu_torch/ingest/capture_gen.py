"""Seeded socket captures of the eleven protocols, for the capture tap.

The capture tap (``tap.py``) reads recorded socket traffic: events of
``{"conn", "dir", "ts", "proto", "data_b64"}``. This module writes such
a recording from a numpy generator, so a test or a run on the card can
feed the tap traffic whose answer is known: every exchange is a request
and its response on one connection (AMQP's ``basic.publish`` is a
request alone), built with the same framing the protocols' stitchers
parse, and each yields exactly one stitched record. A stitched
``latency_ns`` is the response's timestamp minus the request's.

Each protocol's events form one run, in ``PROTOCOLS`` order, so a
transfer whose budget is that run's length parses one protocol.
Connection preambles (the HTTP/2 preface, the PgSQL startup message,
the AMQP protocol header) ride on a connection's first request; a NATS
connection's first exchange is its ``CONNECT`` in verbose mode, so
every later command is answered by ``+OK`` or ``-ERR``.
"""

from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass, field

import numpy as np

PROTOCOLS = ("http", "http2", "dns", "mysql", "pgsql", "redis", "kafka",
             "cql", "nats", "mux", "amqp")

HTTP_METHODS = ("GET", "GET", "GET", "POST", "PUT", "DELETE")
HTTP_PATHS = tuple(f"/api/v1/{r}" for r in (
    "users", "orders", "cart", "items", "search", "login", "logout",
    "checkout", "payments", "reviews", "stock", "ship", "track",
    "profile", "settings", "health"))
#: Mostly 200, as ``replay.gen_http_events``' statuses.
HTTP_STATUSES = (200,) * 92 + (404,) * 4 + (500,) * 3 + (503,)
#: HTTP/2 responses (a request's method is always GET), by their HPACK
#: static-table indices (RFC 7541 appendix A).
H2_STATUS_INDEX = {200: 8, 404: 13, 500: 14}
H2_STATUSES = (200,) * 90 + (404,) * 6 + (500,) * 4
KAFKA_APIS = ((0, 9), (1, 13), (3, 12), (8, 8), (12, 4), (18, 3))
REDIS_CMDS = ("GET", "SET", "INCR", "DEL", "HGETALL")
PG_QUERIES = ("SELECT 1;", "SELECT * FROM orders WHERE id = $1;",
              "UPDATE stock SET n = n - 1;", "BEGIN;", "COMMIT;")
SQL_TABLES = ("orders", "users", "items", "stock")
OP_QUERY, OP_RESULT, OP_ERROR = 0x07, 0x08, 0x00
#: AMQP synchronous methods (class, method) and the reply that answers
#: each; ``basic.publish`` (60, 40) is asynchronous.
AMQP_SYNC = (((50, 10), (50, 11)), ((40, 10), (40, 11)),
             ((60, 70), (60, 72)), ((20, 10), (20, 11)))


@dataclass
class Capture:
    """A recording: the tap's events, the exchanges per protocol (each
    one stitched record), the events in each protocol's run, and for
    HTTP/1 and HTTP/2 what was sent, exchange by exchange (``path``,
    ``status``, ``req_ts``, ``latency_ns``; HTTP/1 also ``method``)."""

    events: list
    exchanges: dict
    runs: dict = field(default_factory=dict)
    truth: dict = field(default_factory=dict)


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def _http_bytes(method: str, path: str, status: int, body: int):
    req = f"{method} {path} HTTP/1.1\r\nHost: svc\r\n\r\n".encode()
    resp = (f"HTTP/1.1 {status} X\r\nContent-Length: {body}\r\n\r\n"
            .encode() + b"x" * body)
    return req, resp


def _h2_frame(ftype: int, flags: int, stream: int, payload: bytes) -> bytes:
    return (len(payload).to_bytes(3, "big") + bytes([ftype, flags])
            + stream.to_bytes(4, "big") + payload)


def _hpack_literal(name: str, value: str) -> bytes:
    nb, vb = name.encode(), value.encode()
    return (b"\x40" + len(nb).to_bytes(1, "big") + nb
            + len(vb).to_bytes(1, "big") + vb)


def _dns(txid: int, name: str, response: bool) -> bytes:
    qname = b"".join(len(p).to_bytes(1, "big") + p.encode()
                     for p in name.split(".")) + b"\x00"
    q = qname + b"\x00\x01\x00\x01"
    if not response:
        return struct.pack(">HHHHHH", txid, 0x0100, 1, 0, 0, 0) + q
    ans = b"\xc0\x0c" + struct.pack(">HHIH", 1, 1, 60, 4) + bytes(
        [10, (txid >> 8) & 255, txid & 255, 1])
    return struct.pack(">HHHHHH", txid, 0x8180, 1, 1, 0, 0) + q + ans


def _my_pkt(seq: int, payload: bytes) -> bytes:
    return len(payload).to_bytes(3, "little") + bytes([seq]) + payload


def _pg_msg(tag: str, body: bytes) -> bytes:
    return tag.encode() + (len(body) + 4).to_bytes(4, "big") + body


def _pg_startup() -> bytes:
    body = (3 << 16).to_bytes(4, "big") + b"user\0app\0\0"
    return (len(body) + 4).to_bytes(4, "big") + body


def _resp_array(*words: str) -> bytes:
    out = f"*{len(words)}\r\n".encode()
    for w in words:
        b = w.encode()
        out += b"$" + str(len(b)).encode() + b"\r\n" + b + b"\r\n"
    return out


def _kafka_req(api_key: int, ver: int, cid: int) -> bytes:
    client = b"app"
    body = (api_key.to_bytes(2, "big") + ver.to_bytes(2, "big")
            + cid.to_bytes(4, "big") + len(client).to_bytes(2, "big")
            + client + b"\x00" * 8)
    return len(body).to_bytes(4, "big") + body


def _kafka_resp(cid: int) -> bytes:
    body = cid.to_bytes(4, "big") + b"\x00" * 8
    return len(body).to_bytes(4, "big") + body


def _cql_frame(opcode: int, stream: int, body: bytes, response: bool) -> bytes:
    v = 4 | (0x80 if response else 0)
    return (bytes([v, 0]) + stream.to_bytes(2, "big", signed=True)
            + bytes([opcode]) + len(body).to_bytes(4, "big") + body)


def _mux_msg(typ: int, tag: int, body: bytes = b"") -> bytes:
    hdr = typ.to_bytes(1, "big", signed=True) + tag.to_bytes(3, "big")
    return (len(hdr) + len(body)).to_bytes(4, "big") + hdr + body


def _amqp_method(channel: int, cid: int, mid: int) -> bytes:
    payload = cid.to_bytes(2, "big") + mid.to_bytes(2, "big") + b"args"
    return (b"\x01" + channel.to_bytes(2, "big")
            + len(payload).to_bytes(4, "big") + payload + b"\xce")


def _exchange_bytes(proto: str, rng, n: int, first: np.ndarray):
    """``n`` (request, response or None) byte pairs of ``proto``;
    ``first[i]`` marks a connection's first exchange."""
    pick = rng.integers(0, 1 << 30, n).tolist()
    out = []
    if proto == "dns":
        for i in range(n):
            name = f"svc-{pick[i] % 64}.ns.svc.cluster.local"
            txid = i & 0xFFFF
            out.append((_dns(txid, name, False), _dns(txid, name, True)))
    elif proto == "mysql":
        for i in range(n):
            t = SQL_TABLES[pick[i] % len(SQL_TABLES)]
            req = _my_pkt(0, b"\x03" + f"SELECT * FROM {t} WHERE id={i}"
                          .encode())
            if pick[i] % 20 == 0:
                resp = _my_pkt(1, b"\xff" + (1064).to_bytes(2, "little")
                               + b"#42000syntax error")
            else:
                resp = _my_pkt(1, b"\x00\x00\x00\x02\x00\x00\x00")
            out.append((req, resp))
    elif proto == "pgsql":
        for i in range(n):
            q = PG_QUERIES[pick[i] % len(PG_QUERIES)]
            req = _pg_msg("Q", q.encode() + b"\0")
            if first[i]:
                req = _pg_startup() + req
            if pick[i] % 25 == 0:
                resp = (_pg_msg("E", b"SERROR\0Msyntax error\0\0")
                        + _pg_msg("Z", b"I"))
            else:
                resp = _pg_msg("C", b"SELECT 1\0") + _pg_msg("Z", b"I")
            out.append((req, resp))
    elif proto == "redis":
        answers = {"GET": b"$1\r\nv\r\n", "SET": b"+OK\r\n",
                   "INCR": b":7\r\n", "DEL": b":1\r\n",
                   "HGETALL": b"*2\r\n$1\r\nf\r\n$1\r\nv\r\n"}
        for i in range(n):
            cmd = REDIS_CMDS[pick[i] % len(REDIS_CMDS)]
            resp = (b"-ERR wrong type\r\n" if pick[i] % 50 == 0
                    else answers[cmd])
            out.append((_resp_array(cmd, f"key{pick[i] % 1000}"), resp))
    elif proto == "kafka":
        for i in range(n):
            key, ver = KAFKA_APIS[pick[i] % len(KAFKA_APIS)]
            out.append((_kafka_req(key, ver, i), _kafka_resp(i)))
    elif proto == "cql":
        for i in range(n):
            sid = i % 32768
            t = SQL_TABLES[pick[i] % len(SQL_TABLES)]
            q = f"SELECT * FROM ks.{t}".encode()
            req = _cql_frame(OP_QUERY, sid, len(q).to_bytes(4, "big") + q
                             + b"\x00\x01\x00", False)
            if pick[i] % 30 == 0:
                msg = b"syntax error"
                body = ((0x2000).to_bytes(4, "big")
                        + len(msg).to_bytes(2, "big") + msg)
                resp = _cql_frame(OP_ERROR, sid, body, True)
            else:
                body = ((2).to_bytes(4, "big") + (1).to_bytes(4, "big")
                        + (1 + pick[i] % 4).to_bytes(4, "big"))
                resp = _cql_frame(OP_RESULT, sid, body, True)
            out.append((req, resp))
    elif proto == "nats":
        for i in range(n):
            if first[i]:
                req = b'CONNECT {"verbose":true}\r\n'
            elif pick[i] % 3 == 0:
                req = f"SUB orders.{pick[i] % 8} {i}\r\n".encode()
            else:
                req = f"PUB orders.{pick[i] % 8} 5\r\nhello\r\n".encode()
            resp = (b"-ERR 'permissions violation'\r\n"
                    if pick[i] % 40 == 0 and not first[i] else b"+OK\r\n")
            out.append((req, resp))
    elif proto == "mux":
        for i in range(n):
            tag = 1 + i % ((1 << 23) - 1)
            if pick[i] % 8 == 0:
                out.append((_mux_msg(65, tag), _mux_msg(-65, tag)))
            else:
                out.append((_mux_msg(2, tag, b"req"),
                            _mux_msg(-2, tag, b"rep")))
    elif proto == "amqp":
        for i in range(n):
            ch = 1 + pick[i] % 4
            if pick[i] % 4 == 0:
                req, resp = _amqp_method(ch, 60, 40), None
            else:
                (rc, rm), (ac, am) = AMQP_SYNC[pick[i] % len(AMQP_SYNC)]
                req, resp = _amqp_method(ch, rc, rm), _amqp_method(ch, ac, am)
            if first[i]:
                req = b"AMQP\x00\x00\x09\x01" + req
            out.append((req, resp))
    else:
        raise ValueError(f"unknown protocol {proto!r}")
    return out


def gen_capture(rng, counts: dict, t0_ns: int = 1_700_000_000 * 10**9,
                span_ns: int = 60_000_000_000, conns: int = 16,
                conn_base: int = 0) -> Capture:
    """A recording of ``counts[proto]`` exchanges of each protocol named
    (``rng`` a ``numpy.random.Generator`` or a seed). Requests are spread
    evenly over ``[t0_ns, t0_ns + span_ns)`` and dealt round-robin to
    ``conns`` connections numbered from ``conn_base``; latencies are
    log-normal around 1 ms. A request at time 0 would read as untimed to
    the HTTP/2 stitcher, so ``t0_ns`` is a wall-clock time."""
    rng = np.random.default_rng(rng)
    events, runs = [], {}
    cap = Capture(events=events, exchanges={}, runs=runs)
    for proto in PROTOCOLS:
        n = int(counts.get(proto, 0))
        if not n:
            continue
        req_ts = t0_ns + (np.arange(n, dtype=np.int64) * span_ns) // n
        lat = np.minimum(rng.lognormal(13.8, 0.6, n), 5e8).astype(np.int64)
        conn = conn_base + np.arange(n, dtype=np.int64) % conns
        first = np.arange(n) < conns
        start = len(events)
        if proto == "http":
            m = rng.integers(0, len(HTTP_METHODS), n)
            p = rng.integers(0, len(HTTP_PATHS), n)
            s = rng.integers(0, len(HTTP_STATUSES), n)
            b = rng.integers(0, 4, n)
            memo: dict = {}
            for i in range(n):
                key = (m[i], p[i], s[i], b[i])
                enc = memo.get(key)
                if enc is None:
                    rq, rs = _http_bytes(HTTP_METHODS[m[i]], HTTP_PATHS[p[i]],
                                         HTTP_STATUSES[s[i]], int(b[i]) * 16)
                    enc = memo[key] = (_b64(rq), _b64(rs))
                c, t = int(conn[i]), int(req_ts[i])
                events.append({"conn": c, "dir": "req", "ts": t,
                               "proto": "http", "data_b64": enc[0]})
                events.append({"conn": c, "dir": "resp",
                               "ts": t + int(lat[i]), "proto": "http",
                               "data_b64": enc[1]})
            cap.truth[proto] = {
                "method": np.asarray(HTTP_METHODS, dtype=object)[m],
                "path": np.asarray(HTTP_PATHS, dtype=object)[p],
                "status": np.asarray(HTTP_STATUSES, dtype=np.int64)[s],
                "req_ts": req_ts, "latency_ns": lat,
            }
        elif proto == "http2":
            p = rng.integers(0, len(HTTP_PATHS), n)
            status = np.asarray(H2_STATUSES, dtype=np.int64)[
                rng.integers(0, len(H2_STATUSES), n)]
            streams: dict = {}
            for i in range(n):
                c, t = int(conn[i]), int(req_ts[i])
                sid = streams[c] = streams.get(c, -1) + 2
                rq = _h2_frame(1, 0x5, sid, b"\x82" + _hpack_literal(
                    ":path", HTTP_PATHS[p[i]]))
                if first[i]:
                    rq = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n" + rq
                rs = _h2_frame(1, 0x5, sid, bytes(
                    [0x80 | H2_STATUS_INDEX[int(status[i])]]))
                events.append({"conn": c, "dir": "req", "ts": t,
                               "proto": proto, "data_b64": _b64(rq)})
                events.append({"conn": c, "dir": "resp",
                               "ts": t + int(lat[i]), "proto": proto,
                               "data_b64": _b64(rs)})
            cap.truth[proto] = {
                "path": np.asarray(HTTP_PATHS, dtype=object)[p],
                "status": status, "req_ts": req_ts, "latency_ns": lat,
            }
        elif proto == "dns":
            for i, (rq, rs) in enumerate(
                    _exchange_bytes(proto, rng, n, first)):
                t = int(req_ts[i])
                events.append({"proto": "dns", "ts": t, "data_b64": _b64(rq)})
                events.append({"proto": "dns", "ts": t + int(lat[i]),
                               "data_b64": _b64(rs)})
        else:
            for i, (rq, rs) in enumerate(
                    _exchange_bytes(proto, rng, n, first)):
                c, t = int(conn[i]), int(req_ts[i])
                events.append({"conn": c, "dir": "req", "ts": t,
                               "proto": proto, "data_b64": _b64(rq)})
                if rs is not None:
                    events.append({"conn": c, "dir": "resp",
                                   "ts": t + int(lat[i]), "proto": proto,
                                   "data_b64": _b64(rs)})
        cap.exchanges[proto] = n
        runs[proto] = len(events) - start
    return cap


def write_jsonl(events, path: str) -> None:
    """The recording as the tap's JSONL file (one event per line)."""
    with open(path, "w") as fh:
        for ev in events:
            fh.write(json.dumps(ev) + "\n")
