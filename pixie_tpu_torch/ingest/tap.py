"""Capture-tap connector: recorded socket captures -> protocol tables.

Reference parity: the socket tracer's transfer pipeline
(``src/stirling/source_connectors/socket_tracer/
socket_trace_connector.cc`` TransferData: drain per-connection capture
buffers through protocol parsers/stitchers into the protocol tables).
The capture source here is a recorded tap — a JSONL file or an
in-memory feed of ``{"conn": id, "dir": "req"|"resp", "ts": ns,
"proto": <protocol>, "data_b64": ...}`` events (what a sidecar proxy or
pcap exporter produces) — pushed through the same incremental
per-protocol parsers/stitchers into the canonical event tables. All 11
reference protocols are covered: http (+http2 into the same
http_events), dns, mysql, pgsql, redis, kafka, cql, nats, mux, amqp.
A copy of the JAX package's ``ingest/tap.py``; its stitchers are copies
of the JAX package's parsers, with the same state machines.
"""

from __future__ import annotations

import base64
import json
from typing import Iterable, Optional

from ..types.dtypes import DataType
from .core import SourceConnector
from .amqp_parser import AMQPStitcher
from .cql_parser import CQLStitcher
from .dns_parser import DNSStitcher
from .http2_parser import HTTP2Stitcher
from .http_parser import HTTPStitcher
from .kafka_parser import KafkaStitcher
from .mux_parser import MuxStitcher
from .mysql_parser import MySQLStitcher
from .nats_parser import NATSStitcher
from .pgsql_parser import PgSQLStitcher
from .redis_parser import RedisStitcher
from .schemas import (
    AMQP_EVENTS_RELATION,
    CQL_EVENTS_RELATION,
    DNS_EVENTS_RELATION,
    HTTP_EVENTS_RELATION,
    KAFKA_EVENTS_RELATION,
    MUX_EVENTS_RELATION,
    MYSQL_EVENTS_RELATION,
    NATS_EVENTS_RELATION,
    PGSQL_EVENTS_RELATION,
    REDIS_EVENTS_RELATION,
)


class CaptureTapConnector(SourceConnector):
    """Feeds capture events through protocol stitchers into tables."""

    name = "capture_tap"
    tables = [
        ("http_events", HTTP_EVENTS_RELATION),
        ("dns_events", DNS_EVENTS_RELATION),
        ("mysql_events", MYSQL_EVENTS_RELATION),
        ("pgsql_events", PGSQL_EVENTS_RELATION),
        ("redis_events", REDIS_EVENTS_RELATION),
        ("kafka_events.beta", KAFKA_EVENTS_RELATION),
        ("cql_events", CQL_EVENTS_RELATION),
        ("nats_events.beta", NATS_EVENTS_RELATION),
        ("mux_events", MUX_EVENTS_RELATION),
        ("amqp_events", AMQP_EVENTS_RELATION),
    ]

    def __init__(self, feed: Optional[Iterable] = None, path: str = "",
                 service: str = "", pod: str = "", **kw):
        super().__init__(**kw)
        self._feed = iter(feed) if feed is not None else None
        self._path = path
        self._fh = None
        self.http = HTTPStitcher(service=service, pod=pod)
        self.http2 = HTTP2Stitcher(service=service, pod=pod)
        self.dns = DNSStitcher(pod=pod)
        self.mysql = MySQLStitcher(service=service, pod=pod)
        self.pgsql = PgSQLStitcher(service=service, pod=pod)
        self.redis = RedisStitcher(service=service, pod=pod)
        self.kafka = KafkaStitcher(service=service, pod=pod)
        self.cql = CQLStitcher(service=service, pod=pod)
        self.nats = NATSStitcher(service=service, pod=pod)
        self.mux = MuxStitcher(service=service, pod=pod)
        self.amqp = AMQPStitcher(service=service, pod=pod)
        self.upid_value = 0

    def init(self) -> None:
        super().init()
        if self._path:
            self._fh = open(self._path)

    def stop(self) -> None:
        super().stop()
        if self._fh:
            self._fh.close()
            self._fh = None

    def _events(self, budget: int):
        if self._fh is not None:
            for _ in range(budget):
                line = self._fh.readline()
                if not line:
                    return
                if line.strip():
                    yield json.loads(line)
            return
        if self._feed is not None:
            for _ in range(budget):
                try:
                    yield next(self._feed)
                except StopIteration:
                    return

    def transfer_data(self, ctx, data_tables, budget: int = 4096) -> None:
        for ev in self._events(budget):
            data = base64.b64decode(ev["data_b64"])
            proto = ev.get("proto", "http")
            if proto == "dns":
                self.dns.feed(data, ts_ns=ev.get("ts"))
            elif proto in ("mysql", "pgsql", "redis", "kafka", "cql",
                           "nats", "mux", "amqp", "http2"):
                stitcher = getattr(self, proto)
                stitcher.feed(
                    ev.get("conn", 0), data,
                    is_request=(ev.get("dir", "req") == "req"),
                    ts_ns=ev.get("ts"),
                )
            else:
                self.http.feed(
                    ev.get("conn", 0), data,
                    is_request=(ev.get("dir", "req") == "req"),
                    ts_ns=ev.get("ts"),
                )
        # HTTP/1 and HTTP/2 land in the same canonical table.
        http_recs = self.http.drain() + self.http2.drain()
        if http_recs:
            cols = {
                k: [r[k] for r in http_recs]
                for k in ("time_", "latency_ns", "resp_status", "req_path",
                          "service")
            }
            # Canonical http_events columns the stitcher does not carry.
            n = len(http_recs)
            full = {name: cols.get(name) for name, _ in
                    HTTP_EVENTS_RELATION.items() if name in cols}
            for name, _dt in HTTP_EVENTS_RELATION.items():
                if name in full and full[name] is not None:
                    continue
                full[name] = self._default_column(name, n, http_recs)
            data_tables["http_events"].append(full)
        for table, rel, recs in (
            ("dns_events", DNS_EVENTS_RELATION, self.dns.drain()),
            ("mysql_events", MYSQL_EVENTS_RELATION, self.mysql.drain()),
            ("pgsql_events", PGSQL_EVENTS_RELATION, self.pgsql.drain()),
            ("redis_events", REDIS_EVENTS_RELATION, self.redis.drain()),
            ("kafka_events.beta", KAFKA_EVENTS_RELATION, self.kafka.drain()),
            ("cql_events", CQL_EVENTS_RELATION, self.cql.drain()),
            ("nats_events.beta", NATS_EVENTS_RELATION, self.nats.drain()),
            ("mux_events", MUX_EVENTS_RELATION, self.mux.drain()),
            ("amqp_events", AMQP_EVENTS_RELATION, self.amqp.drain()),
        ):
            if not recs:
                continue
            n = len(recs)
            full = {}
            for name, dt in rel.items():
                if name == "upid":
                    full[name] = [self.upid_value] * n
                else:
                    dflt = "" if dt == DataType.STRING else 0
                    full[name] = [r.get(name, dflt) for r in recs]
            data_tables[table].append(full)

    def _default_column(self, name: str, n: int, recs):
        if name == "upid":
            return [self.upid_value] * n
        if name in ("req_method",):
            return [r.get("req_method", "") for r in recs]
        if name in ("req_body", "resp_body"):
            return [""] * n
        if name == "resp_body_size":
            return [r.get("resp_body_bytes", 0) for r in recs]
        if name in ("remote_addr", "pod"):
            return [r.get("pod", "") for r in recs]
        return [0] * n
