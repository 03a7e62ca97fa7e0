"""Kafka wire-protocol parser + stitcher: captured bytes ->
kafka_events.

Reference parity: the socket tracer's kafka protocol pair
(``src/stirling/source_connectors/socket_tracer/
protocols/kafka/`` — length-prefixed frame decode + correlation-id
matching in its stitcher). Capture arrives as byte chunks from any tap;
partial frames survive across ``feed`` calls.

Protocol essentials (Kafka protocol, public spec):
- Every request/response is a 4-byte big-endian length prefix + body.
- Request body header: api_key (i16), api_version (i16),
  correlation_id (i32), client_id (nullable string: i16 length, -1 =
  null). Flexible versions append tagged fields — ignored here (the
  summary needs only the fixed header).
- Response body header: correlation_id (i32). Responses pair with
  requests BY CORRELATION ID, not position (brokers may interleave
  fetch long-polls with pipelined produces).
"""

from __future__ import annotations

import time
from collections import OrderedDict

from typing import Optional

from .conn_table import ConnectionTable

#: api_key -> name (protocol spec's ApiKeys table; kafka/types.h APIKey).
API_KEYS = {
    0: "Produce", 1: "Fetch", 2: "ListOffsets", 3: "Metadata",
    4: "LeaderAndIsr", 5: "StopReplica", 6: "UpdateMetadata",
    7: "ControlledShutdown", 8: "OffsetCommit", 9: "OffsetFetch",
    10: "FindCoordinator", 11: "JoinGroup", 12: "Heartbeat",
    13: "LeaveGroup", 14: "SyncGroup", 15: "DescribeGroups",
    16: "ListGroups", 17: "SaslHandshake", 18: "ApiVersions",
    19: "CreateTopics", 20: "DeleteTopics", 21: "DeleteRecords",
    22: "InitProducerId", 23: "OffsetForLeaderEpoch", 24: "AddPartitionsToTxn",
    25: "AddOffsetsToTxn", 26: "EndTxn", 27: "WriteTxnMarkers",
    28: "TxnOffsetCommit", 29: "DescribeAcls", 30: "CreateAcls",
    31: "DeleteAcls", 32: "DescribeConfigs", 33: "AlterConfigs",
    34: "AlterReplicaLogDirs", 35: "DescribeLogDirs", 36: "SaslAuthenticate",
    37: "CreatePartitions", 38: "CreateDelegationToken",
    39: "RenewDelegationToken", 40: "ExpireDelegationToken",
    41: "DescribeDelegationToken", 42: "DeleteGroups", 43: "ElectLeaders",
    44: "IncrementalAlterConfigs", 45: "AlterPartitionReassignments",
    46: "ListPartitionReassignments", 47: "OffsetDelete",
    48: "DescribeClientQuotas", 49: "AlterClientQuotas",
    50: "DescribeUserScramCredentials", 51: "AlterUserScramCredentials",
    56: "AlterPartition", 57: "UpdateFeatures", 60: "DescribeCluster",
    61: "DescribeProducers", 65: "DescribeTransactions",
    66: "ListTransactions", 67: "AllocateProducerIds",
}


class _Framer:
    """Incremental 4-byte-length frame splitter for one direction."""

    MAX_FRAME = 8 << 20  # broker default message.max.bytes is ~1MB

    def __init__(self):
        self._buf = b""
        self._skip = 0
        self._skip_head = b""  # first bytes of an oversized frame
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
                out.append((True, self._skip_head))  # (truncated, head)
                continue
            if len(self._buf) < 4:
                break
            ln = int.from_bytes(self._buf[:4], "big", signed=True)
            if ln < 0:
                self._buf = self._buf[1:]  # garbage: resync byte-wise
                continue
            if ln > self.MAX_FRAME:
                # Keep the header bytes (they carry api key/correlation
                # id) and discard the rest incrementally — pairing must
                # survive giant produce batches. Wait for the header to
                # be fully buffered first: entering skip mode off a chunk
                # boundary inside the first 8 body bytes would lose the
                # correlation id.
                head_n = min(ln, 64)
                if len(self._buf) < 4 + head_n:
                    break
                self.oversized += 1
                self._skip_head = self._buf[4:4 + head_n]
                drop = min(4 + ln, len(self._buf))
                self._skip = 4 + ln - drop
                self._buf = self._buf[drop:]
                if self._skip:
                    break
                out.append((True, self._skip_head))
                continue
            if len(self._buf) < 4 + ln:
                break
            out.append((False, self._buf[4:4 + ln]))
            self._buf = self._buf[4 + ln:]
        return out


class _Conn:
    last_ts = 0

    def __init__(self):
        self.req = _Framer()
        self.resp = _Framer()
        # correlation_id -> (api_name, api_version, client_id, ts);
        # insertion-ordered so overflow evicts the oldest.
        self.pending: OrderedDict = OrderedDict()


class KafkaStitcher:
    """Pairs request/response frames by correlation id; emits
    kafka_events records."""

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
            for truncated, body in c.req.feed(data):
                if len(body) < 8:
                    self.parse_errors += 1
                    continue
                api_key = int.from_bytes(body[0:2], "big", signed=True)
                api_ver = int.from_bytes(body[2:4], "big", signed=True)
                cid = int.from_bytes(body[4:8], "big", signed=True)
                client_id = ""
                if len(body) >= 10:
                    cl = int.from_bytes(body[8:10], "big", signed=True)
                    if 0 <= cl <= len(body) - 10:
                        client_id = body[10:10 + cl].decode("utf-8", "replace")
                if api_key not in API_KEYS:
                    self.parse_errors += 1
                    continue  # not kafka / corrupt: don't poison pending
                while len(c.pending) >= self.PENDING_PER_CONN:
                    # Oldest request never got a response (lost capture):
                    # evict rather than kill — correlation ids keep later
                    # pairs valid, unlike positional protocols.
                    c.pending.popitem(last=False)
                    self.parse_errors += 1
                body_note = "<truncated>" if truncated else ""
                c.pending[cid] = (api_key, api_ver, client_id, ts, body_note)
            return emitted
        for truncated, body in c.resp.feed(data):
            if len(body) < 4:
                self.parse_errors += 1
                continue
            cid = int.from_bytes(body[0:4], "big", signed=True)
            req = c.pending.pop(cid, None)
            if req is None:
                self.parse_errors += 1
                continue
            api_key, api_ver, client_id, req_ts, body_note = req
            resp = "<truncated>" if truncated else f"bytes={len(body)}"
            self.records.append({
                "time_": req_ts,
                "req_cmd": api_key,
                "client_id": client_id,
                "req_body": f"{API_KEYS[api_key]} v{api_ver}"
                            + (f" {body_note}" if body_note else ""),
                "resp": resp,
                "latency_ns": max(ts - req_ts, 0),
                "service": self.service,
                "pod": self.pod,
            })
            emitted += 1
        return emitted

    def drain(self) -> list[dict]:
        out, self.records = self.records, []
        return out
