"""Protocol-name translation UDFs (device-side id tables).

Reference parity: ``src/carnot/funcs/protocols/protocol_ops.{h,cc}`` —
``ProtocolNameUDF`` (the conn_stats ``protocol`` enum,
``src/shared/protocols/protocols.h:28``), ``HTTPRespMessageUDF``,
``MySQLCommandNameUDF``, ``KafkaAPIKeyNameUDF``.

Each is an int -> name mapping, so the device applies one gather
through an id table whose output dictionary holds the names (no host
round trip per row). A copy of the JAX package's
``udf/builtins/protocol_ops.py``: the same vocabularies, the same ids,
the same truncation of the code to int32 before the range check. The
dense tables go to a device once and stay there.
"""

from __future__ import annotations

import numpy as np
import torch

from ...types.strings import StringDictionary
from ..udf import INT64, STRING, device_constant

# shared/protocols/protocols.h enum order (ids ARE dictionary ids).
PROTOCOL_NAMES = (
    "Unknown", "HTTP", "HTTP2", "MySQL", "CQL", "PGSQL", "DNS", "Redis",
    "NATS", "Mongo", "Kafka", "Mux", "AMQP", "TLS",
)

HTTP_RESP_MESSAGES = {
    100: "Continue", 101: "Switching Protocols", 102: "Processing",
    103: "Early Hints",
    200: "OK", 201: "Created", 202: "Accepted",
    203: "Non-Authoritative Information", 204: "No Content",
    205: "Reset Content", 206: "Partial Content", 207: "Multi-Status",
    208: "Already Reported", 226: "IM Used",
    300: "Multiple Choices", 301: "Moved Permanently", 302: "Found",
    303: "See Other", 304: "Not Modified", 305: "Use Proxy",
    307: "Temporary Redirect", 308: "Permanent Redirect",
    400: "Bad Request", 401: "Unauthorized", 402: "Payment Required",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    406: "Not Acceptable", 407: "Proxy Authentication Required",
    408: "Request Timeout", 409: "Conflict", 410: "Gone",
    411: "Length Required", 412: "Precondition Failed",
    413: "Payload Too Large", 414: "URI Too Long",
    415: "Unsupported Media Type", 416: "Range Not Satisfiable",
    417: "Expectation Failed", 418: "I'm a teapot",
    421: "Misdirected Request", 422: "Unprocessable Entity",
    423: "Locked", 424: "Failed Dependency", 425: "Too Early",
    426: "Upgrade Required", 428: "Precondition Required",
    429: "Too Many Requests", 431: "Request Header Fields Too Large",
    451: "Unavailable For Legal Reasons",
    500: "Internal Server Error", 501: "Not Implemented",
    502: "Bad Gateway", 503: "Service Unavailable",
    504: "Gateway Timeout", 505: "HTTP Version Not Supported",
    506: "Variant Also Negotiates", 507: "Insufficient Storage",
    508: "Loop Detected", 510: "Not Extended",
    511: "Network Authentication Required",
}

MYSQL_COMMANDS = (
    "Sleep", "Quit", "InitDB", "Query", "FieldList", "CreateDB", "DropDB",
    "Refresh", "Shutdown", "Statistics", "ProcessInfo", "Connect",
    "ProcessKill", "Debug", "Ping", "Time", "DelayedInsert", "ChangeUser",
    "BinlogDump", "TableDump", "ConnectOut", "RegisterSlave",
    "StmtPrepare", "StmtExecute", "StmtSendLongData", "StmtClose",
    "StmtReset", "SetOption", "StmtFetch", "Daemon", "BinlogDumpGTID",
    "ResetConnection",
)

KAFKA_API_KEYS = (
    "Produce", "Fetch", "ListOffsets", "Metadata", "LeaderAndIsr",
    "StopReplica", "UpdateMetadata", "ControlledShutdown", "OffsetCommit",
    "OffsetFetch", "FindCoordinator", "JoinGroup", "Heartbeat",
    "LeaveGroup", "SyncGroup", "DescribeGroups", "ListGroups",
    "SaslHandshake", "ApiVersions", "CreateTopics", "DeleteTopics",
    "DeleteRecords", "InitProducerId", "OffsetForLeaderEpoch",
    "AddPartitionsToTxn", "AddOffsetsToTxn", "EndTxn", "WriteTxnMarkers",
    "TxnOffsetCommit", "DescribeAcls", "CreateAcls", "DeleteAcls",
    "DescribeConfigs", "AlterConfigs", "AlterReplicaLogDirs",
    "DescribeLogDirs", "SaslAuthenticate", "CreatePartitions",
    "CreateDelegationToken", "RenewDelegationToken",
    "ExpireDelegationToken", "DescribeDelegationToken", "DeleteGroups",
    "ElectLeaders", "IncrementalAlterConfigs", "AlterPartitionReassignments",
    "ListPartitionReassignments", "OffsetDelete", "DescribeClientQuotas",
    "AlterClientQuotas", "DescribeUserScramCredentials",
    "AlterUserScramCredentials",
)


def _i32(x) -> int:
    """A Python int truncated to int32 the way a tensor cast wraps."""
    return (int(x) + (1 << 31)) % (1 << 32) - (1 << 31)


def _enum_table_udf(names, unknown="Unknown"):
    """(fn, out_dict) mapping int ids -> dictionary ids via clamp."""
    # Enum ids ARE dictionary ids — only true while names are unique
    # (StringDictionary dedups, which would shift every later id).
    assert len(set(names)) == len(names), "duplicate enum name"
    vocab = list(names)
    if unknown not in vocab:
        vocab.append(unknown)
    d = StringDictionary(vocab)
    unk = d.lookup(unknown)
    n = len(names)

    def fn(x):
        if not isinstance(x, torch.Tensor):
            x32 = _i32(x)
            return x32 if 0 <= x32 < n else unk
        x32 = x.to(torch.int32)
        return torch.where((x32 >= 0) & (x32 < n), x32, unk).to(torch.int32)

    return fn, d


def _dense_table_udf(mapping, size, unknown="Unknown"):
    """(fn, out_dict) for sparse int -> name maps via a dense id table."""
    vocab = sorted(set(mapping.values())) + [unknown]
    d = StringDictionary(vocab)
    table = np.full(size + 1, d.lookup(unknown), dtype=np.int32)
    for code, name in mapping.items():
        table[code] = d.lookup(name)
    on_device = device_constant(table)

    def fn(x):
        if not isinstance(x, torch.Tensor):
            x32 = _i32(x)
            return int(table[x32]) if 0 <= x32 <= size else int(table[size])
        x32 = x.to(torch.int32)
        safe = torch.clamp(x32, 0, size)
        ids = on_device(x.device)[safe.long()]
        return torch.where(x32 == safe, ids, int(table[size])).to(torch.int32)

    return fn, d


def register(reg):
    fn, d = _enum_table_udf(PROTOCOL_NAMES)
    reg.scalar("protocol_name", (INT64,), STRING, fn, out_dict=d,
               doc="conn_stats protocol enum -> protocol name.")
    fn, d = _dense_table_udf(HTTP_RESP_MESSAGES, 599)
    reg.scalar("http_resp_message", (INT64,), STRING, fn, out_dict=d,
               doc="HTTP status code -> reason phrase.")
    fn, d = _enum_table_udf(MYSQL_COMMANDS)
    reg.scalar("mysql_command_name", (INT64,), STRING, fn, out_dict=d,
               doc="MySQL command byte -> command name.")
    fn, d = _enum_table_udf(KAFKA_API_KEYS)
    reg.scalar("kafka_api_key_name", (INT64,), STRING, fn, out_dict=d,
               doc="Kafka API key -> API name.")
