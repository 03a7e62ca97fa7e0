"""Canonical output-table schemas shipped by the ingest edge.

Reference parity: Stirling's static table schemas —
``src/stirling/source_connectors/socket_tracer/http_table.h`` /
``conn_stats_table.h`` (kConnStatsElements),
``perf_profiler/stack_traces_table.h`` (kStackTraceTable),
``mysql_table.h``, ``source_connectors/process_stats``. These are the
relations a PEM creates at registration (``pem_manager.cc:86-104``
InitSchemas) and the contract the shipped PxL script library compiles
against (``src/e2e_test/vizier/planner/dump_schemas``).

The k8s-context columns (``service``/``pod``) are materialized at
ingest time — Stirling fills them from AgentMetadataState during
TransferData — so group-bys hit dictionary ids directly. A copy of the
JAX package's ``ingest/schemas.py``, with its own http_events relation
(the JAX package keeps that one beside its replay generator).
"""

from __future__ import annotations

from ..types.dtypes import DataType
from ..types.relation import Relation

# socket_tracer http_table.h (+ materialized k8s context).
HTTP_EVENTS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("remote_addr", DataType.STRING),
        ("req_method", DataType.STRING),
        ("req_path", DataType.STRING),
        ("resp_status", DataType.INT64),
        ("resp_body_size", DataType.INT64),
        ("latency_ns", DataType.INT64),
        ("service", DataType.STRING),
        ("pod", DataType.STRING),
    ]
)

# conn_stats_table.h kConnStatsElements (+ materialized k8s context).
CONN_STATS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("remote_addr", DataType.STRING),
        ("remote_port", DataType.INT64),
        ("trace_role", DataType.INT64),
        ("addr_family", DataType.INT64),
        ("protocol", DataType.INT64),
        ("ssl", DataType.BOOLEAN),
        ("conn_open", DataType.INT64),
        ("conn_close", DataType.INT64),
        ("conn_active", DataType.INT64),
        ("bytes_sent", DataType.INT64),
        ("bytes_recv", DataType.INT64),
        ("src_addr", DataType.STRING),
        ("src_pod", DataType.STRING),
    ]
)

# stack_traces_table.h kStackTraceTable ("stack_traces.beta").
STACK_TRACES_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("stack_trace_id", DataType.INT64),
        ("stack_trace", DataType.STRING),
        ("count", DataType.INT64),
        ("pod", DataType.STRING),
    ]
)

# mysql_table.h kMySQLTable (subset: the sql_stats script surface).
MYSQL_EVENTS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("req_cmd", DataType.INT64),
        ("query_str", DataType.STRING),  # req_body in the reference
        ("resp_status", DataType.INT64),
        ("latency_ns", DataType.INT64),
        ("service", DataType.STRING),
    ]
)

# pgsql_table.h kPGSQLTable (subset; req_cmd is the protocol verb).
PGSQL_EVENTS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("req_cmd", DataType.STRING),
        ("req", DataType.STRING),
        ("resp", DataType.STRING),
        ("latency_ns", DataType.INT64),
        ("service", DataType.STRING),
    ]
)

# process_stats connector (proc-fs metrics).
PROCESS_STATS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("major_faults", DataType.INT64),
        ("minor_faults", DataType.INT64),
        ("cpu_utime_ns", DataType.INT64),
        ("cpu_ktime_ns", DataType.INT64),
        ("rss_bytes", DataType.INT64),
        ("vsize_bytes", DataType.INT64),
        ("rchar_bytes", DataType.INT64),
        ("wchar_bytes", DataType.INT64),
        ("read_bytes", DataType.INT64),
        ("write_bytes", DataType.INT64),
        ("pod", DataType.STRING),
    ]
)

# network_stats connector (per-pod RX/TX).
NETWORK_STATS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("pod_id", DataType.STRING),
        ("rx_bytes", DataType.INT64),
        ("rx_packets", DataType.INT64),
        ("rx_errors", DataType.INT64),
        ("rx_drops", DataType.INT64),
        ("tx_bytes", DataType.INT64),
        ("tx_packets", DataType.INT64),
        ("tx_errors", DataType.INT64),
        ("tx_drops", DataType.INT64),
        ("pod", DataType.STRING),
    ]
)

# redis_table.h kRedisTable (subset; +service context).
REDIS_EVENTS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("req_cmd", DataType.STRING),
        ("req_args", DataType.STRING),
        ("resp", DataType.STRING),
        ("latency_ns", DataType.INT64),
        ("service", DataType.STRING),
    ]
)

# kafka_table.h kKafkaTable ("kafka_events.beta" in the reference;
# req_cmd is the APIKey enum value).
KAFKA_EVENTS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("req_cmd", DataType.INT64),
        ("client_id", DataType.STRING),
        ("req_body", DataType.STRING),
        ("resp", DataType.STRING),
        ("latency_ns", DataType.INT64),
        ("service", DataType.STRING),
    ]
)

# cass_table.h kCQLTable (subset; req_op/resp_op are protocol opcodes).
CQL_EVENTS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("req_op", DataType.INT64),
        ("req_body", DataType.STRING),
        ("resp_op", DataType.INT64),
        ("resp_body", DataType.STRING),
        ("latency_ns", DataType.INT64),
        ("service", DataType.STRING),
    ]
)

# nats_table.h kNATSTable ("nats_events.beta": cmd/body/resp).
NATS_EVENTS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("cmd", DataType.STRING),
        ("body", DataType.STRING),
        ("resp", DataType.STRING),
        ("latency_ns", DataType.INT64),
        ("service", DataType.STRING),
    ]
)

# mux_table.h kMuxTable (req_type enum + latency).
MUX_EVENTS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("req_type", DataType.INT64),
        ("latency_ns", DataType.INT64),
        ("service", DataType.STRING),
    ]
)

# AMQP method events (reference protocols/amqp is WIP — this is the
# method-level shape its sibling tables share).
AMQP_EVENTS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("channel", DataType.INT64),
        ("method", DataType.STRING),
        ("resp", DataType.STRING),
        ("latency_ns", DataType.INT64),
        ("service", DataType.STRING),
    ]
)

# proc_stat_connector.h kElements (system-wide CPU split, sampled by
# diffing the aggregate cpu jiffies line of /proc/stat).
PROC_STAT_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("system_percent", DataType.FLOAT64),
        ("user_percent", DataType.FLOAT64),
        ("idle_percent", DataType.FLOAT64),
    ]
)

# pid_runtime_connector.h kTable — the reference keeps the BPF-era name
# "bcc_pid_cpu_usage" for the table even though the gauge is generic.
PID_RUNTIME_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("pid", DataType.INT64),
        ("runtime_ns", DataType.INT64),
        ("cmd", DataType.STRING),
    ]
)

# proc_exit_events_table.h kProcExitEventsTable.
PROC_EXIT_EVENTS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("exit_code", DataType.INT64),
        ("signal", DataType.INT64),
        ("comm", DataType.STRING),
    ]
)

# stirling_error_table.h kStirlingErrorElements (self-observability:
# connector install status + runtime collection errors).
STIRLING_ERROR_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("source_connector", DataType.STRING),
        ("status", DataType.INT64),
        ("error", DataType.STRING),
    ]
)

# -- self-observability tables (services/telemetry.py) -----------------------
# The engine's OWN telemetry as queryable tables: the TelemetryCollector
# folds finished query traces + resource records into these, so bundled
# PxL scripts (px/slow_queries, px/query_cost, px/agent_health) run over
# the system's history through the normal engine path. Reference analog:
# Stirling's stirling_error self-monitoring table, generalized to the
# whole query lifecycle.

# One row per finished query/fragment trace; time_ = trace end.
QUERIES_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("trace_id", DataType.STRING),
        ("qid", DataType.STRING),  # distributed query id ("" = local)
        # Admitting tenant (services/tenancy.py registered set; "" =
        # not a tenant-scoped query) — per-tenant cost/latency rollups
        # run over this column.
        ("tenant", DataType.STRING),
        ("agent_id", DataType.STRING),
        ("kind", DataType.STRING),  # query|stream|fragment|merge|distributed
        ("script_hash", DataType.STRING),
        ("script", DataType.STRING),  # first 200 chars
        ("status", DataType.STRING),
        ("duration_ms", DataType.FLOAT64),
        ("rows_in", DataType.INT64),
        ("rows_out", DataType.INT64),
        ("windows", DataType.INT64),
        ("bytes_staged", DataType.INT64),
        ("device_ms", DataType.FLOAT64),
        ("compile_ms", DataType.FLOAT64),
        ("stall_ms", DataType.FLOAT64),
        ("wire_bytes", DataType.INT64),
        ("retries", DataType.INT64),
        ("skipped_windows", DataType.INT64),
        # Device-tier additions: observed high-water device bytes while
        # the query ran (0 on stat-less backends), and the pxbound
        # PREDICTED cost stamped at plan time (0 = unknown/sketch-less)
        # — observed and predicted side by side is what lets
        # px/bound_accuracy compute the calibration ratio per script
        # hash, closing the arXiv:2102.02440 feedback loop.
        ("device_peak_bytes", DataType.INT64),
        ("predicted_bytes", DataType.INT64),
        ("predicted_rows", DataType.INT64),
        # Storage-tier staleness: query stop-time minus the max event-
        # time watermark of the scanned tables at execute time (worst
        # table; max across agents for distributed queries). 0 = fully
        # fresh OR no time-indexed scan — the exact validity predicate
        # a result cache keyed on (script hash, table watermark) checks.
        ("freshness_lag_ms", DataType.FLOAT64),
        # Result-cache disposition: hit|miss|stale|bypass|view ("" =
        # cache not in play — disabled, or a fragment/merge trace).
        # px/cache_stats rolls hit rates per script hash over this.
        ("cache", DataType.STRING),
    ]
)

# One row per trace span (bounded per trace); time_ = span start.
SPANS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("trace_id", DataType.STRING),
        ("span_id", DataType.STRING),
        ("parent_id", DataType.STRING),
        ("name", DataType.STRING),
        ("agent_id", DataType.STRING),
        ("duration_ms", DataType.FLOAT64),
    ]
)

# Cumulative-counter snapshots of the process program registry
# (exec/programs.py): one row per tracked XLA program whose state
# changed since the previous fold — the LATEST row per program_id is
# its current state (compiles/hits are monotonic). flops/bytes come
# from XLA cost_analysis(), the byte columns from memory_analysis();
# all 0 when the backend reports nothing (timing-only records).
PROGRAMS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("agent_id", DataType.STRING),
        ("program_id", DataType.STRING),
        ("kind", DataType.STRING),  # fragment_update|join_probe_sorted|...
        ("label", DataType.STRING),  # op chain / join strategy summary
        ("compiles", DataType.INT64),
        ("hits", DataType.INT64),
        ("compile_ms", DataType.FLOAT64),
        ("flops", DataType.FLOAT64),
        ("bytes_accessed", DataType.FLOAT64),
        ("argument_bytes", DataType.INT64),
        ("temp_bytes", DataType.INT64),
        ("peak_bytes", DataType.INT64),
    ]
)

# Storage-tier snapshots (services/telemetry.py TableStatsCollector):
# one row per (agent, table) whose stats CHANGED since the collector's
# previous fold — heartbeat cadence + every finished trace. The
# *_total columns are monotonic (latest row per (agent_id, table) is
# current state; cluster merges sum them across agents), `watermark`
# is the max event-time ns ever appended (never regresses; cluster
# merges take the max), live sizes (rows/bytes/...) are gauges.
# Reference analog: the table stats every agent heartbeat ships
# (``table_store.h`` GetTableStats -> agent heartbeat proto).
TABLES_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("agent_id", DataType.STRING),
        ("table", DataType.STRING),
        ("rows", DataType.INT64),  # live rows
        ("bytes", DataType.INT64),  # live bytes (hot + cold)
        ("hot_bytes", DataType.INT64),
        ("cold_bytes", DataType.INT64),  # encoded cold-store bytes
        ("hot_rows", DataType.INT64),  # pxtier split (0s untiered)
        ("cold_rows", DataType.INT64),
        ("cold_raw_bytes", DataType.INT64),  # pre-encoding widths
        ("cold_demotions_total", DataType.INT64),
        ("cold_evictions_total", DataType.INT64),
        ("device_bytes", DataType.INT64),  # HBM-resident staged windows
        ("rows_total", DataType.INT64),  # rows ever appended
        ("bytes_total", DataType.INT64),
        ("expired_rows_total", DataType.INT64),
        ("expired_bytes_total", DataType.INT64),
        ("watermark", DataType.INT64),  # max event-time ns (-1 = none)
        ("min_time", DataType.INT64),  # oldest live event-time ns
        ("last_append", DataType.INT64),  # unix ns of latest append
        ("ingest_rows_per_s", DataType.FLOAT64),  # per-append EWMA
    ]
)

# Profiling tier (ingest/profiler.py): one row per (folded stack,
# attribution) key drained each push period. ``stack_trace`` is the
# flamegraph-folded ``outermost;...;innermost`` string; ``count`` is
# samples at the profiler's period (100Hz default — CPU-seconds =
# count * period). qid/script_hash/tenant come from the thread
# attribution registry (exec/threadmap.py) at sample time ("" =
# unattributed — idle daemons, bus plumbing); ``phase`` splits
# host vs device_dispatch vs stall vs stage so flame roots show
# where the wall time actually went.
STACKS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("agent_id", DataType.STRING),
        ("stack_trace_id", DataType.INT64),
        ("stack_trace", DataType.STRING),
        ("count", DataType.INT64),
        ("qid", DataType.STRING),
        ("script_hash", DataType.STRING),
        ("tenant", DataType.STRING),
        ("phase", DataType.STRING),
    ]
)

# One row per finished trace: the folding agent's running totals (the
# latest row per agent_id is its current health snapshot).
AGENTS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("agent_id", DataType.STRING),
        ("kind", DataType.STRING),  # pem|kelvin|engine|broker
        ("queries_total", DataType.INT64),
        ("errors_total", DataType.INT64),
        ("bytes_staged_total", DataType.INT64),
        ("device_ms_total", DataType.FLOAT64),
        ("wire_bytes_total", DataType.INT64),
    ]
)

# Transport tier (services/busstats.py): one cumulative-counter row
# per changed (kind, topic_class/peer, direction) key each heartbeat
# fold. ``kind`` is bus (in-process fan-out; topic_class label),
# net (wire frames; the key column carries the peer), or rpc
# (request/reply; key = peer, lag quantiles = RTT). Counters are
# monotonic — ``px.max`` per key recovers the latest fold (the
# px/bus_health / px/rpc_latency idiom).
BUS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("agent_id", DataType.STRING),
        ("kind", DataType.STRING),  # bus|net|rpc
        ("topic_class", DataType.STRING),  # peer for net/rpc rows
        ("direction", DataType.STRING),  # pub|deliver|send|recv|conn|request
        ("msgs", DataType.INT64),
        ("bytes", DataType.INT64),
        ("errors", DataType.INT64),
        ("lag_p50_ms", DataType.FLOAT64),
        ("lag_p99_ms", DataType.FLOAT64),
        ("service_p50_ms", DataType.FLOAT64),
        ("service_p99_ms", DataType.FLOAT64),
        ("queue_high_water", DataType.INT64),
    ]
)

#: {table: Relation} for the self-telemetry tables.
TELEMETRY_SCHEMAS: dict[str, "Relation"] = {
    "__queries__": QUERIES_RELATION,
    "__spans__": SPANS_RELATION,
    "__agents__": AGENTS_RELATION,
    "__programs__": PROGRAMS_RELATION,
    "__tables__": TABLES_RELATION,
    "__stacks__": STACKS_RELATION,
    "__bus__": BUS_RELATION,
}

# dns_table.h kDNSTable (subset).
DNS_EVENTS_RELATION = Relation(
    [
        ("time_", DataType.TIME64NS),
        ("upid", DataType.UINT128),
        ("req_header", DataType.STRING),
        ("req_body", DataType.STRING),
        ("resp_header", DataType.STRING),
        ("resp_body", DataType.STRING),
        ("latency_ns", DataType.INT64),
        ("pod", DataType.STRING),
    ]
)

#: Every schema a PEM ships (InitSchemas analog): table name -> Relation.
CANONICAL_SCHEMAS: dict[str, Relation] = {
    "http_events": HTTP_EVENTS_RELATION,
    "conn_stats": CONN_STATS_RELATION,
    "stack_traces.beta": STACK_TRACES_RELATION,
    "mysql_events": MYSQL_EVENTS_RELATION,
    "pgsql_events": PGSQL_EVENTS_RELATION,
    "redis_events": REDIS_EVENTS_RELATION,
    "kafka_events.beta": KAFKA_EVENTS_RELATION,
    "cql_events": CQL_EVENTS_RELATION,
    "nats_events.beta": NATS_EVENTS_RELATION,
    "mux_events": MUX_EVENTS_RELATION,
    "amqp_events": AMQP_EVENTS_RELATION,
    "process_stats": PROCESS_STATS_RELATION,
    "network_stats": NETWORK_STATS_RELATION,
    "dns_events": DNS_EVENTS_RELATION,
    "proc_stat": PROC_STAT_RELATION,
    "bcc_pid_cpu_usage": PID_RUNTIME_RELATION,
    "proc_exit_events": PROC_EXIT_EVENTS_RELATION,
    "stirling_error": STIRLING_ERROR_RELATION,
    # Self-telemetry tables ship with every agent (the collector also
    # lazily creates them, but advertising the schema up front lets the
    # bundled self-monitoring scripts compile before the first query).
    **TELEMETRY_SCHEMAS,
}


def table_budgets(memory_limit_mb: int | None = None) -> dict:
    """{table: max_bytes} budget map (+ ``"*"`` default for non-canonical
    tables) — the ``pem_manager.cc:86-104`` split as data: http_events
    takes its percent, the rest divide the remainder evenly. Installed
    on a TableStore (``table_budgets``) it bounds lazily-created tables
    without pinning schemas."""
    from ..config import get_flag

    limit_mb = (
        memory_limit_mb if memory_limit_mb is not None
        else get_flag("table_store_data_limit_mb")
    )
    if limit_mb <= 0:
        return {}
    memory_limit = limit_mb * 1024 * 1024
    # Clamp: >= 100 would zero (or, negative, UNBOUND) every other table.
    http_pct = min(max(get_flag("table_store_http_events_percent"), 0), 95)
    http_bytes = http_pct * memory_limit // 100
    other = (memory_limit - http_bytes) // max(len(CANONICAL_SCHEMAS) - 1, 1)
    out = {name: other for name in CANONICAL_SCHEMAS}
    out["http_events"] = http_bytes
    out["*"] = other
    return out


def init_schemas(target, memory_limit_mb: int | None = None) -> None:
    """Create every canonical table on an engine/table-store-like target
    with the reference's byte-budget split (``pem_manager.cc:86-104``
    InitSchemas): the ``table_store_data_limit_mb`` budget bounds ALL
    tables, http_events takes ``table_store_http_events_percent`` of it
    and the rest divide the remainder evenly. Each table's ring expires
    its own oldest rows at its budget, so one chatty protocol can never
    evict another's history — the backpressure is per-table by
    construction."""
    budgets = table_budgets(memory_limit_mb)
    if not budgets:
        for name, rel in CANONICAL_SCHEMAS.items():
            target.create_table(name, rel)
        return
    for name, rel in CANONICAL_SCHEMAS.items():
        target.create_table(name, rel, max_bytes=budgets[name])
