"""Flags the port reads, with environment-variable fallback.

The same registry shape as the JAX package's ``config.py``: a value
resolves from an explicit ``set_flag`` override, then the
``PIXIE_TPU_<NAME>`` environment variable, then the default. A flag
whose default is a bool parses "1", "true", "yes" and "on" as True; one
with a tuple of choices takes only those strings. Only
the flags the port reads are defined, with the JAX package's names,
defaults and docs. None of them routes work between a kernel and its
plain version: the device decides that.
"""

from __future__ import annotations

import contextlib
import os
import threading

_DEFAULTS: dict[str, int | float | bool | str] = {}
_DOCS: dict[str, str] = {}
_CHOICES: dict[str, tuple] = {}
_ENV_VARS: dict[str, str] = {}  # name -> PIXIE_TPU_<NAME>
_OVERRIDES: dict[str, int | bool | str] = {}
_LOCK = threading.Lock()
_MISSING = object()


def define_flag(name: str, default: int | bool | str, doc: str,
                choices: tuple | None = None) -> None:
    _DEFAULTS[name] = default
    _DOCS[name] = doc
    _ENV_VARS[name] = "PIXIE_TPU_" + name.upper()
    if choices is not None:
        _CHOICES[name] = choices


def _parse(name: str, value) -> int | bool | str:
    if name in _CHOICES:
        value = str(value).strip().lower()
        if value not in _CHOICES[name]:
            raise ValueError(
                f"flag {name}: {value!r} is not one of {_CHOICES[name]}"
            )
        return value
    if isinstance(_DEFAULTS[name], bool):
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(_DEFAULTS[name], float):
        return float(value)
    if isinstance(_DEFAULTS[name], str):
        return str(value)
    return int(value)


def get_flag(name: str) -> int | bool | str:
    default = _DEFAULTS[name]
    with _LOCK:
        if name in _OVERRIDES:
            return _OVERRIDES[name]
    env = os.environ.get(_ENV_VARS[name])
    return _parse(name, env) if env is not None else default


def get_flags(*names) -> tuple:
    """``get_flag`` of each name, as a tuple, under one lock acquisition
    (the analysis passes' memo keys read several flags per compile)."""
    environ = os.environ
    with _LOCK:
        ov = [_OVERRIDES.get(n, _MISSING) for n in names]
    out = []
    for n, o in zip(names, ov):
        if o is not _MISSING:
            out.append(o)
            continue
        env = environ.get(_ENV_VARS[n])
        out.append(_parse(n, env) if env is not None else _DEFAULTS[n])
    return tuple(out)


def set_flag(name: str, value) -> None:
    if name not in _DEFAULTS:
        raise KeyError(name)
    with _LOCK:
        _OVERRIDES[name] = _parse(name, value)


def clear_flag(name: str) -> None:
    with _LOCK:
        _OVERRIDES.pop(name, None)


def all_flags() -> dict:
    """{name: (value, doc)} snapshot — the statusz listing."""
    return {n: (get_flag(n), _DOCS[n]) for n in sorted(_DEFAULTS)}


define_flag("window_rows", 1 << 17, "Rows per streamed device window.")
define_flag("max_groups_limit", 1 << 22,
            "Hard cap for group-by capacity (the planner's eager-"
            "aggregation sizing reads it).")
define_flag("groupby_impl", "auto",
            "Per-window group-id algorithm for keys WITHOUT a static dense "
            "domain: 'auto' picks per device (hash on the CPU, sort on "
            "CUDA), 'sort' forces the multi-key stable sort (no host "
            "sync), 'hash' forces the bounded-probe device table.",
            choices=("auto", "sort", "hash"))
define_flag("dense_domain_limit", 1 << 20,
            "Group-bys whose key columns all have statically-known domains "
            "(dictionary-encoded strings, booleans) with product <= this "
            "use the packed key as the group id.")
define_flag("int_dense_domain_limit", 1 << 23,
            "Dense-domain budget for a single integer key bounded by the "
            "table's append-time min/max stats (Table.col_stats).")
define_flag("pipeline_depth", 2,
            "Window-executor prefetch depth: host slicing/packing/"
            "device_put of window N+1 runs on a background thread while "
            "window N computes, with at most this many windows in "
            "flight. 1 = serial (no prefetch thread, today's behavior).")
define_flag("ingest_sketches", True,
            "Maintain per-tablet ingest sketches (row count, HLL NDV, "
            "zone maps on key columns) on the append path; join routing "
            "and the planner's eager-aggregation sizing consult them.")
define_flag("device_residency", True,
            "Stage full table windows into device memory (HBM) at append "
            "time so steady-state queries run without host transfers.")
define_flag("device_cache_bytes", 6 << 30,
            "Byte budget for device-resident table windows (LRU-evicted).")
define_flag("scan_zone_skip", True,
            "Skip scan windows whose per-column zone maps cannot satisfy a "
            "query's FilterOp predicate (exec/zoneskip.py) — checked BEFORE "
            "stage/decode, so selective scans over cold data never decode "
            "dead windows. Generalizes join_zone_skip to plain table scans.")
define_flag("join_probe_window_rows", 1 << 20,
            "Probe rows per device-join dispatch for inner/left N:M "
            "joins: the build side is sorted and staged on device ONCE "
            "per query and probe windows stream through the prefetch "
            "pipeline. 0 = single-shot kernel over the whole probe side.")
define_flag("join_strategy", "auto",
            "N:M join strategy: 'auto' (sketch-guided routing picks "
            "host-dict / host-hash / single-shot / windowed sorted-probe "
            "/ windowed radix by shape, device and sketches), or force "
            "'host', 'single', 'sorted', 'radix' for testing/bench.",
            choices=("auto", "host", "single", "sorted", "radix"))
define_flag("join_radix_bits", 8,
            "Radix bits for the partitioned device join: build keys are "
            "splitmix64-hashed and partitioned by the top bits, so each "
            "probe row binary-searches ONE partition instead of the "
            "whole build side. 0 disables the radix strategy entirely.")
define_flag("join_capacity_safety", 2.0,
            "Multiplier on the sketch-estimated join output cardinality "
            "when sizing the initial device-join output capacity (then "
            "rounded to a power-of-two bucket). Headroom over the "
            "NDV-based mean fan-out absorbs moderate key skew; an "
            "overflow retry reruns the window, so over-sizing is the "
            "cheaper error.")
define_flag("join_zone_skip", True,
            "Skip staging probe windows whose key zone map cannot "
            "intersect the build side's key range (inner/left windowed "
            "device joins; left windows emit their null rows host-side).")
define_flag("device_join_min_rows", 1 << 15,
            "Inner/left joins whose two inputs hold fewer rows than this "
            "together try the host dict join first (N:1 builds only); "
            "larger inputs, right/outer and N:M joins go to the bulk "
            "strategies.")
define_flag("table_store_data_limit_mb", 1024 + 256,
            "Byte budget across ALL canonical ingest tables (reference "
            "PL_TABLE_STORE_DATA_LIMIT_MB, default 1.25GB); <= 0 = unbounded.")
define_flag("table_store_http_events_percent", 40,
            "Percent of the table-store budget devoted to http_events "
            "(reference PL_TABLE_STORE_HTTP_EVENTS_PERCENT).")


@contextlib.contextmanager
def override_flag(name: str, value):
    """Scoped ``set_flag`` that restores any earlier override on exit."""
    with _LOCK:
        had = name in _OVERRIDES
        prev = _OVERRIDES.get(name)
    set_flag(name, value)
    try:
        yield
    finally:
        if had:
            set_flag(name, prev)
        else:
            clear_flag(name)


# -- resource bounds (analysis/bounds.py) ------------------------------------
define_flag(
    "bounds_safety", 2.0,
    "Multiplier on pxbound's predicted resource totals (staged bytes, "
    "rows). Covers run-time effects the plan-time walk cannot see "
    "exactly: overflow-rebucket re-folds, concurrent ingest between "
    "compile and execution, join driver re-staging. The soundness gate "
    "(analysis/bound_check.py) asserts observed <= predicted UNDER "
    "this factor.",
)
define_flag(
    "bounds_presize", True,
    "Grow AggOp.max_groups at compile time to the sketch-NDV group "
    "bound (pxbound) so first-run aggregates start at the predicted "
    "capacity instead of climbing the overflow-doubling ladder (one "
    "whole-table re-fold per rung). Growth only — results identical.",
)
define_flag(
    "bounds_query_budget_mb", 0.0,
    "Per-query budget on pxbound's predicted staged bytes; a plan "
    "predicted over budget fails AT COMPILE with a structured "
    "resource-bound Diagnostic instead of OOMing mid-query. 0 "
    "disables. Sketch-less (unbounded) predictions are never rejected.",
)
define_flag(
    "bounds_device_budget_mb", 0.0,
    "Per-node budget on pxbound's predicted device allocation (staged "
    "window planes, aggregate group state, join build+output buffers); "
    "enforced at compile like bounds_query_budget_mb. 0 disables.",
)
define_flag(
    "pushdown_union_agg", True,
    "Distributed planner: place PEM-safe UnionOps (all inputs "
    "PEM-resident and non-blocking, sole consumer chain ending at a "
    "full AggOp) on the data agents so the downstream aggregate splits "
    "into partial-on-PEM + AGG_STATE_MERGE, shipping sketch-sized "
    "merge state (HLL registers, t-digest centroids) instead of "
    "pre-agg rows over the union's ROW_GATHER bridges.",
)


# -- storage tier and repeat serving (table_store/tier.py,
# exec/result_cache.py, exec/views.py) ----------------------------------------
define_flag(
    "cold_tier_mb", 0,
    "Encoded cold-tier byte budget per table (table_store/coldstore.py). "
    "> 0 enables tiering for byte-bounded tables: the oldest hot-ring "
    "windows demote into dictionary/delta/run-length encoded cold "
    "windows instead of expiring, and only cold evictions count as "
    "expiry. 0 = cold tier off (the hot ring expires directly).",
)
define_flag(
    "result_cache_mb", 0,
    "Byte budget (MB) for the watermark-validated result cache of "
    "Engine.execute_query. A repeat of a script whose scanned tables' "
    "watermarks have not advanced past the script's staleness budget "
    "is served from the cache with no compile and no device work. "
    "0 disables (every query executes). Validity is watermark "
    "comparison only, never a wall-clock TTL.",
)
define_flag(
    "result_cache_staleness_ms", 0.0,
    "Default per-script staleness budget (ms) for result-cache hits "
    "when the script manifest carries no staleness_budget_ms field: a "
    "cached result whose stored watermarks trail the current ones by "
    "at most this much still serves. 0 = exact-watermark hits only.",
)
define_flag(
    "view_auto_min_runs", 0,
    "A script executed at least this many times is registered as an "
    "incrementally maintained materialized view (exec/views.py), "
    "answered by folding only the rows appended since its last answer. "
    "0 disables auto-registration (a manifest's 'materialize: true' "
    "still registers while result_cache_mb > 0).",
)


# -- agent mode (services/) ---------------------------------------------------
define_flag(
    "bus_secret", "",
    "Shared secret for netbus/broker bearer tokens; empty disables auth "
    "(single-trust-domain deployments).",
)
define_flag(
    "client_request_retries", 3,
    "api.Client retries of IDEMPOTENT control-plane requests (agents, "
    "schemas, debug_queries, ...) on BusTimeout. execute_script is "
    "never blind-retried (non-idempotent).",
)
define_flag(
    "client_retry_backoff_ms", 50.0,
    "Initial backoff for api.Client idempotent-request retries; "
    "doubles per attempt (capped at 2s) with +0..25% jitter.",
)
# -- broker HA (services/broker_ha.py) ----------------------------------------
define_flag(
    "broker_lease_interval_s", 0.5,
    "Cadence of the leader's broker.lease heartbeat and of each "
    "standby's expiry check / presence announcement.",
)
define_flag(
    "broker_lease_expiry_s", 2.0,
    "Lease age past which a standby declares the leader dead and the "
    "lowest-id standby claims the next epoch (each higher-ranked "
    "standby waits one extra lease interval before claiming).",
)
define_flag(
    "broker_reconcile_wait_s", 0.5,
    "How long a freshly elected leader collects agents' answers to the "
    "broker.reconcile probe before resolving the deposed leader's "
    "in-flight queries (re-attach vs partial/broker_failover).",
)
define_flag(
    "broker_reattach_timeout_s", 15.0,
    "Forwarder wait budget for a re-attached failover query on the new "
    "leader; the inactivity watchdog inside the wait bounds a truly "
    "dead query well before this.",
)

# -- agent mode, continued ------------------------------------------------------
define_flag(
    "dispatch_retries", 3,
    "Re-publishes of an un-acked fragment dispatch before the broker "
    "declares the agent lost (0 = a single un-acked attempt is lost).",
)
define_flag(
    "dispatch_backoff_ms", 50.0,
    "Initial ack-wait/backoff for fragment dispatch retries; doubles "
    "per attempt (capped at 2s) with +0..25% jitter.",
)
define_flag(
    "require_complete", False,
    "Fail a distributed query as soon as a participating data agent is "
    "lost, instead of completing with partial results from the "
    "survivors (the pre-fault-tolerance fail-closed behavior).",
)
define_flag(
    "agent_flap_threshold", 3,
    "Expirations within agent_flap_window_s that quarantine an agent "
    "out of distributed query planning.",
)
define_flag(
    "agent_flap_window_s", 300.0,
    "Sliding window (seconds) for counting agent expirations toward "
    "the flap threshold.",
)
define_flag(
    "agent_quarantine_s", 120.0,
    "Cooldown during which a quarantined (flapping) agent is excluded "
    "from distributed_state() planning; it may re-register and "
    "heartbeat meanwhile.",
)
define_flag(
    "trace_ring_size", 128,
    "Finished query traces kept in the engine tracer's ring buffer "
    "(oldest evicted first).",
)
define_flag(
    "trace_window_sample", 64,
    "Record one per-window stage/compute/stall interval span every N "
    "windows per fragment (1 = every window, 0 = no window spans). "
    "Timestamps only — never forces device sync.",
)
define_flag(
    "trace_export_url", "",
    "OTLP/HTTP base URL to push finished query traces to; empty keeps "
    "traces in-memory only (ring buffer). A failed push counts in "
    "pixie_trace_export_errors_total and never fails the query.",
)
define_flag(
    "slow_query_threshold_ms", 0.0,
    "Queries slower than this (wall-clock ms) dump their full trace to "
    "the 'pixie_tpu_torch.slow_query' logger; 0 disables the slow-query "
    "log.",
)
define_flag(
    "admission_bytes_budget_mb", 0.0,
    "Broker admission control: budget on the SUM of in-flight queries' "
    "predicted staged bytes (pxbound predicted_cost). A single query "
    "predicted over the whole budget is rejected with its diagnostic; "
    "a query that merely doesn't fit NOW queues up to "
    "admission_queue_s. 0 disables (every query admitted). Queries "
    "with unknown (sketch-less) predictions are admitted and accounted "
    "at zero.",
)
define_flag(
    "broker_execute_threads", 16,
    "PER-TENANT worker-thread cap for the served broker.execute topic "
    "(serve()). A tenant's requests past its cap wait in that tenant's "
    "own FIFO backlog.",
)
define_flag(
    "admission_queue_s", 5.0,
    "How long an admission-controlled query may wait for in-flight "
    "predicted bytes to drain before it is rejected (queue timeout). "
    "0 rejects immediately when the budget is full.",
)
define_flag(
    "admission_tenant_weights", "",
    "Registered tenant set with fair-share weights for broker "
    "admission control, as comma-separated name:weight entries "
    "(e.g. 'dash:4,batch:1'). Each tenant's slice of "
    "admission_bytes_budget_mb is budget * weight / sum(weights); the "
    "default tenant 'shared' is always registered (weight 1 unless "
    "listed) and absorbs queries with no/unknown tenant.",
)
define_flag(
    "admission_priority_holddown_ms", 0.0,
    "Non-work-conserving grace window for strict-priority admission: "
    "after a priority-p query releases, strictly-lower-priority "
    "waiters stay queued for this many milliseconds. 0 disables.",
)
define_flag(
    "bus_telemetry", True,
    "Buses stamp the transport tier (services/busstats.py): per-topic-"
    "class publish/deliver/byte counters, dispatcher-lag + handler "
    "service-time histograms, queue-depth high-water gauges. Off = buses "
    "carry no stats object.",
)
define_flag(
    "slow_handler_threshold_ms", 0.0,
    "Bus handlers slower than this (service time, ms) log topic, "
    "class, service/lag times to the 'pixie_tpu_torch.slow_handler' "
    "logger and count in pixie_bus_slow_handlers_total; 0 disables.",
)

# -- device-tier observability (exec/programs.py) ----------------------------
define_flag(
    "program_registry_size", 512,
    "Program registry capacity (exec/programs.py): records of what the "
    "port binds and builds (fragment binds by structural key and input "
    "schema, join drivers by shape, nvcc and g++ libraries), each with "
    "its compile wall time and hit count, kept in an LRU; oldest "
    "evicted. 0 disables tracking entirely.",
)
define_flag(
    "device_memory_poll_s", 0.0,
    "Background poll period of the card's allocator for per-query peak "
    "device-memory attribution (QueryResourceUsage.device_peak_bytes). "
    "0 disables the poll thread; peaks then come from the query "
    "bracket alone. Gauges refresh at every /metrics scrape regardless.",
)
define_flag(
    "admission_observed_floor", True,
    "Broker admission control floors predicted_cost at the observed "
    "per-script-hash bytes_staged history from finished query traces "
    "(the __queries__ feedback loop): a sketch-less UNKNOWN prediction "
    "with history is admitted against the observed bytes instead of "
    "zero, and a known prediction below observed reality is raised to "
    "it. Only matters while admission_bytes_budget_mb > 0.",
)

# -- self-observability (services/telemetry.py, ingest/profiler.py) ----------
define_flag(
    "self_telemetry", True,
    "Agents fold their engine's finished query traces + resource "
    "records into the __queries__/__spans__/__agents__ tables "
    "(PxL-queryable through the normal engine path) and publish "
    "distributed-trace span summaries for the broker's /debug/tracez.",
)
define_flag(
    "telemetry_table_mb", 8,
    "Per-table byte budget (MB) for the self-telemetry tables; each "
    "table's ring expires its own oldest rows at the budget.",
)
define_flag(
    "self_profiling", True,
    "Deploy roles run the self-sampling perf profiler "
    "(ingest/profiler.py): agents AND the broker fold their own "
    "Python stacks — attributed with {qid, script_hash, tenant, "
    "phase} from the thread attribution registry — into the "
    "__stacks__ telemetry ring (px/query_cpu / px/tenant_cpu) plus "
    "the anonymous stack_traces.beta aggregate "
    "(px/perf_flamegraph), and serve merged flames via "
    "/debug/pprof + /debug/flamez. Off = no sampling thread work "
    "at all.",
)
# -- concurrency verification (analysis/lockdep.py) --------------------------
define_flag(
    "lockdep", False,
    "Runtime lock-order validation (Linux-lockdep style): wraps "
    "threading.Lock/RLock/Condition creation, maintains per-thread "
    "held-stacks and a process-wide observed acquisition-order graph, "
    "and raises (with both stack pairs) at the first acquisition that "
    "would close a cycle. Test/deploy instrumentation — off by "
    "default, zero overhead when off (the raw C lock types are "
    "untouched). run_tests.sh --locks runs the concurrency suites "
    "under it; deploy roles honor it at process start.",
)
define_flag(
    "profile_summary_stacks", 512,
    "Per-profiler cap on distinct (stack, attribution) keys kept in "
    "the cumulative folded-stack summary that heartbeats ship for "
    "cluster merge; over the cap the coldest stacks age out "
    "(hottest-kept eviction, counts stay monotonic for survivors).",
)
