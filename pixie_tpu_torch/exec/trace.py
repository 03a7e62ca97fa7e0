"""Always-on query-lifecycle tracing: spans, ring buffer, usage records,
OTLP export.

A port of the JAX package's ``exec/trace.py``. Every query gets a
**trace**: a tree of spans stamped at existing host-side boundaries
(never a device fence), kept in a bounded ring buffer.

Span hierarchy (one trace per ``Engine.execute_plan`` or broker query):

- ``query``               root; status/script-hash/row-count attributes
  and ``engine_self_ms`` (the wall time less compile, the query
  thread's compute/finalize/materialize and its pipeline stall)
- ``compile``             parse + PxL compile + plan (execute_query path)
- ``fragment``            one per compiled fragment executed (each
  rebucket attempt is its own); attributes carry windows, rows in/out
  and the per-stage second totals
- ``window.<stage>``      sampled per-window stage intervals (every
  ``trace_window_sample``-th interval per stage), children of their
  fragment span
- on the broker: ``dispatch``, ``dispatch.retry`` and ``failover``

The stats spine is the engine's ``QueryStats`` (``analyze.py``): a trace
owns a ``TraceStats`` whose fragments the engine fills; ``analyze=True``
flips ``sync=True`` on it, so an attribution run is a detail level of
the same trace. ``QueryResourceUsage`` is what a query cost: agents
return it with every fragment and merge, and the broker merges those.

Consumers: ``Tracer.recent()`` / ``in_flight()``; histograms and
counters on the shared metrics registry (``services/observability.py``);
the slow-query log (``slow_query_threshold_ms``: offending queries dump
their trace to the ``pixie_tpu_torch.slow_query`` logger); the OTLP/HTTP
push of finished traces to ``trace_export_url`` when that flag is set
(``QueryTrace.to_otlp`` through ``exec/otel.py``'s
``OTLPHttpExporter``). A failed push counts in
``pixie_trace_export_errors_total`` and never fails the query.

The same boundaries reach two more consumers through :class:`region`:
the continuous profiler's thread attribution (``exec/threadmap.py``
phases) and, while ``torch.profiler`` runs, ``pixie.<name>`` ranges in
its trace, stamped on the clock of these spans. Garbage-collection
pauses are charged to the query whose thread collected
(``QueryResourceUsage.gc_ms``, ``pixie.gc`` ranges).
"""

from __future__ import annotations

import gc
import hashlib
import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field

from torch.autograd import profiler as _torch_profiler

from ..config import get_flag
from . import threadmap, tracectx
from .analyze import FragmentStats, QueryStats, StageStat

logger = logging.getLogger("pixie_tpu_torch.slow_query")

#: Hard cap on spans kept per trace (sampling bounds the rate, this
#: bounds the worst case — a million-window query must not hold a
#: million span dicts).
MAX_SPANS_PER_TRACE = 512

#: Sub-second buckets for per-window stage timings (a window stage is
#: typically 0.1ms..1s; the prometheus defaults top out too coarse).
STAGE_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)

#: Byte-volume buckets (staged / wire bytes per query): one window is
#: KBs..MBs, a 16M-row scan is GBs.
BYTES_BUCKETS = (
    1 << 10, 1 << 14, 1 << 18, 1 << 22, 1 << 26, 1 << 30, 1 << 34,
)

#: Millisecond buckets (per-query device dispatch time).
MS_BUCKETS = (0.1, 1.0, 10.0, 100.0, 1_000.0, 10_000.0, 100_000.0)


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


#: The threadmap phase of each stage interval: staging work, the fold's
#: launches, and host work on the results.
STAGE_PHASES = {
    "read": "stage", "stage": "stage", "decode": "stage",
    "compute": "device_dispatch",
    "finalize": "host", "materialize": "host",
}


class region:
    """One engine boundary, seen by the profilers: ``with region(name,
    phase): ...`` sets the calling thread's threadmap phase for the block
    (with ``trace``, binds that trace too) and restores it on exit, and,
    only while ``torch.profiler`` is on, opens the range
    ``pixie.<name>`` around the block. Off, the profiler costs one
    module-attribute read: ``record_function`` costs microseconds even
    with no profiler, so it is never created unguarded.

    ``open``/``close`` are the two halves for a scope that does not fit
    one block (a query's scope closes in ``Tracer.end_query``); ``close``
    is idempotent and acts only on the thread that opened."""

    __slots__ = ("name", "phase", "trace", "_tid", "_tok", "_rf")

    def __init__(self, name: str, phase: str, trace=None):
        self.name = name
        self.phase = phase
        self.trace = trace
        self._tid = None
        self._tok = None
        self._rf = None

    def open(self) -> "region":
        self._tid = threading.get_ident()
        if self.trace is not None:
            self._tok = threadmap.bind(trace=self.trace, phase=self.phase)
        else:
            self._tok = threadmap.set_phase(self.phase)
        if _torch_profiler._is_profiler_enabled:
            rf = _torch_profiler.record_function(f"pixie.{self.name}")
            rf.__enter__()
            self._rf = rf
        return self

    def close(self) -> None:
        if self._tid != threading.get_ident():
            return  # not open, already closed, or another thread's
        self._tid = None
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(None, None, None)
        threadmap.unbind(self._tok)

    def __enter__(self) -> "region":
        return self.open()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class _GcHook:
    """The process's one ``gc.callbacks`` hook: times each collection,
    adds the pause to ``usage.gc_ms`` of the trace bound (threadmap) to
    the collecting thread, if any, and under the profiler brackets the
    collection in a ``pixie.gc`` range. Collections never overlap, so
    one slot holds the open one."""

    def __init__(self):
        self.t0 = 0.0
        self.rf = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.t0 = time.perf_counter()
            if _torch_profiler._is_profiler_enabled:
                self.rf = _torch_profiler.record_function("pixie.gc")
                self.rf.__enter__()
            return
        pause_ms = (time.perf_counter() - self.t0) * 1e3
        rf, self.rf = self.rf, None
        if rf is not None:
            rf.__exit__(None, None, None)
        entry = threadmap.current_entry()
        trace = entry.get("trace") if entry else None
        if isinstance(trace, QueryTrace):
            trace.add_gc_ms(pause_ms)


_gc_hook: _GcHook | None = None
_gc_hook_lock = threading.Lock()


def _install_gc_hook() -> None:
    global _gc_hook
    with _gc_hook_lock:
        if _gc_hook is None:
            _gc_hook = _GcHook()
            gc.callbacks.append(_gc_hook)


@dataclass
class QueryResourceUsage:
    """What one query actually COST, accumulated at existing host
    boundaries (never a device sync): the observed counterpart of the
    sketch-guided planner's predictions (arXiv:2102.02440 feedback loop)
    and the load signal multi-tenant admission control schedules on.

    - ``bytes_staged``  host->device transfer bytes during execution
      (0 for device-cache-resident windows — those were staged at
      append time; the gap between rows_in and bytes_staged IS the
      cache-hit signal)
    - ``device_ms``     host-side dispatch time of device programs
      (compute + finalize stage seconds; dispatch, not fenced runtime)
    - ``compile_ms``    the compile span (parse + PxL + plan + verify)
    - ``stall_ms``      query-thread time blocked on the prefetch pipe
    - ``wire_bytes``    bridge payload bytes this query SHIPPED
      (BridgeSinkOp egress — data-agent attribution; the merge's
      ingress is the sum over its producers)
    - ``retries``       dispatch retries (broker) + join-capacity
      overflow retries (engine)
    - ``skipped_windows`` probe/scan windows never staged (zone maps)
    - ``device_peak_bytes`` high-water bytes the torch allocator held on
      the card while the query ran (``torch.cuda.max_memory_allocated``
      around the query; None on the CPU). Merges by MAX across agents:
      it is a watermark, not a volume.
    - ``freshness_lag_ms`` result staleness: query stop-time minus the
      max event-time watermark of each scanned table at execute time,
      worst table kept (0 = fresh or no time-indexed scan). Merges by
      MAX across agents — the answer is only as fresh as the most
      behind shard. The validity predicate a result cache keyed on
      (script hash, table watermark) would check.
    - ``gc_ms``         garbage-collection pauses on a thread bound to the
      query (its own, its prefetch thread); adds up across agents like
      ``stall_ms``
    """

    rows_in: int = 0
    rows_out: int = 0
    windows: int = 0
    bytes_staged: int = 0
    device_ms: float = 0.0
    compile_ms: float = 0.0
    stall_ms: float = 0.0
    wire_bytes: int = 0
    retries: int = 0
    skipped_windows: int = 0
    device_peak_bytes: int | None = None
    freshness_lag_ms: float = 0.0
    # Cold-tier decode wall time charged to this query (decoding runs on
    # the prefetch producer thread — decode-on-stage — so this overlaps
    # device compute rather than adding to it; compare against stall_ms
    # to see whether decode ever became the bottleneck).
    decode_ms: float = 0.0
    gc_ms: float = 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        for k in ("device_ms", "compile_ms", "stall_ms",
                  "freshness_lag_ms", "decode_ms", "gc_ms"):
            d[k] = round(d[k], 3)
        return d

    def merge(self, other: "QueryResourceUsage | dict") -> None:
        """Fold another usage record in (broker-side per-agent
        aggregation; accepts the dict form that crossed the bus)."""
        d = other if isinstance(other, dict) else asdict(other)
        for k in (
            "rows_in", "rows_out", "windows", "bytes_staged", "wire_bytes",
            "retries", "skipped_windows",
        ):
            setattr(self, k, getattr(self, k) + int(d.get(k, 0)))
        for k in ("device_ms", "compile_ms", "stall_ms", "decode_ms",
                  "gc_ms"):
            setattr(self, k, getattr(self, k) + float(d.get(k, 0.0)))
        # A watermark, not a volume: agents sharing a device would
        # double-count under addition. None (a CPU engine) merges as
        # unknown.
        peak = d.get("device_peak_bytes")
        if peak is not None:
            self.device_peak_bytes = max(self.device_peak_bytes or 0,
                                         int(peak))
        # Staleness too: the merged answer is only as fresh as the most
        # behind agent's shard.
        self.freshness_lag_ms = max(
            self.freshness_lag_ms, float(d.get("freshness_lag_ms", 0.0))
        )


@dataclass
class Span:
    """One timed interval. ``to_otlp`` emits the OTLP-JSON span shape
    ``exec/otel.py`` ships (plus trace and span ids, which the batch path
    leaves to the collector)."""

    name: str
    trace_id: str
    span_id: str = field(default_factory=lambda: _new_id(8))
    parent_id: str = ""
    start_unix_nano: int = 0
    end_unix_nano: int = 0
    attributes: dict = field(default_factory=dict)

    def to_otlp(self) -> dict:
        from .otel import _attr_kvs

        d = {
            "name": self.name,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "startTimeUnixNano": int(self.start_unix_nano),
            "endTimeUnixNano": int(self.end_unix_nano),
            "attributes": _attr_kvs(sorted(self.attributes.items())),
        }
        if self.parent_id:
            d["parentSpanId"] = self.parent_id
        return d


class _SpanCtx:
    """Context manager stamping a span's start/end around a block, with
    a ``pixie.<name>`` region (phase ``host``) inside the stamps."""

    def __init__(self, trace: "QueryTrace", name: str, parent: Span | None):
        self.span = trace._new_span(name, parent)
        self.region = region(name, "host")

    def __enter__(self) -> Span:
        self.span.start_unix_nano = time.time_ns()
        self.region.open()
        return self.span

    def __exit__(self, exc_type, exc, tb):
        self.region.close()
        self.span.end_unix_nano = time.time_ns()
        if exc is not None:
            self.span.attributes["error"] = f"{type(exc).__name__}: {exc}"


class TracedFragment(FragmentStats):
    """FragmentStats that additionally owns a ``fragment`` span and
    records sampled per-window stage-interval spans + stage histograms.
    ``add`` runs on both the query thread (compute/stall) and the
    prefetch thread (stage) — the inherited lock covers both."""

    def __init__(self, ops: tuple, trace: "QueryTrace", sync: bool,
                 compiled=None):
        super().__init__(ops=ops, sync=sync, compiled=compiled)
        self.trace = trace
        self.span = trace._new_span("fragment", trace.root)
        self.span.start_unix_nano = time.time_ns()
        self.span.attributes["ops"] = ",".join(ops) or "(join)"
        self.last_activity_ns = self.span.start_unix_nano

    def add(self, stage: str, seconds: float, rows: int = 0,
            nbytes: int = 0, start_ns: int | None = None) -> None:
        """``start_ns`` is the interval's start on ``time.time_ns``, the
        clock ``seconds`` was measured on (the stage timers pass it); an
        interval without one ends now."""
        now_ns = time.time_ns()
        if start_ns is None:
            start_ns = now_ns - round(seconds * 1e9)
        end_ns = start_ns + round(seconds * 1e9)
        with self._lock:
            s = self.stages.setdefault(stage, StageStat())
            s.seconds += seconds
            s.rows += int(rows)
            s.count += 1
            s.nbytes += int(nbytes)
            count = s.count
            self.last_activity_ns = now_ns
        tracer = self.trace.tracer
        if tracer is not None:
            tracer._observe_stage(stage, seconds)
        k = self.trace.window_sample
        if k and (count - 1) % k == 0:
            self.trace._add_span(Span(
                name=f"window.{stage}",
                trace_id=self.trace.trace_id,
                parent_id=self.span.span_id,
                start_unix_nano=start_ns,
                end_unix_nano=end_ns,
            ))

    def finish(self, end_ns: int) -> None:
        """Seal the fragment span (trace end): end timestamp = last
        host-side activity, attributes = the final counters."""
        with self._lock:
            self.span.end_unix_nano = min(
                max(self.last_activity_ns, self.span.start_unix_nano), end_ns
            ) or end_ns
            self.span.attributes.update({
                "windows": self.windows,
                "rows_in": self.rows_in,
                "rows_out": self.rows_out,
            })
            for k, v in self.stages.items():
                self.span.attributes[f"{k}_seconds"] = round(v.seconds, 6)


class TraceStats(QueryStats):
    """The trace's stats spine — what the engine sees as
    ``_query_stats``. ``sync`` False = always-on tracing (no device
    fence); True = analyze detail level."""

    def __init__(self, trace: "QueryTrace", sync: bool = False):
        super().__init__(sync=sync)
        self.trace = trace

    def _fragment(self, ops, compiled) -> TracedFragment:
        return TracedFragment(
            tuple(type(o).__name__ for o in ops), self.trace, self.sync,
            compiled=compiled,
        )

    def note_freshness_lag(self, lag_ms: float, table: str = "") -> None:
        super().note_freshness_lag(lag_ms, table)
        self.trace.note_freshness_lag(table, lag_ms)


class QueryTrace:
    """One query's lifecycle: ids, status, span tree, stats spine."""

    def __init__(self, tracer: "Tracer | None", script: str = "",
                 analyze: bool = False, kind: str = "query",
                 parent_ctx: dict | None = None):
        self.tracer = tracer
        # A valid parent context (a broker dispatch span, carried in the
        # bus envelope — see tracectx.py) makes this trace PART of the
        # distributed trace: same trace id, root parented under the
        # dispatch span. Otherwise this query is its own trace root.
        self.parent_ctx = (
            dict(parent_ctx) if tracectx.valid(parent_ctx) else None
        )
        self.trace_id = (
            self.parent_ctx["trace_id"] if self.parent_ctx else _new_id(16)
        )
        self.script = script or ""
        self.script_hash = hashlib.sha256(
            self.script.encode()
        ).hexdigest()[:12]
        self.kind = kind  # "query" | "stream" | "fragment" | "merge" | ...
        self.qid = ""  # distributed query id (agents/broker stamp it)
        self.agent_id = ""  # executing agent (agents stamp it)
        # Tenant the query was admitted under (services/tenancy.py):
        # the broker stamps its resolved tenant, agents copy it from
        # the dispatch envelope so per-agent __queries__ rows carry the
        # same attribution. "" = not a tenant-scoped query (bare local
        # engines).
        self.tenant = ""
        # Result-cache disposition (exec/result_cache.py): "hit" /
        # "miss" / "stale" / "bypass" / "view"; "" = cache not in play
        # (disabled, or a path the cache never sees). Flows to
        # __queries__ and `px debug queries`.
        self.cache = ""
        self.status = "running"
        self.error = ""
        self.start_unix_nano = time.time_ns()
        self.end_unix_nano = 0
        self._t0 = time.perf_counter()
        self.duration_s = 0.0
        self.window_sample = int(get_flag("trace_window_sample"))
        self.pipeline: dict | None = None  # engine.last_pipeline snapshot
        self.usage = QueryResourceUsage()
        self.agent_usage: dict = {}  # broker: {agent_id: usage dict}
        # pxbound predicted_cost (analysis/bounds.py): what the query
        # was PREDICTED to stage/ship at plan time. The broker stamps
        # it; `px debug queries` renders predicted vs observed.
        self.predicted: dict | None = None
        # Per-scanned-table staleness detail ({table: lag_ms} at scan
        # setup; usage.freshness_lag_ms keeps the worst) — queryz rows.
        self.freshness: dict = {}
        self.exported = False  # OTLP push succeeded (ring-drop counting)
        self.dropped_spans = 0
        # The query's duration less the query thread's compile, compute,
        # finalize, materialize and stall (set at the end; None for a
        # trace that outlives its work: a stream, a broker's wait).
        self.engine_self_ms: float | None = None
        self.scope: region | None = None  # open_scope's pixie.query region
        self._lock = threading.Lock()
        self.root = Span(
            "query", self.trace_id, start_unix_nano=self.start_unix_nano,
            parent_id=self.parent_ctx["span_id"] if self.parent_ctx else "",
        )
        self.spans: list[Span] = [self.root]
        self.stats = TraceStats(self, sync=analyze)

    def ctx(self, span: "Span | None" = None) -> dict:
        """The propagation envelope for children of ``span`` (default:
        the root) — what the broker stamps onto dispatch messages."""
        return tracectx.make(
            self.trace_id, (span or self.root).span_id
        )

    def add_wire_bytes(self, n: int) -> None:
        """Account bridge egress bytes (BridgeSinkOp payloads)."""
        with self._lock:
            self.usage.wire_bytes += int(n)

    def note_freshness_lag(self, table: str, lag_ms: float) -> None:
        """Record one scanned table's staleness (query stop-time minus
        its max event-time watermark at scan setup): the usage field
        keeps the WORST table/round, ``self.freshness`` the per-table
        detail (/debug/queryz). Bounded: one key per scanned table."""
        lag_ms = max(0.0, float(lag_ms))
        with self._lock:
            self.usage.freshness_lag_ms = max(
                self.usage.freshness_lag_ms, lag_ms
            )
            self.freshness[table] = max(
                self.freshness.get(table, 0.0), lag_ms
            )

    def open_scope(self) -> None:
        """Open the query's ``pixie.query`` region on the calling thread
        (binding this trace there, phase ``host``), once; it closes when
        the trace ends (``Tracer.end_query``), inside the root span."""
        if self.scope is None:
            self.scope = region("query", "host", trace=self).open()

    def close_scope(self) -> None:
        if self.scope is not None:
            self.scope.close()

    def add_gc_ms(self, ms: float) -> None:
        """Charge a garbage-collection pause (the process's gc hook). No
        lock: a collection can start while this thread holds
        ``self._lock``, and collections, so their callbacks, never
        overlap, so nothing else adds here while a query runs."""
        self.usage.gc_ms += ms

    # -- span plumbing -------------------------------------------------------
    def _new_span(self, name: str, parent: Span | None) -> Span:
        s = Span(
            name, self.trace_id,
            parent_id=parent.span_id if parent is not None else "",
        )
        self._add_span(s)
        return s

    def _add_span(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) >= MAX_SPANS_PER_TRACE:
                self.dropped_spans += 1
                return
            self.spans.append(span)

    def span(self, name: str, parent: Span | None = None) -> _SpanCtx:
        """``with trace.span("compile"): ...`` — stamps start/end."""
        return _SpanCtx(self, name, parent if parent is not None else self.root)

    # -- derived views -------------------------------------------------------
    @property
    def rows_in(self) -> int:
        return self.stats.rows

    @property
    def rows_out(self) -> int:
        return sum(f.rows_out for f in self.stats.fragments)

    @property
    def windows(self) -> int:
        return self.stats.windows

    def _finalize(self, status: str, error: str) -> None:
        self.status = status
        self.error = error
        self.end_unix_nano = time.time_ns()
        self.duration_s = time.perf_counter() - self._t0
        self.stats.seal()
        self.root.end_unix_nano = self.end_unix_nano
        self._finalize_usage()
        self.root.attributes.update({
            "status": status,
            "script_hash": self.script_hash,
            "rows_in": self.rows_in,
            "rows_out": self.rows_out,
        })
        if self.engine_self_ms is not None:
            self.root.attributes["engine_self_ms"] = round(
                self.engine_self_ms, 3
            )
        if self.qid:
            self.root.attributes["qid"] = self.qid
        if self.agent_id:
            self.root.attributes["agent_id"] = self.agent_id
        if error:
            self.root.attributes["error"] = error
        for f in self.stats.fragments:
            if isinstance(f, TracedFragment):
                f.finish(self.end_unix_nano)

    def _finalize_usage(self) -> None:
        """Derive the resource record from the stats spine + spans.
        Purely host-side arithmetic over already-collected counters."""
        u = self.usage
        # Additive: a broker trace pre-merged its agents' usage (its own
        # stats spine is empty); an engine trace starts from zeros.
        u.rows_in += self.rows_in
        u.rows_out += self.rows_out
        u.windows += self.windows
        st = self.stats
        # Seconds of the query thread's own stages, for the self time.
        query_thread_s = 0.0
        for f in st.fragments:
            stages = f.stage_snapshot()
            compute, finalize, materialize = (
                stages.get(k, (0.0,))[0]
                for k in ("compute", "finalize", "materialize")
            )
            u.device_ms += (compute + finalize) * 1e3
            query_thread_s += compute + finalize + materialize
        u.bytes_staged += st.staged_bytes
        stall_s = st.pipeline.get("stall_secs", 0.0)
        u.stall_ms += stall_s * 1e3
        # Cold-tier decode rides the stage timeline (prefetch thread);
        # skipped windows were pruned by a zone map before any staging.
        u.decode_ms += st.decode_s * 1e3
        u.skipped_windows += st.skipped_windows
        compile_ms = 0.0
        compile_span = next(
            (s for s in self.spans if s.name == "compile"), None
        )
        if compile_span is not None and compile_span.end_unix_nano:
            compile_ms = (
                compile_span.end_unix_nano - compile_span.start_unix_nano
            ) / 1e6
            u.compile_ms += compile_ms
        # The prefetch thread's read and stage overlap these, so they are
        # not taken off. A stream's trace spans its idle time between
        # polls and a broker's its wait on the agents: no self time.
        if self.kind not in ("stream", "distributed"):
            self.engine_self_ms = (
                self.duration_s * 1e3 - compile_ms
                - (query_thread_s + stall_s) * 1e3
            )

    def to_dict(self) -> dict:
        """The /debug/queryz row (and slow-query log body)."""
        d = {
            "id": self.trace_id,
            "kind": self.kind,
            "script_hash": self.script_hash,
            "query": self.script[:200],
            "status": self.status,
            "start_unix_nano": self.start_unix_nano,
            "duration_ms": round(
                (self.duration_s if self.end_unix_nano
                 else time.perf_counter() - self._t0) * 1e3, 3
            ),
            "rows_in": self.rows_in,
            "rows_out": self.rows_out,
            "windows": self.windows,
            "spans": len(self.spans),
            "usage": self.usage.to_dict(),
            "fragments": [f.to_dict() for f in self.stats.fragments],
        }
        if self.qid:
            d["qid"] = self.qid
        if self.agent_id:
            d["agent_id"] = self.agent_id
        if self.tenant:
            d["tenant"] = self.tenant
        if self.cache:
            d["cache"] = self.cache
        if self.agent_usage:
            d["agent_usage"] = dict(self.agent_usage)
        if self.predicted:
            d["predicted"] = dict(self.predicted)
        if self.freshness:
            # dict() snapshot first: queryz renders in-flight traces
            # while the query thread may still note scans.
            d["freshness"] = {
                t: round(v, 3) for t, v in dict(self.freshness).items()
            }
        if self.parent_ctx:
            d["parent"] = dict(self.parent_ctx)
        if self.error:
            d["error"] = self.error
        if self.pipeline:
            d["pipeline"] = {
                k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in self.pipeline.items()
            }
        if self.dropped_spans:
            d["dropped_spans"] = self.dropped_spans
        return d

    def to_otlp(self) -> dict:
        """OTLP-JSON ResourceSpans payload: the exact shape
        ``OTLPHttpExporter`` POSTs to ``/v1/traces``."""
        from .otel import _attr_kvs

        res = [
            ("service.name", "pixie-tpu-engine"),
            ("query.script_hash", self.script_hash),
        ]
        if self.agent_id:
            res.append(("service.instance.id", self.agent_id))
        return {
            "resourceSpans": [{
                "resource": {
                    "attributes": _attr_kvs(res)
                },
                "scopeSpans": [{
                    "scope": {"name": "pixie_tpu_torch.exec.trace"},
                    "spans": [s.to_otlp() for s in self.spans],
                }],
            }]
        }


class Tracer:
    """Per-engine trace sink: bounded ring of finished traces, the
    in-flight set, histogram/counter recording, slow-query log, and the
    optional OTLP push. All methods are thread-safe."""

    def __init__(self, registry=None, ring_size: int | None = None):
        self._registry = registry  # lazy: services import at first use
        self._ring: deque = deque(
            maxlen=int(ring_size or get_flag("trace_ring_size"))
        )
        self._inflight: dict[str, QueryTrace] = {}
        self._lock = threading.Lock()
        self._metrics: dict | None = None
        self._stage_hist: dict = {}  # stage -> bound Histogram
        # Finished-trace listeners (the TelemetryCollector hook): called
        # AFTER metrics/export, exceptions contained — telemetry folding
        # must never fail or slow the query that produced the trace.
        self._listeners: list = []
        self._closed = False
        self._exporter = None
        self._exporter_url = None
        _install_gc_hook()

    def add_listener(self, fn) -> None:
        """Register ``fn(trace)`` to run on every finished trace."""
        self._listeners.append(fn)

    def shutdown(self) -> None:
        """Stop exporting/notifying: traces finished after shutdown
        still finalize into the ring (queryz keeps working) but no OTLP
        push or listener runs — the teardown contract for processes
        whose collector endpoint is already gone."""
        self._closed = True

    # -- metrics -------------------------------------------------------------
    @property
    def registry(self):
        if self._registry is None:
            from ..services.observability import default_registry

            self._registry = default_registry
        return self._registry

    def _m(self) -> dict:
        if self._metrics is None:
            reg = self.registry
            self._metrics = {
                "queries": reg.counter(
                    "pixie_queries_total",
                    "Queries finished, by terminal status",
                ),
                "duration": reg.histogram(
                    "pixie_query_duration_seconds",
                    "End-to-end query wall time (compile + execute)",
                ),
                "stage": reg.histogram(
                    "pixie_window_stage_seconds",
                    "Per-window host-side stage intervals (stage/compute/"
                    "stall/finalize/materialize; timestamps, not device "
                    "sync)",
                    buckets=STAGE_BUCKETS,
                ),
                "stall": reg.histogram(
                    "pixie_pipeline_stall_seconds",
                    "Per-query total window-pipeline stall",
                ),
                "slow": reg.counter(
                    "pixie_slow_queries_total",
                    "Queries over slow_query_threshold_ms",
                ),
                "export_errors": reg.counter(
                    "pixie_trace_export_errors_total",
                    "Failed OTLP trace pushes (trace_export_url)",
                ),
                "dropped": reg.counter(
                    "pixie_trace_dropped_total",
                    "Finished traces evicted from the ring buffer "
                    "without having been OTLP-exported",
                ),
                "bytes_staged": reg.histogram(
                    "pixie_query_bytes_staged",
                    "Per-query host->device staging bytes (0 = fully "
                    "device-cache-resident)",
                    buckets=BYTES_BUCKETS,
                ),
                "device_ms": reg.histogram(
                    "pixie_query_device_ms",
                    "Per-query device program dispatch milliseconds "
                    "(compute + finalize stages; host-side, unfenced)",
                    buckets=MS_BUCKETS,
                ),
                "wire_bytes": reg.histogram(
                    "pixie_query_wire_bytes",
                    "Per-query bridge payload egress bytes (agent "
                    "fragments shipping partial states/rows)",
                    buckets=BYTES_BUCKETS,
                ),
                "gc": reg.histogram(
                    "pixie_query_gc_seconds",
                    "Per-query garbage-collection pauses on the query's "
                    "threads",
                    buckets=STAGE_BUCKETS,
                ),
                "engine_self": reg.histogram(
                    "pixie_query_engine_self_seconds",
                    "Per-query engine self time: wall time less compile, "
                    "compute, finalize, materialize and stall",
                    buckets=STAGE_BUCKETS,
                ),
            }
        return self._metrics

    def _observe_stage(self, stage: str, seconds: float) -> None:
        h = self._stage_hist.get(stage)
        if h is None:
            h = self._stage_hist[stage] = self._m()["stage"].labels(
                stage=stage
            )
        h.observe(seconds)

    # -- lifecycle -----------------------------------------------------------
    def begin_query(self, script: str = "", analyze: bool = False,
                    kind: str = "query",
                    parent_ctx: dict | None = None) -> QueryTrace:
        """Start a trace. ``parent_ctx`` defaults to the AMBIENT
        distributed context (tracectx.current(), bound by the bus
        dispatcher that delivered the triggering message) — so a
        fragment executed inside an agent handler automatically joins
        the broker's trace without explicit plumbing."""
        if parent_ctx is None:
            parent_ctx = tracectx.current()
        tr = QueryTrace(
            self, script=script, analyze=analyze, kind=kind,
            parent_ctx=parent_ctx,
        )
        with self._lock:
            # Keyed by root span id, not trace id: N fragments of one
            # distributed query SHARE a trace id but are distinct
            # in-flight entries.
            self._inflight[tr.root.span_id] = tr
        return tr

    def end_query(self, trace: QueryTrace, status: str = "ok",
                  error: str = "") -> None:
        """Finalize a trace: seal spans, move it to the ring, record
        metrics, run the slow-query log and the OTLP export. Idempotent
        (a second end is a no-op) so both StreamingQuery.run's finally
        and an explicit close() can call it."""
        with self._lock:
            if self._inflight.pop(trace.root.span_id, None) is None:
                return  # already ended (or foreign trace)
        trace.close_scope()
        trace._finalize(status, error)
        m = self._m()
        with self._lock:
            # Ring-drop accounting (satellite): an evicted trace that
            # never made it out over OTLP is telemetry LOST — count it
            # so operators can size trace_ring_size / wire an exporter.
            if (
                self._ring.maxlen is not None
                and len(self._ring) == self._ring.maxlen
                and self._ring
                and not self._ring[0].exported
            ):
                m["dropped"].inc()
            self._ring.append(trace)
        m["queries"].labels(status=status).inc()
        m["duration"].labels(status=status).observe(trace.duration_s)
        u = trace.usage
        m["bytes_staged"].observe(u.bytes_staged)
        m["device_ms"].observe(u.device_ms)
        m["wire_bytes"].observe(u.wire_bytes)
        if trace.pipeline:
            m["stall"].observe(trace.pipeline.get("stall_secs", 0.0))
        m["gc"].observe(u.gc_ms / 1e3)
        if trace.engine_self_ms is not None:
            m["engine_self"].observe(trace.engine_self_ms / 1e3)
        self._slow_query_check(trace, m)
        self._export(trace, m)
        self._notify(trace)

    def _notify(self, trace: QueryTrace) -> None:
        if self._closed:
            return
        for fn in list(self._listeners):
            try:
                fn(trace)
            except Exception:
                # A broken telemetry consumer must never fail queries.
                logging.getLogger("pixie_tpu_torch.trace").warning(
                    "trace listener %r failed", fn, exc_info=True
                )

    def _slow_query_check(self, trace: QueryTrace, m: dict) -> None:
        thresh_ms = float(get_flag("slow_query_threshold_ms"))
        if thresh_ms <= 0 or trace.duration_s * 1e3 < thresh_ms:
            return
        m["slow"].inc()
        logger.warning(
            "slow query (%.1fms > %.1fms): %s",
            trace.duration_s * 1e3, thresh_ms,
            json.dumps(trace.to_dict(), default=str),
        )

    def _export(self, trace: QueryTrace, m: dict) -> None:
        url = str(get_flag("trace_export_url"))
        if not url or self._closed:
            return
        if self._exporter is None or self._exporter_url != url:
            from .otel import OTLPHttpExporter

            self._exporter = OTLPHttpExporter(url)
            self._exporter_url = url
        try:
            self._exporter(trace.to_otlp())
            trace.exported = True
        except Exception:
            # Telemetry never fails the query; the counter is the
            # operator's signal that the collector is down. A shutdown
            # racing a slow push (socket torn down mid-POST) lands here
            # too: counted, not raised.
            m["export_errors"].inc()

    # -- accessors (the /debug/queryz surface) -------------------------------
    def in_flight(self) -> list:
        with self._lock:
            traces = sorted(
                self._inflight.values(), key=lambda t: t.start_unix_nano
            )
        return [t.to_dict() for t in traces]

    def recent(self) -> list:
        with self._lock:
            traces = list(self._ring)
        return [t.to_dict() for t in reversed(traces)]

    def get(self, trace_id: str) -> QueryTrace | None:
        with self._lock:
            for t in self._inflight.values():
                if t.trace_id == trace_id:
                    return t
            for t in self._ring:
                if t.trace_id == trace_id:
                    return t
        return None

    def last(self) -> QueryTrace | None:
        """Most recently finished trace (None if the ring is empty)."""
        with self._lock:
            return self._ring[-1] if self._ring else None


def plan_script(plan) -> str:
    """Stable pseudo-script for direct ``execute_plan`` calls (no PxL
    source): the op-type chain in topo order, so equal plans share a
    script hash in /debug/queryz."""
    try:
        ops = [type(plan.nodes[nid].op).__name__ for nid in plan.topo_order()]
    except Exception:
        return "<plan>"
    return "plan:" + ">".join(ops)
