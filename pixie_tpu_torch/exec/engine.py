"""Query engine: PxL script -> plan -> windowed fold on the device.

A port of the single-engine path of the JAX package's ``exec/engine.py``
(``Engine.execute_query``): compile the script, stream the source
table's windows through the fragment, and finalize into a host
``HostBatch``.

Windows come from the table's device-resident cache when
``device_residency`` is on (staged at append time; misses such as the
partial tail are staged on demand), else from the host ring through
``HostBatch.to_device``. Either way they pass through a
``WindowPipeline`` (``pipeline_depth`` windows in flight on a prefetch
thread) after zone-map pruning (``exec/zoneskip.py``). The default run
never fences the card per window: the result's read at the end is the
query's only wait for the device. An attribution run
(``execute_query(..., analyze=True)``) runs serially and fences after
each stage, so ``read_s``, ``stage_s``, ``fold_s`` and ``finalize_s``
hold that stage's device work.

Joins and unions (``exec/joins.py``) take their inputs as they come: a
join whose build side resolves to a dense-domain table fuses into the
probe stream's fragment as a lookup (its side tables put on the device
once per query), every other join and every union materializes its
inputs and routes by shape, device and sketches. A stream that feeds
more than one consumer is materialized once and shared, unless it is a
pure table scan (each consumer re-reads the resident windows).

Every compile runs the plan verifier and the resource-bound pass
(``analysis/``) over a snapshot of the tables' ingest sketches
(``_compile_table_stats``): a bad script fails at compile, before any
window is staged; aggregates over sketched keys start at their
predicted group capacity; and a join whose build side the run-time
sketches cannot see takes its output capacity from the plan's report.

A UDTF source (``px.GetTables()`` and the other introspection
functions) runs on the host and enters the plan as a materialized
batch. ``set_metadata_state`` binds the metadata functions
(``df.ctx[...]``) to a snapshot of k8s metadata.

Repeat serving (``execute_query``): with ``result_cache_mb`` set, a
repeat of a script whose scanned tables' event-time watermarks have not
advanced past its staleness budget is answered from the
watermark-validated result cache (``exec/result_cache.py``) with no
compile and no device work; a script registered as a materialized view
(``exec/views.py``: ``view_auto_min_runs``, or a manifest's
``materialize``) is answered by folding only the rows appended since
its last answer (``exec/streaming.py``). Only then does the script
compile and execute, and a cacheable result is stored with the
watermarks read before it ran. ``last_stats.cache`` holds the
disposition (``hit``, ``miss``, ``stale``, ``bypass``, ``view``, or ""
when neither tier is on) and ``last_stats.freshness_lag_ms`` the
served answer's lag behind the clock. A tiered table's cold windows
decode on the prefetch thread; ``last_stats.decode_s`` and
``decode_bytes`` hold that work.

Every ``execute_plan`` runs under a query-lifecycle trace
(``exec/trace.py``): its ``TraceStats`` is the query's ``QueryStats``
(``exec/analyze.py``), each executed fragment gets a span, and the
trace's ``usage`` (rows, windows, staged bytes, bridge bytes, the card's
allocation peak from the device-memory monitor of ``exec/programs.py``)
is what an agent reports with its fragment. An engine with a telemetry
collector (``telemetry``, ``services/telemetry.py``; None on a bare
engine) folds every finished trace into its own ``__queries__`` tables.
A ``px.to_table`` sink appends its rows to the named table
(``last_table_sinks``) and returns no client table. A ``px.export`` sink
turns its input, brought to the host once, into an OTLP payload
(``exec/otel.py``) and hands it to ``export_otel``: kept in
``otel_exports`` by default, pushed where a deployment binds an
``OTLPHttpExporter`` there. A query's
cancel handle and stats travel as arguments, and the state its helpers
read back (join decision, resource report) lives on a thread-local
scratch, so an agent's one-shot fragment and its live query's poll run
side by side on one engine; the ``last_*`` attributes are
last-writer-wins snapshots.

Agent mode (``services/``): a plan split by the distributed planner
runs in two halves. A data agent's fragment ends in ``BridgeSinkOp``s,
which return ``{("bridge", id): payload}``: the partial aggregate state
leaves the card as numpy, or the fragment's rows. The merge agent's
plan starts from ``BridgeSourceOp``s fed by ``bridge_inputs``; shipped
states merge on its card and finalize (``exec/bridge.py``).

Device-resident results: ``execute_query(materialize=False)`` leaves
each aggregate output with one consumer on the card as a
``DeviceResult`` (the finalized planes, the valid mask and the overflow
flag). The query's kernels are enqueued and nothing is read back; the
caller picks the moment of the one readback (``to_host``, which also
resolves a group overflow), or only waits for the card
(``block_until_ready``). Row chains, fan-out outputs and every other
sink still come back as host batches.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
without a card it raises rather than carrying on on the CPU. Not ported
here: the TPU's scan batching of resident windows (``update_all``,
which amortises TPU dispatch cost) and the native multi-core CPU fold
(for the XLA:CPU backend).
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Optional

import numpy as np
import torch

from ..config import get_flag
from ..table_store.coldstore import take_decode_meter
from ..types.batch import HostBatch, bucket_capacity
from ..types.relation import Relation
from ..udf.registry import Registry, default_registry
from .analyze import QueryStats
from .bridge import (
    _PendingAggBridge,
    bind_bridge,
    bridge_payload,
    merge_agg_bridge,
    payload_nbytes,
)
from .fragment import _pure_select_map, compile_fragment
from .joins import (
    JoinDecision,
    _join_dispatch,
    _union_host,
    stream_join_stats,
    try_fused_join,
)
from .pipeline import WindowPipeline
from .result_cache import ResultCache
from .plan import (
    AggOp,
    BridgeSinkOp,
    BridgeSourceOp,
    ColumnRef,
    EmptySourceOp,
    FilterOp,
    JoinOp,
    LimitOp,
    MapOp,
    MemorySourceOp,
    OTelExportSinkOp,
    ResultSinkOp,
    TableSinkOp,
    UDTFSourceOp,
    UnionOp,
)
from .stream import (
    QueryCancelled,
    QueryError,
    _apply_limit,
    _block_if,
    _concat_host,
    _double_agg_groups,
    _empty_host_batch,
    _Stream,
    _stream_col_stats,
    _timed,
    _to_host_batch,
)
from .trace import Tracer, plan_script
from .zoneskip import chain_pruner

__all__ = ["DeviceResult", "Engine", "QueryCancelled", "QueryError",
           "QueryStats", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` (the current card) unless the caller
    names another. Raises when CUDA is asked for and there is none."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "engine on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class DeviceResult:
    """An aggregate query output left on the engine's device.

    Holds the finalized ``[G]`` column planes, the valid mask and the
    overflow flag as device tensors, with the stream and fragment that
    made them and the creating query's stats. ``execute_query`` returned
    with the kernels enqueued and nothing read back: ``to_host`` makes
    the one readback, and reads the overflow flag there. An overflow
    rebuckets there too (double ``max_groups``, fold again, finalize),
    each attempt a fresh fragment of the creating query's stats marked
    ``rebucket``. Such a refold reads the source table as it is then:
    rows appended since the query ran are included, unlike the answer
    without an overflow; a caller that needs the snapshot calls
    ``to_host`` before appending more. The host batch is cached (a second
    ``to_host`` returns the same object) and the device tensors are
    dropped.

    While it lives, its bytes are held on the engine's device-memory
    monitor (``exec/programs.py``), so a later query's peak does not
    count them."""

    def __init__(self, engine, stream, frag, cols, valid, overflow,
                 stats, fstats):
        self._engine = engine
        self._stream = stream
        self._frag = frag
        self._cols = cols
        self._valid = valid
        self._overflow = overflow
        self._stats = stats  # the creating query's QueryStats
        self._fstats = fstats  # the fragment that folded it
        self._host: HostBatch | None = None
        device = engine.device
        self._event = None
        if device.type == "cuda":
            # Marks the end of the query's work on this thread's stream.
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))
        monitor = engine.device_memory
        self._release = weakref.finalize(
            self, monitor.release,
            monitor.hold(device, _held_nbytes(cols, valid, overflow)),
        )

    @property
    def relation(self) -> Relation:
        return self._frag.relation

    def block_until_ready(self) -> "DeviceResult":
        """Wait for the engine's device work on this result without
        reading it back (nothing to wait for on the CPU)."""
        if self._event is not None:
            self._event.synchronize()
        return self

    def to_host(self) -> HostBatch:
        if self._host is None:
            self._host = self._engine._agg_result(
                self._stream, self._frag, self._cols, self._valid,
                self._overflow, self._stats, None, fstats=self._fstats,
            )
            self._stats.seal()  # a rebucket's fragment gets its rows
            self._cols = self._valid = self._overflow = None
            self._stream = self._event = None
            self._release()
        return self._host

    def to_pydict(self, **kw) -> dict:
        return self.to_host().to_pydict(**kw)


def _held_nbytes(cols, valid, overflow) -> int:
    """The allocator bytes a result's tensors hold: each storage once,
    in the CUDA caching allocator's 512-byte blocks on a card."""
    tensors = [valid, overflow]
    for planes in cols.values():
        tensors.extend(planes)
    sizes = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            sizes[st.data_ptr()] = (st.nbytes(), t.is_cuda)
    return sum(-(-n // 512) * 512 if on_card else n
               for n, on_card in sizes.values())


def _charge_decode(stats: QueryStats) -> None:
    """Move this thread's cold-decode meter onto the query's stats."""
    secs, nbytes = take_decode_meter()
    if secs or nbytes:
        stats.add("decode", secs, nbytes=nbytes)


class _QueryScratch:
    """Per-query state the engine's helpers read back (its cancel handle
    and stats travel as arguments), one per in-flight ``execute_plan``
    (thread-local on the engine), so queries on other threads never see
    it."""

    __slots__ = ("join_decision", "resource_report", "table_sinks")

    def __init__(self, resource_report=None):
        self.join_decision = None
        self.resource_report = resource_report
        self.table_sinks: dict = {}  # {table: rows} from TableSinkOps


class Engine:
    """Owns tables + registry; executes PxL scripts on one device."""

    # Whether this engine may read device-resident table windows (with
    # the device_residency flag); a subclass may stage every window.
    device_residency = True

    def __init__(self, registry: Registry | None = None,
                 window_rows: int | None = None, device=None,
                 pipeline_depth: int | None = None):
        from ..table_store import TableStore

        self.device = resolve_device(device)
        self.registry = registry or default_registry()
        self.table_store = TableStore()
        self.window_rows = int(window_rows or get_flag("window_rows"))
        # Window-executor prefetch depth (pipeline.py); None reads the
        # pipeline_depth flag per query.
        self.pipeline_depth = pipeline_depth
        # Per-query scratch (thread-local: each concurrent execute_plan
        # runs on its caller's thread). The last_* snapshots below are
        # the last finished query's, last-writer-wins under concurrency.
        self._tls = threading.local()
        # Guards the last_* snapshots and the in-flight counters (a leaf
        # lock: nothing blocks under it).
        self._state_lock = threading.Lock()
        self._inflight = 0
        self.max_inflight = 0  # high-water count of concurrent queries
        # Engine-lifetime pipeline totals (exported by
        # services.observability.engine_collector).
        self.pipeline_totals = {
            "windows": 0, "stage_secs": 0.0, "stall_secs": 0.0,
        }
        self.last_stats: Optional[QueryStats] = None
        # The last query's join routing (joins.JoinDecision: strategy,
        # swap, capacity, retries, skipped windows), None after a query
        # without a join.
        self._last_join_decision: Optional[JoinDecision] = None
        # The last query's plan-time resource envelope
        # (analysis.bounds.PlanResourceReport, attached by compile_pxl),
        # None for a plan compiled without it.
        self._last_resource_report = None
        # The last query's px.to_table writes, {table: rows}.
        self._last_table_sinks: dict = {}
        # OTel egress (export_otel): made here, not at first use, so two
        # concurrent queries cannot each make a list and lose an export.
        self.otel_exports: list = []
        # Query-lifecycle traces (exec/trace.py): every execute_plan gets
        # one; an agent reads its usage after each fragment.
        self.tracer = Tracer()
        # Learned join output capacities per (mode, plan, node), LRU
        # (joins.learned_capacity / remember_capacity).
        self._join_capacity_cache: dict = {}
        # The k8s metadata snapshot the metadata functions are bound to
        # (set_metadata_state); None until one is attached.
        self.metadata_state = None
        # Repeat serving: the watermark-validated result cache (off while
        # result_cache_mb is 0) and the materialized views, built at
        # first use (views ride the streaming cursor, whose module
        # imports this one).
        self.result_cache = ResultCache()
        self._views = None
        # Self-telemetry (services/telemetry.py TelemetryCollector): when
        # attached, finished traces fold into the __queries__/__spans__
        # tables and observed per-script cardinalities feed back into
        # _compile_table_stats. None = off (a bare engine; agents and
        # deploy roles wire it).
        self.telemetry = None
        # Device-tier observability (exec/programs.py): the shared
        # device-memory monitor brackets every execute_plan, so the
        # query's peak on the card lands in
        # QueryResourceUsage.device_peak_bytes.
        from .programs import default_device_monitor

        self.device_memory = default_device_monitor()
        self.device_memory.start()  # no-op unless device_memory_poll_s

    # -- per-query scratch ----------------------------------------------------
    @property
    def _scratch(self) -> Optional[_QueryScratch]:
        return getattr(self._tls, "scratch", None)

    @property
    def last_join_decision(self) -> Optional[JoinDecision]:
        """The running query's join decision on its own thread, else the
        last finished query's."""
        s = self._scratch
        if s is not None and s.join_decision is not None:
            return s.join_decision
        return self._last_join_decision

    @last_join_decision.setter
    def last_join_decision(self, jd) -> None:
        s = self._scratch
        if s is not None:
            s.join_decision = jd
        self._last_join_decision = jd

    @property
    def last_pipeline(self) -> Optional[dict]:
        """The last finished query's window-pipeline counters (depth,
        windows, stage_secs, stall_secs); None when it ran no pipeline."""
        st = self.last_stats
        if st is None or not st.pipeline["depth"]:
            return None
        return dict(st.pipeline)

    @property
    def last_resource_report(self):
        s = self._scratch
        if s is not None:
            return s.resource_report
        return self._last_resource_report

    @property
    def last_table_sinks(self) -> dict:
        """{table: rows} written by the running query's ``px.to_table``
        on its own thread, else by the last finished query's."""
        s = self._scratch
        if s is not None:
            return s.table_sinks
        return self._last_table_sinks

    @property
    def tables(self) -> dict:
        """{name: default-tablet (or first) Table} view over the store."""
        out = {}
        for n in self.table_store.table_names():
            t = self.table_store.get_table(n)
            if t is None:
                tablets = self.table_store.tablets(n)
                t = tablets[0] if tablets else None
            out[n] = t
        return out

    # -- table management ----------------------------------------------------
    def create_table(self, name: str, relation=None, max_bytes: int = -1):
        """Tables created through an engine stage device windows on its
        device at its window size from the first append on."""
        return self.table_store.add_table(
            name, relation, max_bytes=max_bytes,
            device_window_rows=self.window_rows, device=self.device,
        )

    def append_data(self, name: str, data, time_cols=("time_",)):
        """Push path (Stirling's RegisterDataPushCallback analog). The
        atomic get-or-create sets this engine's window size and device,
        so first appends stage device windows correctly."""
        self.table_store.ensure_table(
            name, device_window_rows=self.window_rows, device=self.device
        )
        return self.table_store.append_data(name, data, time_cols=time_cols)

    def set_metadata_state(self, state) -> None:
        """Attach k8s metadata: rebinds the metadata functions to a
        snapshot of ``state`` (reference: per-query AgentMetadataState)
        on a clone of this engine's registry, keeping every other
        registration. The UPID lookup table goes to the device on the
        first query that reads it and stays there until the next call."""
        from ..metadata.funcs import METADATA_FUNC_NAMES, register_metadata_funcs

        self.metadata_state = state
        reg = self.registry.clone("engine", exclude=METADATA_FUNC_NAMES)
        register_metadata_funcs(reg, state)
        self.registry = reg

    # -- execution -----------------------------------------------------------
    def execute_query(self, query: str, now_ns: int = 0,
                      max_output_rows: int = 10_000, analyze: bool = False,
                      cancel=None, materialize: bool = True) -> dict:
        """Compile a PxL script and execute it. Returns {output name:
        HostBatch}; ``last_stats`` holds the query's counters.
        ``analyze=True`` is an attribution run (serial, fenced per
        stage); ``cancel`` is an Event-like handle polled per window.
        ``materialize=False`` leaves each aggregate output on the card
        as a ``DeviceResult`` (``to_host`` for the rows).

        Repeat serving comes first: a valid result-cache entry, then a
        materialized view, answer without executing. Neither serves nor
        stores an attribution run, a device-resident run or a pxtrace
        script; both are off while ``result_cache_mb`` and
        ``view_auto_min_runs`` are 0."""
        # The query's trace starts here, so the compile gets its own
        # span; execute_plan ends it. Its scope (the pixie.query region,
        # this thread bound to the trace) closes when the trace ends.
        trace = self.tracer.begin_query(script=query, analyze=analyze)
        trace.open_scope()
        try:
            return self._execute_query_traced(
                trace, query, now_ns, max_output_rows, analyze, cancel,
                materialize,
            )
        finally:
            trace.close_scope()

    def _execute_query_traced(self, trace, query, now_ns, max_output_rows,
                              analyze, cancel, materialize) -> dict:
        from ..planner import CompilerState, compile_pxl
        from . import result_cache as rc

        # A DeviceResult is the caller's own: never shared through the
        # cache, never answered from it.
        servable = materialize and not analyze and "pxtrace" not in query
        cache_on = servable and self.result_cache.enabled()
        disposition = ""
        if cache_on:
            status, entry, lag_ms = self.result_cache.lookup(
                query, now_ns, max_output_rows, self._table_watermark_ns
            )
            if status == rc.HIT:
                self.last_join_decision = None
                self.last_stats = QueryStats(cache=rc.HIT,
                                             freshness_lag_ms=lag_ms)
                trace.cache = rc.HIT
                trace.usage.freshness_lag_ms = lag_ms
                self.tracer.end_query(trace, status="ok")
                return dict(entry.result)
            disposition = status
        if servable:
            answer = self._try_view_answer(query, now_ns, max_output_rows,
                                           trace)
            if answer is not None:
                trace.cache = rc.VIEW
                self.tracer.end_query(trace, status="ok")
                return answer
        try:
            with trace.span("compile"):
                state = CompilerState(
                    schemas={n: t.relation for n, t in self.tables.items()},
                    registry=self.registry,
                    now_ns=now_ns,
                    max_output_rows=max_output_rows,
                    table_stats=self._compile_table_stats(),
                )
                compiled = compile_pxl(query, state)
        except BaseException as e:
            self.tracer.end_query(
                trace, status="error", error=f"{type(e).__name__}: {e}"
            )
            raise
        # The watermarks are read BEFORE execution: rows landing during
        # the scan make the stored watermark older than the data, so the
        # next lookup checks again rather than trusting too much.
        store_wms = None
        if cache_on:
            tables, _ = rc.scan_info(compiled.plan)
            wms = {t: self._table_watermark_ns(t) for t in tables}
            if tables and all(w is not None for w in wms.values()):
                store_wms = wms
            else:
                disposition = rc.BYPASS
        trace.cache = disposition
        try:
            result = self.execute_plan(compiled.plan, analyze=analyze,
                                       materialize=materialize,
                                       cancel=cancel, trace=trace)
        finally:
            trace.stats.cache = disposition
        if store_wms is not None:
            self.result_cache.store(
                query, state.now_ns, max_output_rows, compiled.plan,
                result, store_wms.get,
            )
        return result

    def _table_watermark_ns(self, table: str):
        """The max event-time watermark across ``table``'s tablets (None
        for an unknown table or one without a time index): the engine's
        half of the result cache's validity check."""
        from ..table_store import table as _table_mod

        tablets = self.table_store.tablets(table)
        if not tablets:
            return None
        return _table_mod.max_watermark_ns(tablets)

    @property
    def views(self):
        """The engine's ViewRegistry (``exec/views.py``), built at first
        use."""
        if self._views is None:
            from .views import ViewRegistry

            self._views = ViewRegistry(self)
        return self._views

    def _try_view_answer(self, query: str, now_ns: int,
                         max_output_rows: int, trace):
        """The materialized-view answer: count the run, register a view
        when the manifest or the run count says so, and answer from a
        registered view by folding the rows appended since its last
        answer; the view's freshness lag goes onto the query's
        ``trace``. None when no view covers the query (execute it). A
        view that fails to answer is logged and the query executes, as
        in the JAX engine."""
        from .views import view_candidates_enabled

        if not view_candidates_enabled(query):
            return None
        try:
            return self.views.serve(
                query, now_ns=now_ns, max_output_rows=max_output_rows,
                trace=trace,
            )
        except Exception:
            import logging

            logging.getLogger("pixie_tpu_torch.views").warning(
                "materialized-view answer failed; executing normally",
                exc_info=True,
            )
            return None

    def _compile_table_stats(self) -> dict:
        """Ingest-sketch stats snapshot for the compiler
        (``CompilerState.table_stats``): per table, the row count, the
        HLL NDV estimate and the global zone map of each sketched
        column, from sketches kept at append time (each call estimates
        every column's NDV afresh, as the JAX engine does), and for a
        tiered table the observed bytes per row of each tier, which seed
        the bounds pass's staged and cold-decode bytes. With telemetry
        attached, the observed per-script output cardinalities of past
        runs ride under ``__observed__`` (keyed by script hash), where
        ``compile_pxl`` resolves the compiled script's entry for the
        optimizer's join pre-aggregation sizing."""
        out: dict = {}
        # Snapshots (list(...)): appends on other threads add tables
        # and sketched columns while a query compiles.
        for n, t in list(self.tables.items()):
            sk = getattr(t, "sketches", None)
            if not sk:
                continue
            cols = list(sk.cols.items())
            out[n] = {
                "rows": sk.rows,
                "ndv": {c: s.ndv for c, s in cols if s.rows},
                # Global zone maps per sketched column: the bounds
                # pass's join overlap term reads them.
                "zones": {
                    c: (s.lo, s.hi)
                    for c, s in cols
                    if s.rows and s.lo is not None
                },
            }
            if t._tier is not None:
                f = t.freshness()
                hr, cr = int(f["hot_rows"]), int(f["cold_rows"])
                out[n]["tier"] = {
                    "hot_rows": hr,
                    "cold_rows": cr,
                    "hot_row_bytes": f["hot_bytes"] / hr if hr else None,
                    "cold_row_bytes": f["cold_bytes"] / cr if cr else None,
                    "raw_row_bytes": (
                        (f["hot_bytes"] + f["cold_raw_bytes"]) / (hr + cr)
                        if hr + cr else None
                    ),
                }
        if self.telemetry is not None:
            obs = self.telemetry.observed()
            if obs:
                out["__observed__"] = obs
        return out

    def execute_plan(self, plan, bridge_inputs: dict | None = None,
                     analyze: bool = False, materialize: bool = True,
                     cancel=None, trace=None) -> dict:
        """Execute a plan. Returns {sink name: HostBatch}.

        A data agent's fragment of a split plan ends in BridgeSinkOps and
        returns {("bridge", id): payload} besides; a merge agent's plan
        starts from BridgeSourceOps and reads ``bridge_inputs`` = {bridge
        id: [payloads]}. ``analyze=True`` is an attribution run (fenced
        per stage); ``cancel`` is an Event-like handle polled per window.
        ``trace`` is the query's trace when the caller began one (else a
        new one starts here); this call ends it. ``materialize=False``
        returns a ``DeviceResult`` for each aggregate output whose input
        has no other consumer; every other output is a HostBatch."""
        if trace is None:
            trace = self.tracer.begin_query(
                script=plan_script(plan), analyze=analyze
            )
        trace.open_scope()
        status, error = "ok", ""
        try:
            return self._execute_plan_scoped(
                plan, bridge_inputs, trace, cancel, materialize
            )
        except QueryCancelled as e:
            status, error = "cancelled", str(e)
            raise
        except BaseException as e:
            status, error = "error", f"{type(e).__name__}: {e}"
            raise
        finally:
            self.tracer.end_query(trace, status=status, error=error)

    def _execute_plan_scoped(self, plan, bridge_inputs, trace, cancel,
                             materialize: bool = True) -> dict:
        stats = trace.stats
        report = getattr(plan, "resource_report", None)
        scratch = _QueryScratch(resource_report=report)
        # Predicted-vs-observed calibration: the plan's predicted cost
        # rides the trace, so the telemetry fold records it next to the
        # observed usage (px/bound_accuracy). The broker stamps its
        # merged cost on its own trace instead.
        if trace.predicted is None and report is not None:
            from ..analysis.bounds import merged_cost

            trace.predicted = merged_cost(report, None)
        # The card's allocator peak over the query (exec/programs.py
        # DeviceMemoryMonitor; None on the CPU).
        mem_token = self.device_memory.query_begin(self.device)
        prev = self._scratch
        self._tls.scratch = scratch
        t0 = time.perf_counter()
        with self._state_lock:
            self._inflight += 1
            self.max_inflight = max(self.max_inflight, self._inflight)
        try:
            return self._execute_plan(plan, stats, cancel, bridge_inputs,
                                      materialize)
        finally:
            stats.wall_s = time.perf_counter() - t0
            self._tls.scratch = prev
            trace.pipeline = dict(stats.pipeline)
            jd = scratch.join_decision
            if jd is not None:
                trace.usage.retries += int(getattr(jd, "retries", 0))
                trace.usage.skipped_windows += int(
                    getattr(jd, "skipped_windows", 0)
                )
            peak = self.device_memory.query_end(mem_token)
            if peak is not None:
                trace.usage.device_peak_bytes = peak
            with self._state_lock:
                self._inflight -= 1
                self.last_stats = stats
                self._last_join_decision = jd
                self._last_resource_report = report
                self._last_table_sinks = scratch.table_sinks

    @staticmethod
    def _plan_fingerprint(plan) -> int:
        """Structural plan hash (cached on the plan object): keys the
        joins' learned-capacity cache so a repeated script starts at the
        output-capacity rung its last run settled on."""
        fp = getattr(plan, "_fingerprint", None)
        if fp is None:
            fp = hash(tuple(
                (nid, type(n.op).__name__, repr(n.op), tuple(n.inputs))
                for nid, n in sorted(plan.nodes.items())
            ))
            plan._fingerprint = fp
        return fp

    def _execute_plan(self, plan, stats: QueryStats, cancel,
                      bridge_inputs: dict | None = None,
                      materialize: bool = True) -> dict:
        results: dict = {}
        outputs: dict = {}
        consumers: dict[int, int] = {}
        for n in plan.nodes.values():
            for i in n.inputs:
                consumers[i] = consumers.get(i, 0) + 1

        def mat_input(nid):
            """Materialize a node's result once; shared by its consumers."""
            r = results[nid]
            if not isinstance(r, HostBatch):
                r = results[nid] = self._materialize(r, stats, cancel)
            return r

        # The bounds pass's envelope (analysis/bounds.py), attached by
        # compile_pxl: the joins read their planned output capacity.
        report = self.last_resource_report
        for nid in plan.topo_order():
            node = plan.nodes[nid]
            op = node.op
            if isinstance(op, MemorySourceOp):
                tablets = self.table_store.tablets(op.table)
                if not tablets:
                    raise QueryError(f"no table named {op.table!r}")
                base = next((t for t in tablets if len(t.relation)), tablets[0])
                self._note_scan_freshness(op, tablets, stats)
                chain = []
                if op.columns is not None:
                    chain.append(
                        MapOp(exprs=tuple((c, ColumnRef(c)) for c in op.columns))
                    )
                results[nid] = _Stream(
                    base.relation, dict(base.dicts), chain, tablets, op
                )
            elif isinstance(op, UDTFSourceOp):
                results[nid] = self._run_udtf(op)
            elif isinstance(op, EmptySourceOp):
                results[nid] = _empty_host_batch(
                    Relation(list(op.relation_items))
                )
            elif isinstance(op, (MapOp, FilterOp, AggOp, LimitOp)):
                st = results[node.inputs[0]]
                if isinstance(st, _PendingAggBridge):
                    # The finalize half of a split aggregate: merge the
                    # shipped partial states on this card and finalize.
                    if not (isinstance(op, AggOp) and op.mode == "finalize"):
                        raise QueryError(
                            "agg bridge must feed its finalize AggOp"
                        )
                    results[nid] = merge_agg_bridge(self, st, stats)
                    continue
                if isinstance(st, HostBatch):
                    st = self._as_stream(st)
                if (st.chain and isinstance(st.chain[-1], LimitOp)) or (
                    isinstance(op, AggOp)
                    and any(isinstance(o, AggOp) for o in st.chain)
                ):
                    # A limit ends its fragment, and two aggregates never
                    # share one: materialize, then chain on the result.
                    st = self._as_stream(self._run_fragment(st, stats, cancel))
                results[nid] = st.extend(op)
            elif isinstance(op, JoinOp):
                fused = try_fused_join(self, nid, node, results, consumers,
                                       stats, cancel)
                if fused is not None:
                    self.last_join_decision = JoinDecision(
                        strategy="fused",
                        reason="dense-domain N:1 in-fragment lookup",
                    )
                    results[nid] = fused
                else:
                    # Ingest-sketch stats are read BEFORE materialization
                    # (the table provenance dies with the stream); they
                    # steer build-side choice, capacity and zone skipping.
                    lstats = stream_join_stats(
                        results[node.inputs[0]], op.left_on
                    )
                    rstats = stream_join_stats(
                        results[node.inputs[1]], op.right_on
                    )
                    left = mat_input(node.inputs[0])
                    right = mat_input(node.inputs[1])
                    # Join-buffer pre-sizing (pxbound): the plan-time
                    # capacity covers build sides the run-time sketches
                    # cannot see (post-aggregate ones), as the rung
                    # before the default.
                    planned = (
                        report.join_capacity.get(nid)
                        if report is not None else None
                    )
                    results[nid] = _join_dispatch(
                        left, right, op, self,
                        left_stats=lstats, right_stats=rstats,
                        cap_key=(self._plan_fingerprint(plan), nid),
                        planned_capacity=planned,
                        qstats=stats, cancel=cancel,
                    )
            elif isinstance(op, UnionOp):
                results[nid] = _union_host([mat_input(i) for i in node.inputs])
            elif isinstance(op, ResultSinkOp):
                src = node.inputs[0]
                r = results[src]
                if (not materialize and isinstance(r, _Stream)
                        and consumers.get(src, 0) <= 1):
                    # An aggregate stays on the card (the readback and
                    # any rebucket happen in DeviceResult.to_host); a
                    # row chain comes back as a HostBatch.
                    outputs[op.name] = self._run_fragment(
                        r, stats, cancel, defer=True
                    )
                else:
                    outputs[op.name] = mat_input(src)
            elif isinstance(op, TableSinkOp):
                # px.to_table: the rows land in the named table (created
                # at the first write), where later queries read them. Not
                # a client output; recorded on the engine.
                hb = mat_input(node.inputs[0])
                self.append_data(op.table, hb)
                self.last_table_sinks[op.table] = hb.length
            elif isinstance(op, OTelExportSinkOp):
                # px.export: the input comes to the host once (one
                # readback of a folded result), and every data spec of
                # the export reads that batch.
                from .otel import batch_to_otlp

                payload = batch_to_otlp(mat_input(node.inputs[0]), op.spec)
                self.export_otel(payload, op.spec.endpoint)
            elif isinstance(op, BridgeSinkOp):
                payload = bridge_payload(
                    self, results[node.inputs[0]], stats, cancel
                )
                outputs[("bridge", op.bridge_id)] = payload
                # Wire accounting: the bytes this fragment ships to the
                # merge tier.
                trace = getattr(stats, "trace", None)
                if trace is not None:
                    trace.add_wire_bytes(payload_nbytes(payload))
            elif isinstance(op, BridgeSourceOp):
                if not bridge_inputs or op.bridge_id not in bridge_inputs:
                    raise QueryError(f"no input for bridge {op.bridge_id}")
                results[nid] = bind_bridge(bridge_inputs[op.bridge_id])
            else:
                raise QueryError(f"unsupported operator {op}")
            # Fan-out of a stream: materialize once and share the batch,
            # EXCEPT pure table scans: their windows are resident, so
            # each consumer re-reading them is free, while a materialize
            # would round-trip the whole table through host memory.
            if consumers.get(nid, 0) > 1 and isinstance(results[nid], _Stream):
                st = results[nid]
                pure_scan = (
                    isinstance(st.source, list)
                    and not st.side
                    and _pure_select_map(st.chain) is not None
                )
                if not pure_scan:
                    results[nid] = self._run_fragment(st, stats, cancel)
        return outputs

    def export_otel(self, payload: dict, endpoint) -> None:
        """OTel egress. By default the payload is kept in memory
        (``otel_exports``; ``list.append`` is atomic under concurrent
        queries); a deployment binds an ``exec.otel.OTLPHttpExporter``
        in its place to push it."""
        self.otel_exports.append({"endpoint": endpoint, "payload": payload})

    @staticmethod
    def _note_scan_freshness(op, tablets, stats: QueryStats) -> None:
        """One table scan's staleness: its stop time (or now, for an
        unbounded scan) less the table's max event-time watermark."""
        from ..table_store import table as _table_mod

        wm = _table_mod.max_watermark_ns(tablets)
        if wm is not None:
            ref = op.stop_time if op.stop_time is not None else time.time_ns()
            stats.note_freshness_lag((int(ref) - wm) / 1e6, op.table)

    def _run_udtf(self, op: UDTFSourceOp) -> HostBatch:
        """Execute a UDTF source (``udtf_source_node.h`` analog): call its
        fn with this engine as context and shape the rows to the declared
        relation. The rows are host data; operators after the source
        stage them like any materialized batch."""
        udtf = self.registry.get_udtf(op.name)
        args = dict(op.args)
        for entry in udtf.init_args:  # declared defaults (3-tuples)
            if len(entry) == 3 and entry[0] not in args:
                args[entry[0]] = entry[2]
        data = udtf.fn(self, **args)
        rel = Relation(list(udtf.relation))
        return HostBatch.from_pydict(data, relation=rel, time_cols=())

    @staticmethod
    def _as_stream(hb: HostBatch) -> _Stream:
        return _Stream(hb.relation, dict(hb.dicts), [], hb)

    # -- the window path -------------------------------------------------------
    @staticmethod
    def _check_cancel(cancel) -> None:
        if cancel is not None and cancel.is_set():
            raise QueryCancelled("query cancelled")

    def _host_windows(self, hb: HostBatch):
        """A materialized host batch in slices of up to ``window_rows``."""
        for off in range(0, hb.length, self.window_rows):
            idx = slice(off, min(off + self.window_rows, hb.length))
            yield HostBatch(
                relation=hb.relation,
                cols={n: tuple(p[idx] for p in ps) for n, ps in hb.cols.items()},
                length=idx.stop - idx.start,
                dicts=hb.dicts,
            )

    def _staged_windows(self, stream: _Stream, stats: QueryStats, cancel):
        """Yield (cols, valid, source) per window of the stream's source.

        With ``device_residency`` on, table windows come from the device
        cache (``Table.device_scan``) and ``valid`` is the (lo - row0,
        hi - row0) pair of the query's live rows in the window; else
        host windows are read from the ring (or sliced from a
        materialized batch) and staged through ``to_device``, with a
        mask. ``source`` is the DeviceWindow or DeviceBatch, whose
        ``handoff`` the consumer calls before it reads the planes.
        Zone-map pruning runs before either stages. A tiered table's
        cold windows decode inside the staging, on the thread running
        this generator (the prefetch thread under a pipeline), whose
        decode meter is charged to the query after each window. The
        meter is cleared first: decodes this thread made outside the
        query (a ``read_all``, staging at append time) are not its."""
        take_decode_meter()
        if isinstance(stream.source, HostBatch):
            yield from self._stage_host(
                self._host_windows(stream.source), stats, cancel
            )
            return
        sop = stream.source_op
        for t in stream.source:
            if t._backend is None:
                continue
            pruner = chain_pruner(t, stream.chain, t.dicts, stats=stats)
            if self.device_residency and get_flag("device_residency"):
                scan = t.device_scan(
                    sop.start_time, sop.stop_time,
                    window_rows=self.window_rows, prune=pruner, stats=stats,
                )
                while True:
                    with _timed(stats, "stage"):
                        item = next(scan, None)
                        if item is not None:
                            _block_if(stats, self.device)
                    _charge_decode(stats)
                    if item is None:
                        break
                    win, lo, hi = item
                    self._check_cancel(cancel)
                    stats.rows += hi - lo
                    yield win.cols, (lo - win.row0, hi - win.row0), win
                continue
            yield from self._stage_host(
                t.scan(sop.start_time, sop.stop_time,
                       window_rows=self.window_rows, cols=sop.columns,
                       prune=pruner),
                stats, cancel,
            )

    def _stage_host(self, windows, stats: QueryStats, cancel):
        """Stage host windows through ``to_device`` (the non-resident
        path), timing the read and the staging apart. Each window pads to
        its own power-of-two size: eager PyTorch has no compiled program
        whose shape a fixed capacity would keep (the JAX engine pads to
        the window size for its jit cache), so a small materialized
        batch is not padded to a full window."""
        while True:
            with _timed(stats, "read"):
                hb = next(windows, None)
            _charge_decode(stats)
            if hb is None:
                return
            self._check_cancel(cancel)
            with _timed(stats, "stage"):
                db = self._stage(hb, bucket_capacity(hb.length))
                _block_if(stats, self.device)
            stats.add("staged", nbytes=sum(
                p.numel() * p.element_size()
                for ps in db.cols.values() for p in ps
            ))
            stats.rows += hb.length
            yield db.cols, db.valid, db

    def _stage(self, hb: HostBatch, capacity: int):
        """Pad a host window to capacity and place it on the device."""
        return hb.to_device(capacity, self.device)

    def _window_pipeline(self, stream: _Stream, stats: QueryStats,
                         cancel) -> WindowPipeline:
        """Pipelined view of ``_staged_windows``: staging of window N+1
        runs on a prefetch thread while the caller folds window N. An
        attribution run is serial. Callers MUST wrap iteration in
        try/finally close()."""
        depth = 1 if stats.sync else (
            self.pipeline_depth or get_flag("pipeline_depth")
        )
        return WindowPipeline(
            self._staged_windows(stream, stats, cancel), depth, cancel=cancel
        )

    def _note_pipeline(self, pipe: WindowPipeline, stats: QueryStats) -> None:
        """Fold a finished pipeline's counters into the query's stats (a
        plan with an interior limit runs two pipelines) and the engine's
        lifetime totals."""
        c = pipe.counters()
        stats.pipeline["depth"] = c["depth"]
        with self._state_lock:
            for k in ("windows", "stage_secs", "stall_secs"):
                stats.pipeline[k] += c[k]
                self.pipeline_totals[k] += c[k]

    def _put_side(self, v):
        """Put one fused-join side table on the engine's device (numpy
        tables from a host build; a dense aggregate's planes are there
        already). Called once per query, when the join fuses."""
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        if v.dtype == np.uint64:
            return torch.from_numpy(v.view(np.int64)).to(self.device).view(
                torch.uint64
            )
        return torch.from_numpy(np.ascontiguousarray(v)).to(self.device)

    @staticmethod
    def _with_side(cols, stream: _Stream):
        """A window's planes plus the stream's side tables (read by the
        fragment's lookup joins); the window's own dict is not changed."""
        return {**cols, "__side__": stream.side} if stream.side else cols

    def _fold_agg_state(self, stream: _Stream, frag, stats: QueryStats, cancel):
        """Stream the source through the fragment's window fold, returning
        the accumulated (unfinalized) group state. No per-window fence."""
        init_state, agg_step, _ = self._compile_steps(frag)
        state = init_state()
        pipe = self._window_pipeline(stream, stats, cancel)
        try:
            for cols, valid, src in pipe:
                src.handoff()
                cols = self._with_side(cols, stream)
                with _timed(stats, "compute"):
                    state = agg_step(state, cols, valid)
                    _block_if(stats, self.device)
                stats.windows += 1
        finally:
            pipe.close()
            self._note_pipeline(pipe, stats)
        return state

    def _compile_steps(self, frag):
        """(init_state, agg_step, rows_step) for a compiled fragment:
        ``agg_step(state, cols, valid)`` folds one window into the
        running group state, ``rows_step(cols, valid)`` runs a row chain
        over one window. A mesh engine (``parallel/executor.py``) runs
        them over its row shards."""
        if frag.is_agg:
            def agg_step(state, cols, valid):
                return frag.merge_states(state, frag.window_state(cols, valid))

            return frag.init_state, agg_step, None
        return None, None, frag.update

    def _compile(self, stream: _Stream):
        return compile_fragment(
            stream.chain, stream.relation, stream.dicts, self.registry,
            self.device, col_stats=_stream_col_stats(stream),
        )

    def _fold_finalize(self, stream: _Stream, frag, stats: QueryStats,
                       cancel):
        """Fold the stream through an aggregate fragment and finalize:
        the [G] output planes, their valid mask and the overflow flag,
        all still on the device (the fused join's dense build reads them
        there; ``_agg_result`` takes them to the host). The fragment's
        record is ``stats.fragments[-1]`` when it returns."""
        stats.new_fragment(stream.chain, frag)
        state = self._fold_agg_state(stream, frag, stats, cancel)
        with _timed(stats, "finalize"):
            return frag.finalize(state)

    def _agg_result(self, stream: _Stream, frag, out_cols, valid, overflow,
                    stats: QueryStats, cancel, fstats=None) -> HostBatch:
        """A finalized aggregate's rows on the host, rebucketing while it
        overflowed (the JAX engine's retry: more distinct keys than
        max_groups, or an integer key that escaped its stats-derived
        domain): double max_groups, recompile against the stats as they
        are now and fold the stream again, each attempt a fragment
        record marked ``rebucket``; past max_groups_limit, raise. One
        read of the overflow flag per fold. ``fstats`` is the record of
        the fold that made ``out_cols`` (default: the query's last)."""
        if fstats is None:
            fstats = stats.fragments[-1]
        while True:
            with _timed(stats, "finalize"):
                if not bool(overflow):
                    out = _to_host_batch(frag.out_meta, out_cols, valid)
                    fstats.rows_out = out.length
                    break
            del out_cols, valid, overflow
            stream = _double_agg_groups(stream)
            frag = self._compile(stream)
            stats.rebuckets += 1
            out_cols, valid, overflow = self._fold_finalize(
                stream, frag, stats, cancel
            )
            fstats = stats.fragments[-1]
            fstats.ops = fstats.ops + ("rebucket",)
        return _apply_limit(out, frag.limit)

    def _materialize(self, res, stats: QueryStats, cancel) -> HostBatch:
        """A node's result as a host batch: a stream runs its fragment, a
        DeviceResult reads back."""
        if isinstance(res, HostBatch):
            return res
        if isinstance(res, DeviceResult):
            return res.to_host()
        return self._run_fragment(res, stats, cancel)

    def _run_fragment(self, stream: _Stream, stats: QueryStats, cancel,
                      defer: bool = False):
        """Run a stream's fragment. An aggregate's answer is read back at
        once, or with ``defer`` left on the card as a ``DeviceResult``;
        a row chain's windows come back as one HostBatch."""
        frag = self._compile(stream)
        if frag.is_agg:
            out_cols, valid, overflow = self._fold_finalize(
                stream, frag, stats, cancel
            )
            if defer:
                return DeviceResult(self, stream, frag, out_cols, valid,
                                    overflow, stats, stats.fragments[-1])
            return self._agg_result(stream, frag, out_cols, valid, overflow,
                                    stats, cancel)
        fstats = stats.new_fragment(stream.chain, frag)

        # Rows: each window's surviving rows to the host, stopping early
        # once the limit is met.
        _, _, rows_step = self._compile_steps(frag)
        pieces, total = [], 0
        pipe = self._window_pipeline(stream, stats, cancel)
        try:
            for cols, valid, src in pipe:
                src.handoff()
                cols = self._with_side(cols, stream)
                with _timed(stats, "compute"):
                    out_cols, out_valid = rows_step(cols, valid)
                    _block_if(stats, self.device)
                stats.windows += 1
                with _timed(stats, "materialize"):
                    piece = _to_host_batch(
                        frag.out_meta, out_cols, out_valid,
                        None if frag.limit is None else frag.limit - total,
                    )
                pieces.append(piece)
                total += piece.length
                if frag.limit is not None and total >= frag.limit:
                    break
        finally:
            pipe.close()
            self._note_pipeline(pipe, stats)
        out = _apply_limit(_concat_host(pieces, frag.relation), frag.limit)
        fstats.rows_out = out.length
        return out
