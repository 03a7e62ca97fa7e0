"""Telemetry as tables: the engine's own history, queryable with PxL.

A port of the JAX package's ``services/telemetry.py``.

The platform that observes your cluster is observable the same way: a
``TelemetryCollector`` registers as a finished-trace listener on an
engine's ``Tracer`` (``exec/trace.py``) and folds every trace + its
``QueryResourceUsage`` into real ``table_store`` tables —

- ``__queries__``  one row per finished query/fragment/merge trace
- ``__spans__``    one row per span (bounded per trace)
- ``__agents__``   the folding agent's running totals per finished trace

— with bounded retention (each table's byte-budget ring expires its own
oldest rows, the same mechanism that bounds ingest tables). Bundled PxL
scripts (``px/slow_queries``, ``px/query_cost``, ``px/agent_health``)
run over these through the NORMAL engine path: on a cluster the
distributed planner fans the scan across every agent's local telemetry,
so per-agent attribution falls out of the ``agent_id`` column.

The collector also closes the planner's feedback loop (PAPERS.md
"Online Sketch-based Query Optimization", arXiv:2102.02440): observed
aggregate output cardinalities per script hash are retained and exposed
through ``Engine._compile_table_stats`` under ``__observed__``, where
``push_agg_through_join`` floors its partial-agg capacity at reality.

``ClusterTraceView`` is the stitching half (PAPERS.md "Near Data
Processing in Taurus", 2506.20010 — ship span summaries, not rows):
agents publish the spans of traces that carry a distributed parent
context on ``telemetry.spans``, the broker's view groups them with its
own dispatch spans by trace id, and ``/debug/tracez`` renders one
coherent waterfall per distributed query.

Both classes run OFF the engine's hot path: folding happens in
``Tracer.end_query`` once the query's result is on the host, and reads
only Python numbers (no tensor, so no device work and no syncs); all
shared state is lock-guarded (bus dispatcher threads).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from ..config import get_flag
from ..ingest.schemas import TELEMETRY_SCHEMAS

#: Bus topic distributed-trace span summaries ride on (agent -> broker).
TOPIC_SPANS = "telemetry.spans"

#: Span rows folded/published per trace (the trace itself caps spans at
#: 512; telemetry keeps the head — root/compile/fragments come first).
MAX_SPAN_ROWS = 128

#: Observed-cardinality entries retained (per script hash; LRU-evicted).
MAX_OBSERVED = 256


def _span_rows(trace, agent_id: str, end_ns: int) -> dict:
    spans = trace.spans[:MAX_SPAN_ROWS]
    return {
        "time_": [s.start_unix_nano or end_ns for s in spans],
        "trace_id": [trace.trace_id] * len(spans),
        "span_id": [s.span_id for s in spans],
        "parent_id": [s.parent_id for s in spans],
        "name": [s.name for s in spans],
        "agent_id": [agent_id] * len(spans),
        "duration_ms": [
            ((s.end_unix_nano - s.start_unix_nano) / 1e6
             if s.end_unix_nano and s.start_unix_nano else 0.0)
            for s in spans
        ],
    }


def _span_summaries(trace) -> list:
    """Compact wire form of a trace's spans (ClusterTraceView rows)."""
    out = []
    for s in trace.spans[:MAX_SPAN_ROWS]:
        d = {
            "span_id": s.span_id,
            "parent_id": s.parent_id,
            "name": s.name,
            "start_unix_nano": int(s.start_unix_nano),
            "end_unix_nano": int(s.end_unix_nano),
        }
        status = s.attributes.get("status")
        if status:
            d["status"] = str(status)
        out.append(d)
    return out


class TableStatsCollector:
    """Folds table-store freshness snapshots into ``__tables__``.

    One row per (agent, table) whose stats CHANGED since this
    collector's previous fold (a change cursor, like the ``__programs__``
    drain: an idle table contributes zero rows however often the fold
    runs). Fired from two cadences — every finished trace (so a query
    immediately sees current storage state in its own history) and the
    agent heartbeat loop (so a query-less ingesting agent still records
    its watermark advance). ``__tables__`` itself is excluded: folding
    it would make every fold a change (each fold appends to it), one
    self-perpetuating row per fold forever on an idle system.

    Host-only arithmetic over already-maintained counters; the lock
    serializes the cursor against concurrent trace listeners +
    heartbeat threads.
    """

    def __init__(self, engine, agent_id: str = "engine"):
        self.engine = engine
        self.agent_id = agent_id
        self._lock = threading.Lock()
        self._last: dict = {}  # table -> change signature tuple

    @staticmethod
    def _signature(f: dict) -> tuple:
        """What 'changed' means: any counter/watermark/size movement.
        ``last_append``/EWMA excluded on purpose — they only move when a
        counter does, and including wall-clock would defeat the cursor."""
        return (
            f["rows_total"], f["expired_rows_total"], f["bytes_total"],
            f["expired_bytes_total"], f["watermark"], f["device_bytes"],
            f["hot_bytes"],
        )

    def fold(self, end_ns: int | None = None, force: bool = False,
             snapshot: dict | None = None) -> int:
        """Append a ``__tables__`` row per changed table (every table
        when ``force`` — the heartbeat cadence, matching the reference's
        stats-on-every-heartbeat: an idle table's row still advances
        ``time_`` past its frozen watermark, which is exactly how
        px/ingest_lag sees a STOPPED ingest as growing lag). The
        change-cursored (per-trace) form covers USER tables only: the
        fold pass itself just appended to ``__queries__``/``__spans__``,
        so dunder tables are "changed" on every finished trace — rows
        for them at query rate would let self-telemetry snapshots evict
        the user-table history out of the ring; they fold at the
        bounded heartbeat cadence instead. ``snapshot`` lets the
        heartbeat reuse one ``TableStore.freshness()`` sweep for both
        the fold and the envelope. Returns the row count."""
        end_ns = end_ns or time.time_ns()
        snap = dict(
            snapshot if snapshot is not None
            else self.engine.table_store.freshness()
        )
        snap.pop("__tables__", None)
        with self._lock:
            changed = {
                name: f for name, f in snap.items()
                if (force or not name.startswith("__"))
                and (force or self._last.get(name) != self._signature(f))
            }
            if not changed:
                return 0
            names = sorted(changed)
            rows = [changed[n] for n in names]
            n = len(names)
            self.engine.append_data("__tables__", {
                "time_": [end_ns] * n,
                "agent_id": [self.agent_id] * n,
                "table": names,
                "rows": [f["rows"] for f in rows],
                "bytes": [f["bytes"] for f in rows],
                "hot_bytes": [f["hot_bytes"] for f in rows],
                "cold_bytes": [f["cold_bytes"] for f in rows],
                "hot_rows": [f["hot_rows"] for f in rows],
                "cold_rows": [f["cold_rows"] for f in rows],
                "cold_raw_bytes": [f["cold_raw_bytes"] for f in rows],
                "cold_demotions_total": [
                    f["cold_demotions_total"] for f in rows
                ],
                "cold_evictions_total": [
                    f["cold_evictions_total"] for f in rows
                ],
                "device_bytes": [f["device_bytes"] for f in rows],
                "rows_total": [f["rows_total"] for f in rows],
                "bytes_total": [f["bytes_total"] for f in rows],
                "expired_rows_total": [
                    f["expired_rows_total"] for f in rows
                ],
                "expired_bytes_total": [
                    f["expired_bytes_total"] for f in rows
                ],
                "watermark": [f["watermark"] for f in rows],
                "min_time": [f["min_time"] for f in rows],
                "last_append": [f["last_append"] for f in rows],
                "ingest_rows_per_s": [
                    float(f["ingest_rows_per_s"]) for f in rows
                ],
            })
            # Commit the cursor only after a successful append (the
            # __programs__ contract: a raising ring must not eat rows).
            for name, f in changed.items():
                self._last[name] = self._signature(f)
            return n


class BusStatsCollector:
    """Folds bus transport snapshots into ``__bus__``.

    One row per (kind, topic_class/peer, direction) key whose counters
    CHANGED since this collector's previous fold (the ``__tables__``
    change-cursor shape). Fired from the heartbeat cadence ONLY, never
    per trace: every distributed trace moves its own ack/dispatch
    counters, so a per-trace fold would be a self-perpetuating row per
    query — the same reasoning that keeps dunder tables out of the
    per-trace ``__tables__`` fold. Reads whatever ``bus.stats`` the
    agent's transport carries (``MessageBus`` or ``RemoteBus``); a
    stats-less bus (``bus_telemetry`` off, or no bus at all) folds
    nothing.
    """

    def __init__(self, engine, agent_id: str = "engine", bus=None):
        self.engine = engine
        self.agent_id = agent_id
        self.bus = bus
        self._lock = threading.Lock()
        self._last: dict = {}  # (kind, key, direction) -> signature

    @staticmethod
    def _signature(r: dict) -> tuple:
        """Any counter movement is a change; the histogram quantiles
        only move when a counter does."""
        return (r["msgs"], r["bytes"], r["errors"], r["queue_high_water"])

    def fold(self, end_ns: int | None = None, force: bool = False) -> int:
        """Append a ``__bus__`` row per changed key (every key when
        ``force`` — the heartbeat cadence). Returns the row count."""
        stats = getattr(self.bus, "stats", None)
        if stats is None:
            return 0
        end_ns = end_ns or time.time_ns()
        snap = stats.snapshot()
        with self._lock:
            changed = [
                r for r in snap
                if force or self._last.get(
                    (r["kind"], r["topic_class"], r["direction"])
                ) != self._signature(r)
            ]
            if not changed:
                return 0
            n = len(changed)
            self.engine.append_data("__bus__", {
                "time_": [end_ns] * n,
                "agent_id": [self.agent_id] * n,
                "kind": [r["kind"] for r in changed],
                "topic_class": [r["topic_class"] for r in changed],
                "direction": [r["direction"] for r in changed],
                "msgs": [int(r["msgs"]) for r in changed],
                "bytes": [int(r["bytes"]) for r in changed],
                "errors": [int(r["errors"]) for r in changed],
                "lag_p50_ms": [float(r["lag_p50_ms"]) for r in changed],
                "lag_p99_ms": [float(r["lag_p99_ms"]) for r in changed],
                "service_p50_ms": [
                    float(r["service_p50_ms"]) for r in changed
                ],
                "service_p99_ms": [
                    float(r["service_p99_ms"]) for r in changed
                ],
                "queue_high_water": [
                    int(r["queue_high_water"]) for r in changed
                ],
            })
            # Commit the cursor only after a successful append (the
            # __programs__ contract: a raising ring must not eat rows).
            for r in changed:
                self._last[
                    (r["kind"], r["topic_class"], r["direction"])
                ] = self._signature(r)
            return n


class TelemetryCollector:
    """Folds one engine's finished traces into its own table store."""

    def __init__(self, engine, agent_id: str = "engine",
                 kind: str = "engine", bus=None):
        self.engine = engine
        self.agent_id = agent_id
        self.kind = kind
        self.bus = bus
        # Storage-tier fold (``__tables__``): shared with the agent
        # heartbeat loop, which calls table_stats.fold() on its cadence.
        self.table_stats = TableStatsCollector(engine, agent_id)
        # Transport-tier fold (``__bus__``): heartbeat cadence only —
        # see BusStatsCollector on why never per trace.
        self.bus_stats = BusStatsCollector(engine, agent_id, bus=bus)
        self._lock = threading.Lock()
        self._totals = {
            "queries": 0, "errors": 0, "bytes_staged": 0,
            "device_ms": 0.0, "wire_bytes": 0,
        }
        self._observed: "OrderedDict[str, dict]" = OrderedDict()
        self._installed = False
        self.fold_errors = 0  # visible health of the fold path itself
        # __programs__ drain cursor into the process program registry
        # (exec/programs.py): each collector folds the rows that changed
        # since ITS last fold, so co-resident agents each get the full
        # program history in their own table.
        self._programs_seq = 0

    # -- lifecycle -----------------------------------------------------------
    def install(self) -> "TelemetryCollector":
        """Create the telemetry tables (bounded rings) and start folding.
        Idempotent; returns self."""
        if self._installed:
            return self
        budget = max(int(get_flag("telemetry_table_mb")), 1) << 20
        for name, rel in TELEMETRY_SCHEMAS.items():
            if self.engine.table_store.relation(name) is None:
                self.engine.create_table(name, rel, max_bytes=budget)
        self.engine.tracer.add_listener(self.on_trace)
        self.engine.telemetry = self
        self._installed = True
        return self

    # -- the fold (Tracer listener) ------------------------------------------
    def on_trace(self, trace) -> None:
        # Tracer._notify already contains exceptions, but count them
        # here too so a schema drift is visible, not silent.
        try:
            self._fold(trace)
        except Exception:
            with self._lock:
                self.fold_errors += 1
            raise

    def _fold(self, trace) -> None:
        end_ns = trace.end_unix_nano or time.time_ns()
        u = trace.usage
        agent = trace.agent_id or self.agent_id
        pred = trace.predicted or {}
        pred_bytes = pred.get("bytes_staged_hi")
        pred_rows = pred.get("rows_in_hi")
        self.engine.append_data("__queries__", {
            "time_": [end_ns],
            "trace_id": [trace.trace_id],
            "qid": [trace.qid or ""],
            "tenant": [getattr(trace, "tenant", "") or ""],
            "agent_id": [agent],
            "kind": [trace.kind],
            "script_hash": [trace.script_hash],
            "script": [trace.script[:200]],
            "status": [trace.status],
            "duration_ms": [trace.duration_s * 1e3],
            "rows_in": [int(u.rows_in)],
            "rows_out": [int(u.rows_out)],
            "windows": [int(u.windows)],
            "bytes_staged": [int(u.bytes_staged)],
            "device_ms": [float(u.device_ms)],
            "compile_ms": [float(u.compile_ms)],
            "stall_ms": [float(u.stall_ms)],
            "wire_bytes": [int(u.wire_bytes)],
            "retries": [int(u.retries)],
            "skipped_windows": [int(u.skipped_windows)],
            # None on a CPU engine (no allocator statistics).
            "device_peak_bytes": [int(u.device_peak_bytes or 0)],
            # 0 = unknown (sketch-less plan / no bounds pass) — the
            # calibration scripts filter on > 0.
            "predicted_bytes": [int(pred_bytes or 0)],
            "predicted_rows": [int(pred_rows or 0)],
            "freshness_lag_ms": [float(u.freshness_lag_ms)],
            "cache": [getattr(trace, "cache", "")],
        })
        self.engine.append_data("__spans__", _span_rows(trace, agent, end_ns))
        self._fold_programs(end_ns)
        self.table_stats.fold(end_ns)
        with self._lock:
            t = self._totals
            t["queries"] += 1
            if trace.status == "error":
                t["errors"] += 1
            t["bytes_staged"] += int(u.bytes_staged)
            t["device_ms"] += float(u.device_ms)
            t["wire_bytes"] += int(u.wire_bytes)
            snapshot = dict(t)
            self._record_observed(trace)
        self.engine.append_data("__agents__", {
            "time_": [end_ns],
            "agent_id": [self.agent_id],
            "kind": [self.kind],
            "queries_total": [snapshot["queries"]],
            "errors_total": [snapshot["errors"]],
            "bytes_staged_total": [snapshot["bytes_staged"]],
            "device_ms_total": [snapshot["device_ms"]],
            "wire_bytes_total": [snapshot["wire_bytes"]],
        })
        # Distributed participants ship their span summary to the
        # broker's ClusterTraceView (sketch-sized telemetry, not rows).
        if self.bus is not None and trace.parent_ctx:
            self.bus.publish(TOPIC_SPANS, {
                "trace_id": trace.trace_id,
                "agent": agent,
                "spans": _span_summaries(trace),
            })

    def _fold_programs(self, end_ns: int) -> None:
        """Drain program-registry updates into ``__programs__`` (one
        cumulative-counter row per changed program; host-list arithmetic
        only — same no-sync contract as the trace fold)."""
        from ..exec.programs import default_program_registry

        # The whole fetch-append-commit runs under the collector lock:
        # listeners fire on whichever thread finished the trace (stream
        # cursor threads overlap query threads), and the cursor must
        # advance exactly once per successfully-appended row set — an
        # early commit would permanently drop rows when append_data
        # raises (ring budget/schema drift), an unlocked one could
        # double-fold or regress. Row volume is bounded by the registry
        # size, so the held append is small host-list work.
        with self._lock:
            cursor, rows = default_program_registry().rows(
                self._programs_seq
            )
            if rows:
                self._append_program_rows(end_ns, rows)
            self._programs_seq = max(self._programs_seq, cursor)

    def _append_program_rows(self, end_ns: int, rows: list) -> None:
        n = len(rows)
        self.engine.append_data("__programs__", {
            "time_": [end_ns] * n,
            "agent_id": [self.agent_id] * n,
            "program_id": [r["program_id"] for r in rows],
            "kind": [r["kind"] for r in rows],
            "label": [r["label"] for r in rows],
            "compiles": [int(r["compiles"]) for r in rows],
            "hits": [int(r["hits"]) for r in rows],
            "compile_ms": [float(r["compile_ms"]) for r in rows],
            "flops": [float(r["flops"]) for r in rows],
            "bytes_accessed": [float(r["bytes_accessed"]) for r in rows],
            "argument_bytes": [int(r["argument_bytes"]) for r in rows],
            "temp_bytes": [int(r["temp_bytes"]) for r in rows],
            "peak_bytes": [int(r["peak_bytes"]) for r in rows],
        })

    # -- planner feedback ----------------------------------------------------
    def _record_observed(self, trace) -> None:
        """Caller holds self._lock. Retain observed output cardinalities
        per script hash: the max aggregate-fragment rows_out is the true
        group count the sketch-driven sizing only estimated."""
        if trace.status != "ok":
            return
        agg_groups = 0
        for f in trace.stats.fragments:
            if any(op in ("AggOp", "rebucket") for op in f.ops):
                agg_groups = max(agg_groups, int(f.rows_out))
        ent = self._observed.pop(trace.script_hash, None) or {
            "agg_groups": 0, "rows_out": 0, "runs": 0,
        }
        ent["agg_groups"] = max(ent["agg_groups"], agg_groups)
        ent["rows_out"] = max(ent["rows_out"], int(trace.rows_out))
        ent["runs"] += 1
        self._observed[trace.script_hash] = ent  # re-insert = most recent
        while len(self._observed) > MAX_OBSERVED:
            self._observed.popitem(last=False)

    def observed(self) -> dict:
        """{script_hash: {agg_groups, rows_out, runs}} snapshot — what
        ``Engine._compile_table_stats`` exposes under ``__observed__``."""
        with self._lock:
            return {h: dict(e) for h, e in self._observed.items()}

    def totals(self) -> dict:
        with self._lock:
            return dict(self._totals)


class ObservedCostIndex:
    """Observed per-script-hash resource history → admission floor.

    The observed half of the arXiv:2102.02440 feedback loop at the
    BROKER: a tracer listener retains, per script hash, the maximum
    observed ``bytes_staged``/``rows_in`` of finished queries (the same
    numbers the agents' collectors fold into ``__queries__`` — the
    broker has no table store, so it indexes its own traces, whose
    usage is the merged per-agent record). ``floor_predicted`` then
    calibrates a pxbound prediction against that history the way
    ``push_agg_through_join`` floors its capacity at observed
    cardinality: an UNKNOWN (sketch-less) prediction with history
    becomes the observed bytes instead of zero, and a known prediction
    below observed reality is raised to it — so admission control
    (`_Admission`) schedules on calibrated rather than worst-case (or
    no) bounds. Bounded LRU; lock-guarded (tracer listeners run on
    whatever thread finished the query).
    """

    def __init__(self, tracer=None, max_entries: int = MAX_OBSERVED):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        if tracer is not None:
            tracer.add_listener(self.on_trace)

    def on_trace(self, trace) -> None:
        if trace.status not in ("ok", "partial"):
            return
        u = trace.usage
        with self._lock:
            ent = self._entries.pop(trace.script_hash, None) or {
                "bytes_staged": 0, "rows_in": 0, "runs": 0,
            }
            ent["bytes_staged"] = max(
                ent["bytes_staged"], int(u.bytes_staged)
            )
            ent["rows_in"] = max(ent["rows_in"], int(u.rows_in))
            ent["runs"] += 1
            self._entries[trace.script_hash] = ent  # re-insert = recent
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def observed(self, script_hash: str) -> dict | None:
        with self._lock:
            ent = self._entries.get(script_hash)
            return dict(ent) if ent is not None else None

    def floor_predicted(self, predicted: dict | None,
                        script_hash: str) -> dict | None:
        """Calibrated prediction: ``predicted`` floored at the observed
        history for ``script_hash`` (returns a NEW dict when flooring
        applied; the input is never mutated — it may already be stamped
        on a trace). No history, or history of zero staged bytes
        (fully device-resident runs), leaves the prediction unchanged —
        the floor can only ever RAISE the admission account."""
        ent = self.observed(script_hash)
        obs = int(ent["bytes_staged"]) if ent else 0
        if obs <= 0:
            return predicted
        pred_bytes = (predicted or {}).get("bytes_staged_hi")
        if pred_bytes is not None and int(pred_bytes) >= obs:
            return predicted
        out = dict(predicted or {})
        out["bytes_staged_hi"] = obs
        out["observed_floor"] = obs
        out["origin"] = (
            "observed" if pred_bytes is None
            else f"{out.get('origin', 'sketch')}+observed"
        )
        # Observed history carries no safety multiplier; keep the key
        # present so admission-reject diagnostics render "x1 safety"
        # instead of "xNone" when the floor built the dict from scratch.
        out.setdefault("safety", 1.0)
        return out


class ClusterTraceView:
    """Cluster-wide stitched traces for ``/debug/tracez`` (broker role).

    Collects span summaries from two feeds — the local tracer's finished
    traces (the broker's compile/dispatch/failover spans) and agents'
    ``telemetry.spans`` publications — grouped by trace id in a bounded
    LRU. A distributed query therefore renders as ONE trace: the
    broker's dispatch span parenting every agent's fragment spans.
    """

    def __init__(self, bus=None, tracer=None, max_traces: int = 64,
                 max_spans: int = 1024):
        self.max_traces = max_traces
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, dict]" = OrderedDict()
        self._sub = (
            bus.subscribe(TOPIC_SPANS, self._on_spans)
            if bus is not None else None
        )
        if tracer is not None:
            tracer.add_listener(self.add_trace)

    def close(self) -> None:
        if self._sub is not None:
            self._sub.unsubscribe()
            self._sub = None

    # -- feeds ---------------------------------------------------------------
    def add_trace(self, trace) -> None:
        """Local-tracer listener (broker's own traces)."""
        self._ingest(
            trace.trace_id, trace.agent_id or "broker",
            _span_summaries(trace),
        )

    def _on_spans(self, msg) -> None:
        tid, spans = msg.get("trace_id"), msg.get("spans")
        if isinstance(tid, str) and isinstance(spans, list):
            self._ingest(tid, str(msg.get("agent", "?")), spans)

    def _ingest(self, trace_id: str, agent: str, spans: list) -> None:
        with self._lock:
            ent = self._traces.pop(trace_id, None) or {
                "spans": [], "agents": set(), "updated_unix_nano": 0,
            }
            room = self.max_spans - len(ent["spans"])
            if room > 0:
                ent["spans"].extend(spans[:room])
            ent["agents"].add(agent)
            ent["updated_unix_nano"] = time.time_ns()
            self._traces[trace_id] = ent  # re-insert = most recent
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)

    # -- the /debug/tracez surface -------------------------------------------
    def tracez(self) -> dict:
        with self._lock:
            rows = [
                {
                    "trace_id": tid,
                    "agents": sorted(ent["agents"]),
                    "spans": len(ent["spans"]),
                    "root": next(
                        (s for s in ent["spans"] if not s["parent_id"]),
                        None,
                    ),
                    "updated_unix_nano": ent["updated_unix_nano"],
                }
                for tid, ent in reversed(self._traces.items())
            ]
        return {"traces": rows}

    def get(self, trace_id: str) -> dict | None:
        """Full stitched span list for one trace (newest-first feed
        order preserved per participant)."""
        with self._lock:
            ent = self._traces.get(trace_id)
            if ent is None:
                return None
            return {
                "trace_id": trace_id,
                "agents": sorted(ent["agents"]),
                "spans": [dict(s) for s in ent["spans"]],
            }


def enable_self_telemetry(engine, agent_id: str = "engine",
                          kind: str = "engine",
                          bus=None) -> TelemetryCollector:
    """Wire a TelemetryCollector onto an engine (idempotent: an engine
    that already has one keeps it)."""
    if getattr(engine, "telemetry", None) is not None:
        return engine.telemetry
    return TelemetryCollector(engine, agent_id, kind, bus=bus).install()


# -- profiling tier: folded-stack math + export formats ----------------------
#
# Pure host arithmetic over {folded_stack: count} maps and the
# profile-summary row shape agents ship in heartbeats
# ({stack, count, qid, script_hash, tenant, phase} — see
# ingest/profiler.py profile_summary). The broker's /debug/pprof,
# /debug/flamez and `px profile --diff` are thin wrappers over these.

def profile_counts(
    rows,
    tenant: str | None = None,
    script_hash: str | None = None,
    phase: str | None = None,
) -> dict[str, int]:
    """Collapse profile-summary rows to ``{folded_stack: count}``,
    optionally filtered by attribution."""
    out: dict[str, int] = {}
    for r in rows or ():
        if tenant is not None and r.get("tenant", "") != tenant:
            continue
        if script_hash is not None and r.get("script_hash", "") != script_hash:
            continue
        if phase is not None and r.get("phase", "") != phase:
            continue
        stack = r.get("stack", "")
        if not stack:
            continue
        out[stack] = out.get(stack, 0) + int(r.get("count", 0))
    return out


def counts_delta(before: dict, after: dict) -> dict[str, int]:
    """Per-stack growth between two cumulative snapshots (the
    ``/debug/pprof?seconds=N`` windowing primitive). Counts are
    monotonic per surviving stack; stacks evicted from a bounded
    summary between snapshots clamp to 0 rather than going negative."""
    return {
        s: n - before.get(s, 0)
        for s, n in after.items()
        if n - before.get(s, 0) > 0
    }


def collapsed_text(counts: dict[str, int]) -> str:
    """Flamegraph collapsed format: one ``stack count`` line per folded
    stack, hottest first — feedable to flamegraph.pl / speedscope / any
    pprof-collapsed importer."""
    lines = [
        f"{stack} {n}"
        for stack, n in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    ]
    return "\n".join(lines) + ("\n" if lines else "")


def profile_diff(base: dict, cmp: dict) -> list[dict]:
    """Differential profile between two ``{folded_stack: count}`` maps
    (two time windows, two script hashes, before/after a change...).

    Per-frame rows — ``frame`` is one ``file:func`` element — with
    **self** counts (samples where the frame is the leaf) and **total**
    counts (samples where it appears anywhere on the stack, counted
    once per stack), sorted by largest absolute self delta. This is the
    regression-hunting primitive: a frame whose self_delta jumped owns
    the new CPU; one whose total_delta jumped but self_delta did not is
    just calling someone who does."""
    def per_frame(counts: dict) -> tuple[dict, dict]:
        self_c: dict[str, int] = {}
        total_c: dict[str, int] = {}
        for stack, n in counts.items():
            frames = stack.split(";")
            leaf = frames[-1]
            self_c[leaf] = self_c.get(leaf, 0) + n
            for f in set(frames):
                total_c[f] = total_c.get(f, 0) + n
        return self_c, total_c

    self_b, total_b = per_frame(base)
    self_c, total_c = per_frame(cmp)
    rows = []
    for frame in set(total_b) | set(total_c):
        sb, sc = self_b.get(frame, 0), self_c.get(frame, 0)
        tb, tc = total_b.get(frame, 0), total_c.get(frame, 0)
        rows.append({
            "frame": frame,
            "self_base": sb, "self_cmp": sc, "self_delta": sc - sb,
            "total_base": tb, "total_cmp": tc, "total_delta": tc - tb,
        })
    rows.sort(
        key=lambda r: (
            -abs(r["self_delta"]), -abs(r["total_delta"]), r["frame"]
        )
    )
    return rows


def _flame_tree(counts: dict[str, int]) -> dict:
    """Folded stacks -> nested {name, value, children: [...]} tree."""
    root: dict = {"name": "all", "value": 0, "children": {}}
    for stack, n in counts.items():
        root["value"] += n
        node = root
        for frame in stack.split(";"):
            child = node["children"].setdefault(
                frame, {"name": frame, "value": 0, "children": {}}
            )
            child["value"] += n
            node = child

    def finish(node: dict) -> dict:
        kids = sorted(
            (finish(c) for c in node["children"].values()),
            key=lambda c: -c["value"],
        )
        return {"name": node["name"], "value": node["value"], "children": kids}

    return finish(root)


def flame_html(counts: dict[str, int], title: str = "pixie flame") -> str:
    """Self-contained static HTML flamegraph (no external assets): the
    folded-stack tree is embedded as JSON and rendered by ~30 lines of
    vanilla JS as nested width-proportional boxes with hover detail and
    click-to-zoom."""
    import html as _html
    import json as _json

    tree = _flame_tree(counts)
    return f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{_html.escape(title)}</title>
<style>
body {{ font: 12px monospace; margin: 8px; background: #fff; }}
#flame {{ position: relative; }}
#flame div.f {{ position: absolute; box-sizing: border-box;
  overflow: hidden; white-space: nowrap; height: 17px;
  border: 1px solid #fff; cursor: pointer; }}
#meta {{ margin-bottom: 8px; color: #444; }}
</style></head><body>
<div id="meta">{_html.escape(title)} — total samples: {tree["value"]}
 (click a frame to zoom; click the root frame to reset)</div>
<div id="flame"></div>
<script>
const TREE = {_json.dumps(tree)};
const el = document.getElementById('flame');
function render(root) {{
  el.innerHTML = '';
  let maxDepth = 0;
  function place(node, x, frac, depth) {{
    maxDepth = Math.max(maxDepth, depth);
    const d = document.createElement('div'); d.className = 'f';
    d.style.left = (x * 100).toFixed(4) + '%';
    d.style.width = (frac * 100).toFixed(4) + '%';
    d.style.top = (depth * 18) + 'px';
    const pct = root.value ? (100 * node.value / root.value) : 0;
    d.textContent = node.name;
    d.title = node.name + ' — ' + node.value + ' samples (' +
      pct.toFixed(2) + '%)';
    d.style.background = depth === 0 ? '#d9d9d9' :
      'hsl(' + (38 - 18 * Math.min(pct, 100) / 100) + ',90%,' +
      (62 + (node.name.length % 5) * 2) + '%)';
    d.onclick = () => render(depth === 0 ? TREE : node);
    el.appendChild(d);
    let cx = x;
    for (const c of node.children) {{
      const cf = node.value ? frac * c.value / node.value : 0;
      if (root.value && c.value / root.value > 0.0005)
        place(c, cx, cf, depth + 1);
      cx += cf;
    }}
  }}
  place(root, 0, 1.0, 0);
  el.style.height = ((maxDepth + 1) * 18 + 4) + 'px';
}}
render(TREE);
</script></body></html>
"""
