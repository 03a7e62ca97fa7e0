"""Agent runtime: PEM (data) and Kelvin (merge) agents over the bus.

Reference parity: ``src/vizier/services/agent/manager/manager.h:102`` —
an agent connects to the control plane, registers, heartbeats every 5s,
and handles execute-query messages (``exec.h:38`` ->
``Carnot::ExecutePlan``). A PEM owns a local engine + table store and
runs data fragments; every agent can also host merge fragments (the
Kelvin role, ``kelvin_manager.h:31``), receiving bridge payloads the way
Kelvin's GRPCRouter receives ``TransferResultChunk`` streams
(``grpc_router.h:53,159``).

A port of the JAX package's ``services/agent.py``. Each agent owns a
port ``Engine``: on the card unless the caller passes an engine built
with ``device="cpu"`` (an agent built without an engine and without a
card raises). A PEM folds its windows with the card's kernels and ships
partial state across bridges (``exec/bridge.py``); a Kelvin merges the
states on its card and finalizes. A fragment that fails is reported in
band on ``query.{qid}.results``; it is never run again another way.

Every agent owns an ingest ``Collector`` wired to its engine (the
Stirling push path, ``pem_manager.cc:48``): ``start`` runs it on a thread
of its own and ``stop`` stops it and its connectors.

With the ``self_telemetry`` flag (on by default) ``start`` wires a
``TelemetryCollector`` (``services/telemetry.py``) to the engine:
finished fragment and merge traces fold into the agent's ``__queries__``,
``__spans__``, ``__agents__`` and ``__programs__`` tables, and the spans
of distributed traces go to the broker's trace view on
``telemetry.spans``. Each heartbeat folds ``__tables__`` and ``__bus__``
and carries the agent's profile summary (``ingest/profiler.py``).

Not in this slice: the dynamic tracepoint surface (a tracepoint message
is answered with a FAILED status).
"""

from __future__ import annotations

import threading
import time
import traceback

from ..exec import tracectx
from ..exec.engine import Engine
from ..exec.pipeline import DeadlineEvent
from ..exec.stream import QueryCancelled
from ..exec.trace import plan_script
from .msgbus import MessageBus
from .tracker import TOPIC_HEARTBEAT, TOPIC_REGISTER

DEFAULT_HEARTBEAT_INTERVAL_S = 5.0
#: Where tracepoint deployment states are published (the JAX package's
#: ``services/tracepoints.py`` topic).
TOPIC_TRACEPOINT_STATUS = "tracepoint.status"


class Agent:
    """Base manager: registration, heartbeats, execute + bridge handlers."""

    processes_data = True
    accepts_remote_sources = False

    def __init__(
        self,
        bus: MessageBus,
        agent_id: str,
        engine: Engine | None = None,
        heartbeat_interval_s: float = DEFAULT_HEARTBEAT_INTERVAL_S,
    ):
        self.bus = bus
        self.agent_id = agent_id
        self.engine = engine or Engine()
        # Per-agent registry with service UDTFs bound to this bus (the
        # VizierFuncFactoryContext analog) — cloned so the process-wide
        # default registry stays untouched.
        from .vizier_funcs import bind_service_registry

        self.engine.registry = bind_service_registry(
            self.engine.registry, bus, f"agent-{agent_id}"
        )
        # The ingest loop's sources push into this agent's engine.
        from ..ingest.collector import Collector

        self.collector = Collector()
        self.collector.wire_to(self.engine)
        self.heartbeat_interval_s = heartbeat_interval_s
        self.asid = None
        self._registered = threading.Event()
        self._stop = threading.Event()
        self._subs = []
        self._lock = threading.Lock()
        # qid -> {"expect": {(bridge_id, agent_id)}, "got": {bid: [payload]},
        #         "plan": merge plan, "reply_to": topic}
        self._pending_merges: dict = {}
        # Bounded memory of cancelled query ids (late bridge chunks for a
        # cancelled query must be dropped, not backlogged forever).
        self._cancelled: "dict[str, None]" = {}
        self._max_cancelled = 1024
        # Bounded memory of (qid, kind) dispatches already accepted: the
        # broker RETRIES un-acked dispatches (and the bus may duplicate
        # under fault injection), so every fragment handler must be
        # idempotent — a repeat re-acks (the first ack may be the lost
        # message) and is otherwise dropped.
        self._seen_dispatch: "dict[tuple, None]" = {}
        # Bounded qid -> reduced data-agent set from merge_update events
        # that arrived BEFORE the (one-shot or streaming) merge install:
        # cross-topic delivery order is unordered, so the install
        # consults this parking lot.
        self._parked_keep: "dict[str, set]" = {}
        # qid -> threading.Event for fragments currently executing: a
        # cancel mid-stream aborts between windows (ExecState keep_running).
        self._running: "dict[str, object]" = {}
        # Live queries (StreamResults analog): qid -> merge state for the
        # Kelvin half {plan, expect, latest {(bid, agent): payload}, seq}.
        self._streaming_merges: dict = {}
        # Broker-HA epoch fence: the highest dispatch epoch seen. A
        # dispatch stamped BELOW it comes from a deposed leader and is
        # rejected (no ack, no execution); unstamped dispatches (epoch
        # 0, plain single-broker deployments) always pass.
        self._max_epoch = 0
        # Self-telemetry (services/telemetry.py), wired by start() under
        # the self_telemetry flag.
        self.telemetry = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Agent":
        a = self.agent_id
        self._subs = [
            self.bus.subscribe(f"agent.{a}.registered", self._on_registered),
            self.bus.subscribe(f"agent.{a}.reregister", lambda m: self._register()),
            self.bus.subscribe(f"agent.{a}.execute", self._on_execute),
            self.bus.subscribe(f"agent.{a}.merge", self._on_merge),
            self.bus.subscribe(f"agent.{a}.bridge", self._on_bridge),
            self.bus.subscribe(
                f"agent.{a}.stream_execute", self._on_stream_execute
            ),
            self.bus.subscribe(
                f"agent.{a}.stream_merge", self._on_stream_merge
            ),
            self.bus.subscribe(
                f"agent.{a}.stream_bridge", self._on_stream_bridge
            ),
            self.bus.subscribe(f"agent.{a}.tracepoint", self._on_tracepoint),
            self.bus.subscribe(
                f"agent.{a}.merge_update", self._on_merge_update
            ),
            self.bus.subscribe("query.cancel", self._on_cancel),
            # Broker-HA takeover probe: a freshly elected leader asks
            # every agent which query fragments are still live here so
            # it can rebuild forwarder expectations (broker_ha.py).
            self.bus.subscribe("broker.reconcile", self._on_reconcile),
        ]
        # Dispatch acks ride a DEDICATED subscription per fragment kind:
        # each subscription has its own dispatcher thread, so receipt is
        # acknowledged immediately even while the main handler is busy
        # executing an earlier fragment — otherwise a retried dispatch's
        # re-ack would queue behind the running query and the broker
        # would declare a live, working agent lost.
        for kind in ("execute", "merge", "stream_execute", "stream_merge"):
            self._subs.append(self.bus.subscribe(
                f"agent.{a}.{kind}",
                lambda m, k=kind: self._ack_receipt(m, k),
            ))
        # Self-telemetry: finished fragment/merge traces fold into this
        # agent's __queries__/__spans__/__agents__ tables (PxL-queryable,
        # per-agent attribution) and distributed span summaries flow to
        # the broker's tracez view.
        from ..config import get_flag

        if get_flag("self_telemetry"):
            from .telemetry import enable_self_telemetry

            self.telemetry = enable_self_telemetry(
                self.engine, agent_id=self.agent_id,
                kind="pem" if self.processes_data else "kelvin",
                bus=self.bus,
            )
        self._register()
        self._hb_thread = threading.Thread(target=self._heartbeat_loop, daemon=True)
        self._hb_thread.start()
        # The ingest loop (Stirling::RunAsThread): drains connector
        # buffers into the engine on their push cadence.
        self.collector.run_as_thread()
        return self

    def stop(self, timeout_s: float = 5.0):
        """Simulate agent death: no more heartbeats or message handling.
        Waits up to ``timeout_s`` for the heartbeat thread to end."""
        self._stop.set()
        for s in self._subs:
            s.unsubscribe()
        self._subs = []
        hb = getattr(self, "_hb_thread", None)
        if hb is not None and hb is not threading.current_thread():
            hb.join(timeout_s)
        self.collector.stop()

    def _register(self):
        msg = {
            "agent_id": self.agent_id,
            "processes_data": self.processes_data,
            "accepts_remote_sources": self.accepts_remote_sources,
            "schemas": self._schemas(),
            "table_stats": self._table_stats(),
        }
        bus_rows = self._bus_summary()
        if bus_rows:
            msg["bus"] = bus_rows
        self.bus.publish(TOPIC_REGISTER, msg)

    def _bus_summary(self) -> list:
        """Compact transport-tier summary for register/heartbeats (the
        tracker's cluster merge; same rows the ``__bus__`` fold
        appends). Empty when bus_telemetry is off."""
        stats = getattr(self.bus, "stats", None)
        if stats is None:
            return []
        try:
            return stats.snapshot()
        except Exception:
            return []  # telemetry must never kill register/heartbeat

    def _on_registered(self, msg):
        self.asid = msg["asid"]
        self._registered.set()

    def _heartbeat_loop(self):
        while not self._stop.wait(self.heartbeat_interval_s):
            self.bus.publish(TOPIC_HEARTBEAT, self._heartbeat())

    def _heartbeat(self) -> dict:
        """One heartbeat: fold the storage and transport tiers into the
        telemetry tables and build the message. One freshness sweep
        serves the ``__tables__`` fold and the envelope; the fold is
        forced (a row per table per heartbeat), so a stopped ingest
        still advances fold time past its frozen watermark
        (px/ingest_lag's signal), while the per-trace fold stays
        change-cursored so query load cannot multiply rows."""
        fresh = self.engine.table_store.freshness()
        tel = self.telemetry
        if tel is not None:
            try:
                tel.table_stats.fold(force=True, snapshot=fresh)
            except Exception:
                pass  # telemetry must never kill the heartbeat loop
        hb = {
            "agent_id": self.agent_id,
            "schemas": self._schemas(),
            "table_stats": self._table_stats(freshness=fresh),
        }
        # Profiling tier: this agent's cumulative folded-stack summary
        # (top-N, counts monotonic) for the tracker's cluster merge,
        # which /debug/pprof and `px profile` read. Filtered by agent_id
        # so agents sharing a process never ship each other's samples.
        from ..ingest.profiler import profile_summary

        prof = profile_summary(agent_id=self.agent_id)
        if prof:
            hb["profile"] = prof
        # Transport tier: fold this agent's bus counters into __bus__
        # (heartbeat cadence only, see BusStatsCollector) and ship the
        # same summary for the tracker's cluster merge.
        if tel is not None:
            try:
                tel.bus_stats.fold(force=True)
            except Exception:
                pass  # telemetry must never kill the heartbeat loop
        bus_rows = self._bus_summary()
        if bus_rows:
            hb["bus"] = bus_rows
        return hb

    def _schemas(self) -> dict:
        # Snapshot: heartbeat thread vs concurrent table creation
        # (same race as _compile_table_stats — a died heartbeat loop
        # silently drops this agent from the tracker at expiry).
        return {
            name: t.relation
            for name, t in list(self.engine.tables.items())
            if t is not None and len(t.relation)
        }

    def _table_stats(self, freshness: dict | None = None) -> dict:
        """Ingest-sketch summaries + freshness for the tracker
        ({table: {rows, ndv, zones, freshness}}): the sketch half is
        the broker-side seed for pxbound predicted costs and the
        planner's NDV sizing; the ``freshness`` sub-dict (watermarks,
        monotonic append/expiry counters, ingest-rate EWMA — see
        ``Table.freshness``) is what ``AgentTracker.table_stats()``
        merges cluster-wide for /debug/tablez. Tables without sketches
        ship a freshness-only entry WITHOUT a "rows" key — pxbound
        treats a missing "rows" as unbounded, so an unsketched table
        never gets a bogus known-zero row bound. Microseconds per
        column — everything was maintained at append time; the
        per-engine __observed__ feedback stays local (script hashes
        are engine-scoped history, not cluster state). ``freshness``
        lets the heartbeat loop reuse its already-taken sweep."""
        stats = self.engine._compile_table_stats()
        stats.pop("__observed__", None)
        if freshness is None:
            freshness = self.engine.table_store.freshness()
        for name, fresh in freshness.items():
            stats.setdefault(name, {})["freshness"] = fresh
        return stats

    # -- data push (Stirling's RegisterDataPushCallback target) --------------
    def append_data(self, table: str, data, time_cols=("time_",)):
        return self.engine.append_data(table, data, time_cols=time_cols)

    # -- dynamic tracepoints ---------------------------------------------------
    def _on_tracepoint(self, msg):
        """Tracepoints (``pxtrace``) are not in this slice of the port: a
        deployment is answered with a FAILED status, a removal with
        nothing."""
        if msg.get("op") == "remove":
            return
        dep = msg.get("deployment")
        self.bus.publish(
            TOPIC_TRACEPOINT_STATUS,
            {
                "name": getattr(dep, "name", ""),
                "agent": self.agent_id,
                "state": "FAILED",
                "error": "tracepoints are not in this slice of the port",
            },
        )

    # -- query execution -----------------------------------------------------
    def _bounded_put(self, d: dict, key, value=None) -> None:
        """Insert into one of the bounded bookkeeping dicts
        (``_cancelled`` / ``_seen_dispatch`` / ``_parked_keep`` /
        per-stream row dedup), evicting insertion-oldest entries past
        ``_max_cancelled``. Caller holds ``self._lock``."""
        d[key] = value
        while len(d) > self._max_cancelled:
            d.pop(next(iter(d)))

    def _on_cancel(self, msg):
        with self._lock:
            self._bounded_put(self._cancelled, msg["qid"])
            self._pending_merges.pop(msg["qid"], None)
            self._streaming_merges.pop(msg["qid"], None)
            ev = self._running.get(msg["qid"])
        if ev is not None:
            ev.set()

    def _on_reconcile(self, msg: dict) -> None:
        """Answer a new leader's takeover probe (broker HA): which query
        fragments are still live HERE — running fragments/merges and,
        for a pending merge, the data agents whose bridge payloads it
        still expects. The successor rebuilds forwarder expectations
        for the deposed leader's in-flight queries from these answers
        (services/broker_ha.py)."""
        self._epoch_ok(msg)  # the probe carries the new epoch: fence up
        reply_to = msg.get("_reply_to") or msg.get("reply_to")
        if not reply_to:
            return
        with self._lock:
            running = sorted(self._running)
            merges = {}
            for qid, pm in self._pending_merges.items():
                exp = pm.get("expect")
                got = pm.get("got_keys") or set()
                if exp is None:
                    # Bridges backlogged before the merge install: the
                    # query is live but its expectations unknown yet.
                    merges[qid] = []
                    continue
                merges[qid] = sorted(
                    {a for (_b, a) in exp if (_b, a) not in got}
                )
            streaming = sorted(self._streaming_merges)
        self.bus.publish(reply_to, {
            "agent": self.agent_id,
            "running": running,
            "pending_merges": merges,
            "streaming": streaming,
        })

    def _epoch_ok(self, msg: dict) -> bool:
        """Broker-HA epoch fence. A message stamped with an epoch BELOW
        the highest this agent has seen comes from a deposed leader:
        reject it (no ack — the sender's retry loop gives up — and no
        execution). Higher stamps raise the fence; unstamped messages
        (epoch 0) always pass, so plain single-broker deployments are
        unaffected."""
        epoch = int(msg.get("epoch", 0) or 0)
        with self._lock:
            if epoch > self._max_epoch:
                self._max_epoch = epoch
                return True
            fenced = 0 < epoch < self._max_epoch
        if fenced:
            from .observability import default_counter

            default_counter(
                "pixie_epoch_fenced_total",
                "Messages rejected as stamped by a deposed broker leader",
            ).inc()
            return False
        return True

    def _ack_receipt(self, msg: dict, kind: str) -> None:
        """Ack a fragment dispatch on ``query.{qid}.ack`` — every
        receipt, including retried/duplicated copies (the first ack may
        be the message that was lost). Deposed-leader dispatches are
        never acked: withholding the ack is what makes the old leader's
        retry loop give up (epoch fencing, broker HA)."""
        if not self._epoch_ok(msg):
            return
        self.bus.publish(
            f"query.{msg['qid']}.ack",
            {"ack": kind, "agent": self.agent_id,
             "epoch": int(msg.get("epoch", 0) or 0)},
        )

    def _dedup_dispatch_locked(self, qid: str, kind: str) -> bool:
        """True when this (qid, kind) dispatch was already accepted:
        retried or fault-duplicated dispatches must not re-run. Caller
        holds ``self._lock``."""
        dup = (qid, kind) in self._seen_dispatch
        self._bounded_put(self._seen_dispatch, (qid, kind))
        return dup

    def _dedup_dispatch(self, qid: str, kind: str) -> bool:
        with self._lock:
            return self._dedup_dispatch_locked(qid, kind)

    def _begin_fragment_trace(self, msg, qid: str, plan, kind: str):
        """Start this fragment's trace as part of the dispatching
        broker's distributed trace: the context envelope in the dispatch
        message (or the ambient one the bus dispatcher bound) parents
        the fragment's root span under the broker's dispatch span."""
        ctx = tracectx.extract(msg) or tracectx.current()
        tr = self.engine.tracer.begin_query(
            script=plan_script(plan), kind=kind, parent_ctx=ctx
        )
        tr.qid = qid
        tr.agent_id = self.agent_id
        # Tenant attribution rides the dispatch envelope: this agent's
        # __queries__/__spans__ rows carry the admitting tenant.
        tr.tenant = str(msg.get("tenant") or "")
        return tr

    @staticmethod
    def _cancel_handle(msg, ev):
        """The fragment's cooperative-cancellation handle: the broker's
        absolute deadline (when the dispatch carries one) wraps the
        cancel event, so the window pipeline aborts past-deadline work
        at its next boundary even before any query.cancel arrives."""
        deadline = msg.get("deadline_unix_s")
        if deadline is None:
            return ev
        return DeadlineEvent(ev, float(deadline))

    def _on_execute(self, msg):
        """Run a data fragment; ship bridge payloads to the merge agent."""
        qid, plan = msg["qid"], msg["plan"]
        if not self._epoch_ok(msg) or self._dedup_dispatch(qid, "execute"):
            return
        import threading as _threading

        ev = _threading.Event()
        with self._lock:
            # Atomic with _on_cancel: a cancel that lands between the
            # check and the registration must either stop us here or find
            # the event to set.
            if qid in self._cancelled:
                return
            self._running[qid] = ev
        trace = self._begin_fragment_trace(msg, qid, plan, "fragment")
        try:
            t0 = time.perf_counter()
            outputs = self.engine.execute_plan(
                plan, cancel=self._cancel_handle(msg, ev), trace=trace
            )
            elapsed = time.perf_counter() - t0
        except QueryCancelled:
            # Deadline lapsed (or a cancel raced its _cancelled mark):
            # the abort is the INTENDED outcome — dead work dropped at
            # a window boundary. The broker's deadline/cancel exit
            # accounts for this agent (missing_reasons), so publishing
            # an error here would wrongly fail the whole query.
            with self._lock:
                self._running.pop(qid, None)
            return
        except Exception as e:
            with self._lock:
                self._running.pop(qid, None)
            if qid not in self._cancelled:
                self.bus.publish(
                    f"query.{qid}.results",
                    {
                        "error": f"{self.agent_id}: {e}",
                        "trace": traceback.format_exc(),
                    },
                )
            return
        with self._lock:
            self._running.pop(qid, None)
            if qid in self._cancelled:
                return  # cancelled during execution: results are dropped
        merge_agent = msg.get("merge_agent")
        for key, val in outputs.items():
            if isinstance(key, tuple) and key[0] == "bridge":
                self.bus.publish(
                    f"agent.{merge_agent}.bridge",
                    {
                        "qid": qid,
                        "bridge_id": key[1],
                        "from_agent": self.agent_id,
                        "payload": val,
                    },
                )
            else:  # whole plan executed locally (no split)
                self.bus.publish(
                    f"query.{qid}.results",
                    {"table": key, "batch": val, "agent": self.agent_id},
                )
        self.bus.publish(
            f"query.{qid}.agent_done",
            {
                "agent": self.agent_id,
                "exec_time_s": elapsed,
                # Per-agent resource attribution (QueryResourceUsage):
                # execute_plan ended the trace, so usage is final here.
                "usage": trace.usage.to_dict(),
            },
        )

    @staticmethod
    def _new_pending_merge() -> dict:
        # "keep" narrows the participating data-agent set when the
        # broker fails over a lost agent (None = everyone expected).
        # "trace_ctx" is the broker's dispatch-span context from the
        # merge install — the merge may RUN from whichever handler
        # completes the bridge set (a different dispatcher thread whose
        # ambient context is some data agent's fragment), so the
        # install-time context is stored, not inherited.
        return {"plan": None, "expect": None, "got": {}, "got_keys": set(),
                "keep": None, "trace_ctx": None, "deadline": None,
                "tenant": ""}

    def _on_merge(self, msg):
        """Install a merge fragment; runs once all bridge payloads land."""
        qid = msg["qid"]
        if not self._epoch_ok(msg):
            return
        with self._lock:
            # Dedup marking and record install must be ONE critical
            # section: _on_bridge/_on_merge_update read "(qid, merge)
            # seen + no record" as "merge already ran" — a gap between
            # the two here would make them drop a live query's chunk.
            if self._dedup_dispatch_locked(qid, "merge"):
                return
            if qid in self._cancelled:
                return
            # Bridge payloads may already be backlogged for this query —
            # merge the plan into the existing record, never replace it.
            pm = self._pending_merges.setdefault(
                qid, self._new_pending_merge()
            )
            parked = self._parked_keep.get(qid)
            if parked is not None:
                pm["keep"] = (
                    parked if pm["keep"] is None else (pm["keep"] & parked)
                )
            pm["plan"] = msg["plan"]
            pm["trace_ctx"] = tracectx.extract(msg) or tracectx.current()
            pm["deadline"] = msg.get("deadline_unix_s")
            pm["tenant"] = str(msg.get("tenant") or "")
            pm["expect"] = {
                (bid, aid)
                for bid in msg["bridge_ids"]
                for aid in msg["data_agents"]
                if pm["keep"] is None or aid in pm["keep"]
            }
        self._maybe_finish_merge(qid)

    def _on_bridge(self, msg):
        qid = msg["qid"]
        with self._lock:
            if qid in self._cancelled:
                return
            pm = self._pending_merges.get(qid)
            if pm is None:
                if (qid, "merge") in self._seen_dispatch:
                    return  # merge already ran; a late duplicate chunk
                # Bridge chunks can arrive before the merge plan (the
                # GRPCRouter backlogs early TransferResultChunks).
                pm = self._pending_merges.setdefault(
                    qid, self._new_pending_merge()
                )
            key = (msg["bridge_id"], msg["from_agent"])
            if key in pm["got_keys"]:
                return  # duplicate delivery (retry / injected dup)
            if pm["keep"] is not None and msg["from_agent"] not in pm["keep"]:
                return  # late chunk from an agent already failed over
            pm["got"].setdefault(msg["bridge_id"], []).append(
                (msg["from_agent"], msg["payload"])
            )
            pm["got_keys"].add(key)
        self._maybe_finish_merge(qid)

    def _on_merge_update(self, msg):
        """The broker failed over a lost data agent: shrink the expected
        set to ``data_agents`` and discard the lost agents' (possibly
        incomplete) contributions so the merge runs from survivors only
        — the partial-aggregation path (Taurus-style best-effort
        scatter-gather). The reduced set is also PARKED: the update can
        beat the (retried) merge/stream_merge install on another
        dispatcher thread, and the install must still see it."""
        qid, keep = msg["qid"], set(msg["data_agents"])
        with self._lock:
            if qid in self._cancelled:
                return
            parked = self._parked_keep.get(qid)
            keep = keep if parked is None else (parked & keep)
            self._bounded_put(self._parked_keep, qid, keep)
            pm = self._pending_merges.get(qid)
            if pm is not None:
                pm["keep"] = (
                    keep if pm["keep"] is None else (pm["keep"] & keep)
                )
                if pm["expect"] is not None:
                    pm["expect"] = {
                        (b, a) for (b, a) in pm["expect"] if a in pm["keep"]
                    }
            st = self._streaming_merges.get(qid)
            if st is not None:
                st["keep"] = (
                    keep if st["keep"] is None else (st["keep"] & keep)
                )
                if st["expect"] is not None:
                    st["expect"] = {
                        (b, a) for (b, a) in st["expect"] if a in st["keep"]
                    }
                st["latest"] = {
                    k: v for k, v in st["latest"].items() if k[1] in st["keep"]
                }
        self._maybe_finish_merge(qid)
        self._maybe_stream_remerge(qid)

    def _maybe_finish_merge(self, qid):
        with self._lock:
            pm = self._pending_merges.get(qid)
            if (
                pm is None
                or pm["plan"] is None
                or pm["expect"] is None
                or not pm["expect"] <= pm["got_keys"]
            ):
                return
            del self._pending_merges[qid]
        keep = pm["keep"]
        bridge_inputs = {}
        for bid, contributions in pm["got"].items():
            # Canonical agent-id order (not arrival order): the merge
            # re-encodes later payloads' string ids into the FIRST
            # payload's dictionary, so arrival-ordered payloads made the
            # merged dictionary CONTENTS depend on bus scheduling — and
            # the content-keyed fragment cache then compiled one XLA
            # program per observed ordering. Merge folds are
            # commutative; ordering by agent id costs one sort of a
            # handful of tuples.
            payloads = [p for (a, p) in sorted(contributions)
                        if keep is None or a in keep]
            if payloads:
                bridge_inputs[bid] = payloads
        trace = self.engine.tracer.begin_query(
            script=plan_script(pm["plan"]), kind="merge",
            parent_ctx=pm["trace_ctx"],
        )
        trace.qid = qid
        trace.agent_id = self.agent_id
        trace.tenant = pm["tenant"]
        # The merge respects the query deadline AND query.cancel:
        # folding states for a client the broker already answered is
        # dead work — the same window-boundary abort as data fragments.
        # The raw event registers under _running so _on_cancel finds it
        # (safe from colliding with this agent's own data fragment: the
        # merge only starts once every expected bridge payload landed,
        # i.e. after any local fragment finished and popped its entry).
        ev = threading.Event()
        with self._lock:
            if qid in self._cancelled:
                return
            self._running[qid] = ev
        cancel = (
            DeadlineEvent(ev, float(pm["deadline"]))
            if pm["deadline"] is not None else ev
        )
        try:
            t0 = time.perf_counter()
            outputs = self.engine.execute_plan(
                pm["plan"], bridge_inputs=bridge_inputs, trace=trace,
                cancel=cancel,
            )
            elapsed = time.perf_counter() - t0
        except QueryCancelled:
            return  # cancelled/past-deadline: the broker already degraded
        except Exception as e:
            self.bus.publish(
                f"query.{qid}.results",
                {"error": f"{self.agent_id}: {e}", "trace": traceback.format_exc()},
            )
            return
        finally:
            with self._lock:
                self._running.pop(qid, None)
        for name, batch in outputs.items():
            self.bus.publish(
                f"query.{qid}.results",
                {"table": name, "batch": batch, "agent": self.agent_id},
            )
        # Merge-tier attribution rides a role-tagged agent_done (the
        # forwarder files it under merge_stats, keeping agent_stats ==
        # data agents for existing consumers). BEFORE eos, so the wait
        # loop never needs its post-eos grace budget for it.
        self.bus.publish(
            f"query.{qid}.agent_done",
            {"agent": self.agent_id, "exec_time_s": elapsed,
             "role": "merge", "usage": trace.usage.to_dict()},
        )
        self.bus.publish(f"query.{qid}.results", {"eos": True})


    # -- live queries (StreamResults analog) ---------------------------------
    def _on_stream_execute(self, msg):
        """Run a live data fragment: a streaming cursor folds appended
        rows on cadence and ships partial states / new rows to the merge
        agent until the query is cancelled
        (``query_result_forwarder.go:470`` StreamResults; infinite
        MemorySource per ``memory_source_node.cc``)."""
        from ..exec.streaming import StreamingQuery

        qid, plan = msg["qid"], msg["plan"]
        if not self._epoch_ok(msg) or self._dedup_dispatch(
            qid, "stream_execute"
        ):
            return
        merge_agent = msg.get("merge_agent")
        interval = float(msg.get("poll_interval_s", 0.25))
        ev = threading.Event()
        with self._lock:
            if qid in self._cancelled:
                return
            self._running[qid] = ev

        def emit(up):
            if up.mode in ("state", "rows"):
                self.bus.publish(
                    f"agent.{merge_agent}.stream_bridge",
                    {
                        "qid": qid,
                        "bridge_id": up.bridge_id,
                        "from_agent": self.agent_id,
                        "payload": up.batch,
                        "seq": up.seq,
                    },
                )
            else:
                self.bus.publish(
                    f"query.{qid}.results",
                    {
                        "table": up.table,
                        "batch": up.batch,
                        "seq": up.seq,
                        "mode": up.mode,
                        "agent": self.agent_id,
                    },
                )

        # The streaming cursor runs on its own thread: re-bind the
        # dispatch's trace context there so the stream's lifecycle trace
        # joins the distributed trace (contextvars are thread-local).
        ctx = tracectx.extract(msg) or tracectx.current()

        def run():
            try:
                with tracectx.bound(ctx):
                    sq = StreamingQuery(self.engine, plan, emit, cancel=ev)
                sq.run(poll_interval_s=interval)
            except Exception as e:
                if qid not in self._cancelled:
                    self.bus.publish(
                        f"query.{qid}.results",
                        {
                            "error": f"{self.agent_id}: {e}",
                            "trace": traceback.format_exc(),
                        },
                    )
            finally:
                with self._lock:
                    self._running.pop(qid, None)

        threading.Thread(target=run, daemon=True).start()

    def _stream_state(self, qid):
        # Every caller holds self._lock (the lint is intraprocedural and
        # cannot see the caller's lock). # pxlint: disable=thread-shared-state
        return self._streaming_merges.setdefault(
            qid,
            {
                "plan": None,
                "expect": None,
                "keep": None,  # reduced agent set after failover
                "latest": {},
                "pending_rows": [],  # chunks that beat the plan install
                "seen_rows": {},  # (bid, agent, seq) dedup, bounded
                "seq": 0,
                "dirty": False,
                "merging": False,
                "merge_lock": threading.Lock(),
            },
        )

    def _on_stream_merge(self, msg):
        """Install a live merge: each round's freshest per-agent states
        re-merge into an updated result (incremental view maintenance —
        the reference re-runs live views from scratch on every poll)."""
        qid = msg["qid"]
        if not self._epoch_ok(msg) or self._dedup_dispatch(
            qid, "stream_merge"
        ):
            return
        with self._lock:
            if qid in self._cancelled:
                return
            st = self._stream_state(qid)
            parked = self._parked_keep.get(qid)
            if parked is not None:
                st["keep"] = (
                    parked if st["keep"] is None else (st["keep"] & parked)
                )
            st["plan"] = msg["plan"]
            st["expect"] = {
                (bid, aid)
                for bid in msg["bridge_ids"]
                for aid in msg["data_agents"]
                if st["keep"] is None or aid in st["keep"]
            }
            backlog = st["pending_rows"]
            st["pending_rows"] = []
        # Row chunks that raced ahead of the install flow through now, in
        # arrival order (the one-shot _on_bridge path buffers the same way).
        for bid, payload in backlog:
            self._stream_emit_rows(qid, bid, payload)
        self._maybe_stream_remerge(qid)

    def _on_stream_bridge(self, msg):
        qid = msg["qid"]
        from ..exec.bridge import RowsPayload

        payload = msg["payload"]
        with self._lock:
            if qid in self._cancelled:
                return
            st = self._stream_state(qid)
            if (
                st["keep"] is not None
                and msg["from_agent"] not in st["keep"]
            ):
                return  # chunk from an agent already failed over
            if isinstance(payload, RowsPayload):
                # Row-gather bridges append: every chunk flows through the
                # merge plan once, independently — so a DUPLICATED
                # delivery (retry / at-least-once transport / injected
                # dup) would double-count rows in the live view. Dedup
                # by the producer's per-cursor sequence number.
                chunk_key = (
                    msg["bridge_id"], msg["from_agent"], msg.get("seq")
                )
                if chunk_key in st["seen_rows"]:
                    return
                self._bounded_put(st["seen_rows"], chunk_key)
                st["latest"][(msg["bridge_id"], msg["from_agent"])] = None
                if st["plan"] is None:
                    st["pending_rows"].append((msg["bridge_id"], payload))
                    return
            else:
                # Agg bridges replace: only this agent's freshest state
                # participates in the next re-merge.
                st["latest"][(msg["bridge_id"], msg["from_agent"])] = payload
                payload = None
        if payload is not None:
            self._stream_emit_rows(qid, msg["bridge_id"], payload)
        else:
            self._maybe_stream_remerge(qid)

    def _stream_emit_rows(self, qid, bridge_id, payload):
        with self._lock:
            st = self._streaming_merges.get(qid)
            if st is None or st["plan"] is None:
                return
            plan = st["plan"]
            lock = st["merge_lock"]
        # Serialize executes + publishes per stream so the client's
        # arrival order matches seq order.
        with lock:
            with self._lock:
                seq = st["seq"]
                st["seq"] += 1
            try:
                outputs = self.engine.execute_plan(
                    plan, bridge_inputs={bridge_id: [payload]}
                )
            except Exception as e:
                self.bus.publish(
                    f"query.{qid}.results",
                    {"error": f"{self.agent_id}: {e}",
                     "trace": traceback.format_exc()},
                )
                return
            for name, batch in outputs.items():
                self.bus.publish(
                    f"query.{qid}.results",
                    {"table": name, "batch": batch, "seq": seq,
                     "mode": "append", "agent": self.agent_id},
                )

    def _maybe_stream_remerge(self, qid):
        """Re-merge the freshest per-agent states, coalescing bursts: a
        merge already in flight absorbs any states that land meanwhile
        (one follow-up run instead of N stale ones)."""
        with self._lock:
            st = self._streaming_merges.get(qid)
            if (
                st is None
                or st["plan"] is None
                or st["expect"] is None
                or not st["expect"] <= set(st["latest"])
            ):
                return
            if st["merging"]:
                st["dirty"] = True
                return
            st["merging"] = True
        try:
            while True:
                with self._lock:
                    st["dirty"] = False
                    plan = st["plan"]
                    by_bridge: dict = {}
                    # Canonical (bridge, agent) order — same dictionary-
                    # content determinism as the one-shot merge path.
                    for (bid, _aid), p in sorted(
                        st["latest"].items(), key=lambda kv: kv[0]
                    ):
                        if p is not None:
                            by_bridge.setdefault(bid, []).append(p)
                if by_bridge:
                    with st["merge_lock"]:
                        # seq is claimed INSIDE merge_lock (same order as
                        # _stream_emit_rows) so publish order always
                        # matches seq order — claiming it earlier let a
                        # lower-seq 'replace' land after a higher-seq
                        # update and be wrongly superseded by clients.
                        with self._lock:
                            seq = st["seq"]
                            st["seq"] += 1
                        try:
                            outputs = self.engine.execute_plan(
                                plan, bridge_inputs=by_bridge
                            )
                        except Exception as e:
                            self.bus.publish(
                                f"query.{qid}.results",
                                {"error": f"{self.agent_id}: {e}",
                                 "trace": traceback.format_exc()},
                            )
                            return
                        for name, batch in outputs.items():
                            self.bus.publish(
                                f"query.{qid}.results",
                                {"table": name, "batch": batch, "seq": seq,
                                 "mode": "replace", "agent": self.agent_id},
                            )
                with self._lock:
                    if not st["dirty"]:
                        return
        finally:
            with self._lock:
                st["merging"] = False


class PEMAgent(Agent):
    """Per-node data agent: ingest push target + data fragments
    (``pem_manager.h:39``)."""

    processes_data = True
    accepts_remote_sources = False

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # The PEM's ingest is bounded by the table-store byte budget
        # from the first append (pem_manager.cc:86-104 InitSchemas) —
        # installed as lazy per-table budgets so synthetic/partial
        # schemas in tests and tools still shape tables from their
        # first append.
        from ..ingest.schemas import table_budgets

        self.engine.table_store.table_budgets = table_budgets()


class KelvinAgent(Agent):
    """Compute-only merge agent (``kelvin_manager.h:31``)."""

    processes_data = False
    accepts_remote_sources = True
