"""Query broker: compile, plan, dispatch, forward results.

Reference parity: ``src/vizier/services/query_broker`` — ExecuteScript
(``controllers/server.go:325``) compiles via the planner against the
live agent set, LaunchQuery publishes per-agent plans over the control
plane (``launch_query.go:36``), and a per-query QueryResultForwarder
(``query_result_forwarder.go:108,241,364``) streams results to the
client with producer/consumer watchdog timeouts and cancellation.

A port of the JAX package's ``services/query_broker.py``: admission
control, the result forwarder with failover to the surviving agents,
dispatch with retries and acks, replanning around expired agents, the
cluster-level result cache, live queries, the bus API (``serve``), the
cluster-stitched trace view (``trace_view``, ``/debug/tracez``), the
observed-cost admission floor (``observed_costs``) and the cluster
profile (``profile_rows``, ``broker.profile``) and the mutation phase:
a script that imports ``pxtrace`` has its tracepoints deployed through
``tracepoints`` (a ``TracepointRegistry``) and waits for them to run
before its query phase compiles. The broker-HA hooks (``broker_id``, ``epoch_fn``,
``state_log``, ``stop_serving``, ``QueryResultForwarder.abandon``) are
wired by ``services/broker_ha.py``; a broker that no replica wires
dispatches without an epoch, as a single-broker deployment does.
"""

from __future__ import annotations

import queue
import random
import threading
import time
import uuid

from ..exec import threadmap
from ..exec.engine import QueryError
from ..planner import CompilerState, compile_mutations, compile_pxl
from ..planner.distributed import DistributedPlanner
from ..planner.distributed.coordinator import PlanningError
from ..udf.registry import Registry, default_registry
from .msgbus import MessageBus
from .tracker import AgentTracker

#: Dispatch-retry backoff hard cap (seconds) — dispatch_backoff_ms
#: doubles per attempt up to here.
MAX_DISPATCH_BACKOFF_S = 2.0


class QueryTimeout(QueryError):
    pass


class AgentLost(QueryError):
    """A query participant died (expired / never acked its dispatch)
    while ``require_complete`` forbids degrading to partial results, or
    the participant was the un-substitutable merge agent."""


class QueryAbandoned(QueryError):
    """A broker-HA kill released this forwarder wait WITHOUT cancelling
    the agents' work: the fragments keep running so the successor
    leader can re-attach a fresh forwarder and complete the very same
    query. The served reply for an abandoned query is suppressed — the
    successor answers the caller's inbox (``services/broker_ha.py``)."""


class AdmissionError(QueryError):
    """Admission control refused the query: its pxbound-predicted cost
    exceeds the per-engine budget (reject), or in-flight queries held
    the budget past the queue timeout. Carries the structured
    :class:`~pixie_tpu.analysis.diagnostics.Diagnostic` so clients see
    a compile-time-style refusal, not a run-time failure."""

    def __init__(self, diagnostic):
        self.diagnostic = diagnostic
        super().__init__(diagnostic.render())


class _Admission:
    """Tenant-aware predicted-cost admission control
    (``admission_bytes_budget_mb`` × ``admission_tenant_weights``).

    Per-tenant accounting over the SUM of in-flight queries' predicted
    staged bytes (pxbound ``predicted_cost.bytes_staged_hi``): each
    registered tenant owns a weighted slice of the budget
    (``services/tenancy.py tenant_shares``), so an over-share tenant's
    burst queues behind *its own* backlog while an under-share tenant
    admits without ever consulting the noisy one's state. ``admit``
    returns immediately when the budget is off or the prediction
    unknown (sketch-less plans are admitted, accounted at zero —
    conservative bounds must never turn into false rejections);
    rejects a query predicted over its tenant's WHOLE share; and
    queues one that merely doesn't fit NOW.

    The wait queue is ordered by (priority desc, earliest deadline
    first, arrival) — not arrival alone — and every ``release``
    re-runs the scheduler under the lock, waking admitted waiters
    through their own events immediately (release-to-admit latency is
    event-driven, not a poll slice). Priority classes are STRICT: a
    query only admits when no strictly-higher-priority query is in
    flight or waiting — on a saturated engine, work-conserving
    admission would keep a best-effort tenant's compute running
    back-to-back under an interactive tenant's queries and move their
    p99 however fair the byte shares are; yielding the whole admission
    slot is what actually protects the higher class's latency.
    (Default priority is 0 for everyone, so the discipline is pure
    weighted-fair until an operator assigns priorities; a starved
    low-priority query still resolves via its queue timeout or
    deadline.) ``admission_priority_holddown_ms`` extends the strict
    rule across a released query's inter-arrival gap: an admitted
    query's compute cannot be preempted (queries overlap on an engine
    since the pxlock unlock, but still contend for its cores/devices),
    so a lower-priority query admitted in the
    ~ms gap between two high-priority queries head-of-line blocks the
    next one at the agent — the hold-down keeps lower classes queued
    for a grace window after each higher-priority release, trading
    low-class throughput for high-class p99 (non-work-conserving by
    design; 0 disables). A waiter whose QUERY deadline lapses while queued is
    shed cheaply — an ``admission-shed`` Diagnostic, never dispatched;
    one that outlives ``admission_queue_s`` is rejected. ``release``
    is idempotent. Counters:
    ``pixie_admission_{queued,shed,rejected}_total{tenant}``.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._in_flight: dict[str, int] = {}  # qid -> predicted bytes
        self._tenant_of: dict[str, str] = {}  # qid -> resolved tenant
        self._prio_of: dict[str, int] = {}  # qid -> priority
        self._waiters: list[dict] = []
        self._seq = 0
        # Priority hold-down (admission_priority_holddown_ms): the
        # highest recently-released priority and when its grace window
        # lapses — strictly-lower waiters stay queued until then.
        self._held_prio: int | None = None
        self._held_until = 0.0

    def in_flight(self) -> dict:
        with self._cond:
            return dict(self._in_flight)

    def in_flight_by_tenant(self) -> dict:
        """{tenant: in-flight predicted bytes} — the queryz view."""
        with self._cond:
            out: dict = {}
            for qid, pred in self._in_flight.items():
                t = self._tenant_of.get(qid, "")
                out[t] = out.get(t, 0) + pred
            return out

    def queued(self) -> list:
        """Waiter snapshot in scheduling order (queryz / tests)."""
        with self._cond:
            return [
                {"qid": w["qid"], "tenant": w["tenant"],
                 "priority": w["priority"], "pred": w["pred"],
                 "deadline": w["deadline"]}
                for w in sorted(self._waiters, key=self._order)
            ]

    @staticmethod
    def _order(w: dict):
        return (
            -w["priority"],
            w["deadline"] if w["deadline"] is not None else float("inf"),
            w["seq"],
        )

    @staticmethod
    def _diag(message: str, code: str = "admission-reject") -> "object":
        from ..analysis.diagnostics import Diagnostic

        return Diagnostic(code=code, message=message, plan="distributed")

    @staticmethod
    def _count(kind: str, tenant: str) -> None:
        from .observability import default_counter
        from .tenancy import resolve_tenant

        # Idempotent for already-resolved names; makes the bounded-
        # cardinality guard airtight AT the labeling point (and keeps
        # the metrics-naming lint's no-baseline invariant: every
        # tenant label value is visibly resolver-derived).
        tenant = resolve_tenant(tenant)
        help_by_kind = {
            "queued": "Queries that waited in the admission queue "
                      "(tenant share full on arrival)",
            "shed": "Queued queries shed before dispatch because "
                    "their deadline lapsed (zero agent work)",
            "cancelled": "Queued queries cancelled (cancel_query / "
                         "px cancel) before dispatch (zero agent work)",
            "rejected": "Queries refused at admission (predicted over "
                        "the tenant share, or queued past "
                        "admission_queue_s)",
        }
        default_counter(
            f"pixie_admission_{kind}_total", help_by_kind[kind]
        ).labels(tenant=tenant).inc()

    def _schedule_locked(self, budget: float) -> None:
        """Admit every eligible waiter, best-ordered first. Caller
        holds ``self._cond``. A blocked tenant's waiters are skipped
        (they queue behind their own backlog) while later-ordered
        waiters of OTHER tenants still admit — weighted fairness, not
        head-of-line blocking."""
        if not self._waiters:
            return
        from .tenancy import tenant_shares

        shares = tenant_shares(budget)
        used: dict = {}
        running_prio = None
        if self._held_prio is not None:
            if time.monotonic() >= self._held_until:
                self._held_prio = None
            else:
                running_prio = self._held_prio
        for qid, pred in self._in_flight.items():
            t = self._tenant_of.get(qid, "")
            used[t] = used.get(t, 0) + pred
            p = self._prio_of.get(qid, 0)
            running_prio = p if running_prio is None else max(running_prio, p)
        blocked_prio = None
        blocked_tenants: set = set()
        for w in sorted(self._waiters, key=self._order):
            if running_prio is not None and w["priority"] < running_prio:
                break  # strict priority: yield to the running class
            if blocked_prio is not None and w["priority"] < blocked_prio:
                break  # ...and to a higher class still waiting
            if w["tenant"] in blocked_tenants:
                # FIFO within a tenant: once its best-ordered waiter is
                # blocked, later same-tenant waiters queue behind it —
                # a stream of small queries must not indefinitely
                # overtake (starve) a blocked larger one on budget the
                # larger query is waiting to accumulate.
                continue
            share = shares.get(w["tenant"], budget)
            if used.get(w["tenant"], 0) + w["pred"] <= share:
                self._waiters.remove(w)
                self._in_flight[w["qid"]] = w["pred"]
                self._tenant_of[w["qid"]] = w["tenant"]
                self._prio_of[w["qid"]] = w["priority"]
                used[w["tenant"]] = used.get(w["tenant"], 0) + w["pred"]
                running_prio = (
                    w["priority"] if running_prio is None
                    else max(running_prio, w["priority"])
                )
                w["admitted"] = True
                w["event"].set()
            else:
                blocked_tenants.add(w["tenant"])
                blocked_prio = (
                    w["priority"] if blocked_prio is None
                    else max(blocked_prio, w["priority"])
                )

    def admit(self, qid: str, predicted: dict | None,
              tenant: str | None = None, priority: int = 0,
              deadline: float | None = None) -> None:
        """Admit/queue/reject ``qid``. ``tenant`` is resolved through
        the registered set; ``deadline`` is an absolute
        ``time.monotonic()`` instant (the query's own deadline — a
        waiter past it is shed, never dispatched)."""
        from ..config import get_flag
        from .tenancy import resolve_tenant, tenant_shares

        budget = float(get_flag("admission_bytes_budget_mb")) * (1 << 20)
        if budget <= 0:
            return
        pred = (predicted or {}).get("bytes_staged_hi")
        if pred is None:
            return  # unknown cost: admit (never falsely reject)
        pred = int(pred)
        tenant = resolve_tenant(tenant)
        share = tenant_shares(budget).get(tenant, budget)
        if pred > share:
            self._count("rejected", tenant)
            raise AdmissionError(self._diag(
                f"query {qid} (tenant {tenant}) predicted {pred} staged "
                f"bytes (x{(predicted or {}).get('safety')} safety, "
                f"origin {(predicted or {}).get('origin')}) > the "
                f"tenant's admission share {int(share)} of budget "
                f"{int(budget)} (admission_bytes_budget_mb x "
                "admission_tenant_weights) — rejected at admission, "
                "not failed at run time"
            ))
        queue_s = float(get_flag("admission_queue_s"))
        give_up = time.monotonic() + max(queue_s, 0.0)
        w = {
            "qid": qid, "tenant": tenant, "pred": pred,
            "priority": int(priority), "deadline": deadline,
            "seq": 0, "event": threading.Event(), "admitted": False,
            "cancelled": False,
        }
        with self._cond:
            self._seq += 1
            w["seq"] = self._seq
            self._waiters.append(w)
            self._schedule_locked(budget)
            if w["admitted"]:
                return
        self._count("queued", tenant)
        while True:
            with self._cond:
                # A lapsed hold-down has no release event behind it, so
                # waiters re-run the scheduler themselves on every wake
                # (idempotent; releases still wake admitted waiters
                # directly through their events).
                self._schedule_locked(budget)
                if w["admitted"]:
                    return
                if w["cancelled"]:
                    # cancel() already removed us and rescheduled.
                    verdict = "cancelled"
                    break
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    self._waiters.remove(w)
                    # This waiter may have been the high-priority head
                    # blocking lower-priority waiters; with it gone the
                    # queue order changed, and no release event is
                    # coming — admit the newly eligible NOW.
                    self._schedule_locked(budget)
                    verdict = "shed"
                    break
                if now >= give_up:
                    self._waiters.remove(w)
                    self._schedule_locked(budget)
                    verdict = "timeout"
                    break
                stop = give_up if deadline is None else min(give_up, deadline)
                holddown_s = (
                    float(get_flag("admission_priority_holddown_ms")) / 1e3
                )
                if holddown_s > 0:
                    # A hold-down may be ARMED while this waiter sleeps
                    # (release() wakes only admitted waiters), and its
                    # lapse has no event behind it either — bounding
                    # every sleep slice at one hold window keeps the
                    # staleness within the same "one extra wake per
                    # window" budget the held-case bound below accepts.
                    stop = min(stop, now + holddown_s)
                if self._held_prio is not None:
                    # Wake at the grace-window lapse even if nothing
                    # releases in the meantime. Unconditional (not just
                    # for priorities the CURRENT hold blocks): a later
                    # release may re-arm the hold at a higher priority
                    # while this waiter sleeps, and if that was the
                    # final release there is no further event to wake
                    # anyone — re-observing within one grace window
                    # keeps the queue live (at most one extra wake per
                    # window per waiter).
                    stop = min(stop, self._held_until)
            w["event"].wait(timeout=max(stop - now, 0.0))
        if verdict == "cancelled":
            self._count("cancelled", tenant)
            raise AdmissionError(self._diag(
                f"query {qid} (tenant {tenant}, predicted {pred} staged "
                "bytes) cancelled while queued for admission — never "
                "dispatched, zero agent work",
                code="admission-cancelled",
            ))
        if verdict == "shed":
            self._count("shed", tenant)
            raise AdmissionError(self._diag(
                f"query {qid} (tenant {tenant}, predicted {pred} "
                f"staged bytes) shed from the admission queue: its "
                f"deadline lapsed while queued behind the tenant's "
                f"in-flight backlog — never dispatched, zero agent "
                "work", code="admission-shed",
            ))
        held = sorted(self.in_flight())
        self._count("rejected", tenant)
        raise AdmissionError(self._diag(
            f"query {qid} (tenant {tenant}) predicted {pred} staged "
            f"bytes queued past admission_queue_s={queue_s}s "
            f"behind in-flight {held} "
            f"(budget {int(budget)} bytes)"
        ))

    def cancel(self, qid: str) -> bool:
        """Cancel a QUEUED (not yet admitted) query — the queued-phase
        half of ``broker.cancel_query`` (a dispatched query takes the
        forwarder/agent path instead). The waiter is removed under the
        lock so the scheduler can never admit it afterwards; its
        ``admit()`` call raises a structured never-dispatched
        Diagnostic (``admission-cancelled``)."""
        from ..config import get_flag

        with self._cond:
            for w in self._waiters:
                if w["qid"] == qid and not w["admitted"]:
                    self._waiters.remove(w)
                    w["cancelled"] = True
                    w["event"].set()
                    # Same reschedule as shed: the departed waiter may
                    # have been priority-blocking eligible waiters.
                    self._schedule_locked(
                        float(get_flag("admission_bytes_budget_mb"))
                        * (1 << 20)
                    )
                    return True
        return False

    def release(self, qid: str) -> None:
        from ..config import get_flag

        with self._cond:
            self._tenant_of.pop(qid, None)
            prio = self._prio_of.pop(qid, None)
            if self._in_flight.pop(qid, None) is None:
                return
            holddown_s = (
                float(get_flag("admission_priority_holddown_ms")) / 1e3
            )
            if holddown_s > 0 and prio is not None:
                now = time.monotonic()
                if (self._held_prio is None or prio >= self._held_prio
                        or now >= self._held_until):
                    self._held_prio = prio
                    self._held_until = now + holddown_s
            # Freed budget admits the next eligible waiter NOW — its
            # event wakes it directly, no timeout slice involved.
            self._schedule_locked(
                float(get_flag("admission_bytes_budget_mb")) * (1 << 20)
            )


class QueryResultForwarder:
    """Per-query result stream assembly with watchdog timeouts,
    failure-driven failover, and partial-result accounting.

    A registered query knows its expected data-agent IDS (not just a
    count) and its merge agent; ``agent.expired`` events and
    dispatch-retry exhaustion (``query.{qid}.agent_lost``) feed the same
    wait loop as results, so a dying agent fails a query over
    immediately instead of waiting out the watchdog
    (query_result_forwarder.go's producer-streams teardown)."""

    def __init__(self, bus: MessageBus):
        self.bus = bus
        self._lock = threading.Lock()
        self._active: dict[str, dict] = {}

    def register_query(
        self,
        qid: str,
        expected_data_agents,
        merge_agent: str = "",
        require_complete: bool = False,
        trace=None,
    ):
        """``expected_data_agents`` is the iterable of agent IDs the
        query was planned onto — IDS, not a count: failover, the
        missing-set in timeout diagnostics, and per-agent dispatch
        state all key on them."""
        agents = list(expected_data_agents)
        from .tracker import TOPIC_EXPIRED

        q: queue.Queue = queue.Queue()

        def on_ack(m):
            # Record the ack HERE, on the subscription's dispatcher
            # thread, so the retry manager can observe it immediately
            # (acked_keys) without its own query.{qid}.ack subscription
            # — ONE ack dispatcher thread per query, not two. The
            # message still flows to the wait loop for dispatch-state
            # bookkeeping and the watchdog reset.
            with self._lock:
                st = self._active.get(qid)
                if st is not None:
                    st["acked"].add((m.get("agent"), m.get("ack")))
            q.put(m)

        subs = [
            self.bus.subscribe(f"query.{qid}.results", q.put),
            self.bus.subscribe(f"query.{qid}.agent_done", q.put),
            self.bus.subscribe(f"query.{qid}.ack", on_ack),
            self.bus.subscribe(f"query.{qid}.agent_lost", q.put),
            self.bus.subscribe(
                TOPIC_EXPIRED,
                lambda m: q.put({
                    "_expired": m.get("agent_id"),
                    "_reason": m.get("reason", "expired"),
                }),
            ),
        ]
        dispatch = {f"{aid}:execute": "dispatched" for aid in agents}
        if merge_agent:
            dispatch[f"{merge_agent}:merge"] = "dispatched"
        with self._lock:
            self._active[qid] = {
                "queue": q,
                "subs": subs,
                "expected": set(agents),
                "merge_agent": merge_agent,
                "require_complete": require_complete,
                "dispatch": dispatch,
                "acked": set(),  # {(agent, kind)} — retry manager reads
                "missing": {},  # aid -> reason
                "trace": trace,
            }

    def acked_keys(self, qid: str):
        """{(agent, kind)} acked so far for a registered query — what
        the broker's dispatch-retry loop polls instead of holding its
        own ``query.{qid}.ack`` subscription (and dispatcher thread).
        None once the query deregisters."""
        with self._lock:
            st = self._active.get(qid)
            return set(st["acked"]) if st is not None else None

    def wait(self, qid: str, timeout_s: float,
             deadline: float | None = None,
             deadline_reason: str = "deadline") -> dict:
        """Blocks until eos/error/timeout. Returns {table: HostBatch} plus
        per-agent exec stats and the partial-result marker; raises on
        error, merge-agent loss, require_complete violation, or watchdog
        expiry. The watchdog is an INACTIVITY timeout: any message
        resets it (the reference's producer watchdog).

        ``deadline`` (absolute ``time.monotonic()``) is the query's own
        deadline: when it passes mid-wait the query is cancelled
        everywhere (agents abort at their next window boundary) and
        whatever already arrived returns as a ``partial`` result with
        the unreported agents marked ``missing_reasons[...] =
        deadline_reason`` — a deadline is degradation, not failure (a
        successor broker adopting an in-flight query passes
        "broker_failover" so the attribution names the takeover, not
        the query). An ``interrupt()`` (the ``cancel_query`` path)
        takes the same exit with reason "cancelled"."""
        with self._lock:
            st = self._active[qid]
        outputs: dict = {}
        stats: dict = {}
        merge_stats: dict = {}  # merge-tier attribution (role="merge")
        eos = False
        grace_deadline = None
        # Inactivity watchdog: only QUERY-RELEVANT activity pushes the
        # deadline out — unrelated cluster churn (another query's agent
        # expiring) must not postpone a hung query's timeout forever.
        watchdog = time.monotonic() + timeout_s
        try:
            while True:
                if eos and self._complete(st, stats):
                    return self._result(st, outputs, stats, merge_stats)
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    return self._interrupted(
                        qid, st, outputs, stats, merge_stats,
                        deadline_reason,
                    )
                if eos:
                    # After eos, per-agent stats may still be in flight
                    # on their own dispatcher threads — drain them under
                    # ONE total grace budget (a per-message wait would
                    # let a trickle of stragglers extend the drain by
                    # ~1s × expected agents).
                    if grace_deadline is None:
                        grace_deadline = now + min(timeout_s, 1.0)
                    wait_s = grace_deadline - now
                    if wait_s <= 0:
                        return self._result(st, outputs, stats, merge_stats)
                else:
                    wait_s = watchdog - now
                    if wait_s <= 0:
                        self.cancel(qid)
                        raise QueryTimeout(
                            self._timeout_message(qid, st, stats, timeout_s)
                        )
                if deadline is not None:
                    wait_s = min(wait_s, deadline - now)
                try:
                    msg = st["queue"].get(timeout=max(wait_s, 0.0))
                except queue.Empty:
                    # Loop back: the top of the loop decides which
                    # limit actually fired (query deadline -> partial,
                    # post-eos grace -> result, watchdog -> the
                    # QueryTimeout above; query_result_forwarder.go:241).
                    continue
                if "_abandon" in msg:
                    # Broker-HA kill: free this waiter and its subs (the
                    # finally deregisters) WITHOUT publishing
                    # query.cancel — agents keep running for the
                    # successor's re-attached forwarder.
                    raise QueryAbandoned(
                        f"query {qid} abandoned: {msg['_abandon']}"
                    )
                if "_interrupt" in msg:
                    # cancel_query(): the same cooperative exit as a
                    # lapsed deadline, reason "cancelled".
                    return self._interrupted(
                        qid, st, outputs, stats, merge_stats,
                        str(msg["_interrupt"]),
                    )
                if "error" in msg:
                    self.cancel(qid)
                    raise QueryError(msg["error"])
                if "ack" in msg:
                    st["dispatch"][
                        f"{msg.get('agent')}:{msg['ack']}"
                    ] = "acked"
                elif "_expired" in msg:
                    aid = msg["_expired"]
                    if (
                        aid != st["merge_agent"]
                        and aid not in st["expected"]
                    ):
                        continue  # another query's churn: no reset
                    if not msg.get("_requeued"):
                        # One-shot deferral: the dead agent may have
                        # DELIVERED everything already, with its
                        # agent_done/eos still sitting in this queue
                        # (separate dispatcher threads enqueue in
                        # nondeterministic order). Re-enqueueing puts
                        # the expiry behind whatever was already in
                        # flight, so delivered data is never discarded.
                        st["queue"].put({**msg, "_requeued": True})
                        continue
                    if eos:
                        # The merge already emitted complete results; at
                        # most stop waiting for this agent's stats.
                        st["expected"].discard(aid)
                        continue
                    self._agent_lost(
                        qid, st, stats, aid,
                        msg.get("_reason", "expired"),
                    )
                elif "agent_lost" in msg:
                    if not msg.get("_requeued"):
                        # Same one-shot deferral as _expired: a late ack
                        # (or delivered results) may already sit in this
                        # queue behind the verdict.
                        st["queue"].put({**msg, "_requeued": True})
                        continue
                    # A retry-exhaustion verdict is advisory: if the
                    # ack DID reach this queue (the retry manager merely
                    # raced its own timeout under load), the agent
                    # demonstrably holds the fragment — keep waiting;
                    # real death is caught by expiry.
                    kind = msg.get("kind", "execute")
                    key = f"{msg['agent_lost']}:{kind}"
                    if (
                        msg.get("unacked")
                        and st["dispatch"].get(key) == "acked"
                    ):
                        continue
                    if eos:
                        st["expected"].discard(msg["agent_lost"])
                        continue
                    self._agent_lost(
                        qid, st, stats, msg["agent_lost"],
                        msg.get("reason", "lost"),
                    )
                elif "exec_time_s" in msg:
                    entry = {"exec_time_s": msg["exec_time_s"]}
                    if isinstance(msg.get("usage"), dict):
                        entry["usage"] = dict(msg["usage"])
                    if msg.get("role") == "merge":
                        # Merge-tier usage is attribution, not a data
                        # shard: kept out of agent_stats so expected-set
                        # completion (and existing consumers) see data
                        # agents only.
                        merge_stats[msg["agent"]] = entry
                    else:
                        stats[msg["agent"]] = entry
                elif msg.get("eos"):
                    eos = True
                elif "table" in msg:
                    outputs[msg["table"]] = msg["batch"]
                watchdog = time.monotonic() + timeout_s
        finally:
            self._deregister(qid)

    @staticmethod
    def _complete(st: dict, stats: dict) -> bool:
        return st["expected"] <= set(stats)

    def interrupt(self, qid: str, reason: str = "cancelled") -> bool:
        """Cooperatively stop a registered one-shot query: the wait
        loop returns a partial result with ``reason`` instead of an
        error (the ``cancel_query`` path). False when ``qid`` is not
        (or no longer) registered."""
        with self._lock:
            st = self._active.get(qid)
        if st is None:
            return False
        st["queue"].put({"_interrupt": reason})
        return True

    def abandon(self, qid: str, reason: str = "broker_failover") -> bool:
        """Release a registered query WITHOUT cancelling the agents'
        work: the wait loop raises :class:`QueryAbandoned` (freeing its
        subscriptions and threads) but no ``query.cancel`` is published
        — the fragments keep running so a broker-HA successor can
        re-attach a fresh forwarder and complete the same query. The
        killed leader's teardown path."""
        with self._lock:
            st = self._active.get(qid)
        if st is None:
            return False
        st["queue"].put({"_abandon": reason})
        return True

    def active_qids(self) -> list[str]:
        """Registered (in-flight) query ids — what a broker-HA kill
        abandons and a standby's mirror is reconciled against."""
        with self._lock:
            return sorted(self._active)

    def _interrupted(self, qid: str, st: dict, outputs: dict,
                     stats: dict, merge_stats: dict,
                     reason: str) -> dict:
        """Deadline/cancel exit: stop the agents (they abort at their
        next window boundary — the shed is cooperative, not advisory),
        mark every agent that hasn't reported as missing with
        ``reason``, and return what DID arrive as a partial result. A
        deadline-exceeded query is a degraded answer, not a failure."""
        self.cancel(qid)
        for aid in sorted(st["expected"] - set(stats)):
            st["missing"][aid] = reason
            st["dispatch"][f"{aid}:execute"] = f"interrupted ({reason})"
        res = self._result(st, outputs, stats, merge_stats)
        res["partial"] = True
        res["interrupted"] = reason
        if not res.get("missing_reasons"):
            # Every data agent reported (only eos/merge was pending):
            # still a partial answer — attribute it to the query itself.
            res["missing_reasons"] = {"_query": reason}
        return res

    def _agent_lost(self, qid: str, st: dict, stats: dict, aid: str,
                    reason: str) -> None:
        """One participant is gone: fail over (partial results), or fail
        fast when degradation is impossible (merge agent) or forbidden
        (require_complete)."""
        if aid == st["merge_agent"]:
            self.cancel(qid)
            raise AgentLost(
                f"merge agent {aid} {reason}; query {qid} failed"
            )
        if aid not in st["expected"] or aid in stats:
            return  # not a participant / already finished its fragment
        if st["require_complete"]:
            self.cancel(qid)
            raise AgentLost(
                f"data agent {aid} {reason} and require_complete is set; "
                f"missing_agents: ['{aid}']"
            )
        st["expected"].discard(aid)
        st["missing"][aid] = reason
        st["dispatch"][f"{aid}:execute"] = f"lost ({reason})"
        tr = st.get("trace")
        if tr is not None:
            with tr.span("failover") as sp:
                sp.attributes.update({"agent": aid, "reason": reason})
        if not st["expected"]:
            self.cancel(qid)
            raise AgentLost(
                f"all data agents lost for query {qid}: "
                f"{sorted(st['missing'])}"
            )
        # Tell the merge agent to finish from the survivors: without
        # this, _maybe_finish_merge waits forever on the dead agent's
        # bridge payloads.
        if st["merge_agent"]:
            self.bus.publish(
                f"agent.{st['merge_agent']}.merge_update",
                {"qid": qid, "data_agents": sorted(st["expected"])},
            )

    @staticmethod
    def _timeout_message(qid: str, st: dict, stats: dict,
                         timeout_s: float) -> str:
        missing = sorted(st["expected"] - set(stats))
        return (
            f"query {qid} timed out after {timeout_s}s "
            f"(reported: {sorted(stats)}; missing: {missing}; "
            f"dispatch: {dict(sorted(st['dispatch'].items()))})"
        )

    def _result(self, st: dict, outputs: dict, stats: dict,
                merge_stats: dict | None = None) -> dict:
        res = {
            "tables": outputs,
            "agent_stats": stats,
            "merge_stats": dict(merge_stats or {}),
            "partial": bool(st["missing"]),
            "missing_agents": sorted(st["missing"]),
        }
        if st["missing"]:
            res["missing_reasons"] = dict(st["missing"])
            from .observability import default_counter

            default_counter(
                "pixie_query_partial_total",
                "Distributed queries completed with partial results "
                "(>=1 data agent lost mid-query)",
            ).inc()
        return res

    def cancel(self, qid: str):
        self.bus.publish("query.cancel", {"qid": qid})

    def is_active(self, qid: str) -> bool:
        """True while ``qid`` is registered and not yet deregistered
        (the dispatch-retry loop's liveness check)."""
        with self._lock:
            return qid in self._active

    def _deregister(self, qid: str):
        with self._lock:
            st = self._active.pop(qid, None)
        if st:
            for s in st["subs"]:
                s.unsubscribe()


class StreamHandle:
    """A live query's client handle: ``cancel()`` stops the agents'
    streaming cursors and detaches the subscriber."""

    def __init__(self, qid: str, broker: "QueryBroker", sub,
                 merge_agent: str = "", data_agents: tuple = (),
                 require_complete: bool = False):
        self.qid = qid
        self.merge_agent = merge_agent
        self.data_agents = tuple(data_agents)
        self.require_complete = require_complete
        self.missing_agents: tuple = ()
        self._broker = broker
        self._sub = sub

    def cancel(self) -> None:
        self._broker._live_streams.pop(self.qid, None)
        self._broker.bus.publish("query.cancel", {"qid": self.qid})
        if self._sub is not None:
            self._sub.unsubscribe()
            self._sub = None


class QueryBroker:
    def __init__(
        self,
        bus: MessageBus,
        tracker: AgentTracker,
        registry: Registry | None = None,
        secret: str | None = None,
    ):
        from ..config import get_flag

        self.bus = bus
        self.tracker = tracker
        # Bearer-token check on served API requests (authcontext analog);
        # empty = auth disabled. Netbus connects are gated separately.
        self.secret = get_flag("bus_secret") if secret is None else secret
        from .vizier_funcs import bind_service_registry

        self.registry = bind_service_registry(
            registry or default_registry(), bus, "broker"
        )
        self.forwarder = QueryResultForwarder(bus)
        self.planner = DistributedPlanner(self.registry)
        # Predicted-cost admission control (pxbound predicted_cost vs
        # admission_bytes_budget_mb; off by default).
        self.admission = _Admission()
        # Broker-side query-lifecycle traces (exec/trace.py Tracer):
        # dispatch / retry / failover spans per distributed query,
        # served as /debug/queryz on the broker role.
        from ..exec.trace import Tracer

        self.tracer = Tracer()
        # Cluster-stitched distributed traces (/debug/tracez): the
        # broker's own dispatch spans + the span summaries agents
        # publish on telemetry.spans, grouped by trace id.
        from .telemetry import ClusterTraceView, ObservedCostIndex

        self.trace_view = ClusterTraceView(bus, tracer=self.tracer)
        # Observed per-script-hash cost history (the __queries__
        # feedback loop at the broker): every finished distributed
        # trace's merged usage is indexed so admission control can floor
        # sketch predictions at observed reality
        # (admission_observed_floor).
        self.observed_costs = ObservedCostIndex(tracer=self.tracer)
        # Watermark-validated merged-result cache (exec/result_cache.py;
        # result_cache_mb flag, 0 = off): repeats of an unchanged-
        # watermark script are served BEFORE admission/compile/dispatch.
        from ..exec.result_cache import ResultCache

        self.result_cache = ResultCache()
        # Dynamic-tracing support (the MutationExecutor dependency,
        # mutation_executor.go:84); wire a TracepointRegistry to enable.
        self.tracepoints = None
        # Every live stream's handle (qid -> StreamHandle): the stream
        # watchdog. A stream whose MERGE agent expires can never emit
        # again (data-agent loss re-merges from survivors instead), so
        # tracker expiry fails it loudly rather than leaving the client
        # on a forever-silent subscription (reference: the forwarder's
        # producer watchdog, query_result_forwarder.go).
        self._live_streams: dict = {}
        # Serializes degrade decisions: two agents expiring at once (on
        # separate dispatcher threads) must not lose each other's
        # handle.data_agents update — a lost update would leave a dead
        # agent in the merge's keep-set and stall the view forever.
        self._degrade_lock = threading.Lock()

        from .tracker import TOPIC_EXPIRED, TOPIC_REGISTER

        self._expiry_sub = self.bus.subscribe(
            TOPIC_EXPIRED, self._on_agent_expired
        )
        # A RE-registration of a PLANNED agent means a new incarnation
        # (restart): the old process's stream state — merge carries on
        # a kelvin, the streaming cursor + bridge on a data agent — is
        # gone even though the agent_id never expired (the operator
        # restarts faster than the tracker's expiry window). A restarted
        # data agent's slice would otherwise silently never rejoin the
        # view (a permanently partial live aggregate); aborting lets the
        # client re-plan against the new topology. The surviving-agent
        # resync case only follows an expiry, which already aborted
        # merge-dead streams and degraded data-dead ones visibly.
        self._register_sub = self.bus.subscribe(
            TOPIC_REGISTER, self._on_agent_registered
        )

        # Broker-HA hooks (services/broker_ha.py wires these; all three
        # default to the plain single-broker behavior). epoch_fn stamps
        # the leader's fencing epoch on every dispatch envelope;
        # state_log streams compact control-plane events to standbys;
        # broker_id identifies which broker answered (px agents).
        self.broker_id = ""
        self.epoch_fn = None    # () -> int; None = epochless
        self.state_log = None   # (event: str, data: dict) -> None
        # Set by BrokerReplica.kill(): this broker is dead, its served
        # ERROR replies are suppressed (they'd be artifacts of the kill
        # itself — fenced dispatches, abandoned waits — and would race
        # the successor's real answer for the caller's one-shot inbox).
        self.ha_suppress_errors = False

    def _log_state(self, event: str, data: dict) -> None:
        """Emit one broker.state replication event when this broker is
        an HA leader; no-op otherwise. Replication must never fail the
        query path."""
        log = self.state_log
        if log is not None:
            try:
                log(event, data)
            except Exception:
                pass

    def _on_agent_registered(self, msg: dict) -> None:
        self._abort_streams_of(
            msg.get("agent_id"), "restarted (re-registered)",
            include_data_agents=True,
        )
        # Agent-set change: a merged cached result no longer covers the
        # same shards (and the cluster watermark alone can't always see
        # that), so a repeat must re-execute — and degrade through the
        # partial-results machinery exactly like a live query.
        # ResultCache serializes internally (its own Lock), so the
        # cross-dispatcher clear() is safe without a broker-side lock.
        self.result_cache.clear()  # pxlint: disable=thread-shared-state
        self._log_state("agent", {
            "op": "registered", "agent_id": msg.get("agent_id"),
        })
        self._log_state("cache_invalidate", {"why": "agent-registered"})

    def _abort_streams_of(self, agent_id, why: str,
                          include_data_agents: bool = False) -> None:
        """Fail every live stream that planned ``agent_id`` as its merge
        agent (always) or as a data agent (``include_data_agents``):
        error to the client THEN cancel directly — cleanup must not
        depend on the client's on_update callback surviving (the bus
        swallows handler exceptions). The atomic pop makes the abort
        exactly-once even when expiry and re-registration race on
        separate dispatcher threads."""
        for qid, handle in list(self._live_streams.items()):
            if handle.merge_agent == agent_id:
                role = "merge agent"
            elif include_data_agents and agent_id in handle.data_agents:
                role = "data agent"
            else:
                continue
            if self._live_streams.pop(qid, None) is None:
                continue  # another aborter claimed it first
            self.bus.publish(
                f"query.{qid}.results",
                {"error": f"{role} {agent_id} {why}; "
                          f"live query {qid} aborted"},
            )
            handle.cancel()  # idempotent (entry already popped)

    def _on_agent_expired(self, msg: dict) -> None:
        """Tracker expiry: merge-agent death aborts the stream (its
        state is unrecoverable); data-agent death degrades the stream to
        the survivors (or aborts, under require_complete). One-shot
        queries get the same event through their forwarder
        registration."""
        aid = msg.get("agent_id")
        self._abort_streams_of(aid, "expired")
        self._degrade_streams_of(aid, msg.get("reason", "expired"))
        # A lost agent's shard is gone from the merged view: cached
        # results that covered it must not serve as-if-complete.
        # ResultCache serializes internally (see _on_agent_registered).
        self.result_cache.clear()  # pxlint: disable=thread-shared-state
        self._log_state("agent", {
            "op": "expired", "agent_id": aid,
            "reason": msg.get("reason", "expired"),
        })
        self._log_state("cache_invalidate", {"why": "agent-expired"})

    def _degrade_streams_of(self, agent_id, why: str) -> None:
        with self._degrade_lock:
            for qid, handle in list(self._live_streams.items()):
                self._degrade_one_locked(qid, handle, agent_id, why)

    def _degrade_one_stream(self, qid: str, agent_id, why: str) -> None:
        """Qid-scoped degrade (the per-query dispatch-loss path: the
        verdict only says THIS query's dispatch went missing, so other
        live streams on the same agent must be untouched)."""
        with self._degrade_lock:
            handle = self._live_streams.get(qid)
            if handle is not None:
                self._degrade_one_locked(qid, handle, agent_id, why)

    def _degrade_one_locked(self, qid: str, handle, agent_id,
                            why: str) -> None:
        if (
            agent_id not in handle.data_agents
            or handle.merge_agent == agent_id
        ):
            return
        survivors = tuple(
            a for a in handle.data_agents if a != agent_id
        )
        if handle.require_complete or not survivors:
            # Nothing to degrade to (or degradation forbidden): a
            # sourceless live stream would sit silent forever —
            # error it out like a merge-agent death instead.
            # Caller holds _degrade_lock (both degrade entry points);
            # the lint is intraprocedural.
            # pxlint: disable=thread-shared-state
            if self._live_streams.pop(qid, None) is None:
                return
            cause = (
                "require_complete" if handle.require_complete
                else "no data agents left"
            )
            self.bus.publish(
                f"query.{qid}.results",
                {"error": f"data agent {agent_id} {why}; live query "
                          f"{qid} aborted ({cause})"},
            )
            handle.cancel()
            return
        handle.data_agents = survivors
        handle.missing_agents = handle.missing_agents + (agent_id,)
        # Shrink the live merge's expected set so re-merges keep
        # flowing from the survivors (and the dead agent's stale
        # last state is dropped, not frozen into the view forever).
        self.bus.publish(
            f"agent.{handle.merge_agent}.merge_update",
            {"qid": qid, "data_agents": list(handle.data_agents)},
        )
        self.bus.publish(
            f"query.{qid}.results",
            {"stream_degraded": True, "partial": True, "qid": qid,
             "missing_agents": sorted(handle.missing_agents),
             "reason": f"data agent {agent_id} {why}"},
        )

    def _check_dispatch_sets(self, dplan, dispatches: dict,
                             merge_agent) -> None:
        """Static cross-check before any message leaves the broker: the
        agents the merge fragment will WAIT for must be exactly the
        agents an execute fragment is SENT to (pixie_tpu/analysis
        verify_dispatch_sets). An asymmetry is a planner/dispatch bug
        that would otherwise surface as a query timeout listing agents
        that were never dispatched — fail at plan time instead."""
        from ..analysis.verifier import verify_dispatch_sets

        merge_expected: list = []
        dispatched = []
        for (aid, kind), (_topic, payload) in dispatches.items():
            if kind in ("merge", "stream_merge"):
                merge_expected = payload.get("data_agents", [])
            else:
                dispatched.append(aid)
        diags = verify_dispatch_sets(
            dplan, merge_expected, dispatched, merge_agent=merge_agent
        )
        if diags:
            raise QueryError(
                "dispatch verification failed: "
                + "; ".join(d.render() for d in diags)
            )

    def _dispatch_with_retry(self, qid: str, dispatches: dict,
                             trace=None, on_lost=None,
                             live=None) -> None:
        """Publish every dispatch in ``dispatches`` ({(aid, kind):
        (topic, msg)}, in order), then — on a background thread —
        re-publish any still un-acked with capped exponential backoff +
        jitter (``dispatch_retries`` × ``dispatch_backoff_ms``). A
        dispatch that never acks publishes ``query.{qid}.agent_lost``
        (the forwarder turns it into failover or fail-fast) or, when
        ``on_lost(aid, kind)`` is given (streaming path), calls that
        instead. ``live()`` gates the loop; default: the forwarder
        registration is still active.

        Ack observation: a forwarder-REGISTERED query (the
        execute_script path) already holds a ``query.{qid}.ack``
        subscription whose callback records every ack — the retry
        manager observes THAT state (``forwarder.acked_keys``) instead
        of spawning a second subscription + dispatcher thread per query.
        Only the streaming path (which never registers) keeps its own
        dedicated ack subscription."""
        from ..config import get_flag

        retries = int(get_flag("dispatch_retries"))
        base_s = float(get_flag("dispatch_backoff_ms")) / 1e3
        use_forwarder_acks = live is None and self.forwarder.is_active(qid)
        if live is None:
            live = lambda: self.forwarder.is_active(qid)  # noqa: E731
        acked: set = set()
        all_acked = threading.Event()
        keys = set(dispatches)
        ack_sub = None
        if use_forwarder_acks:
            def wait_acked(wait_s: float) -> bool:
                # Poll the forwarder's ack state on a short cadence
                # (bounded by the wait budget): the acks were recorded
                # on the forwarder's ack dispatcher the instant they
                # arrived, so freshness matches the old subscription.
                deadline = time.monotonic() + wait_s
                while True:
                    got = self.forwarder.acked_keys(qid)
                    if got is None:
                        return True  # deregistered: query over, stand down
                    acked.clear()
                    acked.update(got)
                    if keys <= acked:
                        return True
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return False
                    time.sleep(min(left, 0.05))
        else:
            def on_ack(m):
                acked.add((m.get("agent"), m.get("ack")))
                if keys <= acked:
                    all_acked.set()

            ack_sub = self.bus.subscribe(f"query.{qid}.ack", on_ack)
            wait_acked = all_acked.wait
        for topic, msg in dispatches.values():
            self.bus.publish(topic, msg)

        def run():
            rng = random.Random()  # jitter only shapes timing
            try:
                for attempt in range(retries + 1):
                    wait_s = min(
                        base_s * (2 ** attempt), MAX_DISPATCH_BACKOFF_S
                    ) * (1.0 + 0.25 * rng.random())
                    if wait_acked(wait_s):
                        return
                    if not live():
                        return  # query already finished/failed
                    if attempt >= retries:
                        break
                    from .observability import default_counter

                    retries_total = default_counter(
                        "pixie_dispatch_retries_total",
                        "Un-acked fragment dispatches re-published by "
                        "the broker",
                    )
                    for (aid, kind) in keys - acked:
                        topic, msg = dispatches[(aid, kind)]
                        self.bus.publish(topic, msg)
                        retries_total.inc()
                        if trace is not None:
                            with trace.span("dispatch.retry") as sp:
                                sp.attributes.update({
                                    "agent": aid, "kind": kind,
                                    "attempt": attempt + 1,
                                })
                for (aid, kind) in sorted(keys - acked):
                    if on_lost is not None:
                        on_lost(aid, kind)
                        continue
                    self.bus.publish(
                        f"query.{qid}.agent_lost",
                        {"agent_lost": aid, "kind": kind, "unacked": True,
                         "reason": f"{kind} dispatch un-acked after "
                                   f"{retries} retries"},
                    )
            finally:
                if ack_sub is not None:
                    ack_sub.unsubscribe()

        threading.Thread(
            target=run, name=f"dispatch-{qid}", daemon=True
        ).start()

    def close(self) -> None:
        """Detach the broker from the bus: watchdog subscriptions, the
        served API topics (if serve() ran), and any still-live streams.
        Transient brokers on a shared bus must not keep reacting to
        agent lifecycle events after they're discarded."""
        for qid in list(self._live_streams):
            # GIL-atomic pop: exactly-once vs a racing aborter, same
            # protocol as _abort_streams_of (see baseline.json).
            handle = self._live_streams.pop(qid, None)  # pxlint: disable=thread-shared-state
            if handle is not None:
                handle.cancel()
        for sub in (self._expiry_sub, self._register_sub):
            sub.unsubscribe()
        for sub in getattr(self, "_serve_subs", []):
            sub.unsubscribe()
        self._serve_subs = []  # a re-serve() after close starts fresh
        if getattr(self, "_exec_gate", None) is not None:
            # In-flight request workers finish their current query
            # (replies are best-effort) but drain no further backlog;
            # daemon threads never block interpreter exit.
            with self._exec_gate:
                self._exec_closed = True
                self._exec_backlog.clear()
        self.trace_view.close()

    def stop_serving(self) -> None:
        """Withdraw the served bus API only (the broker-HA step-down
        path): new ``broker.*`` requests flow to whichever broker now
        serves them, while THIS broker's in-flight queries keep
        completing and replying, and its lifecycle subscriptions stay.
        ``serve()`` may run again on re-election."""
        for sub in getattr(self, "_serve_subs", []):
            sub.unsubscribe()
        self._serve_subs = []

    # -- profiling tier ------------------------------------------------------
    def profile_rows(
        self,
        agent_id: str | None = None,
        tenant: str | None = None,
        script_hash: str | None = None,
    ) -> list[dict]:
        """Cluster-merged folded-stack profile: the tracker's heartbeat
        summaries across agents plus this broker process's own profiler
        (deploy.py samples the broker as agent "broker"), merged per
        (stack, attribution) key, hottest first — what /debug/pprof,
        /debug/flamez and the ``broker.profile`` topic serve."""
        rows = self.tracker.profile(
            agent_id=agent_id, tenant=tenant, script_hash=script_hash
        )
        from ..ingest.profiler import profile_summary

        local = (
            profile_summary(agent_id="broker", top=0)
            if agent_id in (None, "broker") else []
        )
        if not local:
            return rows
        merged: dict[tuple, int] = {}
        for r in rows + [
            r for r in local
            if (tenant is None or r.get("tenant", "") == tenant)
            and (script_hash is None
                 or r.get("script_hash", "") == script_hash)
        ]:
            key = (
                r.get("stack", ""), r.get("qid", ""),
                r.get("script_hash", ""), r.get("tenant", ""),
                r.get("phase", ""),
            )
            merged[key] = merged.get(key, 0) + int(r.get("count", 0))
        out = [
            {
                "stack": k[0], "count": n, "qid": k[1],
                "script_hash": k[2], "tenant": k[3], "phase": k[4],
            }
            for k, n in merged.items()
        ]
        out.sort(key=lambda r: (-r["count"], r["stack"]))
        return out

    def profile_agents(self) -> list[str]:
        """Agents contributing stacks to the merged profile (the
        broker's own sampler counts when it has samples)."""
        from ..ingest.profiler import profile_summary

        agents = self.tracker.profile_agents()
        if profile_summary(agent_id="broker", top=1):
            agents = sorted(set(agents) | {"broker"})
        return agents

    def cancel_query(self, qid: str) -> bool:
        """Cooperatively cancel a running query (`px cancel` /
        ``broker.cancel``): live streams tear down their cursors, a
        one-shot query returns a partial result with reason
        "cancelled", and ``query.cancel`` tells every agent to abort at
        its next window boundary — the same path a lapsed deadline
        takes, which is what makes load shedding safe rather than
        advisory. Returns True when a registered query was found."""
        # GIL-atomic pop: exactly-once vs a racing aborter, same
        # protocol as _abort_streams_of (see baseline.json).
        handle = self._live_streams.pop(qid, None)  # pxlint: disable=thread-shared-state
        if handle is not None:
            handle.cancel()
            return True
        # A query still WAITING for admission (its qid is visible in
        # `px debug queries` / /debug/queryz, inviting exactly this
        # cancel) has no forwarder registration yet — cancel it at the
        # queue, before any dispatch exists to stop.
        if self.admission.cancel(qid):
            return True
        hit = self.forwarder.interrupt(qid, "cancelled")
        # Belt and braces: even a query the forwarder no longer tracks
        # (or one raced between registration steps) gets its agents
        # stopped — agents drop cancels for unknown qids.
        self.bus.publish("query.cancel", {"qid": qid})
        return hit

    def execute_script(
        self,
        query: str,
        timeout_s: float = 30.0,
        now_ns: int = 0,
        max_output_rows: int = 10_000,
        mutation_timeout_s: float = 10.0,
        require_complete: bool | None = None,
        tenant: str | None = None,
        priority: int = 0,
        deadline_ms: float | None = None,
        reply_to: str | None = None,
    ) -> dict:
        """The VizierService.ExecuteScript flow, end to end: compile
        against the tracker's schemas, plan onto the live agents,
        dispatch the fragments and wait for the merged answer.

        Mutation phase first (MutationExecutor.Execute): pxtrace
        tracepoints deploy and the broker waits until their tables are
        schema-ready before compiling the query phase — so a script may
        query the very table its tracepoint creates.

        ``require_complete`` (default: the flag): True fails the query
        as soon as a data agent is lost; False completes from the
        survivors with ``partial=True`` + ``missing_agents``.

        Multi-tenancy (services/tenancy.py): ``tenant`` scopes the
        query to a registered tenant's admission share (unknown/None ->
        the shared tenant), ``priority`` (higher first) and
        ``deadline_ms`` (relative, from now) order the admission wait
        queue. The deadline also rides every dispatch: agents abort
        past-deadline work at window boundaries and the client gets a
        ``partial`` result with ``missing_reasons=...: "deadline"``
        instead of dead compute.

        ``reply_to`` (the served request's inbox) is replicated with the
        in-flight record under broker HA, so a successor leader can
        answer the caller.
        """
        from ..config import get_flag
        from .tenancy import resolve_tenant

        if require_complete is None:
            require_complete = bool(get_flag("require_complete"))
        tenant = resolve_tenant(tenant)
        deadline_mono = deadline_unix = None
        if deadline_ms is not None and float(deadline_ms) > 0:
            deadline_mono = time.monotonic() + float(deadline_ms) / 1e3
            deadline_unix = time.time() + float(deadline_ms) / 1e3
        trace = self.tracer.begin_query(script=query, kind="distributed")
        trace.tenant = tenant
        # Profiler attribution (exec/threadmap.py): broker-side CPU on
        # this thread — compile, planning, dispatch, merge coordination
        # — samples under the query's qid/tenant/script hash.
        tm_token = threadmap.bind(trace=trace, phase="host")
        try:
            result = self._execute_script_inner(
                query, timeout_s, now_ns, max_output_rows,
                mutation_timeout_s, require_complete, trace,
                tenant, int(priority), deadline_mono, deadline_unix,
                reply_to,
            )
        except Exception as e:
            self.tracer.end_query(
                trace, status="error",
                error=f"{type(e).__name__}: {e}"[:300],
            )
            raise
        finally:
            threadmap.unbind(tm_token)
        self.tracer.end_query(
            trace,
            status="partial" if result.get("partial") else "ok",
        )
        return result

    def _execute_script_inner(
        self,
        query: str,
        timeout_s: float,
        now_ns: int,
        max_output_rows: int,
        mutation_timeout_s: float,
        require_complete: bool,
        trace,
        tenant: str,
        priority: int,
        deadline_mono: float | None,
        deadline_unix: float | None,
        reply_to: str | None = None,
    ) -> dict:
        from ..exec import result_cache as rc

        # Result cache (exec/result_cache.py): the lookup sits BEFORE
        # admission, compile and dispatch — a hit pays none of them
        # (the entry carries its scanned-table set, so validity is one
        # watermark read per table, no compile). Mutation scripts
        # bypass: their execution has side effects a cache must not
        # swallow.
        cache_status = ""
        if self.result_cache.enabled():
            if "pxtrace" in query:
                cache_status = rc.BYPASS
            else:
                cluster_stats = self.tracker.table_stats()

                def _cluster_wm(t, _stats=cluster_stats):
                    fresh = _stats.get(t, {}).get("freshness") or {}
                    wm = fresh.get("watermark")
                    return None if wm is None or int(wm) < 0 else int(wm)

                status, entry, lag_ms = self.result_cache.lookup(
                    query, now_ns, max_output_rows, _cluster_wm
                )
                if status == rc.HIT:
                    trace.cache = rc.HIT
                    trace.qid = entry.result.get("qid") or ""
                    trace.usage.freshness_lag_ms = lag_ms
                    result = dict(entry.result)
                    result["cache"] = rc.HIT
                    result["freshness_lag_ms"] = lag_ms
                    return result
                cache_status = status
        trace.cache = cache_status
        compiler_state = CompilerState(
            schemas=self.tracker.schemas(),
            registry=self.registry,
            now_ns=now_ns,
            max_output_rows=max_output_rows,
            # Cluster-wide ingest-sketch summary (agents ship it with
            # heartbeats): seeds the planner's NDV sizing AND pxbound's
            # predicted query cost — the admission-control signal.
            table_stats=self.tracker.table_stats(),
        )
        mutation_states = None
        # Cheap gate: the mutation pass re-executes the script, so skip it
        # entirely unless the source can contain pxtrace at all.
        mutations = (
            compile_mutations(query, compiler_state)
            if "pxtrace" in query
            else []
        )
        if mutations:
            if self.tracepoints is None:
                raise QueryError(
                    "script contains pxtrace mutations but this broker has "
                    "no TracepointRegistry wired"
                )
            self.tracepoints.apply(mutations)
            from ..trace.spec import TracepointDeployment

            names = [
                m.name for m in mutations
                if isinstance(m, TracepointDeployment)
            ]
            mutation_states = self.tracepoints.wait_ready(
                names, timeout_s=mutation_timeout_s
            )
            failed = {n: s for n, s in mutation_states.items() if s != "RUNNING"}
            if failed:
                infos = {
                    n: (self.tracepoints.info(n) or {}).get("error", "")
                    for n in failed
                }
                raise QueryError(f"tracepoint deploy failed: {infos}")
            # Re-read schemas: the tracepoint tables now exist.
            compiler_state = CompilerState(
                schemas=self.tracker.schemas(),
                registry=self.registry,
                now_ns=now_ns,
                max_output_rows=max_output_rows,
                table_stats=self.tracker.table_stats(),
            )
        state = self.tracker.distributed_state()  # fresh per query
        with trace.span("compile"):
            compiled = compile_pxl(query, compiler_state)
        if mutations and not compiled.outputs and not compiled.n_exports:
            return {
                "mutations": mutation_states,
                "tables": {},
                "agent_stats": {},
                "qid": None,
            }
        try:
            dplan = self.planner.plan(
                compiled.plan, state,
                schemas=compiler_state.schemas,
                table_stats=compiler_state.table_stats,
            )
        except PlanningError as e:
            raise QueryError(str(e)) from e

        qid = uuid.uuid4().hex[:12]
        trace.qid = qid
        data_agents = list(dplan.data_agent_ids)
        if not dplan.kelvin_agent_ids:
            raise QueryError("no live agent available to run the query")
        merge_agent = dplan.kelvin_agent_ids[0]

        # Predicted cost (pxbound): the logical plan's resource envelope
        # + the split's bridge wire bound. Stamped on the broker trace
        # (predicted-vs-observed in `px debug queries`), attached to
        # every dispatch, and the admission decision's input.
        from ..analysis.bounds import merged_cost
        from ..config import get_flag

        predicted = merged_cost(
            getattr(compiled.plan, "resource_report", None),
            getattr(dplan, "resource_report", None),
        )
        # Calibration (admission_observed_floor): floor the plan-time
        # prediction at this script hash's OBSERVED staged-byte history
        # — a sketch-less unknown becomes the observed bytes (admitted
        # against reality instead of accounted at zero), and a
        # prediction below past observations is raised to them. The
        # floored dict flows everywhere predicted_cost does: the trace,
        # every dispatch, the client result and the admission decision
        # below. Gated on admission being on: with no budget the floor
        # would only replace the auditable pxbound prediction without
        # anyone consuming it.
        if (
            get_flag("admission_observed_floor")
            and float(get_flag("admission_bytes_budget_mb")) > 0
        ):
            predicted = self.observed_costs.floor_predicted(
                predicted, trace.script_hash
            )
        trace.predicted = predicted

        # LaunchQuery: merge fragment first (so the router can accept
        # early bridge chunks), then the per-agent data fragments —
        # every dispatch acked on receipt and retried with backoff
        # before the agent is declared lost. The tenant + absolute
        # deadline ride every dispatch: agents stamp the tenant onto
        # their fragment traces (per-agent __queries__ attribution) and
        # trip the deadline at window boundaries (exec/pipeline.py
        # DeadlineEvent) so dead work stops instead of completing.
        envelope = {"tenant": tenant}
        if deadline_unix is not None:
            envelope["deadline_unix_s"] = deadline_unix
        if self.epoch_fn is not None:
            # Broker-HA epoch fencing: agents reject dispatches stamped
            # below the highest epoch they've seen, so a deposed
            # leader's (re)dispatches die instead of double-executing.
            envelope["epoch"] = int(self.epoch_fn())
        dispatches: dict = {
            (merge_agent, "merge"): (
                f"agent.{merge_agent}.merge",
                {
                    "qid": qid,
                    "plan": dplan.merge_plan,
                    "bridge_ids": [
                        b.bridge_id for b in dplan.split.bridges
                    ],
                    "data_agents": data_agents,
                    "predicted_cost": predicted,
                    **envelope,
                },
            ),
        }
        for aid in data_agents:
            dispatches[(aid, "execute")] = (
                f"agent.{aid}.execute",
                {
                    "qid": qid,
                    "plan": dplan.split.before_blocking,
                    "merge_agent": merge_agent,
                    "predicted_cost": predicted,
                    **envelope,
                },
            )
        # Admission control: reject/queue/shed BEFORE any registration
        # or dispatch — a refused query must leak nothing. admit()
        # either records the query's predicted bytes against its
        # tenant's share (released in the finally below) or raises
        # without recording; a queued query whose deadline lapses is
        # shed here with zero agent work.
        self.admission.admit(
            qid, predicted, tenant=tenant, priority=priority,
            deadline=deadline_mono,
        )
        try:
            # Verify BEFORE registering the query: a failing check must
            # not leak the forwarder's subscriptions/dispatcher threads
            # (they are only released through wait()'s deregister).
            self._check_dispatch_sets(dplan, dispatches, merge_agent)
            self.forwarder.register_query(
                qid, data_agents, merge_agent=merge_agent,
                require_complete=require_complete, trace=trace,
            )
            # Replication (broker HA): the admission grant + dispatch
            # expectations, enough for a standby to reconcile and
            # resolve this query if this broker dies mid-flight.
            self._log_state("inflight", {
                "qid": qid, "tenant": tenant,
                "expected": list(data_agents),
                "merge_agent": merge_agent,
                "reply_to": reply_to or "",
                "require_complete": bool(require_complete),
                "predicted": predicted,
                "deadline_unix_s": deadline_unix,
            })
            with trace.span("dispatch") as sp:
                sp.attributes.update({
                    "data_agents": ",".join(data_agents),
                    "merge_agent": merge_agent,
                })
                # Trace stitching: every dispatch carries the dispatch
                # span's context envelope, so each agent's fragment/merge
                # trace parents under THIS span — one distributed trace,
                # broker -> N agents -> merge (exec/tracectx.py). Stamped
                # into the stored message dicts so background RETRIES of a
                # dispatch carry the same context.
                from ..exec import tracectx

                ctx = trace.ctx(sp)
                for key, (topic, msg) in list(dispatches.items()):
                    dispatches[key] = (topic, tracectx.attach(msg, ctx))
                self._dispatch_with_retry(qid, dispatches, trace=trace)
            result = self.forwarder.wait(
                qid, timeout_s, deadline=deadline_mono
            )
        finally:
            # The query's predicted bytes stop counting against the
            # admission budget the moment it finishes or fails.
            self.admission.release(qid)
            self._log_state("release", {"qid": qid})
        result["qid"] = qid
        result["distributed_plan"] = dplan
        result["predicted_cost"] = predicted
        result["tenant"] = tenant
        # Fold per-agent resource records into the broker's trace: the
        # distributed query's cost with per-agent attribution (served by
        # broker.debug_queries / `px debug queries` / /debug/queryz).
        # Built locally and assigned ONCE: the trace is already visible
        # to concurrent debug surfaces (to_dict iterates agent_usage),
        # so in-place insertion would race their snapshot.
        agent_usage = {}
        for aid, entry in {**result.get("agent_stats", {}),
                           **result.get("merge_stats", {})}.items():
            u = entry.get("usage")
            if isinstance(u, dict):
                agent_usage[aid] = dict(u)
                trace.usage.merge(u)
        trace.agent_usage = agent_usage
        # Result staleness (storage tier): the worst scanned-table
        # watermark lag any agent reported — how stale this answer is,
        # the validity predicate a result cache would check.
        result["freshness_lag_ms"] = round(
            trace.usage.freshness_lag_ms, 3
        )
        # Prime the result cache. Never a partial/interrupted result (a
        # degraded answer must not masquerade as a complete one on the
        # next repeat) and never a mutation script. The watermark
        # snapshot is the PRE-dispatch compiler_state one —
        # conservative: ingest that landed mid-execution makes the
        # stored watermark older than reality, so the next lookup sees
        # the advance and re-validates instead of over-trusting.
        if (
            self.result_cache.enabled()
            and cache_status != rc.BYPASS
            and not result.get("partial")
            and not result.get("interrupted")
        ):
            def _snap_wm(t, _stats=compiler_state.table_stats):
                fresh = (_stats or {}).get(t, {}).get("freshness") or {}
                wm = fresh.get("watermark")
                return None if wm is None or int(wm) < 0 else int(wm)

            cached = {
                k: v for k, v in result.items() if k != "distributed_plan"
            }
            cache_status = self.result_cache.store(
                query, compiler_state.now_ns, max_output_rows,
                compiled.plan, cached, _snap_wm,
            )
            trace.cache = cache_status
        if cache_status:
            result["cache"] = cache_status
        if mutation_states is not None:
            result["mutations"] = mutation_states
        return result

    def execute_script_streaming(
        self,
        query: str,
        on_update,
        poll_interval_s: float = 0.25,
        now_ns: int = 0,
        require_complete: bool | None = None,
    ) -> "StreamHandle":
        """Live ExecuteScript (StreamResults analog,
        ``query_result_forwarder.go:470``): dispatch streaming fragments
        to the agents and deliver incremental result batches to
        ``on_update`` until ``handle.cancel()``.

        ``on_update`` receives dicts {table, batch, seq, mode, agent}
        where mode is "append" (new rows) or "replace" (full updated
        aggregate). Errors arrive as {error}. When a data agent dies
        mid-stream the view degrades to the survivors and a
        {stream_degraded, partial, missing_agents} update is delivered
        (unless ``require_complete``, which aborts with {error}).
        """
        from ..config import get_flag

        if require_complete is None:
            require_complete = bool(get_flag("require_complete"))
        compiler_state = CompilerState(
            schemas=self.tracker.schemas(),
            registry=self.registry,
            now_ns=now_ns,
            max_output_rows=1 << 62,  # live streams are unbounded
            # Sketch stats for the planner's NDV sizing + pxbound
            # presize. Live streams bypass ADMISSION (their lifetime
            # cost is open-ended; per-execution predictions don't
            # model a polling cursor) but still get right-sized
            # buffers.
            table_stats=self.tracker.table_stats(),
        )
        state = self.tracker.distributed_state()
        compiled = compile_pxl(query, compiler_state)
        try:
            dplan = self.planner.plan(compiled.plan, state)
        except PlanningError as e:
            raise QueryError(str(e)) from e
        # Validate streamability up front (one linear source chain): a
        # bad script should fail the call, not trickle errors later.
        from ..exec.streaming import _linearize

        _linearize(dplan.split.before_blocking)

        qid = uuid.uuid4().hex[:12]
        data_agents = list(dplan.data_agent_ids)
        if not dplan.kelvin_agent_ids:
            raise QueryError("no live agent available to run the query")
        merge_agent = dplan.kelvin_agent_ids[0]

        cell: dict = {}

        def _relay(msg):
            on_update(msg)
            if "error" in msg and cell.get("handle") is not None:
                # An errored stream never recovers: stop the agents'
                # polling loops instead of leaking them server-side.
                cell["handle"].cancel()

        sub = self.bus.subscribe(f"query.{qid}.results", _relay)
        handle = StreamHandle(qid, self, sub, merge_agent=merge_agent,
                              data_agents=data_agents,
                              require_complete=require_complete)
        cell["handle"] = handle
        # Registered under the degrade lock: an agent-expiry degrade
        # sweep iterating _live_streams on another dispatcher thread
        # must either see this stream or run before it exists — an
        # unlocked insert could land mid-sweep and miss the degrade.
        with self._degrade_lock:
            self._live_streams[qid] = handle
        # Close the planning window: if the merge agent expired between
        # the tracker snapshot and this registration, its one-shot
        # expiry event already fired — abort now instead of never (and
        # skip dispatch: no point starting cursors for a dead query).
        if not self.tracker.has_agent(merge_agent):
            self._abort_streams_of(merge_agent, "expired during planning")
            return handle
        envelope: dict = {}
        if self.epoch_fn is not None:
            # Same epoch fencing as one-shot dispatch (broker HA).
            envelope["epoch"] = int(self.epoch_fn())
        dispatches: dict = {
            (merge_agent, "stream_merge"): (
                f"agent.{merge_agent}.stream_merge",
                {
                    "qid": qid,
                    "plan": dplan.merge_plan,
                    "bridge_ids": [
                        b.bridge_id for b in dplan.split.bridges
                    ],
                    "data_agents": data_agents,
                    **envelope,
                },
            ),
        }
        for aid in data_agents:
            dispatches[(aid, "stream_execute")] = (
                f"agent.{aid}.stream_execute",
                {
                    "qid": qid,
                    "plan": dplan.split.before_blocking,
                    "merge_agent": merge_agent,
                    "poll_interval_s": poll_interval_s,
                    **envelope,
                },
            )

        def _stream_dispatch_lost(aid, kind):
            # Scoped to THIS qid: the verdict only says this query's
            # dispatch went missing — other live streams on the same
            # agent are demonstrably fine (they acked theirs).
            why = f"unreachable ({kind} dispatch un-acked)"
            if kind == "stream_merge":
                # No merge installed = the stream can never produce:
                # abort loudly rather than degrade.
                h = self._live_streams.pop(qid, None)
                if h is None:
                    return
                self.bus.publish(
                    f"query.{qid}.results",
                    {"error": f"merge agent {aid} {why}; live query "
                              f"{qid} aborted"},
                )
                h.cancel()
            else:
                self._degrade_one_stream(qid, aid, why)

        try:
            self._check_dispatch_sets(dplan, dispatches, merge_agent)
        except QueryError:
            # The stream is already registered (the planning-window
            # close above needs it); a failing check must unwind it or
            # the phantom stream leaks its results subscription and
            # stays visible to degrade sweeps forever.
            with self._degrade_lock:
                self._live_streams.pop(qid, None)
            sub.unsubscribe()
            raise
        self._dispatch_with_retry(
            qid, dispatches, on_lost=_stream_dispatch_lost,
            live=lambda: qid in self._live_streams,
        )
        # Close the DATA-agent planning window symmetrically: an agent
        # that expired between the tracker snapshot and the stream
        # registration fired its one-shot expiry event before we could
        # hear it — degrade (or abort) now instead of leaving the live
        # merge waiting on a dead agent's states forever.
        for aid in list(handle.data_agents):
            if not self.tracker.has_agent(aid):
                self._degrade_streams_of(aid, "expired during planning")
        return handle

    # -- bus API (the VizierService gRPC surface analog) ---------------------

    def busz(self) -> dict:
        """Cluster transport snapshot for ``/debug/busz``: the
        tracker's per-agent + merged heartbeat bus summaries, plus this
        broker process's own bus (deploy adds the BusServer's
        per-connection wire accounting on top)."""
        t = self.tracker.bus_stats()
        out = {
            "scope": "cluster",
            "agents": t["agents"],
            "merged": t["merged"],
        }
        local = getattr(self.bus, "busz", None)
        if local is not None:
            out["local"] = local()
        return out

    def serve(self) -> None:
        """Expose the broker on bus topics so remote clients (CLI/API over
        the framed-TCP netbus) can execute scripts and introspect the
        cluster — the api.vizierpb.VizierService analog
        (``src/api/proto/vizierpb/vizierapi.proto`` ExecuteScript).

        Topics (all request/reply via ``_reply_to``):
          broker.execute  {query, timeout_s?, max_output_rows?, tenant?,
                          priority?, deadline_ms?}
                          -> {ok, qid, tables, agent_stats} | {ok: False, error}
          broker.cancel   {qid} -> {ok, cancelled} — cooperative
                          cancellation (px cancel); the query returns
                          partial with reason "cancelled"
          broker.execute_stream {query, update_topic, poll_interval_s?}
                          -> {ok, qid}; incremental updates then flow to
                          ``update_topic`` as {table, batch, seq, mode}
                          (or {error}) until broker.stream_cancel {qid}
          broker.stream_cancel {qid} -> {ok}
          broker.schemas  {} -> {ok, schemas: {table: Relation}}
          broker.agents   {} -> {ok, agents: [agent info dict]}
          broker.scripts  {} -> {ok, scripts: [name]}
          broker.debug_queries {limit?} -> {ok, in_flight, queries}
                          recent distributed-query traces with resource
                          usage + per-agent attribution (px debug queries)
        """
        # Idempotent: a second serve() would double-subscribe every
        # topic (each request handled twice — duplicate replies,
        # double-spawned workers, double-counted metrics).
        if getattr(self, "_serve_subs", None):
            return

        def _reply(msg, payload):
            inbox = msg.get("_reply_to")
            if inbox:
                self.bus.publish(inbox, payload)

        def _auth(msg):
            """Verify the request's bearer token; returns the AuthContext
            (threaded into handlers the way the reference's authcontext
            rides the gRPC metadata). No-op when auth is disabled."""
            from .auth import verify_token

            return verify_token(self.secret, msg.get("token"))

        def _guarded(handler):
            def wrapped(msg):
                from .auth import AuthError

                try:
                    msg["_auth"] = _auth(msg)
                except AuthError as e:
                    _reply(msg, {"ok": False, "error": f"AuthError: {e}"})
                    return
                handler(msg)

            return wrapped

        def _run_execute(msg):
            try:
                rc = msg.get("require_complete")
                dl = msg.get("deadline_ms")
                res = self.execute_script(
                    msg["query"],
                    timeout_s=float(msg.get("timeout_s", 30.0)),
                    now_ns=int(msg.get("now_ns", 0)),
                    max_output_rows=int(msg.get("max_output_rows", 10_000)),
                    require_complete=None if rc is None else bool(rc),
                    tenant=msg.get("tenant"),
                    priority=int(msg.get("priority", 0)),
                    deadline_ms=None if dl is None else float(dl),
                    # Broker HA: replicated with the in-flight record so
                    # a successor leader can answer this caller's inbox.
                    reply_to=msg.get("_reply_to"),
                )
                _reply(msg, {
                    "ok": True,
                    "qid": res.get("qid"),
                    "tables": res.get("tables", {}),
                    "agent_stats": res.get("agent_stats", {}),
                    "partial": res.get("partial", False),
                    "missing_agents": res.get("missing_agents", []),
                    "missing_reasons": res.get("missing_reasons", {}),
                    "interrupted": res.get("interrupted"),
                    "mutations": res.get("mutations"),
                    "predicted_cost": res.get("predicted_cost"),
                    "tenant": res.get("tenant"),
                    "freshness_lag_ms": res.get("freshness_lag_ms"),
                    "cache": res.get("cache", ""),
                })
            except QueryAbandoned:
                # Broker-HA kill released this wait without cancelling
                # the agents: the successor leader re-attaches and
                # answers the caller's inbox — replying here would race
                # (and beat) the real answer.
                return
            except Exception as e:  # errors cross the wire as data
                if self.ha_suppress_errors:
                    # Killed broker: its dispatches are epoch-fenced, so
                    # failures here (un-acked retries -> AgentLost) are
                    # artifacts of its own death. The query was mirrored
                    # before dispatch; the successor answers the inbox —
                    # an error reply now would consume the caller's
                    # one-shot inbox and beat the real answer.
                    return
                _reply(msg, {"ok": False, "error": f"{type(e).__name__}: {e}"})

        # One DAEMON worker thread per in-flight request, capped PER
        # TENANT: the broker.execute topic has a SINGLE bus dispatcher
        # thread, so an admission-queued (or merely slow) query handled
        # inline would head-of-line block every other tenant's
        # requests — and a single GLOBAL pool merely moves that
        # blocking up a level (one tenant's requests parked in
        # admission waits would hold every worker while other tenants'
        # requests rot in a shared FIFO). Per-tenant caps keep the
        # isolation contract at the front door: tenant A's backlog
        # queues behind A's own cap, B's requests spawn their own
        # workers. Total thread count stays bounded because tenants
        # are a REGISTERED set (resolve_tenant folds unknowns into
        # "shared"): <= broker_execute_threads x (registered tenants).
        # Daemon threads (vs ThreadPoolExecutor): a slow in-flight
        # query must not block interpreter exit for its whole timeout.
        from collections import deque

        from ..config import get_flag
        from .tenancy import resolve_tenant

        # Live workers hold closures over these attributes: a serve()
        # after close() or a stop_serving() (broker-HA step-down, then
        # re-election) keeps them rather than replacing them under a
        # draining worker.
        if getattr(self, "_exec_gate", None) is None:
            self._exec_gate = threading.Lock()
            self._exec_live: dict = {}     # tenant -> live worker count
            self._exec_backlog: dict = {}  # tenant -> deque of messages
        self._exec_closed = False

        # Backlog bound: per tenant, this many waiting requests ride
        # behind the cap before the front door fails fast (each parked
        # message holds query text + a reply handle — unbounded growth
        # at the exact overload moment this layer defends against).
        _BACKLOG_PER_WORKER = 8

        def _execute_worker(msg, tenant):
            while msg is not None:
                _run_execute(msg)
                msg = None
                while msg is None:
                    with self._exec_gate:
                        backlog = self._exec_backlog.get(tenant)
                        if backlog and not self._exec_closed:
                            msg, enq_t, give_up = backlog.popleft()
                        else:
                            self._exec_live[tenant] -= 1
                            if not self._exec_live[tenant]:
                                del self._exec_live[tenant]
                            return
                    if time.monotonic() >= give_up:
                        # The client's own request timeout elapsed
                        # while this waited behind the tenant's cap:
                        # executing it now is dead agent work for a
                        # caller that already gave up.
                        _reply(msg, {
                            "ok": False,
                            "error": "BrokerOverloaded: request "
                                     f"expired after {time.monotonic() - enq_t:.1f}s "
                                     "in the tenant's front-door "
                                     "backlog (broker_execute_threads)",
                        })
                        msg = None

        def _on_execute(msg):
            tenant = resolve_tenant(msg.get("tenant"), count_unknown=False)
            cap = max(1, int(get_flag("broker_execute_threads")))
            with self._exec_gate:
                if self._exec_closed:
                    return
                if self._exec_live.get(tenant, 0) >= cap:
                    backlog = self._exec_backlog.setdefault(
                        tenant, deque()
                    )
                    if len(backlog) >= cap * _BACKLOG_PER_WORKER:
                        full = True
                    else:
                        full = False
                        now = time.monotonic()
                        backlog.append((
                            msg, now,
                            now + float(msg.get("timeout_s", 30.0)),
                        ))
                else:
                    full = None
                    self._exec_live[tenant] = (
                        self._exec_live.get(tenant, 0) + 1
                    )
            if full:  # fail fast OUTSIDE the gate: publish can be slow
                _reply(msg, {
                    "ok": False,
                    "error": "BrokerOverloaded: tenant front-door "
                             "backlog full (broker_execute_threads x "
                             f"{_BACKLOG_PER_WORKER} waiting requests)",
                })
            elif full is None:
                threading.Thread(
                    target=_execute_worker, args=(msg, tenant),
                    name="broker-execute", daemon=True,
                ).start()

        def _on_cancel(msg):
            qid = msg.get("qid")
            _reply(msg, {
                "ok": True,
                "cancelled": bool(qid) and self.cancel_query(str(qid)),
            })

        def _on_execute_stream(msg):
            topic = msg.get("update_topic")
            try:
                if not topic:
                    raise QueryError("execute_stream needs an update_topic")

                def _push(u, _topic=topic):
                    # publish() reports delivery count: the client
                    # subscribed to its inbox before requesting, so zero
                    # receivers means it disconnected — reap the stream
                    # rather than polling for a ghost.
                    if self.bus.publish(_topic, u) == 0:
                        h = self._live_streams.pop(
                            handle_box.get("qid"), None
                        )
                        if h is not None:
                            h.cancel()

                rc = msg.get("require_complete")
                handle_box: dict = {}
                handle = self.execute_script_streaming(
                    msg["query"],
                    on_update=_push,
                    poll_interval_s=float(msg.get("poll_interval_s", 0.25)),
                    now_ns=int(msg.get("now_ns", 0)),
                    require_complete=None if rc is None else bool(rc),
                )
                handle_box["qid"] = handle.qid
                _reply(msg, {"ok": True, "qid": handle.qid})
            except Exception as e:
                _reply(msg, {"ok": False, "error": f"{type(e).__name__}: {e}"})

        def _on_stream_cancel(msg):
            # GIL-atomic pop: exactly-once vs a racing aborter, same
            # protocol as _abort_streams_of (see baseline.json).
            handle = self._live_streams.pop(msg.get("qid"), None)  # pxlint: disable=thread-shared-state
            if handle is not None:
                handle.cancel()
            _reply(msg, {"ok": True})

        def _on_schemas(msg):
            _reply(msg, {"ok": True, "schemas": self.tracker.schemas()})

        def _on_agents(msg):
            # "broker" names which replica answered (`px agents` prints
            # it) — meaningful under broker HA, empty on a plain broker.
            _reply(msg, {
                "ok": True,
                "agents": self.tracker.agents_info(),
                "broker": self.broker_id,
            })

        def _on_scripts(msg):
            from ..scripts import list_scripts

            _reply(msg, {"ok": True, "scripts": list_scripts()})

        def _on_profile(msg):
            # `px profile` / api.Client.profile: the cluster-merged
            # folded-stack CPU profile (tracker heartbeat summaries +
            # the broker's own profiler), optionally filtered.
            try:
                n = max(1, min(int(msg.get("limit", 64)), 4096))
            except (TypeError, ValueError):
                n = 64
            rows = self.profile_rows(
                agent_id=msg.get("agent") or None,
                tenant=msg.get("tenant") or None,
                script_hash=msg.get("script") or None,
            )
            _reply(msg, {
                "ok": True,
                "agents": self.profile_agents(),
                "stacks": rows[:n],
            })

        def _on_debug_queries(msg):
            # `px debug queries`: the broker's recent distributed-query
            # traces — status, duration, resource usage with per-agent
            # attribution (QueryTrace.to_dict carries usage/agent_usage).
            try:
                n = max(1, min(int(msg.get("limit", 50)), 500))
            except (TypeError, ValueError):
                n = 50
            _reply(msg, {
                "ok": True,
                "in_flight": self.tracer.in_flight(),
                "queries": self.tracer.recent()[:n],
                # Admission-scheduler view: per-tenant in-flight
                # predicted bytes + the ordered wait queue.
                "admission": {
                    "in_flight_by_tenant":
                        self.admission.in_flight_by_tenant(),
                    "queued": self.admission.queued(),
                },
            })

        self._serve_subs = [
            self.bus.subscribe("broker.execute", _guarded(_on_execute)),
            self.bus.subscribe("broker.cancel", _guarded(_on_cancel)),
            self.bus.subscribe(
                "broker.execute_stream", _guarded(_on_execute_stream)
            ),
            self.bus.subscribe(
                "broker.stream_cancel", _guarded(_on_stream_cancel)
            ),
            self.bus.subscribe("broker.schemas", _guarded(_on_schemas)),
            self.bus.subscribe("broker.agents", _guarded(_on_agents)),
            self.bus.subscribe("broker.scripts", _guarded(_on_scripts)),
            self.bus.subscribe("broker.profile", _guarded(_on_profile)),
            self.bus.subscribe(
                "broker.debug_queries", _guarded(_on_debug_queries)
            ),
        ]
