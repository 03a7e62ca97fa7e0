"""Broker high availability: leader leases, a replicated control-plane
state log, and failover of in-flight queries.

The reference deployment runs one query broker per cluster — a single
point of failure for the whole serving path. This module runs N
:class:`BrokerReplica` peers on one bus:

- **Leases, not consensus.** The leader publishes ``broker.lease``
  heartbeats carrying a monotonically-increasing **epoch**
  (``broker_lease_interval_s`` cadence). Standbys watch; when the lease
  goes silent past ``broker_lease_expiry_s`` the lowest-id live standby
  claims ``max(seen epochs) + 1`` and publishes its own lease
  immediately. The bus is the arbiter: a split claim resolves on the
  next lease exchange (higher epoch wins; equal epochs tie-break on
  broker id), and every dispatch is stamped with the leader's epoch so
  agents FENCE a deposed leader's backlog (``Agent._epoch_ok``)
  — two half-leaders can race leases, but only one epoch's work runs.

- **Replicated control-plane state.** The leader streams a compact
  ``broker.state`` log — in-flight query records (admission
  grants/releases), observed-cost updates, agent lifecycle events,
  result-cache invalidations — and each standby folds it into a
  mirror. This is the arXiv:2506.20010 shape (control-plane log
  replicated separately from the compute it describes): the log carries
  broker *decisions*, never table data.

- **Failover of in-flight queries.** On takeover the new leader
  replays its mirror: re-registers a forwarder for every mirrored
  in-flight query (closing the event-loss window first), probes the
  fleet with ``broker.reconcile`` to learn which fragments still run,
  then resolves each query — still-running ones complete normally
  through the re-attached forwarder, unrecoverable ones resolve as
  ``partial`` with ``missing_reasons: "broker_failover"``. Every
  mirrored query answers its caller's inbox; nothing hangs.

Clients never address a broker directly: ``broker.execute`` (and every
served topic) is subscribed only by the current leader, and
``broker.leader`` is answered by every replica, so `api.Client` /
`px` fail over by re-resolving.

A port of the JAX package's ``services/broker_ha.py``. The replicas
exchange host messages only. The agents keep their engines, windows and
bridge states on their own device throughout: a fenced dispatch
launches nothing, and an abandoned query's fragments run on until the
successor's forwarder re-attaches to them.
"""

from __future__ import annotations

import threading
import time
import uuid

from .msgbus import MessageBus
from .observability import default_counter
from .query_broker import QueryBroker
from .tracker import AgentTracker

TOPIC_LEASE = "broker.lease"          # leader heartbeats + standby presence
TOPIC_STATE = "broker.state"          # leader -> standbys control-plane log
TOPIC_LEADER = "broker.leader"        # request/reply: who leads?
TOPIC_RECONCILE = "broker.reconcile"  # takeover probe -> agents answer


class _Mirror:
    """A standby's fold of the leader's ``broker.state`` log. Plain
    dicts guarded by the replica's lock — the mirror is only ever read
    whole at takeover."""

    def __init__(self):
        self.inflight: dict[str, dict] = {}   # qid -> inflight record
        self.costs: dict[str, dict] = {}      # script_hash -> cost entry
        self.agent_events = 0
        self.cache_invalidations = 0


class BrokerReplica:
    """One broker peer: an :class:`AgentTracker` + :class:`QueryBroker`
    pair wrapped in lease-based leader election. Exactly one replica
    serves the ``broker.*`` API at a time; the rest mirror its state
    log and race to take over when its lease lapses."""

    def __init__(
        self,
        bus: MessageBus,
        broker_id: str,
        registry=None,
        secret: str | None = None,
        lease_interval_s: float | None = None,
        lease_expiry_s: float | None = None,
        tracker_kw: dict | None = None,
        leader: bool = False,
    ):
        from ..config import get_flag

        self.bus = bus
        self.broker_id = broker_id
        self.lease_interval_s = (
            float(get_flag("broker_lease_interval_s"))
            if lease_interval_s is None else float(lease_interval_s)
        )
        self.lease_expiry_s = (
            float(get_flag("broker_lease_expiry_s"))
            if lease_expiry_s is None else float(lease_expiry_s)
        )
        self.reconcile_wait_s = float(get_flag("broker_reconcile_wait_s"))
        self.reattach_timeout_s = float(get_flag("broker_reattach_timeout_s"))

        # Standby trackers observe heartbeats but publish NOTHING — two
        # active trackers would double-ack registrations and race
        # expiry/quarantine decisions.
        self.tracker = AgentTracker(
            bus, passive=not leader, **dict(tracker_kw or {})
        )
        self.broker = QueryBroker(bus, self.tracker, registry=registry,
                                  secret=secret)
        self.broker.broker_id = broker_id
        self.broker.epoch_fn = lambda: self.epoch

        self._lock = threading.Lock()
        self.role = "leader" if leader else "standby"
        self.epoch = 1 if leader else 0
        self._state_seq = 0        # leader: last published state-log seq
        self._applied_seq = 0      # standby: last folded state-log seq
        self._leader_state_seq = 0  # standby: leader's seq per its lease
        self.mirror = _Mirror()
        self._known_leader = broker_id if leader else ""
        self._last_lease_t = time.monotonic()  # grace from construction
        self._last_lease: dict = {}
        self._peers: dict[str, float] = {}     # standby id -> last seen
        self._wired = False        # cost-trace listener added once
        self._dead = False
        self._stop = threading.Event()
        self.failovers = 0

        self._subs = [
            bus.subscribe(TOPIC_LEASE, self._on_lease),
            bus.subscribe(TOPIC_STATE, self._on_state),
            bus.subscribe(TOPIC_LEADER, self._on_leader),
        ]
        if leader:
            self._wire_leader()
            self.broker.serve()
            self._publish_lease()
        self._watch = threading.Thread(
            target=self._watch_loop, daemon=True,
            name=f"broker-ha-{broker_id}",
        )
        self._watch.start()

    # -- lease protocol ------------------------------------------------------
    def _publish_lease(self) -> None:
        with self._lock:
            if self._dead:
                return
            payload = {
                "broker": self.broker_id,
                "role": self.role,
                "epoch": self.epoch,
                "state_seq": self._state_seq,
            }
            is_leader = self.role == "leader"
            if is_leader:
                # Our own lease doubles as the freshness record so a
                # just-deposed leader measures staleness the same way.
                self._last_lease = dict(payload)
                self._last_lease_t = time.monotonic()
        self.bus.publish(TOPIC_LEASE, payload)

    def _on_lease(self, msg: dict) -> None:
        if self._dead:
            return
        b = str(msg.get("broker", ""))
        ep = int(msg.get("epoch", 0) or 0)
        if msg.get("role") == "standby":
            if b and b != self.broker_id:
                with self._lock:
                    self._peers[b] = time.monotonic()
            return
        if b == self.broker_id:
            return
        step_down = False
        with self._lock:
            if ep < self.epoch:
                return  # deposed leader's stale lease: ignore
            self._last_lease = dict(msg)
            self._last_lease_t = time.monotonic()
            self._leader_state_seq = int(msg.get("state_seq", 0) or 0)
            self._known_leader = b
            if self.role == "leader" and (
                ep > self.epoch or (ep == self.epoch and b < self.broker_id)
            ):
                # A peer leads at a higher epoch (or won the equal-epoch
                # tie-break): yield. Our queued dispatches carry the old
                # epoch and die at the agents' fence.
                step_down = True
            self.epoch = max(self.epoch, ep)
        if step_down:
            self._step_down()

    def _step_down(self) -> None:
        with self._lock:
            self.role = "standby"
            self._known_leader = ""
        self.broker.stop_serving()
        self.broker.state_log = None
        default_counter(
            "pixie_broker_stepdowns_total",
            "Leaders that yielded to a higher-epoch peer",
        ).inc()

    def _watch_loop(self) -> None:
        while not self._stop.wait(self.lease_interval_s):
            if self._dead:
                return
            if self.role == "leader":
                self._publish_lease()
                continue
            # Standby: advertise presence (rank input for peers), then
            # check the leader's lease.
            self.bus.publish(TOPIC_LEASE, {
                "broker": self.broker_id, "role": "standby",
                "epoch": self.epoch,
            })
            now = time.monotonic()
            with self._lock:
                age = now - self._last_lease_t
                live = sorted(
                    [self.broker_id]
                    + [p for p, t in self._peers.items()
                       if now - t < self.lease_expiry_s]
                )
                rank = live.index(self.broker_id)
            # Ranked claim windows stagger the standbys: the lowest id
            # claims first; a higher-ranked one only moves if the
            # preferred claimant is ALSO gone for its whole window.
            if age > self.lease_expiry_s + rank * self.lease_interval_s:
                self._claim()

    def _claim(self) -> None:
        with self._lock:
            if self._dead or self.role == "leader":
                return
            seen = int(self._last_lease.get("epoch", 0) or 0)
            self.epoch = max(self.epoch, seen) + 1
            self.role = "leader"
            # Continue the state log where the mirror left off so other
            # standbys' replay-lag stays monotone across successions.
            self._state_seq = max(self._state_seq, self._applied_seq)
            self._known_leader = self.broker_id
            self.failovers += 1
        default_counter(
            "pixie_broker_failovers_total",
            "Lease-expiry takeovers by a standby broker",
        ).inc()
        self._publish_lease()  # fence the deposed leader's epoch NOW
        self._takeover()

    # -- state log -----------------------------------------------------------
    def _wire_leader(self) -> None:
        self.broker.state_log = self._publish_state
        if not self._wired:
            self._wired = True
            self.broker.tracer.add_listener(self._on_cost_trace)

    def _publish_state(self, event: str, data: dict) -> None:
        with self._lock:
            if self._dead or self.role != "leader":
                return
            self._state_seq += 1
            payload = {
                "broker": self.broker_id,
                "epoch": self.epoch,
                "seq": self._state_seq,
                "event": event,
                "data": data,
            }
        self.bus.publish(TOPIC_STATE, payload)

    def _on_cost_trace(self, trace) -> None:
        """Tracer listener: replicate the observed-cost history the
        admission floor calibrates on (arXiv:2102.02440 feedback loop)
        so a successor doesn't re-learn it from zero."""
        if self._dead or self.role != "leader":
            return
        if getattr(trace, "kind", "") != "distributed":
            return
        if trace.status not in ("ok", "partial"):
            return
        u = trace.usage
        self._publish_state("cost", {
            "script_hash": trace.script_hash,
            "bytes_staged": int(u.bytes_staged),
            "rows_in": int(u.rows_in),
        })

    def _on_state(self, msg: dict) -> None:
        if self._dead:
            return
        with self._lock:
            if self.role == "leader":
                return
            event = msg.get("event", "")
            data = msg.get("data") or {}
            if event == "inflight":
                qid = data.get("qid", "")
                if qid:
                    self.mirror.inflight[qid] = dict(data)
            elif event == "release":
                self.mirror.inflight.pop(data.get("qid", ""), None)
            elif event == "cost":
                h = data.get("script_hash", "")
                ent = self.mirror.costs.setdefault(
                    h, {"bytes_staged": 0, "rows_in": 0, "runs": 0}
                )
                ent["bytes_staged"] = max(
                    ent["bytes_staged"], int(data.get("bytes_staged", 0))
                )
                ent["rows_in"] = max(
                    ent["rows_in"], int(data.get("rows_in", 0))
                )
                ent["runs"] += 1
            elif event == "agent":
                self.mirror.agent_events += 1
            elif event == "cache_invalidate":
                self.mirror.cache_invalidations += 1
            self._applied_seq = int(msg.get("seq", 0) or 0)

    # -- leader discovery ----------------------------------------------------
    def _on_leader(self, msg: dict) -> None:
        if self._dead:
            return
        inbox = msg.get("_reply_to")
        if not inbox:
            return
        with self._lock:
            leader = (
                self.broker_id if self.role == "leader"
                else self._known_leader
            )
            payload = {
                "ok": bool(leader),
                "broker": leader,
                "epoch": self.epoch,
                "role": self.role,
                "answered_by": self.broker_id,
            }
        if not payload["ok"]:
            return  # mid-failover: stay silent, the claimant answers
        self.bus.publish(inbox, payload)

    # -- takeover ------------------------------------------------------------
    def _takeover(self) -> None:
        with self._lock:
            inflight = dict(self.mirror.inflight)
            costs = dict(self.mirror.costs)
        self.tracker.activate()
        self.broker.observed_costs.seed(costs)
        self._wire_leader()
        self.broker.serve()
        if inflight:
            self._reconcile(inflight)

    def _reconcile(self, inflight: dict) -> None:
        """Resolve every mirrored in-flight query: re-attach a fresh
        forwarder (FIRST — closes the event-loss window), probe the
        fleet for still-running fragments, then complete the live ones
        normally and interrupt the dead ones into
        partial/``broker_failover``. Every record answers its caller."""
        fw = self.broker.forwarder
        waiters: dict[str, threading.Thread] = {}
        for qid, info in inflight.items():
            expected = [str(a) for a in (info.get("expected") or [])]
            fw.register_query(
                qid, expected,
                merge_agent=str(info.get("merge_agent") or ""),
                require_complete=False,
            )
            t = threading.Thread(
                target=self._finish_failover, args=(qid, dict(info)),
                daemon=True, name=f"broker-failover-{qid[:8]}",
            )
            waiters[qid] = t
            t.start()

        # Probe: agents answer with their running fragment set + the
        # unmet merge expectations. The probe carries the NEW epoch, so
        # it also fences agents that never saw our first lease.
        answers: list[dict] = []
        inbox = f"broker.reconcile.{uuid.uuid4().hex[:12]}"
        sub = self.bus.subscribe(inbox, answers.append)
        with self._lock:
            epoch = self.epoch
        self.bus.publish(TOPIC_RECONCILE, {
            "_reply_to": inbox, "epoch": epoch,
        })
        # Collect for the reconcile window, refreshing the lease so a
        # slow probe never reads as a second leader death.
        deadline = time.monotonic() + self.reconcile_wait_s
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            time.sleep(min(left, self.lease_interval_s))
            self._publish_lease()
        sub.unsubscribe()

        running: set[str] = set()          # qids some agent still runs
        for a in answers:
            running.update(str(q) for q in (a.get("running") or []))
            running.update(str(q) for q in (a.get("streaming") or []))
            running.update(str(q) for q in (a.get("pending_merges") or {}))
        for qid in inflight:
            if qid not in running:
                # Nobody owns a fragment: the work died with the old
                # leader (or finished before we re-attached). Interrupt
                # resolves the wait as partial/broker_failover instead
                # of letting it ride the inactivity watchdog.
                fw.interrupt(qid, "broker_failover")
        default_counter(
            "pixie_broker_reconciled_queries_total",
            "In-flight queries resolved by a takeover reconcile",
        ).inc(len(inflight))

    def _finish_failover(self, qid: str, info: dict) -> None:
        """Complete one adopted query and answer its caller's inbox in
        the exact served-reply shape (`_run_execute`).

        The re-attach window is a hard DEADLINE, not an inactivity
        watchdog: fragment results published into the takeover gap
        (after the old leader died, before this forwarder re-
        subscribed) are gone from the bus, so an adopted query can
        have a claimed owner — e.g. a merge agent holding unmet bridge
        expectations — yet never produce another report. When the
        window lapses, whatever DID re-report returns as a structured
        ``partial``/``broker_failover`` reply; an error here would read
        to the caller (and the chaos soak's ledger) as a lost query."""
        fw = self.broker.forwarder
        try:
            res = fw.wait(
                qid, self.reattach_timeout_s,
                deadline=time.monotonic() + self.reattach_timeout_s,
                deadline_reason="broker_failover",
            )
            payload = {
                "ok": True,
                "qid": qid,
                "tables": res.get("tables", {}),
                "agent_stats": res.get("agent_stats", {}),
                "partial": res.get("partial", False),
                "missing_agents": res.get("missing_agents", []),
                "missing_reasons": res.get("missing_reasons", {}),
                "interrupted": res.get("interrupted"),
                "mutations": None,
                "predicted_cost": info.get("predicted"),
                "tenant": info.get("tenant"),
                "freshness_lag_ms": None,
                "cache": "",
                "failover": True,
            }
        except Exception as e:  # errors cross the wire as data
            payload = {
                "ok": False,
                "qid": qid,
                "error": f"{type(e).__name__}: {e}",
                "failover": True,
            }
        reply_to = info.get("reply_to") or ""
        if reply_to:
            self.bus.publish(reply_to, payload)
        with self._lock:
            self.mirror.inflight.pop(qid, None)

    # -- introspection -------------------------------------------------------
    def statusz(self) -> dict:
        """Role, epoch, lease age, and state-log replay lag — merged
        into /statusz by deploy.run_broker."""
        now = time.monotonic()
        with self._lock:
            lag = (
                0 if self.role == "leader"
                else max(0, self._leader_state_seq - self._applied_seq)
            )
            return {
                "broker": self.broker_id,
                "role": self.role,
                "epoch": self.epoch,
                "leader": (
                    self.broker_id if self.role == "leader"
                    else self._known_leader
                ),
                "lease_age_s": round(now - self._last_lease_t, 3),
                "state_seq": self._state_seq,
                "applied_seq": self._applied_seq,
                "replay_lag": lag,
                "mirror_inflight": len(self.mirror.inflight),
                "failovers": self.failovers,
            }

    # -- teardown ------------------------------------------------------------
    def kill(self) -> None:
        """Crash this replica (chaos / failover tests): drop off the
        bus without cancelling the agents' in-flight work, so a
        standby can adopt and complete it. Forwarder waits are
        released via :class:`QueryAbandoned` — their served replies
        are suppressed; the successor answers each caller's inbox."""
        with self._lock:
            if self._dead:
                return
            self._dead = True
        self._stop.set()
        for s in self._subs:
            s.unsubscribe()
        self._subs = []
        self.broker.ha_suppress_errors = True
        fw = self.broker.forwarder
        for qid in fw.active_qids():
            fw.abandon(qid, "broker_failover")
        self.broker.close()
        self.tracker.close()
        if threading.current_thread() is not self._watch:
            self._watch.join(timeout=2 * self.lease_interval_s + 1.0)

    def close(self) -> None:
        """Graceful shutdown: in-flight queries finish and reply
        normally (no abandon); the lease simply stops renewing and a
        standby takes over with an empty reconcile set."""
        with self._lock:
            if self._dead:
                return
            self._dead = True
        self._stop.set()
        for s in self._subs:
            s.unsubscribe()
        self._subs = []
        self.broker.close()
        self.tracker.close()
        if threading.current_thread() is not self._watch:
            self._watch.join(timeout=2 * self.lease_interval_s + 1.0)
