"""Agent tracker: registration, heartbeats, expiry, live-state snapshots.

Reference parity: the metadata service's agent manager + topic listener
(``src/vizier/services/metadata/controllers/agent/agent.go:100``,
``agent_topic_listener.go:41,305-322``): agents register and get an ASID,
heartbeat every few seconds, and are expired + deleted after a minute of
silence — at which point the planner stops scheduling to them. Agents
report their table schemas here (the schema-tracker role), which feeds
the query broker's CompilerState.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..planner.distributed import AgentInfo, DistributedState
from .msgbus import MessageBus

TOPIC_REGISTER = "agent.register"
TOPIC_HEARTBEAT = "agent.heartbeat"
TOPIC_EXPIRED = "agent.expired"
TOPIC_QUARANTINED = "agent.quarantined"

DEFAULT_EXPIRY_S = 60.0
DEFAULT_CHECK_INTERVAL_S = 5.0

#: Bound on per-agent flap-history entries kept by the tracker: with
#: ephemeral agent ids (pod-suffixed names churning for weeks) the
#: bookkeeping must not grow without limit.
MAX_FLAP_TRACKED = 1024


class _Record:
    def __init__(self, info: AgentInfo, schemas: dict,
                 table_stats: dict | None = None):
        self.info = info
        self.schemas = schemas  # {table name: Relation}
        # Ingest-sketch summaries ({table: {rows, ndv, zones}}) the
        # agent ships with registration/heartbeats — the broker-side
        # seed for pxbound's predicted costs (admission control).
        self.table_stats = dict(table_stats or {})
        # Cumulative folded-stack profile summary rows the agent ships
        # in heartbeats ({stack, count, qid, script_hash, tenant,
        # phase}; see ingest/profiler.py profile_summary) — replace-on-
        # heartbeat, merged cluster-wide by AgentTracker.profile().
        self.profile: list[dict] = []
        # Cumulative transport-tier summary rows (busstats snapshot
        # shape) the agent ships in register/heartbeats — replace-on-
        # heartbeat, merged cluster-wide by AgentTracker.bus_stats().
        self.bus: list[dict] = []
        self.last_heartbeat = time.monotonic()


class AgentTracker:
    def __init__(
        self,
        bus: MessageBus,
        expiry_s: float = DEFAULT_EXPIRY_S,
        check_interval_s: float = DEFAULT_CHECK_INTERVAL_S,
        flap_threshold: int | None = None,
        flap_window_s: float | None = None,
        quarantine_s: float | None = None,
        passive: bool = False,
    ):
        from ..config import get_flag

        self.bus = bus
        # Passive (standby-mirror) mode, broker HA: observe the
        # register/heartbeat stream and keep the live-agent map warm,
        # but publish NOTHING — the leader's tracker owns registration
        # acks, re-register nudges, expiry/quarantine events, and the
        # mds.agent_status reply. activate() flips this on takeover.
        self.passive = bool(passive)
        self.expiry_s = expiry_s
        self.check_interval_s = check_interval_s
        # Flap detection: an agent expiring `flap_threshold` times within
        # `flap_window_s` is quarantined out of distributed_state()
        # planning for `quarantine_s` — it may re-register and heartbeat
        # (schemas stay visible) but no new queries are scheduled to it
        # until the cooldown passes.
        self.flap_threshold = (
            int(get_flag("agent_flap_threshold"))
            if flap_threshold is None else int(flap_threshold)
        )
        self.flap_window_s = (
            float(get_flag("agent_flap_window_s"))
            if flap_window_s is None else float(flap_window_s)
        )
        self.quarantine_s = (
            float(get_flag("agent_quarantine_s"))
            if quarantine_s is None else float(quarantine_s)
        )
        self._expiry_history: dict[str, deque] = {}
        self._quarantine_until: dict[str, float] = {}  # aid -> monotonic
        self._lock = threading.Lock()
        self._agents: dict[str, _Record] = {}
        self._next_asid = 1
        self._subs = [
            bus.subscribe(TOPIC_REGISTER, self._on_register),
            bus.subscribe(TOPIC_HEARTBEAT, self._on_heartbeat),
            bus.subscribe("mds.agent_status", self._on_agent_status_request),
        ]
        self._stop = threading.Event()
        self._expiry_thread = threading.Thread(target=self._expiry_loop, daemon=True)
        self._expiry_thread.start()

    # -- message handlers ----------------------------------------------------
    def _on_register(self, msg: dict):
        agent_id = msg["agent_id"]
        with self._lock:
            asid = self._next_asid
            self._next_asid += 1
            info = AgentInfo(
                agent_id=agent_id,
                processes_data=msg.get("processes_data", True),
                accepts_remote_sources=msg.get("accepts_remote_sources", False),
                tables=frozenset(msg.get("schemas", {})),
                asid=asid,
            )
            rec = _Record(
                info, dict(msg.get("schemas", {})),
                msg.get("table_stats"),
            )
            rec.bus = list(msg.get("bus") or [])
            self._agents[agent_id] = rec
        if not self.passive:
            self.bus.publish(f"agent.{agent_id}.registered", {"asid": asid})

    def _on_heartbeat(self, msg: dict):
        agent_id = msg["agent_id"]
        with self._lock:
            rec = self._agents.get(agent_id)
            if rec is None:
                # Unknown agent (e.g. expired): tell it to re-register —
                # the reference's heartbeat-NACK resync path
                # (``manager.h:207`` re-register hook).
                if not self.passive:
                    self.bus.publish(f"agent.{agent_id}.reregister", {})
                return
            rec.last_heartbeat = time.monotonic()
            if "table_stats" in msg:
                rec.table_stats = dict(msg["table_stats"] or {})
            if "profile" in msg:
                rec.profile = list(msg["profile"] or [])
            if "bus" in msg:
                rec.bus = list(msg["bus"] or [])
            if "schemas" in msg:
                rec.schemas = dict(msg["schemas"])
                rec.info = AgentInfo(
                    agent_id=rec.info.agent_id,
                    processes_data=rec.info.processes_data,
                    accepts_remote_sources=rec.info.accepts_remote_sources,
                    tables=frozenset(msg["schemas"]),
                    asid=rec.info.asid,
                )

    def has_agent(self, agent_id: str) -> bool:
        """True while ``agent_id`` is registered and unexpired."""
        with self._lock:
            return agent_id in self._agents

    def agents_info(self) -> list:
        """Live-agent status rows (id, asid, kind, heartbeat age, tables)."""
        now = time.monotonic()
        with self._lock:
            return [
                {
                    "agent_id": aid,
                    "asid": rec.info.asid,
                    "kind": (
                        "kelvin" if rec.info.accepts_remote_sources else "pem"
                    ),
                    "last_heartbeat_s": now - rec.last_heartbeat,
                    "num_tables": len(rec.schemas),
                    "quarantined": (
                        self._quarantine_until.get(aid, 0.0) > now
                    ),
                }
                for aid, rec in sorted(self._agents.items())
            ]

    def _on_agent_status_request(self, msg: dict):
        """MDS stub service for the GetAgentStatus UDTF
        (``md_udtfs_impl.h:258`` hits MDS the same way)."""
        if self.passive:
            return  # the leader's tracker answers
        self.bus.publish(msg["_reply_to"], {"agents": self.agents_info()})

    def activate(self) -> None:
        """Leave passive (standby-mirror) mode: this tracker now OWNS
        the agent lifecycle — registration acks, re-register nudges,
        expiry/quarantine events, status replies (broker-HA takeover)."""
        self.passive = False

    # -- expiry --------------------------------------------------------------
    def _expiry_loop(self):
        while not self._stop.wait(self.check_interval_s):
            self.expire_silent()

    def expire_silent(self) -> list[str]:
        now = time.monotonic()
        expired = []
        with self._lock:
            for aid, rec in list(self._agents.items()):
                if now - rec.last_heartbeat > self.expiry_s:
                    del self._agents[aid]
                    expired.append(aid)
        for aid in expired:
            self._publish_expiry(aid, "expired (silent)")
        return expired

    def force_expire(self, agent_id: str, reason: str = "killed") -> bool:
        """Expire ``agent_id`` NOW, without waiting out the silence
        window — the deterministic failure-detection path used by fault
        injection and by operators reaping a known-dead node. Returns
        True when the agent was registered."""
        with self._lock:
            existed = self._agents.pop(agent_id, None) is not None
        if existed:
            self._publish_expiry(agent_id, reason)
        return existed

    def _publish_expiry(self, agent_id: str, reason: str) -> None:
        """Flap bookkeeping + the ``agent.expired`` event every query
        subscriber (broker, forwarder) keys failover on."""
        now = time.monotonic()
        quarantined = False
        with self._lock:
            hist = self._expiry_history.setdefault(agent_id, deque())
            hist.append(now)
            while hist and now - hist[0] > self.flap_window_s:
                hist.popleft()
            if (
                len(hist) >= self.flap_threshold
                and self._quarantine_until.get(agent_id, 0.0) <= now
            ):
                self._quarantine_until[agent_id] = now + self.quarantine_s
                quarantined = True
            # Bound the bookkeeping: drop histories whose window has
            # fully lapsed (agents that died and never came back) and
            # lapsed quarantines — insertion order approximates LRU for
            # any overflow beyond that.
            if len(self._expiry_history) > MAX_FLAP_TRACKED:
                for aid, h in list(self._expiry_history.items()):
                    if aid == agent_id:
                        continue
                    if not h or now - h[-1] > self.flap_window_s:
                        del self._expiry_history[aid]
                    if len(self._expiry_history) <= MAX_FLAP_TRACKED:
                        break
                while len(self._expiry_history) > MAX_FLAP_TRACKED:
                    self._expiry_history.pop(
                        next(iter(self._expiry_history))
                    )
            for aid, until in list(self._quarantine_until.items()):
                if until <= now:
                    del self._quarantine_until[aid]
        if self.passive:
            return  # mirror bookkeeping only; the leader emits events
        self.bus.publish(TOPIC_EXPIRED, {"agent_id": agent_id,
                                         "reason": reason})
        if quarantined:
            self._count_quarantine(agent_id)
            self.bus.publish(
                TOPIC_QUARANTINED,
                {"agent_id": agent_id, "cooldown_s": self.quarantine_s},
            )

    def _count_quarantine(self, agent_id: str) -> None:
        from .observability import default_counter

        # Deliberately unlabeled: ephemeral agent ids would be an
        # unbounded label cardinality on a long-lived broker. The
        # WHICH is on the agent.quarantined event + /statusz.
        default_counter(
            "pixie_agent_quarantined_total",
            "Flapping agents quarantined out of query planning",
        ).inc()

    # -- quarantine ----------------------------------------------------------
    def is_quarantined(self, agent_id: str) -> bool:
        with self._lock:
            return self._quarantine_until.get(agent_id, 0.0) > time.monotonic()

    def quarantined(self) -> dict[str, float]:
        """{agent_id: cooldown remaining (s)} for active quarantines;
        lapsed entries are dropped."""
        now = time.monotonic()
        with self._lock:
            for aid, until in list(self._quarantine_until.items()):
                if until <= now:
                    del self._quarantine_until[aid]
            return {
                aid: round(until - now, 3)
                for aid, until in self._quarantine_until.items()
            }

    # -- queries -------------------------------------------------------------
    def distributed_state(self) -> DistributedState:
        now = time.monotonic()
        with self._lock:
            agents, quarantined = [], []
            for aid, rec in self._agents.items():
                if self._quarantine_until.get(aid, 0.0) > now:
                    quarantined.append(aid)
                else:
                    agents.append(rec.info)
            return DistributedState(
                agents=agents, quarantined=sorted(quarantined)
            )

    def schemas(self) -> dict:
        """Union of table schemas across live agents."""
        out: dict = {}
        with self._lock:
            for rec in self._agents.values():
                out.update(rec.schemas)
        return out

    def table_stats(self) -> dict:
        """Cluster-wide per-table summary, merged with per-field
        semantics (each agent holds a disjoint shard):

        - sketch fields — ``rows`` summed, per-column NDV summed (an
          upper bound: per-agent HLL registers don't cross the
          heartbeat, so the sums can't dedup values shared between
          agents), zone bounds unioned. Emitted only when at least one
          agent actually shipped sketch data for the table: a table
          known only through its freshness record must stay UNBOUNDED
          to pxbound (a synthesized ``rows: 0`` would be an unsound
          known-zero bound).
        - ``freshness`` — monotonic counters (``rows_total``,
          ``bytes_total``, ``expired_*``) and live sizes SUM, the
          event-time ``watermark`` and ``last_append`` take the MAX,
          ``min_time`` the min; plus ``agents`` (contributing agent
          count) and ``watermark_spread_ns`` (max - min of per-agent
          watermarks — the "which PEM is behind" lag spread).

        Feeds the broker's CompilerState so pxbound's predicted costs
        (and the planner's NDV sizing) work cluster-wide, and
        ``/debug/tablez`` + the bundled storage scripts cluster-merged.
        """
        from ..table_store.table_store import merge_freshness

        out: dict = {}
        agent_wms: dict[str, list] = {}  # table -> per-agent watermarks
        with self._lock:
            records = [rec.table_stats for rec in self._agents.values()]
        for stats in records:
            for table, st in (stats or {}).items():
                if not isinstance(st, dict):
                    continue
                cur = out.setdefault(table, {})
                if "rows" in st:
                    cur.setdefault("rows", 0)
                    cur.setdefault("ndv", {})
                    cur.setdefault("zones", {})
                    cur["rows"] += int(st.get("rows", 0) or 0)
                    for c, v in (st.get("ndv") or {}).items():
                        cur["ndv"][c] = cur["ndv"].get(c, 0) + int(v)
                    for c, z in (st.get("zones") or {}).items():
                        lo, hi = z[0], z[1]
                        if c in cur["zones"]:
                            plo, phi = cur["zones"][c]
                            lo, hi = min(plo, lo), max(phi, hi)
                        cur["zones"][c] = (lo, hi)
                fresh = st.get("freshness")
                if isinstance(fresh, dict):
                    cur["freshness"] = merge_freshness(
                        cur.get("freshness"), fresh
                    )
                    cur["freshness"]["agents"] = (
                        cur["freshness"].get("agents", 0) + 1
                    )
                    wm = int(fresh.get("watermark", -1))
                    if wm >= 0:
                        agent_wms.setdefault(table, []).append(wm)
        for table, st in out.items():
            if "ndv" in st:
                # NDV can never exceed the row count.
                st["ndv"] = {
                    c: min(v, st["rows"])
                    for c, v in st["ndv"].items() if v
                }
            wms = agent_wms.get(table)
            if wms and "freshness" in st:
                st["freshness"]["watermark_spread_ns"] = (
                    max(wms) - min(wms)
                )
        return out

    def table_freshness(self) -> dict:
        """{table: merged freshness} view of :meth:`table_stats` — the
        ``/debug/tablez`` payload on a broker."""
        return {
            table: st["freshness"]
            for table, st in self.table_stats().items()
            if "freshness" in st
        }

    def profile(
        self,
        agent_id: str | None = None,
        tenant: str | None = None,
        script_hash: str | None = None,
    ) -> list[dict]:
        """Cluster-merged folded-stack profile: each agent's latest
        heartbeat summary, counts summed across agents per (stack,
        attribution) key — the /debug/pprof and `px profile` source.
        Filters narrow to one agent / tenant / script hash; merged rows
        come back hottest first."""
        with self._lock:
            summaries = [
                (aid, list(rec.profile))
                for aid, rec in self._agents.items()
                if rec.profile and (agent_id is None or aid == agent_id)
            ]
        merged: dict[tuple, int] = {}
        for _aid, rows in summaries:
            for r in rows:
                if tenant is not None and r.get("tenant", "") != tenant:
                    continue
                if (script_hash is not None
                        and r.get("script_hash", "") != script_hash):
                    continue
                key = (
                    r.get("stack", ""), r.get("qid", ""),
                    r.get("script_hash", ""), r.get("tenant", ""),
                    r.get("phase", ""),
                )
                if not key[0]:
                    continue
                merged[key] = merged.get(key, 0) + int(r.get("count", 0))
        rows = [
            {
                "stack": k[0], "count": n, "qid": k[1],
                "script_hash": k[2], "tenant": k[3], "phase": k[4],
            }
            for k, n in merged.items()
        ]
        rows.sort(key=lambda r: (-r["count"], r["stack"]))
        return rows

    def profile_agents(self) -> list[str]:
        """Agents whose latest heartbeat carried a profile summary."""
        with self._lock:
            return sorted(
                aid for aid, rec in self._agents.items() if rec.profile
            )

    def bus_stats(self) -> dict:
        """Cluster-merged transport tier: each agent's latest heartbeat
        bus summary, merged per (kind, topic_class, direction) key —
        counters summed, queue high-water maxed, and the lag/service
        quantiles taken as the MAX across agents (a worst-participant
        view: cross-agent histogram merge would need the buckets, which
        heartbeats deliberately don't ship). The /debug/busz source."""
        with self._lock:
            agents = {
                aid: [dict(r) for r in rec.bus]
                for aid, rec in self._agents.items()
                if rec.bus
            }
        merged: dict[tuple, dict] = {}
        for rows in agents.values():
            for r in rows:
                key = (
                    r.get("kind", ""), r.get("topic_class", ""),
                    r.get("direction", ""),
                )
                m = merged.get(key)
                if m is None:
                    merged[key] = dict(r)
                    continue
                for f in ("msgs", "bytes", "errors"):
                    m[f] = int(m.get(f, 0)) + int(r.get(f, 0))
                for f in ("lag_p50_ms", "lag_p99_ms",
                          "service_p50_ms", "service_p99_ms"):
                    m[f] = max(float(m.get(f, 0.0)), float(r.get(f, 0.0)))
                m["queue_high_water"] = max(
                    int(m.get("queue_high_water", 0)),
                    int(r.get("queue_high_water", 0)),
                )
        out = sorted(
            merged.values(),
            key=lambda r: (r["kind"], r["topic_class"], r["direction"]),
        )
        return {"agents": agents, "merged": out}

    def agent_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._agents)

    def close(self):
        self._stop.set()
        for s in self._subs:
            s.unsubscribe()
