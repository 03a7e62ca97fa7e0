"""Tracepoint registry: the MDS deploy state machine.

Reference parity: ``src/vizier/services/metadata/controllers/tracepoint/
tracepoint.go`` — tracepoints register with a TTL, deploy to PEMs over
the message bus, aggregate per-agent states into PENDING / RUNNING / FAILED
/ TERMINATED, and expire (terminate + undeploy) when their TTL lapses.
The query broker's mutation executor (``mutation_executor.go:84``) drives
``apply`` + ``wait_ready`` before running the query phase.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..trace.spec import TracepointDelete, TracepointDeployment
from .msgbus import MessageBus

TOPIC_STATUS = "tracepoint.status"

PENDING = "PENDING"
RUNNING = "RUNNING"
FAILED = "FAILED"
TERMINATED = "TERMINATED"


@dataclass
class _TracepointRecord:
    deployment: TracepointDeployment
    state: str = PENDING
    agents: dict = field(default_factory=dict)  # agent_id -> state
    error: str = ""
    expires_at: float = 0.0


class TracepointRegistry:
    def __init__(self, bus: MessageBus, tracker,
                 ttl_check_interval_s: float = 5.0):
        self.bus = bus
        self.tracker = tracker
        self._lock = threading.Lock()
        self._records: dict[str, _TracepointRecord] = {}
        self._changed = threading.Condition(self._lock)
        self._sub = bus.subscribe(TOPIC_STATUS, self._on_status)
        # TTL watcher (tracepoint.go's expiry loop): tick() stays public
        # so tests drive expiry with explicit clocks.
        self._stop = threading.Event()
        self._ttl_thread = threading.Thread(
            target=self._ttl_loop, args=(ttl_check_interval_s,),
            name="tracepoint-ttl", daemon=True,
        )
        self._ttl_thread.start()

    def _ttl_loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            self.tick()

    # -- mutation application ----------------------------------------------
    def apply(self, mutations, now: float | None = None) -> dict:
        """Upsert/delete a batch; returns {name: state}."""
        out = {}
        for m in mutations:
            if isinstance(m, TracepointDeployment):
                out[m.name] = self.upsert(m, now=now)
            elif isinstance(m, TracepointDelete):
                self.delete(m.name)
                out[m.name] = TERMINATED
        return out

    def upsert(self, dep: TracepointDeployment, now: float | None = None) -> str:
        now = time.monotonic() if now is None else now
        data_agents = [
            a.agent_id
            for a in self.tracker.distributed_state().agents
            if a.processes_data
        ]
        with self._lock:
            rec = self._records.get(dep.name)
            if rec is not None and rec.deployment == dep and rec.state in (
                PENDING, RUNNING
            ):
                rec.expires_at = now + dep.ttl_s  # TTL refresh only
                return rec.state
            rec = _TracepointRecord(
                deployment=dep, expires_at=now + dep.ttl_s
            )
            rec.agents = {aid: PENDING for aid in data_agents}
            self._records[dep.name] = rec
        for aid in data_agents:
            self.bus.publish(
                f"agent.{aid}.tracepoint", {"op": "deploy", "deployment": dep}
            )
        return PENDING

    def delete(self, name: str) -> None:
        with self._lock:
            rec = self._records.get(name)
            if rec is None:
                return
            rec.state = TERMINATED
            agents = list(rec.agents)
        for aid in agents:
            self.bus.publish(
                f"agent.{aid}.tracepoint", {"op": "remove", "name": name}
            )

    # -- status aggregation --------------------------------------------------
    def _on_status(self, msg: dict) -> None:
        name, agent, state = msg["name"], msg["agent"], msg["state"]
        with self._lock:
            rec = self._records.get(name)
            if rec is None or rec.state == TERMINATED:
                return
            rec.agents[agent] = state
            if msg.get("error"):
                rec.error = msg["error"]
            states = set(rec.agents.values())
            if RUNNING in states:
                rec.state = RUNNING  # any running PEM serves the table
            elif states and states <= {FAILED}:
                rec.state = FAILED
            self._changed.notify_all()

    def state(self, name: str) -> str | None:
        with self._lock:
            rec = self._records.get(name)
            return rec.state if rec is not None else None

    def info(self, name: str) -> dict | None:
        with self._lock:
            rec = self._records.get(name)
            if rec is None:
                return None
            return {
                "state": rec.state,
                "agents": dict(rec.agents),
                "error": rec.error,
                "table_name": rec.deployment.table_name,
            }

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._records)

    def wait_ready(self, names, timeout_s: float = 10.0) -> dict:
        """Block until every named tracepoint is RUNNING (and its table
        schema is visible to the planner) or FAILED; returns states."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while True:
                states = {
                    n: (self._records[n].state if n in self._records else None)
                    for n in names
                }
                settled = all(s in (RUNNING, FAILED, TERMINATED) for s in states.values())
                if settled:
                    tables = [
                        self._records[n].deployment.table_name
                        for n in names
                        if n in self._records
                        and self._records[n].state == RUNNING
                    ]
                    known = self.tracker.schemas()
                    if all(t in known for t in tables):
                        return states
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return states
                self._changed.wait(timeout=min(remaining, 0.25))

    # -- TTL expiry ----------------------------------------------------------
    def tick(self, now: float | None = None) -> list[str]:
        """Expire TTL-lapsed tracepoints (tracepoint.go TTL watcher)."""
        now = time.monotonic() if now is None else now
        expired = []
        with self._lock:
            for name, rec in self._records.items():
                if rec.state != TERMINATED and now >= rec.expires_at:
                    expired.append(name)
        for name in expired:
            self.delete(name)
        return expired

    def close(self) -> None:
        self._stop.set()
        self._sub.unsubscribe()
