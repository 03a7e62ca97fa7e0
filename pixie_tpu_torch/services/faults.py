"""Deterministic fault injection for the message bus and netbus.

Reference parity: the reference exercises failure paths with embedded
fake NATS connections and dropped gRPC streams in its broker tests
(``query_result_forwarder_test.go``, ``agent_topic_listener_test.go``);
chaos tooling in distributed query serving (and the Taurus-style
best-effort scatter-gather literature, PAPERS.md) treats *reproducible*
component failure as a first-class test input. This module is that
input: a rule table keyed by topic pattern, driven by one seeded RNG,
attached to a ``MessageBus`` (or ``RemoteBus``) via its
``fault_injector`` attribute.

Faults:

- ``drop(pattern)``        the message is never delivered
- ``delay(pattern, s)``    delivery is deferred ``s`` seconds
- ``duplicate(pattern)``   every planned delivery happens twice
- ``on_match(pattern, fn)``  trigger hook: run ``fn(topic, msg)`` when
  a matching message is published (BEFORE delivery) — the kill-an-agent
  / sever-a-connection trigger point
- ``kill_agent(pattern, agent, tracker)``  convenience trigger: stop
  the agent and force-expire it from the tracker
- ``sever(pattern, remote_bus)``  convenience trigger: hard-cut a
  netbus connection (mid-flight partition)
- ``partition(pattern_a, pattern_b)`` / ``heal()``  bidirectional drop
  of traffic crossing two peer sets (agent-id patterns; ``"broker"``
  names the control-plane side)

All rules support ``prob`` (applied via the seeded RNG), ``count``
(max applications), ``after`` (skip the first N matches) and ``where``
(a message predicate). A given (seed, workload) replays identically.

A copy of the JAX package's ``services/faults.py``: host messages only,
nothing here touches a tensor.
"""

from __future__ import annotations

import fnmatch
import random
import threading
from typing import Callable


def _peer_of_topic(topic: str) -> str:
    """Destination peer of a topic: ``agent.{id}.{kind}`` names the
    agent; everything else (registration, query.*, leases, inboxes)
    terminates at the control plane — ``"broker"``."""
    parts = topic.split(".")
    if parts[0] == "agent" and len(parts) >= 3:
        return parts[1]
    return "broker"


def _peer_of_msg(msg: dict) -> str:
    """Origin peer of a message, from its agent-id fields; messages
    carrying none (dispatches, probes, client requests) originate at
    the control plane — ``"broker"``."""
    for k in ("from_agent", "agent", "agent_id"):
        v = msg.get(k)
        if v:
            return str(v)
    return "broker"


class _Rule:
    __slots__ = (
        "pattern", "action", "prob", "count", "delay_s", "after",
        "fn", "where", "matched", "fired",
    )

    def __init__(
        self,
        pattern: str,
        action: str,
        *,
        prob: float = 1.0,
        count: int | None = None,
        delay_s: float = 0.0,
        after: int = 0,
        fn: Callable | None = None,
        where: Callable | None = None,
    ):
        self.pattern = pattern
        self.action = action  # "drop"|"delay"|"duplicate"|"call"|"partition"
        self.prob = prob
        self.count = count  # max applications; None = unlimited
        self.delay_s = delay_s
        self.after = after  # skip the first `after` matching messages
        self.fn = fn
        self.where = where
        self.matched = 0  # messages matching pattern+where
        self.fired = 0  # times the action actually applied


class FaultInjector:
    """Seeded, rule-based fault hook for ``MessageBus``/``RemoteBus``.

    Attach with ``bus.fault_injector = injector``; the bus calls
    ``intercept(topic, msg)`` on every publish and follows the returned
    delivery plan (a list of per-copy delays in seconds; empty list =
    dropped). ``log`` records every applied fault as ``(action, topic)``
    for test assertions.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self._rules: list[_Rule] = []
        self._partition_rules: list[_Rule] = []
        self._lock = threading.Lock()
        self.log: list[tuple[str, str]] = []

    # -- rule construction ---------------------------------------------------
    def _add(self, rule: _Rule) -> "FaultInjector":
        with self._lock:
            self._rules.append(rule)
        return self

    def drop(self, pattern: str, *, prob: float = 1.0,
             count: int | None = None, after: int = 0,
             where: Callable | None = None) -> "FaultInjector":
        return self._add(_Rule(pattern, "drop", prob=prob, count=count,
                               after=after, where=where))

    def delay(self, pattern: str, delay_s: float, *, prob: float = 1.0,
              count: int | None = None, after: int = 0,
              where: Callable | None = None) -> "FaultInjector":
        return self._add(_Rule(pattern, "delay", prob=prob, count=count,
                               delay_s=delay_s, after=after, where=where))

    def duplicate(self, pattern: str, *, prob: float = 1.0,
                  count: int | None = None, after: int = 0,
                  where: Callable | None = None) -> "FaultInjector":
        return self._add(_Rule(pattern, "duplicate", prob=prob, count=count,
                               after=after, where=where))

    def on_match(self, pattern: str, fn: Callable, *, count: int | None = 1,
                 after: int = 0,
                 where: Callable | None = None) -> "FaultInjector":
        """Run ``fn(topic, msg)`` when a matching message is published.
        Fires BEFORE delivery (and outside the injector lock, so ``fn``
        may itself publish, stop agents, or expire trackers)."""
        return self._add(_Rule(pattern, "call", fn=fn, count=count,
                               after=after, where=where))

    def kill_agent(self, pattern: str, agent, tracker=None, *,
                   after: int = 0,
                   where: Callable | None = None) -> "FaultInjector":
        """Kill ``agent`` when a matching message is published: stop it
        (no more heartbeats or handlers) and — with a ``tracker`` —
        force-expire it immediately so failure detection is
        deterministic rather than waiting out the expiry window."""

        def _kill(_topic, _msg):
            agent.stop()
            if tracker is not None:
                tracker.force_expire(
                    agent.agent_id, reason="fault-injected kill"
                )

        return self.on_match(pattern, _kill, after=after, where=where)

    def sever(self, pattern: str, remote_bus, *, after: int = 0,
              where: Callable | None = None) -> "FaultInjector":
        """Hard-cut a netbus connection when a matching message is
        published (``RemoteBus.sever``) — a mid-flight partition."""
        return self.on_match(
            pattern, lambda _t, _m: remote_bus.sever(), after=after,
            where=where,
        )

    def partition(self, pattern_a: str, pattern_b: str, *,
                  prob: float = 1.0,
                  count: int | None = None) -> "FaultInjector":
        """Bidirectional sever of two peer sets until :meth:`heal`.

        Peers are named by fnmatch patterns over agent ids; the id
        ``"broker"`` stands for the control-plane side (tracker, broker,
        forwarder — any participant that is not an ``agent.{id}.*``
        endpoint). A message is dropped when its origin peer matches one
        side and its destination peer matches the other, in EITHER
        direction; intra-set traffic flows. Granularity is the bus's:
        origin comes from the message's agent-id fields
        (``from_agent``/``agent``/``agent_id``), destination from an
        ``agent.{id}.*`` topic — fan-out topics without a single
        destination (``query.cancel``, leases) count as broker-side.
        """

        def _crosses(topic: str, msg: dict) -> bool:
            src = _peer_of_msg(msg)
            dst = _peer_of_topic(topic)
            a_src = fnmatch.fnmatchcase(src, pattern_a)
            b_src = fnmatch.fnmatchcase(src, pattern_b)
            a_dst = fnmatch.fnmatchcase(dst, pattern_a)
            b_dst = fnmatch.fnmatchcase(dst, pattern_b)
            return (a_src and b_dst) or (b_src and a_dst)

        rule = _Rule("*", "partition", prob=prob, count=count, fn=_crosses)
        with self._lock:
            self._rules.append(rule)
            self._partition_rules.append(rule)
        return self

    def heal(self) -> int:
        """Remove every :meth:`partition` rule (both directions of every
        cut); all other rules stay. Returns how many cuts were healed."""
        with self._lock:
            for r in self._partition_rules:
                try:
                    self._rules.remove(r)
                except ValueError:
                    pass
            healed = len(self._partition_rules)
            self._partition_rules = []
        return healed

    # -- the bus hook --------------------------------------------------------
    def intercept(self, topic: str, msg: dict) -> list:
        """Delivery plan for one publish: a list of per-copy delays in
        seconds ([0.0] = deliver now, [] = dropped). Rules apply in
        registration order to the running plan; trigger hooks fire after
        the plan is decided, outside the lock."""
        plan = [0.0]
        triggers = []
        with self._lock:
            for r in self._rules:
                if not fnmatch.fnmatchcase(topic, r.pattern):
                    continue
                if r.where is not None and not r.where(msg):
                    continue
                if r.action == "partition" and not r.fn(topic, msg):
                    continue  # not a cut-crossing message
                r.matched += 1
                if r.matched <= r.after:
                    continue
                if r.count is not None and r.fired >= r.count:
                    continue
                if r.prob < 1.0 and self.rng.random() >= r.prob:
                    continue
                r.fired += 1
                self.log.append((r.action, topic))
                if r.action in ("drop", "partition"):
                    plan = []
                elif r.action == "delay":
                    plan = [d + r.delay_s for d in plan]
                elif r.action == "duplicate":
                    plan = plan * 2
                elif r.action == "call":
                    triggers.append(r.fn)
        for fn in triggers:
            fn(topic, msg)
        return plan

    def fired(self, action: str | None = None) -> int:
        """How many faults applied (optionally filtered by action)."""
        with self._lock:
            return sum(
                1 for a, _t in self.log if action is None or a == action
            )
