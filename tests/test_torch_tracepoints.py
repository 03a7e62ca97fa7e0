"""The port's broker-side tracepoint registry
(``pixie_tpu_torch/services/tracepoints.py``) against the JAX package's.

Each case drives both registries through the same calls and the same
``tracepoint.status`` messages on their own package's ``MessageBus``,
with the same stand-in tracker, and the observations (returned states,
``info``, ``names``, ``wait_ready``, TTL ``tick`` and every message the
registry publishes to an agent) must be equal. The TTL thread is parked
(an hour's interval), so expiry moves only with the explicit clocks
passed to ``apply`` and ``tick``.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import time
from types import SimpleNamespace

import pytest

PACKAGES = ("pixie_tpu", "pixie_tpu_torch")
AGENTS = (("pem-0", True), ("pem-1", True), ("kelvin-0", False))


def _wait_for(cond, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return cond()


def _plain(obj):
    """Package-free form of a message: dataclasses as dicts, enums by
    name, so the two packages' objects compare equal."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


class _Tracker:
    """The two calls the registry makes of an ``AgentTracker``."""

    def __init__(self):
        self.known: dict = {}

    def distributed_state(self):
        return SimpleNamespace(agents=[
            SimpleNamespace(agent_id=a, processes_data=d) for a, d in AGENTS])

    def schemas(self) -> dict:
        return dict(self.known)


class _Harness:
    def __init__(self, pkg: str):
        msgbus = importlib.import_module(f"{pkg}.services.msgbus")
        self.tp = importlib.import_module(f"{pkg}.services.tracepoints")
        self.spec = importlib.import_module(f"{pkg}.trace.spec")
        sent = self.sent = []

        class RecordingBus(msgbus.MessageBus):
            def publish(self, topic, msg):
                if topic.startswith("agent."):
                    sent.append((topic, _plain(msg)))
                return super().publish(topic, msg)

        self.bus = RecordingBus()
        self.tracker = _Tracker()
        self.reg = self.tp.TracepointRegistry(
            self.bus, self.tracker, ttl_check_interval_s=3600.0)

    def deployment(self, name: str, ttl_s: float = 30.0):
        s = self.spec
        probe = s.ProbeDef("demo.handle", (
            ("arg0", s.TraceExpr("arg", "arg0")),
            ("lat", s.TraceExpr("latency")),
        ))
        return s.TracepointDeployment(name, f"{name}_calls", probe, ttl_s)

    def status(self, name: str, agent: str, state: str, error: str = ""):
        """Publish one agent's status and wait until the registry took it."""
        self.bus.publish(self.tp.TOPIC_STATUS, {
            "name": name, "agent": agent, "state": state, "error": error})
        assert _wait_for(
            lambda: self.reg.info(name)["agents"].get(agent) == state)

    def drain(self) -> list:
        out, self.sent[:] = list(self.sent), []
        return out

    def close(self):
        self.reg.close()
        self.bus.close()


def _refresh(h: _Harness, obs: list) -> None:
    dep = h.deployment("tp")
    obs.append(h.reg.apply([dep], now=100.0))
    obs.append(h.drain())
    obs.append(h.reg.apply([dep], now=110.0))  # the TTL refresh only
    obs.append(h.drain())
    obs.append(h.reg.tick(now=135.0))
    obs.append(h.reg.tick(now=140.0))
    obs.append(h.reg.state("tp"))
    obs.append(h.drain())
    obs.append(h.reg.tick(now=1000.0))  # a terminated record stays so


def _aggregate(h: _Harness, obs: list) -> None:
    obs.append(h.reg.apply([h.deployment("tp")], now=0.0))
    obs.append(h.drain())
    h.status("tp", "pem-0", h.tp.RUNNING)
    obs.append(h.reg.info("tp"))
    h.status("tp", "pem-1", h.tp.FAILED, error="attach failed")
    obs.append(h.reg.info("tp"))
    obs.append(h.reg.names())


def _all_failed(h: _Harness, obs: list) -> None:
    obs.append(h.reg.apply([h.deployment("tp")], now=0.0))
    h.status("tp", "pem-0", h.tp.FAILED)
    obs.append(h.reg.state("tp"))
    h.status("tp", "pem-1", h.tp.FAILED, error="no such symbol")
    obs.append(h.reg.info("tp"))
    obs.append(h.reg.wait_ready(["tp"], timeout_s=5.0))
    # A failed record is replaced by a fresh deployment.
    obs.append(h.reg.apply([h.deployment("tp")], now=1.0))
    obs.append(h.reg.info("tp"))
    obs.append(h.drain())


def _wait_ready(h: _Harness, obs: list) -> None:
    obs.append(h.reg.apply([h.deployment("tp")], now=0.0))
    h.status("tp", "pem-1", h.tp.RUNNING)
    # RUNNING, but its table has not reached the tracker's schemas yet.
    t0 = time.monotonic()
    obs.append(h.reg.wait_ready(["tp"], timeout_s=0.3))
    obs.append(time.monotonic() - t0 >= 0.3)
    h.tracker.known["tp_calls"] = object()
    t0 = time.monotonic()
    obs.append(h.reg.wait_ready(["tp"], timeout_s=5.0))
    obs.append(time.monotonic() - t0 < 1.0)
    obs.append(h.reg.wait_ready(["tp", "unknown"], timeout_s=0.3))


def _delete(h: _Harness, obs: list) -> None:
    obs.append(h.reg.apply([h.deployment("tp"), h.deployment("tp2")],
                           now=0.0))
    obs.append(h.drain())
    obs.append(h.reg.apply([h.spec.TracepointDelete("tp")]))
    obs.append(h.drain())
    # A status for a terminated record is ignored: the next status on the
    # same subscription landing proves the first one was handled.
    h.bus.publish(h.tp.TOPIC_STATUS, {
        "name": "tp", "agent": "pem-0", "state": h.tp.RUNNING})
    h.status("tp2", "pem-0", h.tp.RUNNING)
    obs.append(h.reg.info("tp"))
    obs.append(h.reg.info("tp2"))
    obs.append(h.reg.names())
    obs.append(h.reg.apply([h.spec.TracepointDelete("never-deployed")]))
    obs.append(h.drain())


CASES = {
    "ttl_refresh_and_expiry": _refresh,
    "status_aggregation": _aggregate,
    "all_agents_failed": _all_failed,
    "wait_ready": _wait_ready,
    "delete_and_ignored_status": _delete,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_registry_matches_jax(case):
    got = {}
    for pkg in PACKAGES:
        h = _Harness(pkg)
        try:
            obs: list = []
            CASES[case](h, obs)
            got[pkg] = _plain(obs)
        finally:
            h.close()
    assert got["pixie_tpu_torch"] == got["pixie_tpu"]


def test_registry_observations_are_the_reference_states():
    """The port's registry on its own: the states the reference
    controller gives for one deploy, a RUNNING PEM and the TTL lapse."""
    h = _Harness("pixie_tpu_torch")
    try:
        assert h.reg.apply([h.deployment("tp")], now=0.0) == {"tp": "PENDING"}
        assert [t for t, _ in h.drain()] == [
            "agent.pem-0.tracepoint", "agent.pem-1.tracepoint"]
        h.status("tp", "pem-0", "RUNNING")
        assert h.reg.state("tp") == "RUNNING"
        assert h.reg.tick(now=29.0) == []
        assert h.reg.tick(now=30.0) == ["tp"]
        assert h.reg.state("tp") == "TERMINATED"
        assert h.drain() == [
            ("agent.pem-0.tracepoint", {"op": "remove", "name": "tp"}),
            ("agent.pem-1.tracepoint", {"op": "remove", "name": "tp"}),
        ]
    finally:
        h.close()
