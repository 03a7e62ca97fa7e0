"""Broker HA on the port (``services/broker_ha.py`` and the broker's,
the client's and the config's hooks) against the JAX package's.

- The JAX ``tests/test_broker_ha.py`` classes on a port cluster of CPU
  engines (3 PEMs, a Kelvin, 2 ``BrokerReplica``s on one bus, the fast
  lease clock): election, failover of in-flight queries, epoch fencing,
  ``QueryResultForwarder.abandon``, the re-attach deadline, the
  client's retries and graceful handoff. Answers are held to numpy over
  the PEMs' rows, and a healthy HA query's answer to the JAX HA
  cluster's over the same seeded rows.
- Carrying the state across: the same ``broker.state`` event sequence
  folded into a port standby and a JAX standby leaves equal mirrors
  (in-flight records, observed costs, agent events, cache
  invalidations) and equal applied sequence numbers.
- The five flags of the slice equal the JAX package's (default and
  help text).

Every wait is a poll with a deadline of its own; every cluster is torn
down in a ``finally`` (injector off, agents, replicas, bus).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import types

import numpy as np
import pytest

import pixie_tpu.config as jax_config
import pixie_tpu.services as jax_services
import pixie_tpu.services.broker_ha as jax_ha
from pixie_tpu.exec.engine import Engine as JaxEngine
import pixie_tpu_torch.config as port_config
import pixie_tpu_torch.services as port_services
import pixie_tpu_torch.services.broker_ha as port_ha
from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.services import MessageBus
from pixie_tpu_torch.services.broker_ha import (
    TOPIC_LEASE,
    TOPIC_RECONCILE,
    BrokerReplica,
)
from pixie_tpu_torch.services.faults import FaultInjector
from pixie_tpu_torch.services.msgbus import BusTimeout
from pixie_tpu_torch.services.query_broker import (
    QueryAbandoned,
    QueryResultForwarder,
)

SEED = int(os.environ.get("PIXIE_TPU_FAULT_SEED", "0"))
FAST = dict(heartbeat_interval_s=5.0)
LEASE = dict(lease_interval_s=0.05, lease_expiry_s=0.3)
#: For the cases that kill no leader: a lease a busy host (an XLA compile
#: on the JAX side holds the GIL for longer than 0.3 s) cannot lapse.
STEADY = dict(lease_interval_s=0.1, lease_expiry_s=5.0)
TRACKER_KW = dict(expiry_s=60.0, check_interval_s=60.0, flap_threshold=3,
                  flap_window_s=60.0, quarantine_s=60.0)
W = 1 << 10

PKGS = {
    "port": types.SimpleNamespace(
        s=port_services, ha=port_ha, override_flag=port_config.override_flag,
        engine=lambda: Engine(window_rows=W, device="cpu")),
    "jax": types.SimpleNamespace(
        s=jax_services, ha=jax_ha, override_flag=jax_config.override_flag,
        engine=lambda: JaxEngine(window_rows=W)),
}

AGG_Q = (
    "import px\n"
    "df = px.DataFrame(table='http_events')\n"
    "df = df.groupby('service').agg(n=('latency_ns', px.count))\n"
    "px.display(df, 'out')\n"
)


def _wait_for(pred, timeout_s=10.0, interval_s=0.02):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(interval_s)
    return True


@contextlib.contextmanager
def _ha_cluster(name="port", n_pems=3, n_brokers=2, rows=300, lease=None):
    """The JAX test's ``_mk_ha_cluster`` for package ``name``, converged:
    every agent registered, the schemas known, and every standby at the
    leader's epoch (a standby that never saw a lease would claim epoch
    1 on a kill, which cannot fence the deposed epoch-1 leader)."""
    pkg = PKGS[name]
    s = pkg.s
    with pkg.override_flag("broker_reconcile_wait_s", 0.4), \
            pkg.override_flag("broker_reattach_timeout_s", 8.0):
        bus = s.MessageBus()
        replicas, agents = [], []
        try:
            for i in range(n_brokers):
                replicas.append(pkg.ha.BrokerReplica(
                    bus, f"broker-{i}", tracker_kw=TRACKER_KW,
                    leader=(i == 0), **(lease or LEASE)))
            rng = np.random.default_rng(SEED)
            pems = []
            for i in range(n_pems):
                pem = s.PEMAgent(bus, f"pem-{i}", engine=pkg.engine(), **FAST)
                n = rows + 50 * i
                pem.engine.append_data("http_events", {
                    "time_": np.arange(n, dtype=np.int64),
                    "latency_ns": rng.integers(1000, 1_000_000, n),
                    "service": [f"svc-{(i + j) % 3}" for j in range(n)],
                })
                pems.append(pem.start())
                agents.append(pems[-1])
            kelvin = s.KelvinAgent(bus, "kelvin-0", engine=pkg.engine(),
                                   **FAST).start()
            agents.append(kelvin)
            lead = replicas[0]
            assert _wait_for(
                lambda: len(lead.tracker.agent_ids()) == n_pems + 1
                and "http_events" in lead.tracker.schemas()
                and all(r.epoch >= lead.epoch for r in replicas[1:]))
            yield types.SimpleNamespace(bus=bus, replicas=replicas,
                                        pems=pems, kelvin=kelvin, pkg=pkg)
        finally:
            bus.fault_injector = None
            for a in agents:
                a.stop()
            for r in replicas:
                if not r._dead:
                    r.close()
            bus.close()


@pytest.fixture
def ha_cluster():
    with _ha_cluster() as c:
        yield c.bus, c.replicas, c.pems, c.kelvin


@pytest.fixture
def steady_cluster():
    with _ha_cluster(lease=STEADY) as c:
        yield c.bus, c.replicas, c.pems, c.kelvin


def _truth(pems) -> int:
    return sum(p.engine.tables["http_events"].num_rows for p in pems)


def _total_n(res) -> int:
    return int(np.sum(res["tables"]["out"].to_pydict()["n"]))


def _groups(res) -> dict:
    d = res["tables"]["out"].to_pydict()
    return dict(zip(d["service"], (int(n) for n in d["n"])))


def _execute(bus, timeout_s=15.0):
    return bus.request("broker.execute",
                       {"query": AGG_Q, "timeout_s": timeout_s},
                       timeout_s=timeout_s + 5.0)


class TestFlags:
    @pytest.mark.parametrize("flag", [
        "broker_lease_interval_s", "broker_lease_expiry_s",
        "broker_reconcile_wait_s", "broker_reattach_timeout_s", "lockdep"])
    def test_flag_equals_jax(self, flag):
        port, jax = port_config.all_flags()[flag], jax_config.all_flags()[flag]
        assert port == jax
        assert type(port[0]) is type(jax[0])


class TestElection:
    def test_leader_serves_standby_mirrors(self, steady_cluster):
        bus, (r0, r1), pems, kelvin = steady_cluster
        assert r0.role == "leader" and r0.epoch == 1
        assert r1.role == "standby"
        res = _execute(bus)
        assert res["ok"] and res["partial"] is False
        assert _total_n(res) == _truth(pems)
        s0, s1 = r0.statusz(), r1.statusz()
        assert s0["state_seq"] > 0
        assert _wait_for(
            lambda: r1.statusz()["applied_seq"] == r0.statusz()["state_seq"])
        assert r1.statusz()["replay_lag"] == 0
        assert s0["role"] == "leader" and s1["role"] == "standby"
        assert s1["leader"] == "broker-0"
        assert _wait_for(lambda: r1.statusz()["mirror_inflight"] == 0)
        assert s0["lease_age_s"] < 1.0

    def test_healthy_answer_equals_jax_ha_cluster(self):
        """The same seeded rows through a port and a JAX HA cluster: the
        served answer, the leader resolution and the statusz keys are
        the same."""
        out = {}
        for name in ("port", "jax"):
            with _ha_cluster(name, lease=STEADY) as c:
                res = _execute(c.bus)
                lead = c.bus.request("broker.leader", {}, timeout_s=2.0)
                out[name] = {
                    "ok": res["ok"], "partial": res["partial"],
                    "failover": res.get("failover"),
                    "groups": _groups(res),
                    # Every replica answers; "role" is the answerer's.
                    "leader": (lead["broker"], lead["epoch"]),
                    "statusz": sorted(c.replicas[1].statusz()),
                    "agents_broker": c.bus.request(
                        "broker.agents", {}, timeout_s=5.0)["broker"],
                }
        assert out["port"] == out["jax"]
        assert out["port"]["leader"] == ("broker-0", 1)

    def test_leader_resolution_topic(self, steady_cluster):
        bus, (r0, r1), pems, kelvin = steady_cluster
        res = bus.request("broker.leader", {}, timeout_s=2.0)
        assert res["ok"] and res["broker"] == "broker-0"
        assert res["answered_by"] in ("broker-0", "broker-1")

    def test_statusz_reports_ha_fields(self, steady_cluster):
        bus, (r0, r1), pems, kelvin = steady_cluster
        s = r1.statusz()
        for key in ("broker", "role", "epoch", "leader", "lease_age_s",
                    "state_seq", "applied_seq", "replay_lag",
                    "mirror_inflight", "failovers"):
            assert key in s, key

    def test_equal_epoch_claim_tiebreaks_on_broker_id(self):
        bus = MessageBus()
        rs = []
        try:
            r = BrokerReplica(bus, "broker-5", tracker_kw=TRACKER_KW,
                              leader=True, **LEASE)
            rs.append(r)
            assert r.role == "leader"
            bus.publish(TOPIC_LEASE, {"broker": "broker-1", "role": "leader",
                                      "epoch": r.epoch, "state_seq": 0})
            assert _wait_for(lambda: r.role == "standby", timeout_s=5.0)
            r2 = BrokerReplica(bus, "broker-0", tracker_kw=TRACKER_KW,
                               leader=True, **LEASE)
            rs.append(r2)
            seen = []
            sub = bus.subscribe(TOPIC_LEASE, seen.append)
            bus.publish(TOPIC_LEASE, {"broker": "broker-4", "role": "leader",
                                      "epoch": r2.epoch, "state_seq": 0})
            # r2 has had the higher id's lease once the next of its own
            # leases follows it on the topic.
            assert _wait_for(lambda: any(
                m.get("broker") == "broker-4" for m in seen) and any(
                m.get("broker") == "broker-0" for m in seen[
                    next(i for i, m in enumerate(seen)
                         if m.get("broker") == "broker-4"):]), 5.0)
            sub.unsubscribe()
            assert r2.role == "leader"
        finally:
            for x in rs:
                x.close()
            bus.close()


class TestFailover:
    def test_leader_kill_resolves_every_inflight_query(self, ha_cluster):
        """Kill the leader with queries in flight: takeover within a
        lease window; every in-flight query resolves, re-attached and
        complete or partial with ``broker_failover``; no leaked forwarder
        registration or thread; the new leader serves."""
        bus, (r0, r1), pems, kelvin = ha_cluster
        threads_before = threading.active_count()
        inj = FaultInjector(seed=SEED)
        inj.delay("agent.kelvin-0.bridge", 1.5)
        bus.fault_injector = inj
        results: dict = {}

        def submit(i):
            try:
                results[i] = _execute(bus, 20.0)
            except Exception as e:
                results[i] = e

        workers = [threading.Thread(target=submit, args=(i,))
                   for i in range(3)]
        for w in workers:
            w.start()
        assert _wait_for(lambda: r1.statusz()["mirror_inflight"] >= 1,
                         timeout_s=10.0)
        t_kill = time.monotonic()
        r0.kill()
        assert _wait_for(lambda: r1.role == "leader", timeout_s=5.0)
        assert time.monotonic() - t_kill < 5 * LEASE["lease_expiry_s"]
        assert r1.epoch > 1
        for w in workers:
            w.join(timeout=30.0)
        assert not any(w.is_alive() for w in workers)
        for i, res in results.items():
            assert isinstance(res, dict), f"query {i} raised: {res!r}"
            assert res.get("ok"), res
            if res.get("partial"):
                assert set(res["missing_reasons"].values()) <= {
                    "broker_failover"}, res
            else:
                assert _total_n(res) == _truth(pems)
        assert any(isinstance(r, dict) and r.get("failover")
                   for r in results.values())
        assert _wait_for(lambda: not r1.broker.forwarder._active)
        assert _wait_for(lambda: r1.statusz()["mirror_inflight"] == 0)
        assert _wait_for(lambda: threading.active_count() <= threads_before,
                         timeout_s=12.0, interval_s=0.2), \
            [t.name for t in threading.enumerate()]
        bus.fault_injector = None
        res = _execute(bus)
        assert res["ok"] and res["partial"] is False
        assert _total_n(res) == _truth(pems)
        assert bus.request("broker.agents", {},
                           timeout_s=5.0)["broker"] == "broker-1"
        rendered = port_services.observability.default_registry.render()
        assert "pixie_broker_failovers_total" in rendered
        assert "pixie_broker_reconciled_queries_total" in rendered

    def test_unrecoverable_inflight_resolves_partial_broker_failover(
            self, ha_cluster):
        bus, (r0, r1), pems, kelvin = ha_cluster
        inj = FaultInjector(seed=SEED)
        inj.delay("agent.kelvin-0.bridge", 1.5)
        bus.fault_injector = inj
        result: dict = {}

        def submit():
            try:
                result["res"] = _execute(bus, 20.0)
            except Exception as e:
                result["res"] = e

        w = threading.Thread(target=submit)
        w.start()
        assert _wait_for(lambda: r1.statusz()["mirror_inflight"] >= 1,
                         timeout_s=10.0)
        kelvin.stop()
        t0 = time.monotonic()
        r0.kill()
        w.join(timeout=30.0)
        elapsed = time.monotonic() - t0
        assert not w.is_alive()
        res = result["res"]
        assert isinstance(res, dict), repr(res)
        assert res.get("ok") and res["partial"] is True
        assert set(res["missing_reasons"].values()) == {"broker_failover"}
        assert res.get("failover") is True
        assert elapsed < 6.0, f"took {elapsed:.1f}s: the watchdog"


class TestEpochFencing:
    def test_deposed_leader_dispatch_is_fenced(self, steady_cluster):
        bus, (r0, r1), pems, kelvin = steady_cluster
        agent = pems[0]
        acks: list = []
        bus.subscribe("query.fence-test.ack", acks.append)
        fenced = port_services.observability.default_counter(
            "pixie_epoch_fenced_total")
        before = fenced.value()
        bus.publish(TOPIC_RECONCILE, {"_reply_to": "fence.probe.reply",
                                      "epoch": 2})
        assert _wait_for(lambda: agent._max_epoch == 2, timeout_s=5.0)
        bus.publish(f"agent.{agent.agent_id}.execute",
                    {"qid": "fence-test", "epoch": 1, "plan": {}})
        assert _wait_for(lambda: fenced.value() > before, 5.0)
        assert acks == []
        assert "fence-test" not in agent._running
        bus.publish(f"agent.{agent.agent_id}.execute",
                    {"qid": "fence-test", "epoch": 2, "plan": {}})
        assert _wait_for(lambda: len(acks) == 1, timeout_s=5.0), acks

    def test_epochless_dispatch_passes(self, steady_cluster):
        bus, (r0, r1), pems, kelvin = steady_cluster
        res = r0.broker.execute_script(AGG_Q)
        assert res["partial"] is False
        assert pems[0]._epoch_ok({"qid": "x"}) is True

    def test_dispatch_envelopes_carry_the_epoch(self, steady_cluster):
        """One-shot and streaming dispatches of a replica's broker carry
        its epoch; a broker no replica wires stamps none."""
        bus, (r0, r1), pems, kelvin = steady_cluster
        seen: list = []
        for t in ("agent.pem-0.execute", "agent.pem-0.stream_execute"):
            bus.subscribe(t, seen.append)
        r0.broker.execute_script(AGG_Q)
        handle = r0.broker.execute_script_streaming(
            AGG_Q, on_update=lambda u: None, poll_interval_s=0.05)
        try:
            assert _wait_for(lambda: len(seen) >= 2, 5.0)
        finally:
            handle.cancel()
        assert {m.get("epoch") for m in seen} == {1}
        plain = port_services.QueryBroker(bus, r0.tracker)
        try:
            seen.clear()
            plain.execute_script(AGG_Q)
            assert _wait_for(lambda: seen, 5.0)
            assert all("epoch" not in m for m in seen)
        finally:
            plain.close()


class TestAbandon:
    def test_abandon_releases_wait_without_cancelling(self):
        bus = MessageBus()
        cancels: list = []
        bus.subscribe("query.cancel", cancels.append)
        fwd = QueryResultForwarder(bus)
        fwd.register_query("q-ab", ["a0"], merge_agent="m")
        out: dict = {}

        def wait():
            try:
                fwd.wait("q-ab", timeout_s=10.0)
            except QueryAbandoned as e:
                out["err"] = e

        t = threading.Thread(target=wait)
        t.start()
        try:
            assert fwd.active_qids() == ["q-ab"]
            assert fwd.abandon("q-ab", "broker_failover") is True
            t.join(timeout=5.0)
            assert not t.is_alive()
            assert "broker_failover" in str(out["err"])
            time.sleep(0.2)  # a query.cancel would have landed
            assert cancels == []
            assert fwd.active_qids() == []
            assert fwd.abandon("gone", "x") is False
        finally:
            bus.close()


class TestReattachDeadline:
    def test_reattach_lapse_resolves_partial_broker_failover(self):
        bus = MessageBus()
        fwd = QueryResultForwarder(bus)
        fwd.register_query("q-gap", ["pem-0", "pem-1"], merge_agent="m")
        try:
            t0 = time.monotonic()
            res = fwd.wait("q-gap", 5.0, deadline=time.monotonic() + 0.4,
                           deadline_reason="broker_failover")
            assert time.monotonic() - t0 < 2.0
            assert res["partial"] is True
            assert res["interrupted"] == "broker_failover"
            assert set(res["missing_reasons"].values()) == {
                "broker_failover"}
            assert sorted(res["missing_agents"]) == ["pem-0", "pem-1"]
            assert fwd.active_qids() == []
        finally:
            bus.close()


class TestClientRetry:
    class _FlakyBus:
        def __init__(self, fail_n, reply):
            self.fail_n = fail_n
            self.reply = reply
            self.calls: list = []

        def request(self, topic, msg, timeout_s=10.0):
            self.calls.append(topic)
            if self.calls.count(topic) <= self.fail_n:
                raise BusTimeout(f"no reply from {topic!r}")
            return dict(self.reply)

        def close(self):
            pass

    @staticmethod
    def _client(bus):
        from pixie_tpu_torch.api import Client

        c = Client.__new__(Client)
        c._bus = bus
        return c

    def test_idempotent_request_retries_with_backoff(self):
        counter = port_services.observability.default_counter(
            "pixie_client_retries_total",
            "Idempotent client requests retried after a bus timeout")
        before = counter.value()
        bus = self._FlakyBus(fail_n=2, reply={"ok": True, "scripts": []})
        client = self._client(bus)
        with override_flag("client_request_retries", 3), \
                override_flag("client_retry_backoff_ms", 5.0):
            t0 = time.monotonic()
            assert client.list_scripts() == []
            assert time.monotonic() - t0 >= 0.005
        assert bus.calls.count("broker.scripts") == 3
        assert counter.value() == before + 2

    def test_retries_exhausted_reraises(self):
        bus = self._FlakyBus(fail_n=99, reply={"ok": True})
        client = self._client(bus)
        with override_flag("client_request_retries", 2), \
                override_flag("client_retry_backoff_ms", 1.0), \
                pytest.raises(BusTimeout):
            client.schemas()
        assert bus.calls.count("broker.schemas") == 3

    def test_resolve_leader_is_retried_as_idempotent(self):
        bus = self._FlakyBus(fail_n=1, reply={
            "ok": True, "broker": "broker-1", "epoch": 2, "role": "leader",
            "answered_by": "broker-0"})
        with override_flag("client_retry_backoff_ms", 1.0):
            info = self._client(bus).resolve_leader()
        assert info["broker"] == "broker-1" and info["epoch"] == 2
        assert bus.calls.count("broker.leader") == 2

    def test_execute_script_never_blind_retried(self):
        from pixie_tpu_torch.api import ScriptExecutionError

        class _Bus(self._FlakyBus):
            def request(self, topic, msg, timeout_s=10.0):
                self.calls.append(topic)
                if topic == "broker.leader":
                    return {"ok": True, "broker": "broker-1", "epoch": 2,
                            "role": "leader"}
                raise BusTimeout(f"no reply from {topic!r}")

        bus = _Bus(fail_n=0, reply={})
        with override_flag("client_request_retries", 3), \
                pytest.raises(ScriptExecutionError) as ei:
            self._client(bus).execute_script("import px", timeout_s=0.1)
        assert bus.calls.count("broker.execute") == 1
        msg = str(ei.value)
        assert "not retried" in msg and "non-idempotent" in msg
        assert "broker-1" in msg

    def test_execute_script_error_without_leader(self):
        from pixie_tpu_torch.api import ScriptExecutionError

        bus = self._FlakyBus(fail_n=99, reply={})
        with override_flag("client_retry_backoff_ms", 1.0), \
                pytest.raises(ScriptExecutionError) as ei:
            self._client(bus).execute_script("import px", timeout_s=0.1)
        assert "mid-failover" in str(ei.value)


class TestGracefulHandoff:
    def test_close_hands_over_without_inflight_loss(self, ha_cluster):
        bus, (r0, r1), pems, kelvin = ha_cluster
        r0.close()
        assert _wait_for(lambda: r1.role == "leader", timeout_s=5.0)
        res = None
        deadline = time.monotonic() + 5.0
        while res is None:
            # The role flips before the takeover re-serves
            # broker.execute: retry the no-responder window as a client.
            try:
                res = _execute(bus)
            except BusTimeout:
                assert time.monotonic() < deadline, "never re-served"
                time.sleep(0.05)
        assert res["ok"] and res["partial"] is False
        assert _total_n(res) == _truth(pems)
        assert r1.statusz()["epoch"] > 1


# -- the state log, folded in both packages -----------------------------------

def _events(seed: int, n: int = 120) -> list:
    """A ``broker.state`` stream as a leader publishes it: in-flight
    records and their releases, observed costs, agent lifecycle events
    and cache invalidations (and one event kind no standby knows)."""
    rng = np.random.default_rng(seed)
    open_q, out = [], []
    for seq in range(1, n + 1):
        k = int(rng.integers(6))
        if k == 0 or (k == 1 and not open_q):
            qid = f"q{seq:04d}"
            open_q.append(qid)
            data = {"qid": qid, "tenant": "shared",
                    "expected": [f"pem-{j}" for j in range(
                        int(rng.integers(1, 4)))],
                    "merge_agent": "kelvin-0", "reply_to": f"_inbox.{seq}",
                    "require_complete": bool(rng.integers(2)),
                    "predicted": {"bytes_staged_hi": int(rng.integers(1e6))},
                    "deadline_unix_s": None}
            ev = "inflight"
        elif k == 1:
            ev, data = "release", {"qid": open_q.pop(
                int(rng.integers(len(open_q))))}
        elif k == 2:
            ev, data = "cost", {"script_hash": f"h{int(rng.integers(4))}",
                                "bytes_staged": int(rng.integers(1e7)),
                                "rows_in": int(rng.integers(1e6))}
        elif k == 3:
            ev, data = "agent", {"op": "registered",
                                 "agent_id": f"pem-{int(rng.integers(3))}"}
        elif k == 4:
            ev, data = "cache_invalidate", {"why": "agent-expired"}
        else:
            ev, data = "unknown_kind", {"x": seq}
        out.append({"broker": "broker-0", "epoch": 1, "seq": seq,
                    "event": ev, "data": data})
    return out


def _fold(ha, events, role: str = "standby") -> dict:
    bus = ha.MessageBus()
    r = ha.BrokerReplica(bus, "broker-1", tracker_kw=TRACKER_KW,
                         leader=(role == "leader"), lease_interval_s=60.0,
                         lease_expiry_s=600.0)
    try:
        for ev in events:
            r._on_state(ev)
        m = r.mirror
        return {"inflight": m.inflight, "costs": m.costs,
                "agent_events": m.agent_events,
                "cache_invalidations": m.cache_invalidations,
                "applied_seq": r._applied_seq,
                "mirror_inflight": r.statusz()["mirror_inflight"]}
    finally:
        r.close()
        bus.close()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mirror_folds_equal_jax(seed):
    events = _events(seed)
    port = _fold(port_ha, events)
    jax = _fold(jax_ha, events)
    assert port == jax
    assert port["applied_seq"] == len(events)
    assert port["costs"] and port["agent_events"] > 0


def test_leader_folds_nothing_in_both():
    events = _events(5, n=20)
    port = _fold(port_ha, events, role="leader")
    assert port == _fold(jax_ha, events, role="leader")
    assert port["inflight"] == {} and port["applied_seq"] == 0


def test_takeover_seeds_observed_costs_from_the_mirror():
    """The mirrored cost history seeds the successor's admission floor
    (``ObservedCostIndex.seed``): max-merge per script hash."""
    events = [e for e in _events(9) if e["event"] == "cost"]
    got = {}
    for name, ha in (("port", port_ha), ("jax", jax_ha)):
        bus = ha.MessageBus()
        r = ha.BrokerReplica(bus, "broker-1", tracker_kw=TRACKER_KW,
                             lease_interval_s=60.0, lease_expiry_s=600.0)
        try:
            for ev in events:
                r._on_state(ev)
            r.broker.observed_costs.seed(r.mirror.costs)
            got[name] = {h: r.broker.observed_costs.observed(h)
                         for h in r.mirror.costs}
        finally:
            r.close()
            bus.close()
    assert got["port"] == got["jax"] and got["port"]
