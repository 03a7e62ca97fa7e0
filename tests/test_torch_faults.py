"""Fault injection on the port (``services/faults.py`` and the buses'
hooks) against the JAX package's.

- The injector: seeded the same and fed the same (topic, msg) sequence,
  both packages' injectors return the same delivery plans and the same
  ``fired()`` counts, rule for rule.
- The bus hooks: drop, delay, duplicate, partition/heal and sever deliver
  the same message sequence on the port's ``MessageBus`` and
  ``RemoteBus`` as on the JAX ones.
- The cluster cases of ``tests/test_fault_injection.py`` (dispatch
  retry, agent death, stream faults, quarantine and its cooldown, the
  forwarder watchdog, the grace drain, the deadline fault, load under
  faults, partition determinism): each runs on a port cluster of CPU
  engines and on a JAX cluster over the same seeded rows, and the
  answers, ``missing_agents`` and ``missing_reasons`` of the two are
  equal.

Every wait is a poll with a deadline of its own; a cluster is stopped and
its bus closed in a ``finally``. Where a JAX test sleeps and then asserts
on membership, the port's case waits for the condition its assertion
reads.
"""

from __future__ import annotations

import contextlib
import os
import re
import threading
import time
import types

import numpy as np
import pytest

import pixie_tpu.config as jax_config
import pixie_tpu.services as jax_services
import pixie_tpu.services.faults as jax_faults
import pixie_tpu.services.load_tester as jax_load_tester
import pixie_tpu.services.netbus as jax_netbus
import pixie_tpu.services.observability as jax_obs
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.services.tracker import TOPIC_EXPIRED as JAX_TOPIC_EXPIRED
import pixie_tpu_torch.config as port_config
import pixie_tpu_torch.services as port_services
import pixie_tpu_torch.services.faults as port_faults
import pixie_tpu_torch.services.load_tester as port_load_tester
import pixie_tpu_torch.services.netbus as port_netbus
import pixie_tpu_torch.services.observability as port_obs
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.services.tracker import TOPIC_EXPIRED

SEED = int(os.environ.get("PIXIE_TPU_FAULT_SEED", "0"))
FAST = dict(heartbeat_interval_s=0.05)
W = 1 << 10

PKGS = {
    "port": types.SimpleNamespace(
        s=port_services, faults=port_faults, netbus=port_netbus,
        obs=port_obs, load_tester=port_load_tester,
        override_flag=port_config.override_flag,
        TOPIC_EXPIRED=TOPIC_EXPIRED,
        engine=lambda: Engine(window_rows=W, device="cpu"),
    ),
    "jax": types.SimpleNamespace(
        s=jax_services, faults=jax_faults, netbus=jax_netbus,
        obs=jax_obs, load_tester=jax_load_tester,
        override_flag=jax_config.override_flag,
        TOPIC_EXPIRED=JAX_TOPIC_EXPIRED,
        engine=lambda: JaxEngine(window_rows=W),
    ),
}

AGG_Q = (
    "import px\n"
    "df = px.DataFrame(table='http_events')\n"
    "df = df.groupby('service').agg(n=('latency_ns', px.count))\n"
    "px.display(df, 'out')\n"
)
ROWS_Q = (
    "import px\n"
    "df = px.DataFrame(table='http_events')\n"
    "df = df[df.resp_status == 500]\n"
    "px.display(df, 'errs')\n"
)


def _wait_for(pred, timeout_s: float = 10.0, interval_s: float = 0.01):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(interval_s)
    return True


def _rows(i: int, n: int, rng) -> dict:
    return {
        "time_": np.arange(n, dtype=np.int64),
        "latency_ns": rng.integers(1000, 1_000_000, n),
        "resp_status": rng.choice(np.array([200, 404, 500]), n),
        "service": [f"svc-{(i + j) % 3}" for j in range(n)],
    }


@contextlib.contextmanager
def _cluster(name: str, n_pems: int = 3, rows: int = 400,
             step: int = 100, **tracker_kw):
    """The JAX test's ``_mk_cluster`` for package ``name``: PEMs with
    ``rows + step * i`` seeded rows each, a Kelvin, a tracker (expiry and
    checks at 60 s, flapping at 3 in 60 s, a 60 s quarantine unless
    ``tracker_kw`` says otherwise) and a broker, on one bus."""
    pkg = PKGS[name]
    s = pkg.s
    kw = dict(expiry_s=60.0, check_interval_s=60.0, flap_threshold=3,
              flap_window_s=60.0, quarantine_s=60.0)
    kw.update(tracker_kw)
    bus = s.MessageBus()
    tracker = s.AgentTracker(bus, **kw)
    agents, broker = [], None
    try:
        pems = []
        for i in range(n_pems):
            pems.append(s.PEMAgent(bus, f"pem-{i}", engine=pkg.engine(),
                                   **FAST).start())
            agents.append(pems[-1])
        kelvin = s.KelvinAgent(bus, "kelvin-0", engine=pkg.engine(),
                               **FAST).start()
        agents.append(kelvin)
        rng = np.random.default_rng(SEED)
        for i, pem in enumerate(pems):
            pem.append_data("http_events", _rows(i, rows + step * i, rng))
            pem._register()
        # Every PEM's re-registration must have landed, not just the
        # first one's (the union of schemas): a PEM whose table the
        # tracker has not seen yet is pruned from the next plan.
        assert _wait_for(
            lambda: len(tracker.agent_ids()) == n_pems + 1
            and sum(a.has_table("http_events")
                    for a in tracker.distributed_state().pems) == n_pems,
            5.0)
        broker = s.QueryBroker(bus, tracker)
        yield types.SimpleNamespace(bus=bus, tracker=tracker, pems=pems,
                                    kelvin=kelvin, broker=broker, pkg=pkg)
    finally:
        bus.fault_injector = None
        for a in agents:
            a.stop()
        if broker is not None:
            broker.close()
        tracker.close()
        bus.close()


def _both(scenario, **cluster_kw):
    """Run ``scenario(cluster)`` on a port and a JAX cluster; their
    outcomes must be equal. Returns the port's."""
    outs = {}
    for name in ("port", "jax"):
        with _cluster(name, **cluster_kw) as c:
            outs[name] = scenario(c)
    assert outs["port"] == outs["jax"], outs
    return outs["port"]


def _truth(pems, alive) -> int:
    return sum(pems[i].engine.tables["http_events"].num_rows for i in alive)


def _total_n(res) -> int:
    return int(np.sum(res["tables"]["out"].to_pydict()["n"]))


def _by_service(res) -> dict:
    d = res["tables"]["out"].to_pydict()
    return dict(zip(d["service"], (int(n) for n in d["n"])))


def _answer(res) -> dict:
    """What a one-shot answer is held to across packages."""
    return {
        "partial": bool(res["partial"]),
        "missing_agents": list(res["missing_agents"]),
        "missing_reasons": dict(res.get("missing_reasons", {})),
        "groups": _by_service(res) if "out" in res["tables"] else None,
    }


# -- the injector -------------------------------------------------------------

def _rule_table(faults, seed: int):
    """One injector with every rule kind (partition included), for the
    plan-for-plan comparison."""
    inj = faults.FaultInjector(seed=seed)
    calls: list = []
    inj.drop("a.*", prob=0.3, count=40)
    inj.drop("a.b", after=3, count=2)
    inj.delay("d.*", 0.25, prob=0.5)
    inj.delay("d.x", 0.1, count=5, where=lambda m: m["i"] % 2 == 0)
    inj.duplicate("*.dup", prob=0.4, count=30)
    inj.duplicate("d.*", prob=0.2)
    inj.on_match("c.*", lambda t, m: calls.append((t, m["i"])), count=4,
                 after=2)
    inj.partition("pem-1", "broker", prob=0.7)
    return inj, calls


def _messages(n: int = 400, seed: int = 0):
    rng = np.random.default_rng(seed + 1000)
    topics = ["a.b", "a.c", "d.x", "d.y", "x.dup", "c.k", "agent.pem-1.x",
              "agent.pem-2.x", "other"]
    out = []
    for i in range(n):
        t = topics[int(rng.integers(len(topics)))]
        msg = {"i": i}
        if rng.random() < 0.3:
            msg["agent"] = "pem-1"
        out.append((t, msg))
    return out


class TestInjectorDeterminism:
    @pytest.mark.parametrize("seed", [0, 1, 2, 7])
    def test_plans_and_fired_equal_jax(self, seed):
        """The same seed and (topic, msg) sequence give the same plan per
        publish, the same fired() counts per action, the same per-rule
        matched/fired counters and the same trigger calls; heal()
        removes the cut in both, and the sequence after it agrees too."""
        got = {}
        msgs = _messages(seed=seed)
        for name, faults in (("port", port_faults), ("jax", jax_faults)):
            inj, calls = _rule_table(faults, seed)
            plans = [inj.intercept(t, dict(m)) for t, m in msgs[:250]]
            healed = inj.heal()
            plans += [inj.intercept(t, dict(m)) for t, m in msgs[250:]]
            got[name] = {
                "plans": plans,
                "fired": {a: inj.fired(a) for a in
                          (None, "drop", "delay", "duplicate", "call",
                           "partition")},
                "rules": [(r.pattern, r.action, r.matched, r.fired)
                          for r in inj._rules],
                "calls": calls,
                "log": list(inj.log),
                "healed": healed,
            }
        assert got["port"] == got["jax"]
        assert got["port"]["healed"] == 1
        assert 0 < got["port"]["fired"]["drop"] < 250
        assert got["port"]["calls"] and len(got["port"]["calls"]) == 4

    def test_same_seed_same_decisions(self):
        """The JAX test: a (seed, workload) pair replays identically on
        the port's bus, and delivers what the JAX bus delivers."""
        def run(pkg):
            inj = pkg.faults.FaultInjector(seed=SEED)
            inj.drop("t.*", prob=0.5)
            bus = pkg.s.MessageBus()
            bus.fault_injector = inj
            got = []
            bus.subscribe("t.x", got.append)
            for i in range(64):
                bus.publish("t.x", {"i": i})
            _wait_for(lambda: len(got) >= 64 - inj.fired(), 2.0)
            log = list(inj.log)
            bus.close()
            return log, sorted(m["i"] for m in got)

        a, b = run(PKGS["port"]), run(PKGS["port"])
        assert a == b == run(PKGS["jax"])
        assert 0 < len(a[0]) < 64

    def test_rule_mechanics(self):
        """drop count/after, duplicate, delay, where-predicates."""
        inj = port_faults.FaultInjector(seed=SEED)
        inj.drop("a.b", count=1, after=1)
        inj.duplicate("dup.*", count=1)
        inj.delay("slow", 0.15, count=1)
        inj.drop("pred", where=lambda m: m.get("kill"))
        bus = port_services.MessageBus()
        bus.fault_injector = inj
        got = {"ab": [], "dup": [], "slow": [], "pred": []}
        for k, t in (("ab", "a.b"), ("dup", "dup.x"), ("slow", "slow"),
                     ("pred", "pred")):
            bus.subscribe(t, got[k].append)
        try:
            for i in range(3):
                bus.publish("a.b", {"i": i})
            bus.publish("dup.x", {"i": 0})
            t0 = time.monotonic()
            bus.publish("slow", {"i": 0})
            bus.publish("pred", {"kill": True})
            bus.publish("pred", {"kill": False})
            assert _wait_for(lambda: len(got["ab"]) == 2
                             and len(got["dup"]) == 2 and got["slow"]
                             and len(got["pred"]) == 1, 5.0), got
            assert sorted(m["i"] for m in got["ab"]) == [0, 2]
            assert time.monotonic() - t0 >= 0.15
            assert [m["kill"] for m in got["pred"]] == [False]
        finally:
            bus.close()


# -- the bus hooks ------------------------------------------------------------

def _deliveries(pkg, fault: str, transport: str) -> dict:
    """Publish 40 messages on ``t.x`` (with an ``agent`` field on every
    third) through ``transport`` under one ``fault``; what the
    subscriber on the served bus got, in multiset form, and the
    injector's counts."""
    s = pkg.s
    bus = s.MessageBus()
    got: list = []
    bus.subscribe("t.x", got.append)
    bus.subscribe("agent.pem-1.x", got.append)
    server = rb = None
    pub = bus
    if transport == "remotebus":
        server = pkg.netbus.BusServer(bus)
        rb = pkg.netbus.RemoteBus("127.0.0.1", server.port)
        pub = rb
    inj = pkg.faults.FaultInjector(seed=SEED)
    expect_errors = 0
    if fault == "drop":
        inj.drop("t.x", prob=0.5, after=2)
    elif fault == "delay":
        inj.delay("t.x", 0.2, where=lambda m: m["i"] % 4 == 0)
    elif fault == "duplicate":
        inj.duplicate("t.x", prob=0.5, count=12)
    elif fault == "partition_heal":
        inj.partition("pem-*", "broker")
    elif fault == "sever":
        inj.sever("t.x", rb, after=10)
    pub.fault_injector = inj
    errors = []
    t0 = time.monotonic()
    try:
        for i in range(40):
            topic = "agent.pem-1.x" if i % 5 == 0 else "t.x"
            msg = {"i": i}
            if i % 3 == 0:
                msg["agent"] = "pem-2"
            if fault == "partition_heal" and i == 20:
                assert inj.heal() == 1
            try:
                pub.publish(topic, msg)
            except (ConnectionError, OSError):
                # Which of the two a severed socket raises is a race of
                # its read loop; that it raises is not.
                errors.append(i)
        if rb is not None and fault != "sever":
            # A round trip through the served bus: every publish before
            # it has been fanned out there.
            bus.subscribe("echo", lambda m: bus.publish(m["_reply_to"], {}))
            rb.request("echo", {}, timeout_s=5.0)
        if fault != "sever":
            want = 40 - inj.fired("drop") - inj.fired("partition") \
                + inj.fired("duplicate")
            assert _wait_for(lambda: len(got) >= want, 3.0), (want, got)
        time.sleep(0.25)  # a late duplicate or delayed copy would land
        delayed = sorted(m["i"] for m in got
                         if fault == "delay" and m["i"] % 4 == 0)
        if delayed:
            assert time.monotonic() - t0 >= 0.2
        return {
            "got": sorted(m["i"] for m in got),
            "fired": {a: inj.fired(a) for a in
                      ("drop", "delay", "duplicate", "call", "partition")},
            "errors": errors,
        }
    finally:
        if rb is not None:
            rb.close()
        if server is not None:
            server.close()
        bus.close()


@pytest.mark.parametrize("fault,transport", [
    ("drop", "msgbus"), ("drop", "remotebus"),
    ("delay", "msgbus"), ("delay", "remotebus"),
    ("duplicate", "msgbus"), ("duplicate", "remotebus"),
    ("partition_heal", "msgbus"), ("partition_heal", "remotebus"),
    ("sever", "remotebus"),
])
def test_bus_hook_delivers_as_jax(fault, transport):
    port = _deliveries(PKGS["port"], fault, transport)
    jax = _deliveries(PKGS["jax"], fault, transport)
    assert port == jax
    if fault == "sever":
        # The cut lands on the 11th t.x publish: nothing after it.
        assert port["fired"]["call"] == 1 and port["errors"]
        assert max(port["got"]) < port["errors"][0]
    elif fault == "partition_heal":
        # pem-2 -> pem-1 and untagged traffic flow; broker -> pem-1 is
        # cut until the heal at i == 20.
        assert port["fired"]["partition"] > 0
        assert all(i >= 20 or i % 3 == 0 for i in port["got"]
                   if i % 5 == 0)
    else:
        assert port["fired"][fault] > 0


def test_msgbus_and_netbus_raise_shared_bus_timeout():
    """Both transports raise one BusTimeout (a TimeoutError subclass)."""
    bus = port_services.MessageBus()
    with pytest.raises(port_services.BusTimeout):
        bus.request("nobody.home", {}, timeout_s=0.05)
    bus.subscribe("silent", lambda m: None)
    with pytest.raises(port_services.BusTimeout):
        bus.request("silent", {}, timeout_s=0.05)
    server = port_netbus.BusServer(bus)
    rb = port_netbus.RemoteBus("127.0.0.1", server.port)
    try:
        with pytest.raises(port_services.BusTimeout) as ei:
            rb.request("nobody.home", {}, timeout_s=0.05)
        assert isinstance(ei.value, TimeoutError)
    finally:
        rb.close()
        server.close()
        bus.close()


# -- dispatch retry -----------------------------------------------------------

class TestDispatchRetry:
    def test_ack_loss_retries_and_completes_exactly_once(self):
        def run(c):
            inj = c.pkg.faults.FaultInjector(seed=SEED)
            inj.drop("query.*.ack", count=1,
                     where=lambda m: m.get("agent") == "pem-1"
                     and m.get("ack") == "execute")
            c.bus.fault_injector = inj
            with c.pkg.override_flag("dispatch_retries", 3), \
                    c.pkg.override_flag("dispatch_backoff_ms", 20.0):
                res = c.broker.execute_script(AGG_Q)
            assert _total_n(res) == _truth(c.pems, [0, 1, 2])
            assert set(res["agent_stats"]) == {"pem-0", "pem-1", "pem-2"}
            # (Whether the retry counter moves is a race: pem-1's report
            # can beat the 20 ms ack wait, and then nothing re-sends.)
            assert inj.fired("drop") == 1
            return _answer(res)

        out = _both(run)
        assert out["partial"] is False and out["missing_agents"] == []

    def test_duplicate_dispatch_is_idempotent(self):
        def run(c):
            inj = c.pkg.faults.FaultInjector(seed=SEED)
            inj.duplicate("agent.pem-0.execute")
            inj.duplicate("agent.kelvin-0.bridge", count=2)
            c.bus.fault_injector = inj
            res = c.broker.execute_script(AGG_Q)
            assert _total_n(res) == _truth(c.pems, [0, 1, 2])
            return _answer(res)

        assert _both(run)["partial"] is False

    def test_death_before_dispatch_degrades_to_partial(self):
        def run(c):
            inj = c.pkg.faults.FaultInjector(seed=SEED)
            inj.drop("agent.pem-2.execute")
            c.bus.fault_injector = inj
            t0 = time.monotonic()
            with c.pkg.override_flag("dispatch_retries", 2), \
                    c.pkg.override_flag("dispatch_backoff_ms", 20.0):
                res = c.broker.execute_script(AGG_Q, timeout_s=30.0)
            assert time.monotonic() - t0 < 10.0
            assert _total_n(res) == _truth(c.pems, [0, 1])
            return _answer(res)

        out = _both(run)
        assert out["partial"] is True and out["missing_agents"] == ["pem-2"]
        assert "un-acked" in out["missing_reasons"]["pem-2"]


# -- agent death --------------------------------------------------------------

def _kill_pem2_mid_fragment(c):
    inj = c.pkg.faults.FaultInjector(seed=SEED)
    dead = lambda m: m.get("from_agent") == "pem-2"  # noqa: E731
    inj.drop("agent.kelvin-0.bridge", where=dead)
    inj.drop("query.*.agent_done", where=lambda m: m.get("agent") == "pem-2")
    inj.kill_agent("agent.kelvin-0.bridge", c.pems[2], c.tracker, where=dead)
    c.bus.fault_injector = inj


def _error(call) -> dict:
    """A query that must fail: its exception's type name and message
    (the query id masked)."""
    t0 = time.monotonic()
    try:
        call()
    except Exception as e:  # compared across packages below
        msg = re.sub(r"query [0-9a-f]{12}", "query <qid>", str(e))
        return {"type": type(e).__name__, "msg": msg,
                "secs": time.monotonic() - t0}
    raise AssertionError("the query did not fail")


class TestAgentDeath:
    def test_killed_mid_fragment_returns_partial_fast(self):
        def run(c):
            _kill_pem2_mid_fragment(c)
            t0 = time.monotonic()
            res = c.broker.execute_script(AGG_Q, timeout_s=30.0)
            assert time.monotonic() - t0 < 10.0
            assert _total_n(res) == _truth(c.pems, [0, 1])
            assert "pem-2" not in res["agent_stats"]
            return _answer(res)

        out = _both(run)
        assert out["partial"] is True and out["missing_agents"] == ["pem-2"]

    def test_require_complete_fails_fast(self):
        def run(c):
            _kill_pem2_mid_fragment(c)
            err = _error(lambda: c.broker.execute_script(
                AGG_Q, timeout_s=30.0, require_complete=True))
            assert err["secs"] < 5.0
            return {k: err[k] for k in ("type", "msg")}

        out = _both(run)
        assert out["type"] == "AgentLost"
        assert "pem-2" in out["msg"] and "require_complete" in out["msg"]

    def test_merge_agent_death_fails_query_fast(self):
        def run(c):
            inj = c.pkg.faults.FaultInjector(seed=SEED)
            inj.kill_agent("agent.kelvin-0.bridge", c.kelvin, c.tracker)
            c.bus.fault_injector = inj
            err = _error(lambda: c.broker.execute_script(AGG_Q,
                                                         timeout_s=30.0))
            assert err["secs"] < 5.0
            return {"type": err["type"],
                    "merge": "merge agent kelvin-0" in err["msg"]}

        assert _both(run)["merge"] is True

    def test_all_data_agents_lost_errors(self):
        def run(c):
            inj = c.pkg.faults.FaultInjector(seed=SEED)
            inj.drop("agent.pem-*.execute")
            c.bus.fault_injector = inj
            with c.pkg.override_flag("dispatch_retries", 1), \
                    c.pkg.override_flag("dispatch_backoff_ms", 20.0):
                err = _error(lambda: c.broker.execute_script(
                    AGG_Q, timeout_s=30.0))
            # The message lists the agents lost so far: a race of the
            # retry timers.
            return {"type": err["type"],
                    "all lost": "all data agents lost" in err["msg"]}

        assert _both(run) == {"type": "AgentLost", "all lost": True}

    def test_timeout_message_reports_missing_and_dispatch_state(self):
        def run(c):
            inj = c.pkg.faults.FaultInjector(seed=SEED)
            inj.drop("agent.kelvin-0.bridge",
                     where=lambda m: m.get("from_agent") == "pem-1")
            inj.drop("query.*.agent_done",
                     where=lambda m: m.get("agent") == "pem-1")
            c.bus.fault_injector = inj
            err = _error(lambda: c.broker.execute_script(AGG_Q,
                                                         timeout_s=1.0))
            msg = err["msg"]
            return {"type": err["type"],
                    "missing": "missing: ['pem-1']" in msg,
                    "dispatch": "pem-1:execute" in msg and "acked" in msg}

        assert _both(run) == {"type": "QueryTimeout", "missing": True,
                              "dispatch": True}


# -- stream faults ------------------------------------------------------------

def _replaces(updates):
    return [u for u in updates if u.get("mode") == "replace"]


def _last_total(updates) -> int:
    r = _replaces(updates)
    return int(np.sum(r[-1]["batch"].to_pydict()["n"])) if r else -1


def _start_stream(c, updates, **kw):
    handle = c.broker.execute_script_streaming(
        AGG_Q, on_update=updates.append, poll_interval_s=0.05, **kw)
    assert _wait_for(lambda: _replaces(updates)), \
        "stream never produced a merged view"
    return handle


def _append_on(pem, n: int) -> None:
    n0 = pem.engine.tables["http_events"].num_rows
    pem.append_data("http_events", {
        "time_": np.arange(n0, n0 + n, dtype=np.int64),
        "latency_ns": np.full(n, 5000, dtype=np.int64),
        "resp_status": np.full(n, 200, dtype=np.int64),
        "service": ["svc-0"] * n,
    })


class TestStreamFaults:
    def test_data_agent_death_degrades_stream(self):
        def run(c):
            updates: list = []
            handle = _start_stream(c, updates)
            try:
                c.pems[2].stop()
                c.tracker.force_expire("pem-2", reason="killed mid-stream")
                assert _wait_for(lambda: any(
                    u.get("stream_degraded") for u in updates))
                deg = [u for u in updates if u.get("stream_degraded")][0]
                assert handle.data_agents == ("pem-0", "pem-1")
                assert handle.missing_agents == ("pem-2",)
                _append_on(c.pems[0], 200)
                want = _truth(c.pems, [0, 1])
                assert _wait_for(lambda: _last_total(updates) == want)
                assert not any("error" in u for u in updates), updates
                return {"missing": deg["missing_agents"], "total": want,
                        "groups": _by_service(
                            {"tables": {"out": _replaces(updates)[-1]
                                        ["batch"]}})}
            finally:
                handle.cancel()

        assert _both(run)["missing"] == ["pem-2"]

    def test_data_agent_death_aborts_require_complete_stream(self):
        def run(c):
            updates: list = []
            handle = _start_stream(c, updates, require_complete=True)
            try:
                c.pems[2].stop()
                c.tracker.force_expire("pem-2", reason="killed mid-stream")
                assert _wait_for(lambda: any("error" in u for u in updates))
                err = [u for u in updates if "error" in u][0]["error"]
                assert handle.qid not in c.broker._live_streams
                return {"require_complete": "require_complete" in err,
                        "pem-2": "pem-2" in err}
            finally:
                handle.cancel()

        assert _both(run) == {"require_complete": True, "pem-2": True}

    def test_merge_agent_death_aborts_stream_and_cancel_is_idempotent(self):
        def run(c):
            updates: list = []
            handle = _start_stream(c, updates)
            c.kelvin.stop()
            c.tracker.force_expire("kelvin-0", reason="killed mid-stream")
            assert _wait_for(lambda: any("error" in u for u in updates))
            err = [u for u in updates if "error" in u][0]["error"]
            assert _wait_for(lambda: not c.broker._live_streams, 5.0)
            n = len(updates)
            handle.cancel()
            handle.cancel()
            time.sleep(0.1)
            assert len(updates) == n
            return {"merge agent": "merge agent" in err,
                    "kelvin-0": "kelvin-0" in err}

        assert _both(run) == {"merge agent": True, "kelvin-0": True}


class TestStreamDispatchLoss:
    def test_lost_stream_execute_dispatch_degrades(self):
        def run(c):
            inj = c.pkg.faults.FaultInjector(seed=SEED)
            inj.drop("agent.pem-2.stream_execute")
            c.bus.fault_injector = inj
            updates: list = []
            with c.pkg.override_flag("dispatch_retries", 1), \
                    c.pkg.override_flag("dispatch_backoff_ms", 20.0):
                handle = c.broker.execute_script_streaming(
                    AGG_Q, on_update=updates.append, poll_interval_s=0.05)
            try:
                assert _wait_for(lambda: any(
                    u.get("stream_degraded") for u in updates))
                deg = [u for u in updates if u.get("stream_degraded")][0]
                want = _truth(c.pems, [0, 1])
                assert _wait_for(lambda: _last_total(updates) == want)
                return {"missing": deg["missing_agents"],
                        "un-acked": "un-acked" in deg["reason"],
                        "total": want}
            finally:
                handle.cancel()

        out = _both(run)
        assert out["missing"] == ["pem-2"] and out["un-acked"]

    def test_lost_stream_merge_dispatch_aborts(self):
        def run(c):
            inj = c.pkg.faults.FaultInjector(seed=SEED)
            inj.drop("agent.kelvin-0.stream_merge")
            c.bus.fault_injector = inj
            updates: list = []
            with c.pkg.override_flag("dispatch_retries", 1), \
                    c.pkg.override_flag("dispatch_backoff_ms", 20.0):
                handle = c.broker.execute_script_streaming(
                    AGG_Q, on_update=updates.append, poll_interval_s=0.05)
            try:
                assert _wait_for(lambda: any("error" in u for u in updates))
                err = [u for u in updates if "error" in u][0]["error"]
                assert handle.qid not in c.broker._live_streams
                return {"un-acked": "un-acked" in err}
            finally:
                handle.cancel()

        assert _both(run) == {"un-acked": True}

    def test_duplicated_stream_rows_chunks_not_double_counted(self):
        def run(c):
            inj = c.pkg.faults.FaultInjector(seed=SEED)
            inj.duplicate("agent.kelvin-0.stream_bridge")
            c.bus.fault_injector = inj
            updates: list = []
            handle = c.broker.execute_script_streaming(
                ROWS_Q, on_update=updates.append, poll_interval_s=0.05)
            try:
                truth = sum(
                    int((p.engine.tables["http_events"].read_all()
                         .to_pydict()["resp_status"] == 500).sum())
                    for p in c.pems)

                def total():
                    return sum(u["batch"].length for u in updates
                               if "batch" in u)

                assert _wait_for(lambda: total() >= truth)
                time.sleep(0.5)  # a double-counted duplicate would land
                assert total() == truth, (total(), truth)
                assert inj.fired("duplicate") > 0
                return {"rows": total()}
            finally:
                handle.cancel()

        _both(run)

    def test_lost_dispatch_only_affects_its_own_stream(self):
        def run(c):
            healthy_updates: list = []
            healthy = _start_stream(c, healthy_updates)
            try:
                inj = c.pkg.faults.FaultInjector(seed=SEED)
                inj.drop("agent.kelvin-0.stream_merge")
                c.bus.fault_injector = inj
                doomed_updates: list = []
                with c.pkg.override_flag("dispatch_retries", 1), \
                        c.pkg.override_flag("dispatch_backoff_ms", 20.0):
                    doomed = c.broker.execute_script_streaming(
                        AGG_Q, on_update=doomed_updates.append,
                        poll_interval_s=0.05)
                assert _wait_for(lambda: any(
                    "error" in u for u in doomed_updates))
                assert doomed.qid not in c.broker._live_streams
                assert healthy.qid in c.broker._live_streams
                assert not any("error" in u for u in healthy_updates)
                _append_on(c.pems[0], 100)
                want = _truth(c.pems, [0, 1, 2])
                assert _wait_for(lambda: _last_total(healthy_updates) == want), (
                    c.pkg is PKGS["port"], _last_total(healthy_updates), want,
                    [u for u in healthy_updates if "mode" not in u])
                return {"total": want}
            finally:
                healthy.cancel()
                c.bus.fault_injector = None

        _both(run)

    def test_stream_aborts_when_last_data_agent_dies(self):
        def run(c):
            updates: list = []
            handle = _start_stream(c, updates)
            c.pems[0].stop()
            c.tracker.force_expire("pem-0", reason="killed")
            assert _wait_for(lambda: any("error" in u for u in updates))
            err = [u for u in updates if "error" in u][0]["error"]
            assert handle.qid not in c.broker._live_streams
            return {"no data agents left": "no data agents left" in err}

        assert _both(run, n_pems=1) == {"no data agents left": True}


# -- quarantine ---------------------------------------------------------------

def _flap(c, aid: str, times: int) -> None:
    """Expire ``aid`` and re-register it ``times`` times, each time
    waiting until the tracker holds it again."""
    pem = next(p for p in c.pems if p.agent_id == aid)
    for _ in range(times):
        c.tracker.force_expire(aid, reason="flap")
        c.bus.publish("agent.register", {
            "agent_id": aid, "processes_data": True,
            "schemas": pem._schemas()})
        assert _wait_for(lambda: aid in c.tracker.agent_ids(), 5.0)


class TestQuarantine:
    def test_flapping_agent_is_quarantined_out_of_planning(self):
        def run(c):
            _flap(c, "pem-2", 3)
            assert c.tracker.is_quarantined("pem-2")
            assert "pem-2" in c.tracker.quarantined()
            state = c.tracker.distributed_state()
            assert state.quarantined == ["pem-2"]
            res = c.broker.execute_script(AGG_Q)
            assert res["distributed_plan"].n_data_shards == 2
            assert _total_n(res) == _truth(c.pems, [0, 1])
            info = {a["agent_id"]: a for a in c.tracker.agents_info()}
            assert info["pem-2"]["quarantined"] is True
            assert "pixie_agent_quarantined_total" in \
                c.pkg.obs.default_registry.render()
            return {"planned": sorted(a.agent_id for a in state.agents),
                    **_answer(res)}

        assert _both(run)["planned"] == ["kelvin-0", "pem-0", "pem-1"]

    def test_quarantine_lapses_after_cooldown(self):
        out = {}
        for name, pkg in PKGS.items():
            bus = pkg.s.MessageBus()
            tracker = pkg.s.AgentTracker(
                bus, expiry_s=60.0, check_interval_s=60.0, flap_threshold=2,
                flap_window_s=60.0, quarantine_s=0.2)
            try:
                bus.publish("agent.register", {"agent_id": "a1",
                                               "schemas": {}})
                assert _wait_for(lambda: "a1" in tracker.agent_ids(), 5.0)
                for _ in range(2):
                    tracker.force_expire("a1")
                    bus.publish("agent.register", {"agent_id": "a1",
                                                   "schemas": {}})
                    assert _wait_for(lambda: "a1" in tracker.agent_ids(), 5.0)
                quarantined = tracker.is_quarantined("a1")
                assert _wait_for(lambda: not tracker.is_quarantined("a1"),
                                 5.0)
                out[name] = {
                    "quarantined": quarantined,
                    "after": tracker.quarantined(),
                    "planned": [a.agent_id for a in
                                tracker.distributed_state().agents],
                }
            finally:
                tracker.close()
                bus.close()
        assert out["port"] == out["jax"] == {
            "quarantined": True, "after": {}, "planned": ["a1"]}


class TestQuarantineCooldownRecovery:
    """flap -> quarantine -> cooldown -> re-register, end to end through
    query execution on both transports. Each step waits for what its
    assertion reads: the tracker's planning set AND the broker's result
    cache being emptied by the lifecycle event (the JAX test waits on
    the tracker alone, and a stale cache entry can answer first)."""

    @staticmethod
    def _settled(c, planned: set):
        return _wait_for(
            lambda: {a.agent_id for a in c.tracker.distributed_state().agents
                     if a.agent_id.startswith("pem")} == planned
            and not c.broker.result_cache._entries, 5.0)

    def _lifecycle(self, c, execute) -> list:
        seen = []
        res = execute()
        seen.append(_answer(res))
        assert set(res["agent_stats"]) == {"pem-0", "pem-1", "pem-2"}
        want_all = _truth(c.pems, [0, 1, 2])
        assert _total_n(res) == want_all
        assert execute().get("cache") == "hit"
        _flap(c, "pem-2", 2)
        assert c.tracker.is_quarantined("pem-2")
        assert self._settled(c, {"pem-0", "pem-1"})
        res = execute()
        seen.append(_answer(res))
        assert set(res["agent_stats"]) == {"pem-0", "pem-1"}
        assert _total_n(res) == _truth(c.pems, [0, 1])
        assert _wait_for(lambda: not c.tracker.is_quarantined("pem-2"), 5.0)
        c.bus.publish("agent.register", {
            "agent_id": "pem-2", "processes_data": True,
            "schemas": c.pems[2]._schemas()})
        assert self._settled(c, {"pem-0", "pem-1", "pem-2"})
        res = execute()
        seen.append(_answer(res))
        assert set(res["agent_stats"]) == {"pem-0", "pem-1", "pem-2"}
        assert _total_n(res) == want_all
        assert res.get("cache") != "hit"
        return seen

    def _run(self, transport: str) -> None:
        out = {}
        for name in ("port", "jax"):
            with _cluster(name, rows=300, step=50, flap_threshold=2,
                          quarantine_s=0.4) as c:
                rb = server = None
                if transport == "netbus":
                    c.broker.serve()
                    server = c.pkg.netbus.BusServer(c.bus)
                    rb = c.pkg.netbus.RemoteBus("127.0.0.1", server.port)

                    def execute():
                        res = rb.request(
                            "broker.execute",
                            {"query": AGG_Q, "timeout_s": 20.0},
                            timeout_s=25.0)
                        assert res["ok"], res
                        return res
                else:
                    def execute():
                        return c.broker.execute_script(AGG_Q, timeout_s=20.0)
                try:
                    with c.pkg.override_flag("result_cache_mb", 64):
                        out[name] = self._lifecycle(c, execute)
                finally:
                    if rb is not None:
                        rb.close()
                        server.close()
        assert out["port"] == out["jax"]

    def test_recovery_in_process(self):
        self._run("in_process")

    def test_recovery_over_netbus(self):
        self._run("netbus")


# -- forwarder ----------------------------------------------------------------

class TestForwarderWatchdog:
    def test_unrelated_expiry_does_not_reset_watchdog(self):
        for pkg in PKGS.values():
            bus = pkg.s.MessageBus()
            fwd = pkg.s.QueryResultForwarder(bus)
            fwd.register_query("q1", ["a0"], merge_agent="m")
            stop = threading.Event()

            def churn():
                i = 0
                while not stop.wait(0.3):
                    bus.publish(pkg.TOPIC_EXPIRED,
                                {"agent_id": f"other-{i}", "reason": "flap"})
                    i += 1

            t = threading.Thread(target=churn, daemon=True)
            t.start()
            t0 = time.monotonic()
            try:
                with pytest.raises(pkg.s.QueryTimeout):
                    fwd.wait("q1", timeout_s=1.0)
                assert time.monotonic() - t0 < 3.0
            finally:
                stop.set()
                t.join(2.0)
                bus.close()

    def test_post_eos_agent_loss_does_not_discard_results(self):
        out = {}
        for name, pkg in PKGS.items():
            bus = pkg.s.MessageBus()
            fwd = pkg.s.QueryResultForwarder(bus)
            fwd.register_query("q2", ["a0", "a1"], merge_agent="m")
            bus.publish("query.q2.results", {"table": "t", "batch": "B"})
            bus.publish("query.q2.agent_done",
                        {"agent": "a0", "exec_time_s": 0.01})
            bus.publish("query.q2.results", {"eos": True})
            # Cross-topic delivery is unordered: wait until the forwarder
            # holds the eos before the deaths (the case is about POST-eos
            # losses).
            st = fwd._active["q2"]
            assert _wait_for(lambda: st["queue"].qsize() >= 3, 5.0)
            bus.publish(pkg.TOPIC_EXPIRED, {"agent_id": "m",
                                            "reason": "died"})
            bus.publish(pkg.TOPIC_EXPIRED, {"agent_id": "a1",
                                            "reason": "died"})
            res = fwd.wait("q2", timeout_s=5.0)
            bus.close()
            out[name] = (res["tables"], res["partial"],
                         res["missing_agents"])
        assert out["port"] == out["jax"] == ({"t": "B"}, False, [])


class TestGraceDrain:
    def test_post_eos_stats_drain_is_bounded_total(self):
        out = {}
        for name, pkg in PKGS.items():
            bus = pkg.s.MessageBus()
            inj = pkg.faults.FaultInjector(seed=SEED)
            agents = [f"a{i}" for i in range(4)]
            for i, aid in enumerate(agents):
                inj.delay("query.q1.agent_done", 0.5 * (i + 1),
                          where=lambda m, a=aid: m.get("agent") == a)
            bus.fault_injector = inj
            fwd = pkg.s.QueryResultForwarder(bus)
            fwd.register_query("q1", agents, merge_agent="m")
            bus.publish("query.q1.results", {"table": "t", "batch": "B"})
            for aid in agents:
                bus.publish("query.q1.agent_done",
                            {"agent": aid, "exec_time_s": 0.01})
            bus.publish("query.q1.results", {"eos": True})
            t0 = time.monotonic()
            res = fwd.wait("q1", timeout_s=8.0)
            assert time.monotonic() - t0 < 1.8
            bus.close()
            out[name] = (res["tables"], res["partial"],
                         "a0" in res["agent_stats"],
                         "a3" in res["agent_stats"])
        assert out["port"] == out["jax"] == ({"t": "B"}, False, True, False)


# -- deadlines ----------------------------------------------------------------

def _slow_windows(c, delay_s: float, window_rows: int = 64):
    """Every PEM fragment slow between windows: small windows (about 8
    per fragment), each handed over ``delay_s`` apart, so a sub-second
    deadline trips between windows. Returns the undo."""
    undo = []
    for p in c.pems:
        eng = p.engine
        orig = eng._staged_windows
        undo.append((eng, orig, eng.window_rows))
        eng.window_rows = window_rows

        def slow(*args, _orig=orig, **kw):
            for w in _orig(*args, **kw):
                time.sleep(delay_s)
                yield w

        eng._staged_windows = slow

    def restore():
        for eng, orig, wr in undo:
            eng._staged_windows = orig
            eng.window_rows = wr

    return restore


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.is_alive() and t.name == "pixie-window-prefetch"]


class TestDeadlineFault:
    def test_mid_pipeline_deadline_abort_no_leaks(self):
        def run(c):
            c.broker.execute_script(AGG_Q)  # warm outside the clock
            before = len(_prefetch_threads())
            restore = _slow_windows(c, 0.15)
            t0 = time.monotonic()
            # Host windows (residency off on the port: the resident
            # window's size was fixed at append).
            with c.pkg.override_flag("device_residency", False) \
                    if c.pkg is PKGS["port"] else contextlib.nullcontext():
                try:
                    res = c.broker.execute_script(AGG_Q, timeout_s=30.0,
                                                  deadline_ms=300.0)
                finally:
                    restore()
            assert time.monotonic() - t0 < 5.0
            assert _wait_for(lambda: len(_prefetch_threads()) <= before, 5.0)
            guard = getattr(c.pems[0].engine, "_exec_guard", None)
            for p in c.pems if guard is not None else ():
                assert p.engine._exec_guard.acquire(timeout=5.0)
                p.engine._exec_guard.release()
            fresh = c.broker.execute_script(AGG_Q, timeout_s=30.0)
            assert fresh["partial"] is False
            assert _total_n(fresh) == _truth(c.pems, [0, 1, 2])
            return {"partial": res["partial"],
                    "interrupted": res["interrupted"],
                    "reasons": set(res["missing_reasons"].values()),
                    "fresh": _answer(fresh)}

        out = _both(run)
        assert out["partial"] is True and out["interrupted"] == "deadline"
        assert out["reasons"] == {"deadline"}

    def test_delayed_bridge_fault_rule_degrades_at_deadline(self):
        def run(c):
            c.broker.execute_script(AGG_Q)  # warm
            inj = c.pkg.faults.FaultInjector(seed=SEED)
            inj.delay("agent.kelvin-0.bridge", 3.0,
                      where=lambda m: m.get("from_agent") == "pem-2")
            inj.delay("query.*.agent_done", 3.0,
                      where=lambda m: m.get("agent") == "pem-2")
            c.bus.fault_injector = inj
            t0 = time.monotonic()
            res = c.broker.execute_script(AGG_Q, timeout_s=30.0,
                                          deadline_ms=500.0)
            assert time.monotonic() - t0 < 3.0
            if "out" in res["tables"]:
                assert _total_n(res) <= _truth(c.pems, [0, 1, 2])
            return {"partial": res["partial"],
                    "interrupted": res["interrupted"],
                    "pem-2": res["missing_reasons"].get("pem-2")}

        assert _both(run) == {"partial": True, "interrupted": "deadline",
                              "pem-2": "deadline"}


# -- load under faults --------------------------------------------------------

class TestLoadUnderFaults:
    def test_load_tester_reports_failure_rates(self):
        def run(c):
            lt = c.pkg.load_tester
            c.broker.execute_script(AGG_Q)  # warm outside the clock
            inj = c.pkg.faults.FaultInjector(seed=SEED)
            inj.drop("agent.pem-2.execute", prob=0.4)
            c.bus.fault_injector = inj
            with c.pkg.override_flag("dispatch_retries", 0), \
                    c.pkg.override_flag("dispatch_backoff_ms", 20.0):
                report = lt.run_load(lt.broker_executor(c.broker), AGG_Q,
                                     workers=2, per_worker=3, timeout_s=30.0)
            d = report.to_dict()
            assert d["queries"] == 6
            assert d["failure_rate"] == report.errors / 6
            assert isinstance(d["errors_by_type"], dict)
            inj2 = c.pkg.faults.FaultInjector(seed=SEED)
            inj2.drop("agent.pem-2.execute")
            c.bus.fault_injector = inj2

            def strict(query, timeout_s):
                return c.broker.execute_script(
                    query, timeout_s=timeout_s, require_complete=True)

            with c.pkg.override_flag("dispatch_retries", 0), \
                    c.pkg.override_flag("dispatch_backoff_ms", 20.0):
                st = lt.run_load(strict, AGG_Q, workers=1, per_worker=2,
                                 timeout_s=30.0)
            return {"queries": d["queries"],
                    "strict": (st.errors, st.failure_rate,
                               st.errors_by_type)}

        assert _both(run)["strict"] == (2, 1.0, {"AgentLost": 2})


# -- partitions ---------------------------------------------------------------

def _partition_run(pkg, seed: int, prob: float):
    inj = pkg.faults.FaultInjector(seed=seed)
    inj.partition("pem-*", "broker", prob=prob)
    bus = pkg.s.MessageBus()
    bus.fault_injector = inj
    got = {"to_agent": [], "to_broker": [], "intra": []}
    bus.subscribe("agent.pem-1.execute", got["to_agent"].append)
    bus.subscribe("agent.register", got["to_broker"].append)
    bus.subscribe("agent.pem-2.bridge", got["intra"].append)
    try:
        for i in range(32):
            bus.publish("agent.pem-1.execute", {"qid": f"q{i}", "i": i})
            bus.publish("agent.register", {"agent_id": "pem-1", "i": i})
            bus.publish("agent.pem-2.bridge", {"from_agent": "pem-1", "i": i})
        fired = inj.fired("partition")
        assert _wait_for(
            lambda: len(got["intra"]) == 32
            and len(got["to_agent"]) + len(got["to_broker"]) == 64 - fired,
            3.0)
        return (list(inj.log), fired,
                sorted(m["i"] for m in got["to_agent"]),
                sorted(m["i"] for m in got["to_broker"]),
                sorted(m["i"] for m in got["intra"]))
    finally:
        bus.close()


class TestPartitionDeterminism:
    def test_same_seed_replays_identically(self):
        a = _partition_run(PKGS["port"], SEED, 0.5)
        assert a == _partition_run(PKGS["port"], SEED, 0.5)
        assert a == _partition_run(PKGS["jax"], SEED, 0.5)
        log, fired, to_agent, to_broker, intra = a
        assert 0 < fired < 64
        assert len(to_agent) < 32 or len(to_broker) < 32
        assert intra == list(range(32))

    def test_full_cut_and_heal(self):
        inj = port_faults.FaultInjector(seed=SEED)
        inj.partition("pem-*", "broker")
        bus = port_services.MessageBus()
        bus.fault_injector = inj
        got = []
        bus.subscribe("agent.pem-0.execute", got.append)
        try:
            bus.publish("agent.pem-0.execute", {"i": 0})
            assert inj.fired("partition") == 1 and got == []
            assert inj.heal() == 1
            bus.publish("agent.pem-0.execute", {"i": 1})
            assert _wait_for(lambda: got, 3.0)
            assert [m["i"] for m in got] == [1]
            inj.drop("agent.pem-0.execute", count=1)
            assert inj.heal() == 0
            bus.publish("agent.pem-0.execute", {"i": 2})
            assert inj.fired("drop") == 1
            bus.publish("agent.pem-0.execute", {"i": 3})
            assert _wait_for(lambda: len(got) == 2, 3.0)
            assert [m["i"] for m in got] == [1, 3]
        finally:
            bus.close()

    def test_heal_removes_both_directions_of_every_cut(self):
        for faults in (port_faults, jax_faults):
            inj = faults.FaultInjector(seed=SEED)
            inj.partition("pem-a", "broker")
            inj.partition("pem-b", "broker")
            assert inj.heal() == 2
            assert inj.heal() == 0
