"""The race suite of ``tests/test_stress.py`` on both packages.

Every shared-state surface is hammered from many threads, on the JAX
package and on the port, and the invariants that races would break are
asserted on each: no lost messages on the bus (8 publishers, 3
subscribers), no error under subscribe/unsubscribe churn, unique ASIDs
under concurrent register and heartbeat, six parallel queries on one
engine each counting every row, counts that only grow while appends race
queries, concurrent first compiles on fresh engines, and netbus
publishers that lose nothing while other clients connect and vanish.
The two packages' observations (message counts, agent counts, query
counts) must be equal. The engines are the port's on the CPU. On the
port alone, more threads than cores under a 1 us switch interval leave
the engine's in-flight count at 0.
"""

from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest

from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.services.msgbus import MessageBus as JaxMessageBus
from pixie_tpu.services.netbus import BusServer as JaxBusServer
from pixie_tpu.services.netbus import RemoteBus as JaxRemoteBus
from pixie_tpu.services.tracker import AgentTracker as JaxAgentTracker
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.services.msgbus import MessageBus
from pixie_tpu_torch.services.netbus import BusServer, RemoteBus
from pixie_tpu_torch.services.tracker import AgentTracker

N_THREADS = 8
N_MSGS = 200

PKGS = {
    "jax": types.SimpleNamespace(
        MessageBus=JaxMessageBus, AgentTracker=JaxAgentTracker,
        BusServer=JaxBusServer, RemoteBus=JaxRemoteBus,
        engine=lambda window_rows: JaxEngine(window_rows=window_rows)),
    "port": types.SimpleNamespace(
        MessageBus=MessageBus, AgentTracker=AgentTracker,
        BusServer=BusServer, RemoteBus=RemoteBus,
        engine=lambda window_rows: Engine(window_rows=window_rows,
                                          device="cpu")),
}

COUNT_Q = (
    "import px\ndf = px.DataFrame(table='t')\n"
    "df = df.groupby('v').agg(n=('v', px.count))\npx.display(df)"
)


def _both(case) -> dict:
    """Run ``case(pkg)`` on each package; the observations must agree."""
    got = {name: case(p) for name, p in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


class TestMsgBusRaces:
    def test_concurrent_publish_fanout_no_loss(self):
        def case(p):
            bus = p.MessageBus()
            got = []
            lock = threading.Lock()

            def on_msg(m):
                with lock:
                    got.append(m["i"])

            subs = [bus.subscribe("t", on_msg) for _ in range(3)]

            def pub(base):
                for i in range(N_MSGS):
                    bus.publish("t", {"i": base + i})

            threads = [
                threading.Thread(target=pub, args=(k * N_MSGS,))
                for k in range(N_THREADS)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            deadline = time.time() + 10
            want = 3 * N_THREADS * N_MSGS
            while time.time() < deadline and len(got) < want:
                time.sleep(0.01)
            # Every message reaches every subscriber.
            assert len(got) == want
            for s in subs:
                s.unsubscribe()
            bus.close()
            return sorted(got)

        _both(case)

    def test_subscribe_unsubscribe_churn_under_publish(self):
        def case(p):
            bus = p.MessageBus()
            stop = threading.Event()
            errors = []

            def churn():
                try:
                    while not stop.is_set():
                        s = bus.subscribe("c", lambda m: None)
                        s.unsubscribe()
                except Exception as e:  # pragma: no cover - the failure signal
                    errors.append(e)

            def pub():
                try:
                    while not stop.is_set():
                        bus.publish("c", {})
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            threads = [threading.Thread(target=churn) for _ in range(4)] + [
                threading.Thread(target=pub) for _ in range(4)
            ]
            for t in threads:
                t.start()
            time.sleep(0.5)
            stop.set()
            for t in threads:
                t.join()
            bus.close()
            assert not errors
            return errors

        _both(case)


class TestTrackerRaces:
    def test_concurrent_register_heartbeat_expire(self):
        def case(p):
            bus = p.MessageBus()
            tracker = p.AgentTracker(bus, expiry_s=60.0,
                                     check_interval_s=60.0)
            try:

                def agent_life(k):
                    for _ in range(50):
                        bus.publish("agent.register", {
                            "agent_id": f"a-{k}",
                            "accepts_remote_sources": False,
                            "schemas": {},
                        })
                        bus.publish("agent.heartbeat", {"agent_id": f"a-{k}"})

                threads = [
                    threading.Thread(target=agent_life, args=(k,))
                    for k in range(N_THREADS)
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                deadline = time.time() + 5
                while (time.time() < deadline
                       and len(tracker.agent_ids()) < N_THREADS):
                    time.sleep(0.01)
                assert len(tracker.agent_ids()) == N_THREADS
                # ASIDs stay unique under concurrent registration.
                asids = [a["asid"] for a in tracker.agents_info()]
                assert len(set(asids)) == len(asids)
                return sorted(tracker.agent_ids()), len(set(asids))
            finally:
                tracker.close()
                bus.close()

        _both(case)


class TestEngineConcurrentQueries:
    def test_parallel_queries_one_engine(self):
        """Six concurrent read queries over a static table each count
        every row."""
        def case(p):
            eng = p.engine(1 << 12)
            n = 20_000
            rng = np.random.default_rng(0)
            eng.append_data("t", {
                "time_": np.arange(n, dtype=np.int64),
                "v": rng.integers(0, 50, n),
            })
            first = eng.execute_query(COUNT_Q)["output"].to_pydict()
            results, errors = [], []

            def run():
                try:
                    out = eng.execute_query(COUNT_Q)["output"].to_pydict()
                    results.append(int(out["n"].sum()))
                except Exception as e:  # pragma: no cover
                    errors.append(e)

            threads = [threading.Thread(target=run) for _ in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errors
            assert results == [n] * 6
            return results, sorted(zip(first["v"].tolist(),
                                       first["n"].tolist()))

        _both(case)

    def test_ingest_during_queries_monotonic(self):
        """Counts only grow while appends race queries (no torn
        windows)."""
        def case(p):
            eng = p.engine(1 << 10)
            eng.append_data("t", {
                "time_": np.arange(100, dtype=np.int64),
                "v": np.zeros(100, dtype=np.int64),
            })
            eng.execute_query(COUNT_Q)
            stop = threading.Event()
            errors = []

            def ingest():
                i = 100
                while not stop.is_set():
                    eng.append_data("t", {
                        "time_": np.arange(i, i + 100, dtype=np.int64),
                        "v": np.zeros(100, dtype=np.int64),
                    })
                    i += 100
                    time.sleep(0.005)

            t = threading.Thread(target=ingest)
            t.start()
            seen = 0
            try:
                for _ in range(10):
                    try:
                        out = eng.execute_query(COUNT_Q)["output"].to_pydict()
                    except Exception as e:  # pragma: no cover
                        errors.append(e)
                        break
                    total = int(out["n"].sum())
                    assert total >= seen, (
                        f"count went backwards: {total} < {seen}")
                    assert total % 100 == 0, f"torn append: {total}"
                    seen = total
            finally:
                stop.set()
                t.join()
            assert not errors
            assert seen >= 100
            return True

        _both(case)


def test_inflight_count_under_many_threads():
    """More threads than cores query one port engine with the interpreter
    switching threads every microsecond: every answer counts every row,
    ``max_inflight`` never exceeds the threads, and the in-flight count
    returns to 0 (a lost update under its lock would leave it off)."""
    import os
    import sys

    n_threads = (os.cpu_count() or 4) + 4
    eng = PKGS["port"].engine(1 << 10)
    n = 8000
    eng.append_data("t", {
        "time_": np.arange(n, dtype=np.int64),
        "v": np.arange(n, dtype=np.int64) % 13,
    })
    eng.execute_query(COUNT_Q)
    eng.max_inflight = 0
    totals, errors = [], []

    def run():
        try:
            for _ in range(3):
                out = eng.execute_query(COUNT_Q)["output"].to_pydict()
                totals.append(int(out["n"].sum()))
        except Exception as e:  # pragma: no cover - the failure signal
            errors.append(e)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert totals == [n] * (3 * n_threads)
    assert 1 <= eng.max_inflight <= n_threads
    assert eng._inflight == 0
    assert not eng.tracer.in_flight()


class TestFragmentCacheRaces:
    def test_concurrent_compile_same_query(self):
        """Parallel first compiles of one script on fresh engines. The
        JAX side clears its jitted-fragment cache first; the port keeps no
        jitted fragments, and its fresh engines share the planner's and
        the analysis passes' memos and the program registry instead."""
        from pixie_tpu.exec.fragment import _FRAGMENT_CACHE

        def case(p):
            if p is PKGS["jax"]:
                _FRAGMENT_CACHE.clear()
            engines = []
            for _ in range(4):
                e = p.engine(1 << 10)
                e.append_data("t", {
                    "time_": np.arange(500, dtype=np.int64),
                    "v": np.arange(500, dtype=np.int64) % 7,
                })
                engines.append(e)
            errors, totals = [], []

            def run(e):
                try:
                    out = e.execute_query(COUNT_Q)["output"].to_pydict()
                    totals.append(int(out["n"].sum()))
                except Exception as ex:  # pragma: no cover
                    errors.append(ex)

            threads = [threading.Thread(target=run, args=(e,))
                       for e in engines]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errors
            assert totals == [500] * 4
            return totals

        _both(case)


class TestNetbusChurn:
    """Concurrent remote clients publishing while other clients connect,
    subscribe and disconnect without a goodbye mid-traffic."""

    @pytest.mark.parametrize("pkg", list(PKGS))
    def test_clients_churn_under_publish(self, pkg):
        p = PKGS[pkg]
        bus = p.MessageBus()
        server = p.BusServer(bus)
        got = []
        bus.subscribe("t", got.append)
        errors = []
        stop = threading.Event()

        def publisher(i):
            try:
                rb = p.RemoteBus("127.0.0.1", server.port)
                for k in range(50):
                    rb.publish("t", {"src": i, "k": k})
                rb.close()
            except Exception as e:  # pragma: no cover
                errors.append(("pub", i, repr(e)))

        def churner():
            # Connect, subscribe, vanish without unsubscribing: the
            # server must reap dead forwarders and drop no other
            # client's messages.
            while not stop.is_set():
                try:
                    rb = p.RemoteBus("127.0.0.1", server.port)
                    rb.subscribe("t", lambda m: None)
                    time.sleep(0.002)
                    rb.sock.close()
                except Exception:
                    pass

        churn_threads = [threading.Thread(target=churner, daemon=True)
                         for _ in range(3)]
        for t in churn_threads:
            t.start()
        pubs = [threading.Thread(target=publisher, args=(i,))
                for i in range(4)]
        for t in pubs:
            t.start()
        for t in pubs:
            t.join(timeout=30)
            assert not t.is_alive(), "publisher hung"
        stop.set()
        for t in churn_threads:
            t.join(timeout=5)
        try:
            assert not errors, errors
            deadline = time.time() + 5
            while len(got) < 200 and time.time() < deadline:
                time.sleep(0.02)
            assert len(got) == 200, len(got)
            per_src = {}
            for m in got:
                per_src.setdefault(m["src"], []).append(m["k"])
            for i in range(4):
                # Per-connection order holds (one TCP stream).
                assert per_src[i] == list(range(50)), i
        finally:
            server.close()
            bus.close()
