"""Runtime lock-order validation on the port (``analysis/lockdep.py``)
against the JAX package's.

- The JAX ``tests/test_lockdep.py`` classes on the port's module: cycle
  detection, RLock reentrancy and ``Condition.wait``, enable/disable,
  real locks under lockdep.
- Scripted acquisition sequences: the same steps give the same verdict
  under both modules (the step that raises, its first message line, the
  edges recorded and what stays held).
- A port cluster query (2 PEMs, a Kelvin, a broker) built under the
  port's lockdep records no violation, and a windowed engine query
  reaches the prefetch thread's ``Condition.wait`` under it.

Only one lockdep may patch ``threading`` at a time: the cases that
enable the port's module run inside this file's fixture, which enables
and disables it around each case. Under ``PIXIE_TPU_LOCKDEP=1`` the JAX
conftest has already enabled the JAX lockdep, and those cases skip.
(Under it torch itself fails to import: ``concurrent.futures.thread``
registers its lock for fork, which the JAX wrapper cannot do.)
"""

from __future__ import annotations

import os
import queue
import threading
import time

import numpy as np
import pytest

from pixie_tpu.analysis import lockdep as jax_lockdep
from pixie_tpu_torch.analysis import lockdep
from pixie_tpu_torch.analysis.lockdep import LockDep, LockOrderError

JAX_LOCKDEP_ON = bool(os.environ.get("PIXIE_TPU_LOCKDEP"))
needs_threading = pytest.mark.skipif(
    JAX_LOCKDEP_ON,
    reason="PIXIE_TPU_LOCKDEP=1: the JAX lockdep patches threading for the "
           "whole run, and only one lockdep may patch it at a time",
)


@pytest.fixture
def dep():
    return LockDep()


@pytest.fixture
def enabled():
    """The port's lockdep enabled for one case, disabled after it."""
    assert not jax_lockdep.enabled() and not lockdep.enabled()
    st = lockdep.enable()
    try:
        yield st
    finally:
        lockdep.disable()
    assert threading.Lock is lockdep._REAL_LOCK


# -- scripted sequences, both modules ----------------------------------------

#: Each script: lock kinds, then steps run in order. A step is
#: (thread, op, lock[, blocking]) with op "acq" or "rel"; thread "main"
#: or "t1" (t1's steps run on one helper thread, in order, between the
#: main thread's neighbouring steps).
SCRIPTS = {
    "abba": ({"a": "lock", "b": "lock"}, [
        ("t1", "acq", "a"), ("t1", "acq", "b"), ("t1", "rel", "b"),
        ("t1", "rel", "a"),
        ("main", "acq", "b"), ("main", "acq", "a"),
    ]),
    "transitive": ({"a": "lock", "b": "lock", "c": "lock"}, [
        ("main", "acq", "a"), ("main", "acq", "b"), ("main", "rel", "b"),
        ("main", "rel", "a"), ("main", "acq", "b"), ("main", "acq", "c"),
        ("main", "rel", "c"), ("main", "rel", "b"),
        ("main", "acq", "c"), ("main", "acq", "a"),
    ]),
    "consistent": ({"a": "lock", "b": "lock"}, [
        ("main", "acq", "a"), ("main", "acq", "b"), ("main", "rel", "b"),
        ("main", "rel", "a")] * 3),
    "trylocks": ({"a": "lock", "b": "lock"}, [
        ("main", "acq", "a"), ("main", "acq", "b", False),
        ("main", "rel", "b"), ("main", "rel", "a"),
        ("main", "acq", "b"), ("main", "acq", "a", False),
        ("main", "rel", "a"), ("main", "rel", "b"),
    ]),
    "self_deadlock": ({"a": "lock"}, [
        ("main", "acq", "a"), ("main", "acq", "a"),
    ]),
    "trylock_of_held": ({"a": "lock"}, [
        ("main", "acq", "a"), ("main", "acq", "a", False),
        ("main", "rel", "a"), ("main", "acq", "a"), ("main", "rel", "a"),
    ]),
    "rlock_reentrant": ({"r": "rlock", "a": "lock"}, [
        ("main", "acq", "r"), ("main", "acq", "r"), ("main", "acq", "a"),
        ("main", "rel", "a"), ("main", "rel", "r"), ("main", "rel", "r"),
    ]),
    "rlock_cycle": ({"r": "rlock", "a": "lock"}, [
        ("main", "acq", "r"), ("main", "acq", "a"), ("main", "rel", "a"),
        ("main", "rel", "r"), ("main", "acq", "a"), ("main", "acq", "r"),
    ]),
    "cross_thread_release": ({"sig": "lock", "o": "lock"}, [
        ("t1", "acq", "sig"), ("main", "rel", "sig"),
        ("t1", "acq", "o"), ("t1", "acq", "sig"), ("t1", "rel", "sig"),
        ("t1", "rel", "o"), ("main", "acq", "sig"), ("main", "acq", "o"),
    ]),
}


def _make(st, kind):
    # One line for both modules: lock names carry this creation site.
    return st.make_lock() if kind == "lock" else st.make_rlock()


def _run_script(mod, name):
    kinds, steps = SCRIPTS[name]
    st = mod.LockDep()
    locks = {n: _make(st, k) for n, k in kinds.items()}
    jobs: "queue.Queue" = queue.Queue()
    done: "queue.Queue" = queue.Queue()

    def helper():
        while True:
            step = jobs.get()
            if step is None:
                return
            done.put(_step(locks, step))

    t = threading.Thread(target=helper, daemon=True)
    t.start()
    verdict = None
    held = {}
    try:
        for i, step in enumerate(steps):
            if step[0] == "t1":
                jobs.put(step)
                out = done.get(timeout=5.0)
            else:
                out = _step(locks, step)
            if out is not None:
                verdict = (i, out)
                break
    finally:
        jobs.put(None)
        t.join(5.0)
    held = [(n.split("@")[0], c) for n, c in st.held()]
    edges = sorted(st.edges)
    return {
        "verdict": verdict,
        "edges": edges,
        "held": held,
        "violations": len(st.violations),
        "tracked": st.tracked_locks,
    }


def _step(locks, step):
    """One acquire or release; returns the error's first line, the
    trylock's False, or None."""
    _thread, op, name, *blocking = step
    lk = locks[name]
    if op == "rel":
        lk.release()
        return None
    try:
        ok = lk.acquire(blocking[0] if blocking else True)
    except (LockOrderError, jax_lockdep.LockOrderError) as e:
        return ("raised", type(e).__name__, str(e).splitlines()[0])
    return None if ok else ("refused",)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_verdicts_equal_jax(name):
    port = _run_script(lockdep, name)
    jax = _run_script(jax_lockdep, name)
    assert port == jax
    # cross_thread_release: the handoff leaves no stale entry on t1
    # (its later o -> sig is clean), and main's sig -> o then inverts it.
    expect_raise = name in ("abba", "transitive", "self_deadlock",
                            "rlock_cycle", "cross_thread_release")
    assert (port["verdict"] is not None
            and port["verdict"][1][0] == "raised") == expect_raise
    assert port["violations"] == int(expect_raise)


# -- the JAX test classes, on the port's module -------------------------------

class TestCycleDetection:
    def test_abba_raises_with_both_stack_pairs(self, dep):
        a = dep.make_lock()
        b = dep.make_lock()

        def fwd():
            with a:
                with b:
                    pass

        t = threading.Thread(target=fwd)
        t.start()
        t.join()
        with pytest.raises(LockOrderError) as ei:
            with b:
                with a:
                    pass
        msg = str(ei.value)
        assert "lock-order cycle closed" in msg
        assert msg.count("test_torch_lockdep.py") >= 4, msg
        assert "fwd" in msg
        assert len(dep.violations) == 1

    def test_transitive_cycle_through_third_lock(self, dep):
        a, b, c = dep.make_lock(), dep.make_lock(), dep.make_lock()
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with pytest.raises(LockOrderError) as ei:
            with c:
                with a:
                    pass
        assert "prior observation" in str(ei.value)
        assert len(dep.violations) == 1

    def test_consistent_order_is_clean(self, dep):
        a, b = dep.make_lock(), dep.make_lock()
        for _ in range(3):
            with a:
                with b:
                    pass
        assert dep.violations == []
        assert sorted(dep.edges) == [(1, 2)]

    def test_trylock_never_adds_edges(self, dep):
        a, b = dep.make_lock(), dep.make_lock()
        with a:
            assert b.acquire(blocking=False)
            b.release()
        with b:
            assert a.acquire(blocking=False)
            a.release()
        assert dep.edges == {} and dep.violations == []

    def test_self_deadlock_on_nonreentrant_lock(self, dep):
        a = dep.make_lock()
        with pytest.raises(LockOrderError) as ei:
            with a:
                a.acquire()
        assert "self-deadlock" in str(ei.value)

    def test_trylock_of_held_lock_is_a_legal_probe(self, dep):
        a = dep.make_lock()
        with a:
            assert a.acquire(blocking=False) is False
        assert dep.violations == []
        with a:
            pass
        assert dep.held() == []

    def test_cross_thread_release_clears_the_holder_entry(self, dep):
        sig = dep.make_lock()
        other = dep.make_lock()
        idents = {}
        phase2 = threading.Event()
        done = {}

        def owner():
            idents["a"] = threading.get_ident()
            sig.acquire()
            phase2.wait(5.0)
            try:
                with other:
                    with sig:
                        pass
                done["ok"] = True
            except LockOrderError as e:
                done["err"] = e

        t = threading.Thread(target=owner)
        t.start()
        deadline = time.monotonic() + 5.0
        while "a" not in idents or not dep.held(idents.get("a", -1)):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        sig.release()
        assert dep.held(idents["a"]) == []
        phase2.set()
        t.join(5.0)
        assert done.get("ok"), done.get("err")
        assert dep.violations == []


class TestRLockAndCondition:
    def test_rlock_reentrancy_is_clean(self, dep):
        r = dep.make_rlock()
        with r:
            with r:
                with r:
                    assert dep.held() == [(r._dep_name, 3)]
        assert dep.held() == []
        assert dep.violations == [] and dep.edges == {}

    def test_condition_wait_releases_its_edge(self, dep):
        cond = dep.make_condition()
        in_wait = threading.Event()
        woke = threading.Event()
        idents = {}

        def consumer():
            idents["t"] = threading.get_ident()
            with cond:
                in_wait.set()
                cond.wait(timeout=10.0)
                idents["held_after_wake"] = dep.held()
            woke.set()

        t = threading.Thread(target=consumer)
        t.start()
        assert in_wait.wait(5.0)
        deadline = time.monotonic() + 5.0
        while dep.held(idents["t"]) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert dep.held(idents["t"]) == []
        with cond:
            cond.notify()
        assert woke.wait(5.0)
        t.join(5.0)
        assert idents["held_after_wake"]
        assert dep.held(idents["t"]) == []
        assert dep.violations == []

    def test_wait_window_reacquire_still_orders(self, dep):
        lk = dep.make_lock()
        cond = dep.make_condition(lk)
        c = dep.make_lock()
        done = {}

        def waiter():
            done["ident"] = threading.get_ident()
            try:
                with cond:
                    with c:
                        cond.wait(timeout=0.2)
            except LockOrderError as e:
                done["err"] = e

        t = threading.Thread(target=waiter)
        t.start()
        t.join(5.0)
        assert not t.is_alive()
        assert "lock-order cycle closed" in str(done["err"])
        assert dep.violations == [done["err"]]
        assert dep.held(done["ident"]) == []
        assert not lk._inner.locked() and not c._inner.locked()


@needs_threading
class TestEnableDisable:
    def test_enable_patches_and_scoped_active_restores(self):
        with lockdep.active() as st:
            lk = threading.Lock()
            rl = threading.RLock()
            assert type(lk).__name__ == "_DepLock"
            assert type(rl).__name__ == "_DepRLock"
            with lk:
                pass
            with rl:
                pass
            assert st.tracked_locks >= 2
        assert threading.Lock is lockdep._REAL_LOCK
        assert threading.RLock is lockdep._REAL_RLOCK
        assert threading.Condition is lockdep._REAL_CONDITION

    def test_patched_condition_default_lock_is_tracked(self, enabled):
        before = enabled.tracked_locks
        cond = threading.Condition()
        with cond:
            cond.notify_all()
        assert enabled.tracked_locks == before + 1

    def test_no_overhead_when_disabled(self):
        assert threading.Lock is lockdep._REAL_LOCK
        lk = threading.Lock()
        assert type(lk) is type(lockdep._REAL_LOCK())
        assert not hasattr(lk, "_dep_serial")

    def test_lock_made_under_lockdep_reinits_at_fork(self, enabled):
        """A deliberate difference from the JAX module: a wrapped lock
        has ``_at_fork_reinit``, so a module that registers a lock for
        fork (``concurrent.futures.thread`` at import) can load while
        lockdep is on. The JAX wrapper has none."""
        lk = threading.Lock()
        lk.acquire()
        lk._at_fork_reinit()
        assert not lk._inner.locked()
        assert not hasattr(jax_lockdep.LockDep().make_lock(),
                           "_at_fork_reinit")

    def test_enable_is_idempotent_and_disable_returns_the_state(self):
        st = lockdep.enable()
        try:
            assert lockdep.enable() is st and lockdep.state() is st
            assert lockdep.enabled()
        finally:
            assert lockdep.disable() is st
        assert not lockdep.enabled() and lockdep.state() is None


@needs_threading
class TestRealLocksUnderLockdep:
    def test_queue_and_event_survive_wrapping(self, enabled):
        q = queue.Queue(maxsize=2)
        q.put(1)
        q.put(2, timeout=1.0)
        assert q.get() == 1
        assert q.get(timeout=1.0) == 2
        with pytest.raises(queue.Empty):
            q.get(timeout=0.05)
        ev = threading.Event()
        assert not ev.wait(0.01)
        ev.set()
        assert ev.wait(0.01)
        assert enabled.violations == []

    def test_engine_query_reaches_condition_wait(self, enabled):
        """A windowed query with the prefetch thread (pipeline depth 2,
        residency off, 8 host windows): the window queue is a
        ``queue.Queue`` built over patched locks, so its handoffs go
        through the tracked ``Condition.wait``; the answer equals numpy
        and no order is violated."""
        from pixie_tpu_torch.config import override_flag
        from pixie_tpu_torch.exec.engine import Engine

        waits = []
        real = enabled.wait_release

        def counting(lock):
            waits.append(threading.current_thread().name)
            return real(lock)

        enabled.wait_release = counting
        eng = Engine(window_rows=1 << 10, device="cpu")
        v = np.arange(8192, dtype=np.int64) % 7
        eng.append_data("t", {"time_": np.arange(8192, dtype=np.int64),
                              "v": v})
        with override_flag("device_residency", False), \
                override_flag("pipeline_depth", 2):
            out = eng.execute_query(
                "import px\n"
                "df = px.DataFrame(table='t')\n"
                "df = df.groupby('v').agg(n=('v', px.count))\n"
                "px.display(df, 'o')\n")
        d = out["o"].to_pydict()
        assert dict(zip(d["v"], d["n"])) == {
            k: int((v == k).sum()) for k in range(7)}
        assert enabled.tracked_locks > 0
        assert waits, "no Condition.wait went through lockdep"
        assert enabled.violations == []

    def test_cluster_query_runs_clean_under_lockdep(self, enabled):
        """2 PEMs, a Kelvin, a tracker and a broker on one bus, all built
        under the port's lockdep: a distributed group-by equals numpy and
        records no violation."""
        from pixie_tpu_torch.exec.engine import Engine
        from pixie_tpu_torch.services import (
            AgentTracker, KelvinAgent, MessageBus, PEMAgent, QueryBroker)

        bus = MessageBus()
        tracker = AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
        agents, broker = [], None
        rng = np.random.default_rng(3)
        want = {}
        try:
            for i in range(2):
                pem = PEMAgent(bus, f"pem-{i}",
                               engine=Engine(window_rows=1 << 10,
                                             device="cpu"),
                               heartbeat_interval_s=0.05).start()
                agents.append(pem)
                n = 1500 + 300 * i
                svc = [f"svc-{(i + j) % 3}" for j in range(n)]
                pem.append_data("http_events", {
                    "time_": np.arange(n, dtype=np.int64),
                    "latency_ns": rng.integers(1000, 10**6, n),
                    "service": svc,
                })
                for s_ in svc:
                    want[s_] = want.get(s_, 0) + 1
                pem._register()
            agents.append(KelvinAgent(
                bus, "kelvin-0",
                engine=Engine(window_rows=1 << 10, device="cpu"),
                heartbeat_interval_s=0.05).start())
            deadline = time.monotonic() + 5.0
            while len(tracker.agent_ids()) < 3 or sum(
                    a.has_table("http_events")
                    for a in tracker.distributed_state().pems) < 2:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            broker = QueryBroker(bus, tracker)
            res = broker.execute_script(
                "import px\n"
                "df = px.DataFrame(table='http_events')\n"
                "df = df.groupby('service').agg(n=('latency_ns', px.count))\n"
                "px.display(df, 'out')\n", timeout_s=30.0)
            d = res["tables"]["out"].to_pydict()
            assert dict(zip(d["service"], (int(x) for x in d["n"]))) == want
            assert res["partial"] is False
        finally:
            for a in agents:
                a.stop()
            if broker is not None:
                broker.close()
            tracker.close()
            bus.close()
        assert enabled.tracked_locks > 50
        assert len(enabled.edges) > 0
        assert enabled.violations == []
