"""The port's in-process message bus (``services/msgbus.py``) against the
JAX package's, case by case: the same publishes give the same
deliveries, request/reply and its timeouts, one dispatcher thread per
subscription, and the trace-context envelope stamped on nested
publishes. Every wait is a poll with a deadline of 5 s or less.
"""

import threading
import time

import pytest

from pixie_tpu.exec import tracectx as jax_tracectx
from pixie_tpu.services.msgbus import BusTimeout as JaxBusTimeout
from pixie_tpu.services.msgbus import MessageBus as JaxMessageBus
from pixie_tpu_torch.exec import tracectx
from pixie_tpu_torch.services.msgbus import BusTimeout, MessageBus

BUSES = {
    "port": (MessageBus, BusTimeout, tracectx),
    "jax": (JaxMessageBus, JaxBusTimeout, jax_tracectx),
}
CTX = {"trace_id": "ab" * 16, "span_id": "cd" * 8}


@pytest.fixture(params=sorted(BUSES))
def bus(request):
    cls, timeout_cls, ctxmod = BUSES[request.param]
    b = cls()
    try:
        yield b, timeout_cls, ctxmod
    finally:
        b.close()


def _wait_for(pred, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.005)
    return True


def _run_both(fn):
    """``fn(bus_cls, timeout_cls, ctxmod)`` on both buses: the results
    must be equal."""
    out = {}
    for name, (cls, timeout_cls, ctxmod) in BUSES.items():
        b = cls()
        try:
            out[name] = fn(b, timeout_cls, ctxmod)
        finally:
            b.close()
    assert out["port"] == out["jax"]
    return out["port"]


def test_fanout_and_order_match_jax():
    def run(b, _t, _c):
        got = {"a": [], "b": []}
        b.subscribe("t", got["a"].append)
        b.subscribe("t", got["b"].append)
        counts = [b.publish("t", {"i": i}) for i in range(50)]
        counts.append(b.publish("nobody", {"i": -1}))
        assert _wait_for(lambda: len(got["a"]) == len(got["b"]) == 50)
        return counts, got

    counts, got = _run_both(run)
    assert counts == [2] * 50 + [0]
    assert [m["i"] for m in got["a"]] == list(range(50))


def test_unsubscribe_stops_delivery_like_jax():
    def run(b, _t, _c):
        got = []
        sub = b.subscribe("t", got.append)
        b.publish("t", {"i": 0})
        assert _wait_for(lambda: len(got) == 1)
        sub.unsubscribe()
        return b.publish("t", {"i": 1}), got

    assert _run_both(run) == (0, [{"i": 0}])


def test_request_reply_matches_jax():
    def run(b, _t, _c):
        b.subscribe(
            "echo",
            lambda m: b.publish(m["_reply_to"], {"v": m["v"] * 2}),
        )
        return [b.request("echo", {"v": v}, timeout_s=5.0) for v in range(5)]

    assert _run_both(run) == [{"v": 2 * v} for v in range(5)]


@pytest.mark.parametrize("responder", [False, True])
def test_request_timeouts_match_jax(responder):
    def run(b, timeout_cls, _c):
        if responder:
            b.subscribe("slow", lambda m: None)  # never replies
        t0 = time.monotonic()
        with pytest.raises(timeout_cls) as ei:
            b.request("slow", {}, timeout_s=0.05)
        assert time.monotonic() - t0 < 5.0
        return str(ei.value).split(" ")[0:3]

    _run_both(run)


def test_bus_timeout_is_a_timeout_error(bus):
    b, timeout_cls, _c = bus
    with pytest.raises(TimeoutError):
        b.request("nobody", {}, timeout_s=0.01)
    assert issubclass(timeout_cls, TimeoutError)


def test_one_dispatcher_thread_per_subscription(bus):
    b, _t, _c = bus
    release = threading.Event()
    seen = []

    def slow(m):
        seen.append(("slow", threading.current_thread().name))
        release.wait(5.0)

    def fast(m):
        seen.append(("fast", threading.current_thread().name))

    b.subscribe("x", slow)
    b.subscribe("x", fast)
    try:
        b.publish("x", {})
        # The blocked handler does not hold up its sibling.
        assert _wait_for(lambda: len(seen) == 2)
    finally:
        release.set()
    names = {kind: name for kind, name in seen}
    assert names["slow"] == names["fast"] == "bus-sub-x"
    threads = [t for t in threading.enumerate() if t.name == "bus-sub-x"]
    assert len(threads) >= 2


def test_request_inbox_starts_no_thread(bus):
    b, _t, _c = bus
    b.subscribe("echo", lambda m: b.publish(m["_reply_to"], {"ok": 1}))
    assert b.request("echo", {}, timeout_s=5.0) == {"ok": 1}
    assert not [t for t in threading.enumerate()
                if t.name.startswith("bus-sub-_inbox")]


def test_handler_error_does_not_kill_delivery(bus):
    b, _t, _c = bus
    got = []

    def h(m):
        if m["i"] == 0:
            raise ValueError("boom")
        got.append(m["i"])

    b.subscribe("t", h)
    for i in range(3):
        b.publish("t", {"i": i})
    assert _wait_for(lambda: got == [1, 2])
    assert b._handler_errors_total == 1
    assert b.busz()["handler_errors_total"] == 1


def test_trace_context_stamped_like_jax():
    def run(b, _t, ctxmod):
        seen = []

        def relay(m):
            # The handler runs under the message's context, and a nested
            # publish carries it on.
            seen.append(("relay", ctxmod.current()))
            b.publish("leaf", {"hop": 2})

        b.subscribe("mid", relay)
        b.subscribe("leaf", lambda m: seen.append(("leaf", m.get("_trace_ctx"))))
        with ctxmod.bound(CTX):
            b.publish("mid", {"hop": 1})
        b.publish("leaf", {"hop": 0})  # outside any trace: no envelope
        assert _wait_for(lambda: len(seen) == 3)
        return sorted(seen, key=lambda x: (x[0], str(x[1])))

    got = _run_both(run)
    assert ("relay", CTX) in got and ("leaf", CTX) in got and ("leaf", None) in got


def test_trace_context_attach_and_extract_match_jax():
    bad = {"trace_id": "zz", "span_id": "cd" * 8}
    for mod in (tracectx, jax_tracectx):
        assert mod.extract(mod.attach({"a": 1}, CTX)) == CTX
        assert mod.attach({"a": 1}, bad) == {"a": 1}
        assert mod.extract({"_trace_ctx": bad}) is None
        stamped = {"a": 1, "_trace_ctx": dict(CTX)}
        other = {"trace_id": "01" * 16, "span_id": "02" * 8}
        assert mod.attach(stamped, other) is stamped  # the originator wins
    assert tracectx.TRACE_CTX_KEY == jax_tracectx.TRACE_CTX_KEY


def test_bus_stats_count_like_jax():
    def run(b, _t, _c):
        got = []
        b.subscribe("agent.a.execute", got.append)
        for i in range(4):
            b.publish("agent.a.execute", {"i": i})
        assert _wait_for(lambda: len(got) == 4)
        return sorted(
            (r["kind"], r["topic_class"], r["direction"], r["msgs"],
             r["errors"])
            for r in b.stats.snapshot()
        )

    assert _run_both(run) == [
        ("bus", "agent.execute", "deliver", 4, 0),
        ("bus", "agent.execute", "pub", 4, 0),
    ]
