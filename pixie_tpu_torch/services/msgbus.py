"""In-process message bus with NATS pub/sub semantics.

Reference parity: ``src/common/event/nats.h:36-60`` (C++ NATS connector)
and the Go ``msgbus`` wrapper (``src/shared/services/msgbus``) — topics,
fan-out to every subscriber, asynchronous delivery. Each subscription
owns a queue + dispatcher thread so a slow handler never blocks
publishers or sibling subscribers (NATS's per-subscription pending
buffer). Swapping in a real NATS/gRPC transport means reimplementing
this one class against sockets; everything above it is transport-blind.

Transport-tier telemetry (``bus_telemetry`` flag, services/busstats.py):
the bus stamps per-topic-class publish/deliver/byte counters,
publish-to-handler-entry dispatcher-lag and handler service-time
histograms, per-subscription queue-depth high-water marks (the
backpressure signal), handler-error counts, and a slow-handler log —
monotonic clock reads only on the hot path, served via ``busz()``.

A copy of the JAX package's ``services/msgbus.py`` without the fault
injector's hook (fault injection is a later slice of the port).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable

from ..config import get_flag
from ..exec import tracectx
from .busstats import BusStats, HANDLER_ERROR_RING, topic_class


class Subscription:
    def __init__(self, bus: "MessageBus", topic: str, fn: Callable):
        self.bus = bus
        self.topic = topic
        self.fn = fn
        self._q: queue.Queue = queue.Queue()
        self._alive = True
        # Stamping is decided once at subscribe time (the bus's stats
        # object never changes after construction), so queue items are
        # uniformly raw messages or (msg, enqueue_monotonic) pairs.
        self._cls = topic_class(topic)
        self._hw = 0
        # Named for observability (and the ack-thread regression test):
        # one dispatcher thread per subscription, identifiable by topic.
        self._thread = threading.Thread(
            target=self._run, name=f"bus-sub-{topic}", daemon=True
        )
        self._thread.start()

    def _run(self):
        st = self.bus.stats
        while True:
            item = self._q.get()
            if item is _CLOSE:
                return
            if st is not None:
                msg, enq_t = item
                t0 = time.monotonic()
                lag_s = t0 - enq_t
            else:
                msg = item
            err = False
            try:
                # Distributed-trace propagation: bind the message's
                # context envelope (if any) around the handler so work
                # it triggers — including Engine query traces — parents
                # under the publisher's span (tracectx.py).
                with tracectx.bound(tracectx.extract(msg)):
                    self.fn(msg)
            except Exception as e:  # handler errors must not kill delivery
                err = True
                self.bus._on_handler_error(self.topic, e)
            if st is not None:
                st.on_handled(
                    self._cls, self.topic, lag_s,
                    time.monotonic() - t0, error=err,
                )

    def _deliver(self, msg, nbytes: int = 0):
        if not self._alive:
            return
        st = self.bus.stats
        if st is not None:
            depth = self._q.qsize() + 1
            if depth > self._hw:
                self._hw = depth
            st.on_deliver(self._cls, nbytes, depth)
            self._q.put((msg, time.monotonic()))
        else:
            self._q.put(msg)

    def unsubscribe(self):
        self._alive = False
        self.bus._remove(self)
        self._q.put(_CLOSE)


class _OneShotInbox:
    """Thread-less subscription for request/reply inboxes: delivery
    goes straight into the waiter's queue on the PUBLISHER's thread —
    no dispatcher thread, no close sentinel. Safe because the waiter
    is already blocked on the queue and a reply handler's trace context
    travels inside the message envelope, not the delivery thread.
    Quacks like Subscription where the bus touches it (``.topic``,
    ``._deliver``, ``.unsubscribe``)."""

    __slots__ = ("bus", "topic", "_q", "_alive", "_cls")

    def __init__(self, bus: "MessageBus", topic: str, q: queue.Queue):
        self.bus = bus
        self.topic = topic
        self._q = q
        self._alive = True
        self._cls = topic_class(topic)

    def _deliver(self, msg, nbytes: int = 0):
        if not self._alive:
            return
        st = self.bus.stats
        if st is not None:
            st.on_deliver(self._cls, nbytes, self._q.qsize() + 1)
        self._q.put(msg)

    def unsubscribe(self):
        self._alive = False
        self.bus._remove(self)


_CLOSE = object()


class BusTimeout(TimeoutError):
    """Uniform request/reply timeout across bus transports.

    Both ``MessageBus.request`` and ``netbus.RemoteBus.request`` raise
    THIS (never a bare ``TimeoutError``) so broker/agent retry logic can
    catch one exception type regardless of transport."""


class MessageBus:
    def __init__(self):
        self._lock = threading.Lock()
        self._subs: dict[str, list] = {}
        # Bounded ring of the last HANDLER_ERROR_RING failures (topic,
        # exception, unix_ns) — a long-lived bus under sustained handler
        # failure must not leak; the true cumulative count lives in
        # _handler_errors_total / pixie_bus_handler_errors_total.
        self.handler_errors: deque = deque(maxlen=HANDLER_ERROR_RING)
        self._handler_errors_total = 0
        self.stats: BusStats | None = (
            BusStats() if get_flag("bus_telemetry") else None
        )

    def subscribe(self, topic: str, fn: Callable) -> Subscription:
        sub = Subscription(self, topic, fn)
        with self._lock:
            self._subs.setdefault(topic, []).append(sub)
        return sub

    def publish(self, topic: str, msg: dict) -> int:
        """Fan out to all subscribers; returns the number delivered to.

        Trace-context envelope: a publish from inside a traced scope
        (an explicit ``tracectx.bound`` or a handler delivering a
        context-stamped message) stamps the ambient context onto the
        message — on a COPY, so retried publishes of a shared dict and
        the caller's object are never mutated."""
        st = self.stats
        nbytes = st.on_publish(topic, msg)[1] if st is not None else 0
        msg = tracectx.attach(msg)
        return self._fanout(topic, msg, nbytes)

    def _fanout(self, topic: str, msg: dict, nbytes: int = 0) -> int:
        with self._lock:
            subs = list(self._subs.get(topic, []))
        for s in subs:
            s._deliver(msg, nbytes)
        return len(subs)

    def request(self, topic: str, msg: dict, timeout_s: float = 5.0) -> dict:
        """NATS request/reply: publish with a one-shot ``_reply_to`` inbox
        and block for the response (the UDTF -> MDS stub call pattern).

        The inbox is a thread-less ``_OneShotInbox`` — the reply lands
        directly in this waiter's queue instead of spinning up (and
        tearing down) a dispatcher thread per call."""
        import uuid as _uuid

        st = self.stats
        inbox = f"_inbox.{_uuid.uuid4().hex}"
        q: queue.Queue = queue.Queue()
        sub = _OneShotInbox(self, inbox, q)
        with self._lock:
            self._subs.setdefault(inbox, []).append(sub)
        t0 = time.monotonic()
        try:
            n = self.publish(topic, {**msg, "_reply_to": inbox})
            if n == 0:
                if st is not None:
                    st.on_request("local", time.monotonic() - t0,
                                  error=True)
                raise BusTimeout(f"no responder on {topic!r}")
            reply = q.get(timeout=timeout_s)
            if st is not None:
                st.on_request("local", time.monotonic() - t0)
            return reply
        except queue.Empty:
            if st is not None:
                st.on_request("local", time.monotonic() - t0, error=True)
            raise BusTimeout(
                f"no reply from {topic!r} in {timeout_s}s"
            ) from None
        finally:
            sub.unsubscribe()

    def _remove(self, sub):
        with self._lock:
            lst = self._subs.get(sub.topic, [])
            if sub in lst:
                lst.remove(sub)

    def _on_handler_error(self, topic: str, e: Exception):
        with self._lock:
            self.handler_errors.append((topic, e, time.time_ns()))
            self._handler_errors_total += 1

    def busz(self) -> dict:
        """The ``/debug/busz`` surface for this bus: cumulative stat
        rows, live per-topic-class queue state, and the recent
        handler-error ring."""
        st = self.stats
        with self._lock:
            subs = [(t, list(lst)) for t, lst in self._subs.items()]
            recent = [
                {"topic": t, "error": repr(e), "unix_ns": ns}
                for t, e, ns in self.handler_errors
            ]
            errors_total = self._handler_errors_total
        queues: dict[str, dict] = {}
        for topic, lst in subs:
            cls = topic_class(topic)
            ent = queues.setdefault(
                cls, {"subscriptions": 0, "depth": 0, "high_water": 0}
            )
            for s in lst:
                ent["subscriptions"] += 1
                ent["depth"] = max(ent["depth"], s._q.qsize())
                ent["high_water"] = max(
                    ent["high_water"], getattr(s, "_hw", 0)
                )
        if st is not None:
            for cls, hw in st.queue_high_water().items():
                ent = queues.setdefault(
                    cls, {"subscriptions": 0, "depth": 0, "high_water": 0}
                )
                ent["high_water"] = max(ent["high_water"], hw)
        return {
            "rows": st.snapshot() if st is not None else [],
            "queues": queues,
            "handler_errors_total": errors_total,
            "recent_errors": recent,
        }

    def close(self):
        with self._lock:
            subs = [s for lst in self._subs.values() for s in lst]
        for s in subs:
            s.unsubscribe()
