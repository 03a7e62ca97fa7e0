"""Transport-tier telemetry: counters/histograms for the message path.

Every tier of the engine has an observability surface — traces,
device programs, storage freshness, CPU profiles — except the bus the
whole cluster rides. ``BusStats`` is that surface: one lock-guarded
accumulator per bus (``MessageBus`` and ``RemoteBus`` each own one)
that the hot publish/deliver path stamps with monotonic clock reads
only, mirrored into the process-wide Prometheus registry and folded
into the ``__bus__`` telemetry ring on the heartbeat cadence by
``telemetry.BusStatsCollector``.

Cardinality discipline: raw topics embed query ids and agent ids
(``query.{qid}.ack``, ``agent.{aid}.execute``), so every metric label
uses :func:`topic_class` — a pure normalizer to a BOUNDED class set —
and the accumulator hard-caps distinct tracked keys at
``MAX_TRACKED_KEYS``, overflowing into ``"other"`` rather than growing
without bound on a hostile topic stream.

Lock discipline (pxlock): registry mirrors are updated OUTSIDE the
``BusStats`` lock — the accumulator lock and the metrics-registry lock
are never nested, so neither lockdep nor the static lock-order rule
ever sees an edge between them.
"""
from __future__ import annotations

import bisect
import logging
import threading

from ..config import get_flag
from .observability import _interpolate_quantiles, default_registry

# Finer-than-default buckets: dispatcher lag and handler service time
# are µs-to-ms scale (the default 5ms-first bucket would flatten them),
# while a saturated queue or a stalled peer reaches seconds.
BUS_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)

# Hard bound on distinct (kind, key, direction) rows one BusStats
# tracks; past it, new keys collapse into "other". 256 >> the real
# class count (a handful of subsystem prefixes x verbs), so overflow
# only ever triggers on a topic-name bug — which the "other" row then
# makes visible instead of hiding behind unbounded growth.
MAX_TRACKED_KEYS = 256

# Ring size for MessageBus.handler_errors / RemoteBus.handler_errors.
HANDLER_ERROR_RING = 256

_slow_log = logging.getLogger("pixie_tpu_torch.slow_handler")


def topic_class(topic: str) -> str:
    """Normalize a raw topic to a bounded-cardinality class.

    ``query.{qid}.ack`` -> ``query.ack``; ``agent.{aid}.execute`` ->
    ``agent.execute``; reply inboxes (``_inbox.{uuid}``) -> ``_inbox``;
    one- and two-part topics (``agent.register``, ``telemetry.spans``)
    are already classes and pass through; anything else deeper than two
    parts keeps only its subsystem prefix (``foo.a.b.c`` -> ``foo.*``).
    """
    if topic.startswith("_inbox."):
        return "_inbox"
    parts = topic.split(".")
    if len(parts) <= 2:
        return topic
    if parts[0] in ("query", "agent"):
        return f"{parts[0]}.{parts[-1]}"
    return f"{parts[0]}.*"


def payload_bytes(obj, _depth: int = 0) -> int:
    """Cheap payload-size estimate (NOT a serialization): strings and
    bytes count their length, scalars a flat 8, containers recurse with
    bounded depth and per-level sampling so a huge bridge payload costs
    O(1) to estimate. Close enough for byte accounting; the netbus
    frame counters carry the true wire bytes."""
    if isinstance(obj, (bytes, bytearray, str)):
        return len(obj) or 1
    if isinstance(obj, (int, float, bool)) or obj is None:
        return 8
    if _depth >= 3:
        return 64
    if isinstance(obj, dict):
        n = 0
        for i, (k, v) in enumerate(obj.items()):
            if i >= 8:
                n += (len(obj) - 8) * max(n // 8, 8)
                break
            n += payload_bytes(k, _depth + 1) + payload_bytes(v, _depth + 1)
        return n
    if isinstance(obj, (list, tuple)):
        n = 0
        for i, v in enumerate(obj):
            if i >= 8:
                # Extrapolate the unsampled tail from the sampled head.
                n += (len(obj) - 8) * max(n // 8, 8)
                break
            n += payload_bytes(v, _depth + 1)
        return n
    return 64


class _SmallHist:
    """Fixed-bucket histogram over BUS_BUCKETS (seconds). Mutated only
    under the owning BusStats lock; quantiles share the registry's
    interpolation so busz/__bus__ p50/p99 agree with /metrics."""

    __slots__ = ("counts", "count", "sum")

    def __init__(self):
        self.counts = [0] * (len(BUS_BUCKETS) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(BUS_BUCKETS, v)] += 1
        self.count += 1
        self.sum += v

    def quantiles(self, qs=(0.5, 0.99)) -> dict | None:
        """{q: seconds} via the registry's shared interpolation."""
        if self.count == 0:
            return None
        return _interpolate_quantiles(
            BUS_BUCKETS, self.counts, self.count, qs
        )


class _ClsState:
    """Per-topic-class cached handles: the row lists, internal
    histograms, and bound registry mirrors resolved ONCE, so the
    per-message path is a dict get plus list arithmetic — no tuple-key
    or label-dict construction per event. Bounded alongside the intern
    set (one entry per interned class)."""

    __slots__ = (
        "key", "pub_row", "del_row", "lag_h", "svc_h",
        "pub_mir", "del_mir",
        "m_pub", "b_pub", "m_del", "b_del",
        "lag", "svc", "errs", "slow", "qhw",
    )

    def __init__(self, key: str):
        self.key = key
        # Row lists / hists attach lazily so pub-only classes never
        # grow zero deliver rows in snapshot() (and vice versa).
        self.pub_row = None
        self.del_row = None
        self.lag_h = None
        self.svc_h = None
        # [msgs, bytes] already flushed into the registry counters —
        # the msgs/bytes mirrors batch every 32nd event per class (the
        # registry lock would otherwise be contended once per message
        # from the publisher thread). At most 31 events stale; exact
        # after every BusStats.snapshot().
        self.pub_mir = [0, 0]
        self.del_mir = [0, 0]


class BusStats:
    """Per-bus transport accumulator + registry mirror.

    Rows are keyed (kind, key, direction):

    - ``("bus", topic_class, "pub"|"deliver")`` — in-process messages;
      deliver rows carry the dispatch-lag / service-time histograms,
      the queue high-water mark, and handler-error counts.
    - ``("net", peer, "send"|"recv")`` — wire frames/bytes; send rows
      carry the send-stall (``_send_lock`` wait) histogram.
    - ``("net", peer, "conn")`` — connection events: msgs counts
      connects, errors counts drops + auth failures.
    - ``("rpc", peer, "request")`` — request/reply round trips; the lag
      histogram is the RTT, errors are timeouts/failures.

    ``snapshot()`` emits the rows in ``__bus__`` column shape.
    """

    def __init__(self, registry=None):
        self.registry = registry or default_registry
        self._lock = threading.Lock()
        # (kind, key, direction) -> [msgs, bytes, errors]
        self._rows: dict[tuple, list] = {}
        # (kind, key, direction, which) -> _SmallHist
        self._hists: dict[tuple, _SmallHist] = {}
        # topic_class -> monotonic queue-depth high-water
        self._qhw: dict[str, int] = {}
        self._keys: set[str] = set()
        # Cached bound-metric handles, keyed (metric, key[, direction]).
        # Read/insert without the stats lock: dict ops are GIL-atomic
        # and a racing double-insert just builds an equivalent bound.
        self._handles: dict[tuple, object] = {}
        # Per-topic-class handle structs for the in-process hot path,
        # keyed by INTERNED class only (bounded; hostile topics past
        # the intern cap pay the slow path into the "other" entry).
        self._cls_cache: dict[str, _ClsState] = {}
        # slow_handler_threshold_ms, re-read from the flag store every
        # 64th handled message: the hot path skips the flag lookup,
        # toggles still land within one heartbeat of traffic.
        self._slow_ms = 0.0
        self._handled_n = 0
        r = self.registry
        self._m_msgs = r.counter(
            "pixie_bus_msgs_total",
            "Messages through the in-process bus by topic class and "
            "direction (pub = publish calls, deliver = per-subscriber "
            "enqueues).")
        self._m_bytes = r.counter(
            "pixie_bus_bytes_total",
            "Estimated payload bytes through the in-process bus by "
            "topic class and direction.")
        self._m_lag = r.histogram(
            "pixie_bus_dispatch_lag_seconds",
            "Publish-to-handler-entry latency per topic class (the "
            "backpressure signal: a deep queue shows up here first).",
            buckets=BUS_BUCKETS)
        self._m_svc = r.histogram(
            "pixie_bus_handler_seconds",
            "Handler service time per topic class.",
            buckets=BUS_BUCKETS)
        self._m_qhw = r.gauge(
            "pixie_bus_queue_high_water",
            "Monotonic per-topic-class subscription queue depth "
            "high-water mark.")
        self._m_errs = r.counter(
            "pixie_bus_handler_errors_total",
            "Handler exceptions per topic class (true cumulative count;"
            " the busz ring keeps only the most recent).")
        self._m_slow = r.counter(
            "pixie_bus_slow_handlers_total",
            "Handlers slower than slow_handler_threshold_ms per topic "
            "class.")
        self._m_frames = r.counter(
            "pixie_net_frames_total",
            "Wire-bus frames by peer and direction.")
        self._m_net_bytes = r.counter(
            "pixie_net_bytes_total",
            "Wire-bus bytes (length prefix + encoded frame) by peer "
            "and direction — the cluster's wire-byte ground truth.")
        self._m_rtt = r.histogram(
            "pixie_net_request_seconds",
            "Request/reply round-trip time by peer.",
            buckets=BUS_BUCKETS)
        self._m_stall = r.histogram(
            "pixie_net_send_stall_seconds",
            "Time spent waiting for the frame send lock by peer (a "
            "slow/stalled peer backs up here).",
            buckets=BUS_BUCKETS)
        self._m_connects = r.counter(
            "pixie_net_connects_total",
            "Wire-bus connections established by peer (reconnects "
            "advance this).")
        self._m_drops = r.counter(
            "pixie_net_drops_total",
            "Wire-bus connections lost (error/EOF teardown) by peer.")
        self._m_auth_fail = r.counter(
            "pixie_net_auth_failures_total",
            "Wire-bus authentication failures by peer.")

    # -- internal -------------------------------------------------------------
    def _intern(self, key: str) -> str:
        """Caller holds self._lock. Bound distinct tracked keys."""
        if key in self._keys:
            return key
        if len(self._keys) >= MAX_TRACKED_KEYS:
            return "other"
        self._keys.add(key)
        return key

    def _row(self, kind: str, key: str, direction: str) -> list:
        """Caller holds self._lock."""
        r = self._rows.get((kind, key, direction))
        if r is None:
            r = self._rows[(kind, key, direction)] = [0, 0, 0]
        return r

    def _hist(self, kind: str, key: str, direction: str,
              which: str) -> _SmallHist:
        """Caller holds self._lock."""
        h = self._hists.get((kind, key, direction, which))
        if h is None:
            h = self._hists[(kind, key, direction, which)] = _SmallHist()
        return h

    def _bound(self, metric, **labels):
        key = (id(metric), tuple(sorted(labels.items())))
        b = self._handles.get(key)
        if b is None:
            b = self._handles[key] = metric.labels(**labels)
        return b

    def _cls_state(self, cls: str) -> _ClsState:
        """Resolve (intern + build) the per-class handle struct. Cached
        under the INTERNED key only, so the cache stays bounded; a
        racing double-build just produces equivalent bound handles."""
        with self._lock:
            key = self._intern(cls)
        cs = self._cls_cache.get(key)
        if cs is None:
            cs = _ClsState(key)
            cs.m_pub = self._m_msgs.labels(topic_class=key,
                                           direction="pub")
            cs.b_pub = self._m_bytes.labels(topic_class=key,
                                            direction="pub")
            cs.m_del = self._m_msgs.labels(topic_class=key,
                                           direction="deliver")
            cs.b_del = self._m_bytes.labels(topic_class=key,
                                            direction="deliver")
            cs.lag = self._m_lag.labels(topic_class=key)
            cs.svc = self._m_svc.labels(topic_class=key)
            cs.errs = self._m_errs.labels(topic_class=key)
            cs.slow = self._m_slow.labels(topic_class=key)
            cs.qhw = self._m_qhw.labels(topic_class=key)
            self._cls_cache[key] = cs
        return cs

    def _mirror_cls(self, cs: _ClsState) -> None:
        """Flush this class's pending msgs/bytes counter deltas into
        the registry. Delta computed and committed under the BusStats
        lock, APPLIED outside it — the no-lock-nesting rule."""
        dp = dd = None
        with self._lock:
            r = cs.pub_row
            if r is not None and r[0] != cs.pub_mir[0]:
                dp = (r[0] - cs.pub_mir[0], r[1] - cs.pub_mir[1])
                cs.pub_mir[0], cs.pub_mir[1] = r[0], r[1]
            r = cs.del_row
            if r is not None and r[0] != cs.del_mir[0]:
                dd = (r[0] - cs.del_mir[0], r[1] - cs.del_mir[1])
                cs.del_mir[0], cs.del_mir[1] = r[0], r[1]
        if dp is not None:
            cs.m_pub.inc(dp[0])
            cs.b_pub.inc(dp[1])
        if dd is not None:
            cs.m_del.inc(dd[0])
            cs.b_del.inc(dd[1])

    # -- in-process bus hot path ---------------------------------------------
    def on_publish(self, topic: str, msg) -> tuple[str, int]:
        """Count one publish; returns (topic_class, payload estimate)
        so the fan-out can stamp per-subscriber rows without repeating
        the estimate."""
        cls = topic_class(topic)
        nb = payload_bytes(msg)
        cs = self._cls_cache.get(cls) or self._cls_state(cls)
        with self._lock:
            r = cs.pub_row
            if r is None:
                r = cs.pub_row = self._row("bus", cs.key, "pub")
            r[0] += 1
            r[1] += nb
            n = r[0]
        if not n & 0x1F:
            self._mirror_cls(cs)
        return cs.key, nb

    def on_deliver(self, cls: str, nbytes: int, depth: int) -> None:
        """One per-subscriber enqueue; ``depth`` is the subscription
        queue depth observed at enqueue time (the high-water feed)."""
        cs = self._cls_cache.get(cls) or self._cls_state(cls)
        new_hw = 0
        with self._lock:
            r = cs.del_row
            if r is None:
                r = cs.del_row = self._row("bus", cs.key, "deliver")
            r[0] += 1
            r[1] += nbytes
            n = r[0]
            if depth > self._qhw.get(cs.key, 0):
                self._qhw[cs.key] = new_hw = depth
        if not n & 0x1F:
            self._mirror_cls(cs)
        if new_hw:
            cs.qhw.set(new_hw)

    def on_handled(self, cls: str, topic: str, lag_s: float,
                   service_s: float, error: bool = False) -> None:
        """Handler completed: stamp dispatch lag + service time, count
        errors, and feed the slow-handler log (same shape as the
        slow-query log: threshold flag, dedicated logger, counter)."""
        cs = self._cls_cache.get(cls) or self._cls_state(cls)
        with self._lock:
            lh = cs.lag_h
            if lh is None:
                lh = cs.lag_h = self._hist("bus", cs.key, "deliver",
                                           "lag")
                cs.svc_h = self._hist("bus", cs.key, "deliver",
                                      "service")
            lh.observe(lag_s)
            cs.svc_h.observe(service_s)
            if error:
                self._row("bus", cs.key, "deliver")[2] += 1
            n = self._handled_n
            self._handled_n = n + 1
        cs.lag.observe(lag_s)
        cs.svc.observe(service_s)
        if error:
            cs.errs.inc()
        if not n & 0x3F:  # periodic flag refresh (see __init__)
            self._slow_ms = float(get_flag("slow_handler_threshold_ms"))
        thresh_ms = self._slow_ms
        if thresh_ms > 0 and service_s * 1e3 >= thresh_ms:
            cs.slow.inc()
            _slow_log.warning(
                "slow handler: topic=%s class=%s service_ms=%.2f "
                "lag_ms=%.2f threshold_ms=%.1f%s",
                topic, cs.key, service_s * 1e3, lag_s * 1e3, thresh_ms,
                " (handler raised)" if error else "")

    # -- wire bus -------------------------------------------------------------
    def on_frame(self, peer: str, direction: str, nbytes: int) -> None:
        with self._lock:
            peer = self._intern(peer)
            r = self._row("net", peer, direction)
            r[0] += 1
            r[1] += nbytes
        self._bound(self._m_frames, peer=peer, direction=direction).inc()
        self._bound(self._m_net_bytes, peer=peer,
                    direction=direction).inc(nbytes)

    def on_send_stall(self, peer: str, stall_s: float) -> None:
        with self._lock:
            peer = self._intern(peer)
            self._hist("net", peer, "send", "lag").observe(stall_s)
        self._bound(self._m_stall, peer=peer).observe(stall_s)

    def on_conn_event(self, peer: str, event: str) -> None:
        """``event`` in ("connect", "drop", "auth_failure")."""
        with self._lock:
            peer = self._intern(peer)
            r = self._row("net", peer, "conn")
            if event == "connect":
                r[0] += 1
            else:
                r[2] += 1
        m = {"connect": self._m_connects, "drop": self._m_drops,
             "auth_failure": self._m_auth_fail}[event]
        self._bound(m, peer=peer).inc()

    def on_request(self, peer: str, rtt_s: float,
                   error: bool = False) -> None:
        with self._lock:
            peer = self._intern(peer)
            r = self._row("rpc", peer, "request")
            r[0] += 1
            if error:
                r[2] += 1
            self._hist("rpc", peer, "request", "lag").observe(rtt_s)
        self._bound(self._m_rtt, peer=peer).observe(rtt_s)

    # -- snapshots ------------------------------------------------------------
    def snapshot(self) -> list[dict]:
        """Cumulative rows in ``__bus__`` column shape (monotonic
        counters; ``px.max`` per key recovers the latest fold)."""
        # Settle the batched registry mirrors first: every snapshot
        # consumer (busz, heartbeat summary, __bus__ fold) doubles as
        # a flush point, so /metrics is exact at those cadences.
        for cs in list(self._cls_cache.values()):
            self._mirror_cls(cs)
        rows = []
        with self._lock:
            for (kind, key, direction), r in sorted(self._rows.items()):
                lag = self._hists.get((kind, key, direction, "lag"))
                svc = self._hists.get((kind, key, direction, "service"))
                lq = lag.quantiles() if lag is not None else None
                sq = svc.quantiles() if svc is not None else None
                rows.append({
                    "kind": kind,
                    "topic_class": key,
                    "direction": direction,
                    "msgs": r[0],
                    "bytes": r[1],
                    "errors": r[2],
                    "lag_p50_ms": (lq[0.5] * 1e3) if lq else 0.0,
                    "lag_p99_ms": (lq[0.99] * 1e3) if lq else 0.0,
                    "service_p50_ms": (sq[0.5] * 1e3) if sq else 0.0,
                    "service_p99_ms": (sq[0.99] * 1e3) if sq else 0.0,
                    "queue_high_water": (
                        self._qhw.get(key, 0) if kind == "bus" else 0
                    ),
                })
        return rows

    def queue_high_water(self) -> dict[str, int]:
        with self._lock:
            return dict(self._qhw)
