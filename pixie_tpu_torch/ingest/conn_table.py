"""Shared per-connection tracker table for protocol stitchers.

Reference parity: the socket tracer's ConnTracker lifecycle
(``socket_trace_connector.cc`` expires idle trackers and disables ones
it can no longer trust). Every stitcher (HTTP/MySQL/PgSQL) keeps
per-connection parser state; this table owns the eviction policy so it
exists in exactly one place: idle connections expire after a TTL sweep,
and at the hard cap the least-recently-used tracker is dropped.

Connection state objects must expose a mutable ``last_ts`` attribute.
"""

from __future__ import annotations


class ConnectionTable:
    IDLE_TTL_NS = 300 * 1_000_000_000
    MAX_CONNS = 4096
    SWEEP_MIN = 64  # skip the TTL sweep below this population

    def __init__(self, factory):
        self._factory = factory
        self._conns: dict = {}

    def __len__(self) -> int:
        return len(self._conns)

    def get(self, conn_id, now_ns: int):
        """The connection's state, created on first sight; touches its
        last-activity timestamp."""
        c = self._conns.get(conn_id)
        if c is None:
            self._evict(now_ns)
            c = self._factory()
            c.last_ts = now_ns
            self._conns[conn_id] = c
        c.last_ts = now_ns
        return c

    def kill(self, conn_id) -> None:
        """Drop a tracker whose stream can no longer be trusted."""
        self._conns.pop(conn_id, None)

    def values(self):
        return self._conns.values()

    def _evict(self, now_ns: int) -> None:
        cutoff = now_ns - self.IDLE_TTL_NS
        if len(self._conns) > self.SWEEP_MIN:
            self._conns = {
                cid: c for cid, c in self._conns.items()
                if c.last_ts >= cutoff
            }
        while len(self._conns) >= self.MAX_CONNS:
            lru = min(self._conns, key=lambda cid: self._conns[cid].last_ts)
            self._conns.pop(lru)
