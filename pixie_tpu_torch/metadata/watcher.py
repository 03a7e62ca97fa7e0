"""Metadata watcher: streams resource updates into MetadataState.

Reference parity: the metadata service's k8s watcher
(``src/vizier/services/metadata/controllers/k8smeta/
k8s_metadata_handler.go`` — watch pods/services/endpoints, convert to
ResourceUpdates with monotonically increasing resource versions, replay
missed ranges on reconnect). Without a k8s API in scope, the watcher
consumes the same ResourceUpdate-shaped dicts from any iterable feed —
an in-memory queue, a JSONL file tail, or a bus topic — tracks the
resource version high-water mark, and applies updates to a
``MetadataState`` under a lock, optionally fanning out to subscribers
(the NATS ``MetadataUpdates`` publication analog).
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Optional

from .state import MetadataState


class MetadataWatcher:
    """Applies versioned ResourceUpdates to a MetadataState."""

    def __init__(self, state: Optional[MetadataState] = None):
        self.state = state if state is not None else MetadataState()
        self.resource_version = 0
        self.updates_applied = 0
        self.updates_skipped = 0  # stale (<= high-water) versions
        self._lock = threading.Lock()
        self._subscribers: list[Callable] = []

    def subscribe(self, fn: Callable) -> None:
        """fn(update_dict) after each applied update (MetadataUpdates
        publication)."""
        self._subscribers.append(fn)

    def apply(self, update: dict) -> bool:
        """Apply one update; returns False for stale resource versions.

        Updates carry an optional monotonically-increasing ``rv``; absent
        rv means unversioned (always applied) — the reference's full-sync
        path. Out-of-order versioned updates are skipped, which is what
        makes reconnect replays idempotent.
        """
        rv = update.get("rv")
        with self._lock:
            if rv is not None:
                if rv <= self.resource_version:
                    self.updates_skipped += 1
                    return False
                self.resource_version = rv
            payload = {k: v for k, v in update.items() if k != "rv"}
            self.state.apply_update(payload)
            self.updates_applied += 1
        for fn in self._subscribers:
            fn(update)
        return True

    def apply_all(self, feed) -> int:
        """Drain an iterable of update dicts; returns applied count."""
        n = 0
        for u in feed:
            if self.apply(u):
                n += 1
        return n

    def load_jsonl(self, path: str) -> int:
        """Replay a recorded update log (one JSON object per line) — the
        missed-range replay path on restart."""
        with open(path) as f:
            return self.apply_all(
                json.loads(line) for line in f if line.strip()
            )

    def missing_range(self, from_rv: int, to_rv: int) -> tuple[int, int]:
        """(from, to) of updates a reconnecting consumer must replay
        (GetUpdatesForRange analog)."""
        with self._lock:
            return (min(from_rv, self.resource_version),
                    min(to_rv, self.resource_version))
