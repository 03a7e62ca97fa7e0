"""Connector framework: lifecycle, buffers, frequencies.

Reference parity: ``src/stirling/core`` — ``SourceConnector``
(``source_connector.h:43``: Init/TransferData/Stop, per-table schemas,
sampling+push periods), ``DataTable`` (``data_table.h:51``: accumulation
buffer with tablets and push thresholds), ``FrequencyManager``
(``frequency_manager.h:31``: expired/reset cycle accounting).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from ..types.relation import Relation


class FrequencyManager:
    """Cycle clock: fires when ``period_s`` has elapsed since last reset."""

    def __init__(self, period_s: float):
        self.period_s = period_s
        self._next = time.monotonic()
        self.count = 0

    def expired(self, now: Optional[float] = None) -> bool:
        return (now if now is not None else time.monotonic()) >= self._next

    def reset(self, now: Optional[float] = None) -> None:
        self._next = (now if now is not None else time.monotonic()) + self.period_s
        self.count += 1

    @property
    def next_deadline(self) -> float:
        return self._next


class DataTable:
    """Per-connector accumulation buffer for one output table.

    Reference: ``core/data_table.h:51`` — records accumulate between
    transfer cycles; the collector drains them to the push callback when
    the push period fires (or the buffer crosses its size threshold).
    """

    def __init__(
        self,
        name: str,
        relation: Relation,
        push_threshold_rows: int = 1 << 16,
        max_buffer_rows: int | None = None,
    ):
        self.name = name
        self.relation = relation
        self.push_threshold_rows = push_threshold_rows
        # Hard cap when no consumer drains us (e.g. collector started
        # before a push callback is wired): drop oldest, count the loss
        # (the reference DataTable expires oldest on occupancy too).
        self.max_buffer_rows = (
            max_buffer_rows if max_buffer_rows is not None
            else 4 * push_threshold_rows
        )
        self.rows_dropped = 0
        # append runs on the collector thread, drain on flush callers —
        # guard both (records landing mid-drain must not be lost).
        self._lock = threading.Lock()
        self._pending: list[dict] = []
        self._pending_rows = 0

    def append(self, records: dict) -> None:
        n = len(next(iter(records.values()))) if records else 0
        if n == 0:
            return
        with self._lock:
            self._pending.append(records)
            self._pending_rows += n
            while self._pending_rows > self.max_buffer_rows and len(self._pending) > 1:
                dropped = self._pending.pop(0)
                m = len(next(iter(dropped.values())))
                self._pending_rows -= m
                self.rows_dropped += m

    @property
    def pending_rows(self) -> int:
        with self._lock:
            return self._pending_rows

    def over_threshold(self) -> bool:
        return self.pending_rows >= self.push_threshold_rows

    def drain(self) -> Optional[dict]:
        """Concatenate and clear pending records."""
        with self._lock:
            pending, self._pending = self._pending, []
            self._pending_rows = 0
        if not pending:
            return None
        if len(pending) == 1:
            return pending[0]
        keys = pending[0].keys()
        return {
            k: np.concatenate([np.asarray(p[k]) for p in pending]) for k in keys
        }


class SourceConnector:
    """Base connector (``source_connector.h:43``).

    Subclasses declare ``tables`` = [(name, Relation)] and implement
    ``transfer_data(ctx, data_tables)`` to append newly-collected records.
    """

    name = "source"
    # [(table name, Relation)] — the InfoClassManager publication.
    tables: list = []
    default_sampling_period_s = 0.1
    default_push_period_s = 1.0

    def __init__(
        self,
        sampling_period_s: Optional[float] = None,
        push_period_s: Optional[float] = None,
    ):
        self.sampling_freq = FrequencyManager(
            sampling_period_s
            if sampling_period_s is not None
            else self.default_sampling_period_s
        )
        self.push_freq = FrequencyManager(
            push_period_s if push_period_s is not None else self.default_push_period_s
        )
        self.initialized = False

    # -- lifecycle -----------------------------------------------------------
    def init(self) -> None:
        """One-time setup (probe deployment in the reference)."""
        self.initialized = True

    def stop(self) -> None:
        self.initialized = False

    def transfer_data(self, ctx, data_tables: dict) -> None:
        """Collect and append records to ``data_tables[name]``."""
        raise NotImplementedError
