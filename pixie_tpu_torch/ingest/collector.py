"""Collector core loop: poll connectors, push full tables downstream.

Reference parity: ``src/stirling/stirling.{h,cc}`` —
``Stirling::Create`` + ``RegisterDataPushCallback`` + ``RunAsThread``
(``stirling.h:90-190``); the core loop wakes at the earliest
sampling/push deadline across connectors (``stirling.cc:732,770-815``),
calls ``TransferData`` on expired samplers, and drains tables whose push
period fired (or whose buffers crossed their threshold) into the
registered push callback — ``TableStore.append_data`` when wired to an
engine/agent (``pem_manager.cc:48``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from .core import DataTable, SourceConnector


class Collector:
    def __init__(self):
        self._connectors: list[SourceConnector] = []
        self._data_tables: dict[str, DataTable] = {}
        self._push_cb: Optional[Callable] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.stats = {"transfer_calls": 0, "pushes": 0, "rows_pushed": 0}
        # Connector failures are recorded, not fatal (the stirling_error
        # self-observability pattern): one bad source must never stop the
        # others from collecting.
        self.errors: list[tuple[str, str]] = []

    # -- setup ---------------------------------------------------------------
    def register_source(self, connector: SourceConnector) -> None:
        connector.init()
        with self._lock:
            self._connectors.append(connector)
            for name, rel in connector.tables:
                existing = self._data_tables.get(name)
                if existing is not None and list(existing.relation.items()) == list(rel.items()):
                    continue  # same-schema redeploy: pending rows survive
                self._data_tables[name] = DataTable(name, rel)

    def remove_source(self, connector: SourceConnector) -> None:
        """Stop and detach a connector (dynamic tracepoint removal); its
        table buffer stays so already-collected rows still push."""
        connector.stop()
        with self._lock:
            if connector in self._connectors:
                self._connectors.remove(connector)

    def register_data_push_callback(self, cb: Callable) -> None:
        """cb(table_name, relation, records_dict) — the
        RegisterDataPushCallback surface (``stirling.h:115``)."""
        self._push_cb = cb

    def wire_to(self, engine_or_agent) -> None:
        """Convenience: push straight into an engine/agent table store
        (``pem_manager.cc:48`` binds the callback to AppendData)."""

        def cb(name, relation, records):
            engine_or_agent.append_data(name, records)

        self.register_data_push_callback(cb)

    def schemas(self) -> dict:
        """Published table schemas (InfoClassManager pub/sub analog)."""
        with self._lock:
            return {n: dt.relation for n, dt in self._data_tables.items()}

    # -- core loop -----------------------------------------------------------
    def run_core(self, once: bool = False) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            with self._lock:
                connectors = list(self._connectors)
            for c in connectors:
                if c.sampling_freq.expired(now):
                    try:
                        c.transfer_data(self, self._data_tables)
                        self.stats["transfer_calls"] += 1
                    except Exception as e:
                        self.errors.append((c.name, repr(e)))
                    c.sampling_freq.reset(now)
                push_due = c.push_freq.expired(now)
                if push_due:
                    c.push_freq.reset(now)
                for name, _rel in c.tables:
                    dt = self._data_tables[name]
                    if (push_due or dt.over_threshold()) and dt.pending_rows:
                        try:
                            self._push(dt)
                        except Exception as e:  # push must not kill the loop
                            self.errors.append((dt.name, repr(e)))
            if once:
                return
            # Sleep until the earliest upcoming deadline (stirling.cc:732).
            deadlines = [
                f.next_deadline
                for c in connectors
                for f in (c.sampling_freq, c.push_freq)
            ]
            wake = min(deadlines) if deadlines else now + 0.1
            self._stop.wait(timeout=max(0.0, wake - time.monotonic()))

    def _push(self, dt: DataTable) -> None:
        if self._push_cb is None:
            return  # keep buffering until a callback is wired
        records = dt.drain()
        if records is None:
            return
        n = len(next(iter(records.values())))
        self._push_cb(dt.name, dt.relation, records)
        self.stats["pushes"] += 1
        self.stats["rows_pushed"] += n

    def run_as_thread(self) -> threading.Thread:
        """Stirling::RunAsThread (``stirling.h:132``)."""
        self._thread = threading.Thread(target=self.run_core, daemon=True)
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        for c in self._connectors:
            c.stop()

    def flush(self) -> None:
        """Drain every pending buffer immediately (test/shutdown path)."""
        with self._lock:
            tables = list(self._data_tables.values())
        for dt in tables:
            if dt.pending_rows:
                self._push(dt)
