"""Tier manager: byte-budget demotion from the hot ring into the cold store.

A copy of the JAX package's ``table_store/tier.py``.

Policy: a tiered table keeps its backend ring
*unbounded* and the manager enforces the budgets instead —

- ``hot_budget_bytes`` (the table's ``max_bytes``): before every append,
  the oldest hot rows demote window-by-window into the encoded cold
  store until the incoming batch fits. Demotion is a **handoff, not
  expiry**: rows are encoded into ``ColdStore`` *first* and only then
  dropped from the ring (``drop_before``), so a concurrent reader always
  finds every live row in exactly one tier (readers consult the ring
  first, then fill the gap from cold — ``Table.read_rows``). None of the
  expiry counters move.
- ``cold_budget_bytes`` (``cold_tier_mb`` flag): after demotion, the
  oldest *encoded* windows evict until the encoded footprint fits. That
  is true expiry — ``rows_expired`` / ``bytes_expired`` advance (at raw
  row widths, matching the hot ring's accounting).

Demotion chunks align to the table's device window grid so previously
staged device windows keep their (window, row0, n) identity across
demotion and repeat scans stay device-resident.
"""

from __future__ import annotations

import threading

import numpy as np

from .coldstore import ColdStore

MB = 1 << 20


class TierManager:
    def __init__(self, table, hot_budget_bytes: int, cold_budget_bytes: int):
        self.table = table
        self.hot_budget = int(hot_budget_bytes)
        self.cold_budget = int(cold_budget_bytes)
        has_time = bool(
            table._plane_layout and table._plane_layout[0][0] == "time_"
            and table._plane_layout[0][1] == 0
        )
        self.store = ColdStore(has_time)
        self._monotonic = [
            i == 0 and has_time for i in range(len(table._plane_layout))
        ]
        self.lock = threading.Lock()

    @property
    def row_bytes(self) -> int:
        be = self.table._backend
        return int(sum(np.dtype(d).itemsize for d in be.elem_dtypes))

    def demote_for(self, incoming_bytes: int) -> int:
        """Demote oldest hot rows so the ring fits incoming_bytes more.
        Called on the append path BEFORE the backend append. Returns rows
        demoted."""
        be = self.table._backend
        hot_bytes = be.stats()[0]
        need = hot_bytes + int(incoming_bytes) - self.hot_budget
        if need <= 0:
            return 0
        rb = self.row_bytes
        rows = -(-need // rb) if rb > 0 else 0
        return self.demote_rows(rows)

    def demote_rows(self, rows: int) -> int:
        """Demote at least ``rows`` oldest hot rows (rounded up to the
        device window grid), encode them, then drop them from the ring."""
        if rows <= 0:
            return 0
        be = self.table._backend
        w = max(1, int(self.table.device_window_rows))
        demoted = 0
        with self.lock:
            while demoted < rows:
                first = be.first_row_id()
                end = be.end_row_id()
                if first >= end:
                    break
                chunk_end = min((first // w + 1) * w, end)
                planes, got_first, n = be.read(first, chunk_end - first)
                if n <= 0:
                    break
                if self.store.has_time:
                    times = planes[0]
                    mn, mx = int(times.min()), int(times.max())
                else:
                    mn, mx = 0, 0
                self.store.append_window(
                    got_first, planes, mn, mx, self._monotonic
                )
                be.drop_before(got_first + n)
                demoted += n
            self.store.evict_to(self.cold_budget)
        return demoted

    def counters(self) -> dict:
        s = self.store
        return {
            "cold_windows": len(s.windows),
            "cold_bytes": s.nbytes,
            "cold_raw_bytes": s.raw_nbytes,
            "cold_rows": s.num_rows(),
            "demotions_total": s.demotions,
            "evictions_total": s.evictions,
            "rows_evicted_total": s.rows_evicted,
            "decode_windows_total": s.decoded_windows,
            "decode_bytes_total": s.decoded_bytes,
            "decode_seconds_total": round(s.decode_seconds, 6),
        }
