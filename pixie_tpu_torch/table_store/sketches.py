"""Per-tablet ingest sketches: row count, zone maps, HLL NDV.

A port of the JAX package's ``table_store/sketches.py``. Maintained on
the table-store push path (``Table.append``) so plan-time decisions
never scan data:

- **row count**: exact rows ever appended (expiry never decrements it;
  every use is a conservative upper bound).
- **zone maps**: per key column, the global (min, max) plus a bounded
  ring of per-append (first_row_id, n, min, max) entries. The ring
  (``window_zone``) is what predicate-driven window skipping
  (``exec/zoneskip.py``) reads: a scan window whose zone cannot meet the
  filter is never staged.
- **HLL NDV**: one ``ops/hll.py`` register row per key column (the numpy
  mirror, bit-identical to the JAX package's registers).

Sketched columns are the single-plane INT64 columns and dictionary
string code columns, never ``time_`` (the time index covers it).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops.hll import DEFAULT_P, hll_estimate_np, hll_init_np, hll_update_np

#: Per-append zone-map entries kept per column; beyond this the oldest
#: entries merge pairwise (coverage stays total, granularity halves) so
#: long-lived streaming tables cannot grow the ring without bound.
MAX_ZONE_ENTRIES = 1024


@dataclass
class ZoneEntry:
    row0: int  # first row id of the appended batch
    n: int  # rows in the batch
    lo: int
    hi: int


@dataclass
class ColumnSketch:
    """Ingest sketch for one key column."""

    rows: int = 0
    lo: int | None = None  # global zone map (min over all appends)
    hi: int | None = None
    registers: np.ndarray = field(default_factory=hll_init_np)
    zones: list = field(default_factory=list)  # list[ZoneEntry]

    def update(self, values: np.ndarray, row0: int) -> None:
        """Fold one appended batch (single int plane / string codes)."""
        n = len(values)
        if n == 0:
            return
        lo, hi = int(values.min()), int(values.max())
        self.rows += n
        self.lo = lo if self.lo is None else min(self.lo, lo)
        self.hi = hi if self.hi is None else max(self.hi, hi)
        hll_update_np(self.registers, values, DEFAULT_P)
        self.zones.append(ZoneEntry(row0, n, lo, hi))
        if len(self.zones) > MAX_ZONE_ENTRIES:
            merged = []
            it = iter(self.zones)
            for a in it:
                b = next(it, None)
                if b is None:
                    merged.append(a)
                elif b.row0 == a.row0 + a.n:
                    merged.append(ZoneEntry(
                        a.row0, a.n + b.n, min(a.lo, b.lo), max(a.hi, b.hi)
                    ))
                else:  # non-contiguous (expiry gap): keep both
                    merged.extend((a, b))
            self.zones = merged

    @property
    def ndv(self) -> int:
        """Estimated distinct values (HLL, ~3% error), capped by rows."""
        return max(1, min(hll_estimate_np(self.registers), self.rows))

    def window_zone(self, row_lo: int, row_hi: int):
        """Conservative (min, max) over rows [row_lo, row_hi), or None
        when no zone entry overlaps (the range pre-dates sketching or
        lies in an expiry gap): callers treat None as unbounded."""
        lo = hi = None
        for z in self.zones:
            if z.row0 + z.n <= row_lo or z.row0 >= row_hi:
                continue
            lo = z.lo if lo is None else min(lo, z.lo)
            hi = z.hi if hi is None else max(hi, z.hi)
        if lo is None:
            return None
        return lo, hi


class TableSketches:
    """All of one tablet's column sketches + the exact row count."""

    def __init__(self):
        self.rows = 0
        self.cols: dict[str, ColumnSketch] = {}

    def update(self, name: str, values: np.ndarray, row0: int) -> None:
        self.cols.setdefault(name, ColumnSketch()).update(values, row0)

    def col(self, name: str) -> ColumnSketch | None:
        return self.cols.get(name)

    def ndv(self, name: str) -> int | None:
        s = self.cols.get(name)
        return s.ndv if s is not None and s.rows else None
