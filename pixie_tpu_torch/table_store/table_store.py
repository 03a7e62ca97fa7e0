"""TableStore: the name/id -> Table map shared by ingest and queries.

Reference parity: ``src/table_store/table/table_store.h:79``: tables are
addressable by name and by numeric id (ingest pushes by id), with tablet
support (``tablets_group.h``): a (table, tablet_id) pair maps to its own
physical Table, and reads over the table see all tablets. A port of the
JAX package's ``table_store/table_store.py``. A table created with a device and a window size stages its windows at
that size onto that device from its first append on; new tablets
inherit both from the base tablet. A tiered table's demoted windows keep
their staged device windows (``Table.first_row_id`` spans both tiers),
so repeat scans of a tiered table stay resident. A PEM agent installs
lazy per-table byte budgets (``table_budgets``) that shape a table at
its creation, and ships ``freshness()`` to the agent tracker, which
merges the agents' records with ``merge_freshness``.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..types.relation import Relation
from .table import DEFAULT_COMPACTED_ROWS, Table

DEFAULT_TABLET = ""


def _new_table(name, relation, max_bytes, dicts, device, device_window_rows,
               compacted_rows=DEFAULT_COMPACTED_ROWS):
    t = Table(name, relation, max_bytes=max_bytes,
              compacted_rows=compacted_rows, dicts=dicts)
    t.device = device
    if device_window_rows is not None:
        t.device_window_rows = int(device_window_rows)
    return t


class TableStore:
    def __init__(self):
        self._lock = threading.Lock()
        # name -> {tablet_id -> Table}
        self._tables: dict[str, dict[str, Table]] = {}
        self._ids: dict[int, str] = {}
        self._names_to_ids: dict[str, int] = {}
        self._next_id = 1
        # Lazy per-table byte budgets: {name: max_bytes, "*": default}.
        # Applied when a table is created with no explicit max_bytes (a
        # PEM installs the reference's InitSchemas split here).
        self.table_budgets: dict = {}

    def _budget_for(self, name: str, max_bytes: int) -> int:
        if max_bytes != -1 or not self.table_budgets:
            return max_bytes
        return self.table_budgets.get(name, self.table_budgets.get("*", -1))

    def _name_id_locked(self, name: str, table_id: Optional[int] = None):
        """Give ``name`` its id (``table_id``, else the next free one) the
        first time the table is seen."""
        if name not in self._names_to_ids:
            tid = table_id if table_id is not None else self._next_id
            self._next_id = max(self._next_id, tid) + 1
            self._ids[tid] = name
            self._names_to_ids[name] = tid

    def _name_of_locked(self, name_or_id):
        return (self._ids.get(name_or_id) if isinstance(name_or_id, int)
                else name_or_id)

    def add_table(
        self,
        name: str,
        relation: Relation | None = None,
        table_id: Optional[int] = None,
        max_bytes: int = -1,
        compacted_rows: int = DEFAULT_COMPACTED_ROWS,
        tablet_id: str = DEFAULT_TABLET,
        device_window_rows: int | None = None,
        device=None,
    ) -> Table:
        with self._lock:
            base = next(iter(self._tables.get(name, {}).values()), None)
            t = _new_table(
                name, relation, self._budget_for(name, max_bytes),
                base.dicts if base is not None else None,
                device, device_window_rows, compacted_rows,
            )
            self._tables.setdefault(name, {})[tablet_id] = t
            self._name_id_locked(name, table_id)
            return t

    def ensure_table(
        self,
        name: str,
        relation: Relation | None = None,
        max_bytes: int = -1,
        device_window_rows: int | None = None,
        device=None,
    ) -> Table:
        """Atomic get-or-create of a table's default tablet (callers racing
        on a first append must not replace each other's table)."""
        with self._lock:
            existing = next(iter(self._tables.get(name, {}).values()), None)
            if existing is not None:
                return existing
            t = _new_table(
                name, relation, self._budget_for(name, max_bytes), None,
                device, device_window_rows,
            )
            self._tables.setdefault(name, {})[DEFAULT_TABLET] = t
            self._name_id_locked(name)
            return t

    def get_table(self, name_or_id, tablet_id: str = DEFAULT_TABLET) -> Optional[Table]:
        with self._lock:
            name = self._name_of_locked(name_or_id)
            if name is None:
                return None
            return self._tables.get(name, {}).get(tablet_id)

    def get_table_id(self, name: str) -> Optional[int]:
        with self._lock:
            return self._names_to_ids.get(name)

    def get_table_name(self, table_id: int) -> str:
        with self._lock:
            return self._ids.get(table_id, "")

    def table_ids(self) -> list[int]:
        with self._lock:
            return sorted(self._ids)

    def table_names(self) -> list[str]:
        with self._lock:
            return sorted(self._tables)

    def tablets(self, name: str) -> list[Table]:
        with self._lock:
            return [t for _, t in sorted(self._tables.get(name, {}).items())]

    def append_data(self, name_or_id, data, tablet_id: str = DEFAULT_TABLET,
                    time_cols=("time_",)):
        """Ingest push target (table_store.h:152 AppendData). Creates the
        table or tablet on first write; a table addressed by id must
        exist already (``KeyError`` otherwise). New tablets inherit the
        base tablet's schema, byte budget, compaction size, (shared)
        string dictionaries, device and window size, so every tablet
        encodes into one id space and stages like its base."""
        with self._lock:
            name = self._name_of_locked(name_or_id)
            if name is None:
                raise KeyError(f"no table with id {name_or_id}")
            tablets = self._tables.setdefault(name, {})
            t = tablets.get(tablet_id)
            if t is None:
                base = next(iter(tablets.values()), None)
                t = _new_table(
                    name,
                    base.relation if base is not None else None,
                    base.max_bytes if base is not None
                    else self._budget_for(name, -1),
                    base.dicts if base is not None else None,
                    base.device if base is not None else None,
                    base.device_window_rows if base is not None else None,
                    base.compacted_rows if base is not None
                    else DEFAULT_COMPACTED_ROWS,
                )
                tablets[tablet_id] = t
            self._name_id_locked(name)
        return t.append(data, time_cols=time_cols)

    def compact_all(self) -> int:
        """One compaction pass over every tablet (the body of the
        reference's timed compaction). Returns the cold batches made."""
        with self._lock:
            tables = [t for tablets in self._tables.values()
                      for t in tablets.values()]
        return sum(t.compact() for t in tables)

    def relation(self, name: str) -> Optional[Relation]:
        tablets = self.tablets(name)
        return tablets[0].relation if tablets else None

    def freshness(self) -> dict:
        """{table: merged freshness dict} across each table's tablets: the
        per-agent half of the cluster merge the tracker performs."""
        out: dict = {}
        for name in self.table_names():
            merged = None
            for t in self.tablets(name):
                if t._backend is None:
                    continue
                merged = merge_freshness(merged, t.freshness())
            if merged is not None:
                out[name] = merged
        return out


#: Freshness keys that merge by summation (live sizes and monotonic
#: counters over disjoint shards); the rest are watermark-style.
_FRESHNESS_SUM_KEYS = (
    "rows", "bytes", "hot_bytes", "cold_bytes", "device_bytes",
    "rows_total", "bytes_total", "expired_rows_total",
    "expired_bytes_total", "ingest_rows_per_s",
    "hot_rows", "cold_rows", "cold_raw_bytes",
    "cold_demotions_total", "cold_evictions_total",
    "cold_decode_seconds_total",
)


def merge_freshness(into: dict | None, fresh: dict) -> dict:
    """Fold one tablet or agent freshness record into an accumulator
    (shared by ``TableStore.freshness`` and the tracker's cluster merge):
    sums for counters, max for ``watermark``/``last_append``, min for
    ``min_time`` (-1 = no live rows, ignored)."""
    if into is None:
        return dict(fresh)
    for k in _FRESHNESS_SUM_KEYS:
        into[k] = into.get(k, 0) + fresh.get(k, 0)
    for k in ("watermark", "last_append"):
        into[k] = max(into.get(k, -1), fresh.get(k, -1))
    mt_a, mt_b = into.get("min_time", -1), fresh.get("min_time", -1)
    into["min_time"] = (
        mt_b if mt_a < 0 else (mt_a if mt_b < 0 else min(mt_a, mt_b))
    )
    return into
