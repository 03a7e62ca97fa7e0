"""TableStore: the name -> Table map shared by ingest and queries.

Reference parity: ``src/table_store/table/table_store.h:79``, with tablet
support (``tablets_group.h``): a (table, tablet_id) pair maps to its own
physical Table, and reads over the table see all tablets. A port of the
JAX package's ``table_store/table_store.py`` without numeric table ids.
A table created with a device and a window size stages its windows at
that size onto that device from its first append on; new tablets
inherit both from the base tablet. A tiered table's demoted windows keep
their staged device windows (``Table.first_row_id`` spans both tiers),
so repeat scans of a tiered table stay resident.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..types.relation import Relation
from .table import Table

DEFAULT_TABLET = ""


def _new_table(name, relation, max_bytes, dicts, device, device_window_rows):
    t = Table(name, relation, max_bytes=max_bytes, dicts=dicts)
    t.device = device
    if device_window_rows is not None:
        t.device_window_rows = int(device_window_rows)
    return t


class TableStore:
    def __init__(self):
        self._lock = threading.Lock()
        # name -> {tablet_id -> Table}
        self._tables: dict[str, dict[str, Table]] = {}

    def add_table(
        self,
        name: str,
        relation: Relation | None = None,
        max_bytes: int = -1,
        tablet_id: str = DEFAULT_TABLET,
        device_window_rows: int | None = None,
        device=None,
    ) -> Table:
        with self._lock:
            base = next(iter(self._tables.get(name, {}).values()), None)
            t = _new_table(
                name, relation, max_bytes,
                base.dicts if base is not None else None,
                device, device_window_rows,
            )
            self._tables.setdefault(name, {})[tablet_id] = t
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
                name, relation, max_bytes, None, device, device_window_rows
            )
            self._tables.setdefault(name, {})[DEFAULT_TABLET] = t
            return t

    def get_table(self, name: str, tablet_id: str = DEFAULT_TABLET) -> Optional[Table]:
        with self._lock:
            return self._tables.get(name, {}).get(tablet_id)

    def table_names(self) -> list[str]:
        with self._lock:
            return sorted(self._tables)

    def tablets(self, name: str) -> list[Table]:
        with self._lock:
            return [t for _, t in sorted(self._tables.get(name, {}).items())]

    def append_data(self, name: str, data, tablet_id: str = DEFAULT_TABLET,
                    time_cols=("time_",)):
        """Ingest push target (table_store.h:152 AppendData). Creates the
        table or tablet on first write; new tablets inherit the base
        tablet's schema, byte budget, (shared) string dictionaries,
        device and window size, so every tablet encodes into one id
        space and stages like its base."""
        with self._lock:
            tablets = self._tables.setdefault(name, {})
            t = tablets.get(tablet_id)
            if t is None:
                base = next(iter(tablets.values()), None)
                t = _new_table(
                    name,
                    base.relation if base is not None else None,
                    base.max_bytes if base is not None else -1,
                    base.dicts if base is not None else None,
                    base.device if base is not None else None,
                    base.device_window_rows if base is not None else None,
                )
                tablets[tablet_id] = t
        return t.append(data, time_cols=time_cols)
