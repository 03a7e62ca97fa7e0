"""TableStore: the name -> Table map shared by ingest and queries.

Reference parity: ``src/table_store/table/table_store.h:79``, with tablet
support (``tablets_group.h``): a (table, tablet_id) pair maps to its own
physical Table, and reads over the table see all tablets. A port of the
JAX package's ``table_store/table_store.py`` without numeric table ids.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..types.relation import Relation
from .table import Table

DEFAULT_TABLET = ""


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
    ) -> Table:
        with self._lock:
            base = next(iter(self._tables.get(name, {}).values()), None)
            t = Table(
                name,
                relation,
                max_bytes=max_bytes,
                dicts=base.dicts if base is not None else None,
            )
            self._tables.setdefault(name, {})[tablet_id] = t
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
        tablet's schema, byte budget and (shared) string dictionaries so
        every tablet encodes into one id space."""
        with self._lock:
            tablets = self._tables.setdefault(name, {})
            t = tablets.get(tablet_id)
            if t is None:
                base = next(iter(tablets.values()), None)
                t = Table(
                    name,
                    base.relation if base is not None else None,
                    max_bytes=base.max_bytes if base is not None else -1,
                    dicts=base.dicts if base is not None else None,
                )
                tablets[tablet_id] = t
        return t.append(data, time_cols=time_cols)
