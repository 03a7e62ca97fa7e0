"""Control-plane KV datastore with pluggable backends.

Reference parity: ``src/vizier/utils/datastore/datastore.go:65`` — the
interface the metadata service persists agents/tracepoints/cron scripts
through, with pebble (default) and etcd backends. Telemetry data is
deliberately NOT stored here (SURVEY.md §5: the table store is a bounded
in-memory ring); this is durable control-plane state only. Backends:
in-memory (tests, the reference's buntdb role) and sqlite3 (stdlib —
the single-file persistent default, pebble's role).
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Iterable, Optional


class Datastore:
    """KV interface (Get/Set/Delete/GetWithPrefix/DeleteWithPrefix)."""

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def set(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def get_with_prefix(self, prefix: str) -> list[tuple[str, bytes]]:
        raise NotImplementedError

    def delete_with_prefix(self, prefix: str) -> None:
        for k, _ in self.get_with_prefix(prefix):
            self.delete(k)

    def close(self) -> None:
        pass


class MemoryDatastore(Datastore):
    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict[str, bytes] = {}

    def get(self, key):
        with self._lock:
            return self._data.get(key)

    def set(self, key, value):
        with self._lock:
            self._data[key] = bytes(value)

    def delete(self, key):
        with self._lock:
            self._data.pop(key, None)

    def get_with_prefix(self, prefix):
        with self._lock:
            return sorted(
                (k, v) for k, v in self._data.items() if k.startswith(prefix)
            )


class SqliteDatastore(Datastore):
    """Single-file persistent backend (the pebble-default analog)."""

    def __init__(self, path: str):
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v BLOB)"
        )
        self._db.commit()

    def get(self, key):
        with self._lock:
            row = self._db.execute(
                "SELECT v FROM kv WHERE k = ?", (key,)
            ).fetchone()
        return bytes(row[0]) if row else None

    def set(self, key, value):
        with self._lock:
            self._db.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?) "
                "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                (key, bytes(value)),
            )
            self._db.commit()

    def delete(self, key):
        with self._lock:
            self._db.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._db.commit()

    def get_with_prefix(self, prefix):
        # Range scan [prefix, prefix+0x10FFFF) — the ordered-KV idiom.
        with self._lock:
            rows = self._db.execute(
                "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k",
                (prefix, prefix + "\U0010ffff"),
            ).fetchall()
        return [(k, bytes(v)) for k, v in rows]

    def close(self):
        with self._lock:
            self._db.close()
