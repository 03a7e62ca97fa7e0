"""Device-resident table windows: device memory as the cold store.

A port of the JAX package's ``table_store/device_cache.py``. A full
window of rows is staged onto the table's device once, at append time,
and every later query reads the resident planes, so steady-state queries
copy no table data from the host.

Windows are aligned to absolute row-id multiples of the window size (row
ids are monotone and never reused), so a full window's content never
changes. Partial tail windows are cached keyed by their current length
and staged again as they grow; expired windows are evicted. One LRU
byte budget (``device_cache_bytes``) bounds the sum over every table's
cache.

On CUDA a window is staged through a pinned host buffer and an
asynchronous copy on the device's copy stream (``types/batch.py``
``stage_planes``); the window carries the copy's event, and a consumer
calls ``DeviceWindow.handoff`` before reading it. ``nbytes`` counts the
padded planes the card holds. Eviction drops the tensors; the caching
allocator keeps their memory reserved for reuse, so device use is read
from ``torch.cuda.memory_allocated``, not from the card's totals.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field

from ..config import get_flag
from ..types.batch import bucket_capacity, handoff, stage_planes
from ..types.dtypes import device_dtypes, pad_values

# Global LRU accounting: the device_cache_bytes budget bounds the SUM of
# resident windows across every table's cache (one device memory, many
# tables), so eviction picks the globally least-recently-used window.
# Engines stage from their own threads (appends, prefetch producers)
# while others create tables, so every cache mutation and every
# traversal of the registry holds one lock: the JAX package records a
# "Set changed size during iteration" race here.
_CACHES: "weakref.WeakSet[DeviceWindowCache]" = weakref.WeakSet()
_LOCK = threading.RLock()
_TICK = itertools.count()


def _caches() -> list:
    with _LOCK:
        return list(_CACHES)


def total_resident_bytes() -> int:
    with _LOCK:
        return sum(c._bytes for c in _CACHES)


def _enforce_global_budget(newest: tuple) -> None:
    """Evict globally-LRU windows until under budget; the just-inserted
    window (``newest`` = (cache, key)) always survives."""
    budget = get_flag("device_cache_bytes")
    with _LOCK:
        while total_resident_bytes() > budget:
            victim = None  # (tick, cache, key)
            for c in _CACHES:
                for k, t in c._ticks.items():
                    if (c, k) == newest:
                        continue
                    if victim is None or t < victim[0]:
                        victim = (t, c, k)
            if victim is None:
                break
            victim[1]._evict(victim[2])


@dataclass
class DeviceWindow:
    """One staged window: device column planes + occupancy info.

    ``cols`` maps column name -> tuple of planes, each of length
    ``capacity`` (a power of two). Rows [row0, row0 + n) are live; the
    validity mask for a query's row range is built on the device by the
    fragment from a (lo, hi) pair. ``event`` marks the end of the
    staging copy on CUDA (None on the CPU).
    """

    row0: int  # absolute row id of slot 0
    n: int  # live rows staged
    capacity: int
    cols: dict  # {name: tuple(tensors)}
    nbytes: int
    event: object = None
    _handed: set = field(default_factory=set, repr=False)

    def handoff(self) -> None:
        """Order the consumer's current stream after the staging copy
        (once per consumer stream; a no-op on the CPU)."""
        handoff(self.cols, self.event, self._handed)


class DeviceWindowCache:
    """Cache of staged windows for one Table, keyed ``(W, k, row0, n)``;
    the budget is enforced globally."""

    def __init__(self):
        self._entries: OrderedDict[tuple, DeviceWindow] = OrderedDict()
        self._ticks: dict[tuple, int] = {}
        self._bytes = 0
        with _LOCK:
            _CACHES.add(self)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def keys(self) -> list:
        with _LOCK:
            return list(self._entries)

    def get(self, key: tuple) -> DeviceWindow | None:
        with _LOCK:
            win = self._entries.get(key)
            if win is not None:
                self._entries.move_to_end(key)
                self._ticks[key] = next(_TICK)
            return win

    def put(self, key: tuple, win: DeviceWindow) -> None:
        with _LOCK:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = win
            self._ticks[key] = next(_TICK)
            self._bytes += win.nbytes
            # A grown window supersedes its stale shorter stagings of the
            # same (window_rows, window_index).
            for k in [k for k in self._entries if k[:2] == key[:2] and k != key]:
                self._evict(k)
            _enforce_global_budget(newest=(self, key))

    def _evict(self, key: tuple) -> None:
        with _LOCK:
            win = self._entries.pop(key, None)
            self._ticks.pop(key, None)
            if win is not None:
                self._bytes -= win.nbytes

    def evict_other_window_sizes(self, window_rows: int) -> None:
        """Drop entries staged at a different window size: a consumer
        scanning at W never hits a (W', ...) entry, and keeping them
        would double the device memory in use."""
        with _LOCK:
            for k in [k for k in self._entries if k[0] != window_rows]:
                self._evict(k)

    def evict_before(self, first_row_id: int) -> None:
        """Drop windows fully expired from the table."""
        with _LOCK:
            stale = [
                k for k, w in self._entries.items()
                if w.row0 + w.n <= first_row_id
            ]
            for k in stale:
                self._evict(k)

    def clear(self) -> None:
        with _LOCK:
            self._entries.clear()
            self._ticks.clear()
            self._bytes = 0


def stage_window(table, window_index: int, window_rows: int) -> DeviceWindow | None:
    """Read window ``window_index`` (rows [k*W, (k+1)*W)), pad its n rows
    to ``bucket_capacity(n)`` with each type's pad value and place each
    plane on the table's device in the device dtypes. A full window pads
    as ``bucket_capacity(W)``; a partial tail only to its own power of
    two, so a small table's query copies what its rows need (eager
    PyTorch keeps no compiled program whose shape a fixed capacity would
    keep). Returns None for an empty window. On CUDA the copy is
    asynchronous: callers at append time pay only the host read and
    pad."""
    lo = window_index * window_rows
    planes, first, n = table.read_rows(
        max(lo, table.first_row_id()), window_rows
    )
    hi_cap = (window_index + 1) * window_rows
    if n > 0 and first + n > hi_cap:  # clip reads that ran past the window
        n = max(0, hi_cap - first)
        planes = [p[:n] for p in planes]
    if n <= 0:
        return None
    cap = bucket_capacity(n)
    pads, ddts = [], []
    for cname, plane_i in table._plane_layout:
        dt = table.relation.col_type(cname)
        pads.append(pad_values(dt)[plane_i])
        ddts.append(device_dtypes(dt)[plane_i])  # f64 -> f32 etc.
    staged, event = stage_planes(planes, pads, ddts, cap, table.device)
    cols: dict = {}
    for (cname, plane_i), t in zip(table._plane_layout, staged):
        cols.setdefault(cname, {})[plane_i] = t
    cols = {c: tuple(v[i] for i in sorted(v)) for c, v in cols.items()}
    nbytes = sum(t.numel() * t.element_size() for t in staged)
    return DeviceWindow(
        row0=first, n=n, capacity=cap, cols=cols, nbytes=nbytes, event=event
    )
