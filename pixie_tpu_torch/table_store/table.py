"""Table: relation + dictionaries over an append-only ring of host batches.

A port of the JAX package's ``table_store/table.py`` without its native
ring and cold tier. Rows live in host memory (numpy) in the pure-numpy
ring ``_PyBackend``. On the push path ``append`` keeps per-column
(min, max) bounds (``col_stats``, which the fragment compiler turns into
dense key domains) and the ingest sketches (``sketches.py``, whose zone
maps drive window skipping), and, with ``device_residency`` on, stages
every newly completed window onto the table's device
(``device_cache.py``). Queries read resident windows through
``device_scan``, or host windows through ``scan``. A table with no
device (``device`` is None until an engine sets it) stages nothing.

Reference parity: ``src/table_store/table/table.h`` (Table, Cursor,
batch queue with byte-budget expiry).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np

from ..config import get_flag
from ..types.batch import HostBatch
from ..types.dtypes import DataType, host_dtypes
from ..types.relation import Relation
from ..types.strings import StringDictionary
from .device_cache import DeviceWindowCache, stage_window

TIME_COLUMN = "time_"


@dataclass
class TableStats:
    """A table's size and ring counters (the JAX package's
    ``TableStats`` for a ring that is neither compacted nor tiered:
    every live byte is hot, and the cold fields stay 0)."""

    bytes: int
    num_batches: int
    batches_added: int
    batches_expired: int
    bytes_added: int
    min_time: int  # of the oldest live batch; -1 when empty
    num_rows: int
    compacted_batches: int = 0
    cold_bytes: int = 0
    cold_rows: int = 0
    cold_raw_bytes: int = 0
    demotions: int = 0
    evictions: int = 0

    @property
    def hot_bytes(self) -> int:
        return self.bytes

    @property
    def hot_rows(self) -> int:
        return self.num_rows


class _PyBackend:
    """Pure-numpy ring of appended batches in row-id order, with
    byte-budget expiry of the oldest batches."""

    def __init__(self, elem_dtypes, has_time, max_bytes):
        self.elem_dtypes = elem_dtypes
        self.row_bytes = sum(np.dtype(d).itemsize for d in elem_dtypes)
        self.has_time = has_time
        self.max_bytes = max_bytes
        self.lock = threading.Lock()
        self.batches: list = []  # [first_row_id, planes, min_t, max_t]
        self.next_row_id = 0
        self.counters = dict(batches_added=0, batches_expired=0, bytes_added=0)

    def _bytes(self) -> int:
        return sum(len(b[1][0]) * self.row_bytes for b in self.batches)

    def _first_row_id(self) -> int:
        return self.batches[0][0] if self.batches else self.next_row_id

    def append(self, planes: Sequence[np.ndarray], times) -> int:
        n = len(planes[0])
        if n == 0:
            return -1
        mn, mx = (int(times.min()), int(times.max())) if self.has_time else (0, 0)
        with self.lock:
            if self.max_bytes >= 0:
                while (
                    self.batches
                    and self._bytes() + n * self.row_bytes > self.max_bytes
                ):
                    self.batches.pop(0)
                    self.counters["batches_expired"] += 1
            rid = self.next_row_id
            self.next_row_id += n
            self.batches.append([rid, [p.copy() for p in planes], mn, mx])
            self.counters["batches_added"] += 1
            self.counters["bytes_added"] += n * self.row_bytes
            return rid

    def stats(self) -> TableStats:
        with self.lock:
            return TableStats(
                bytes=self._bytes(),
                num_batches=len(self.batches),
                min_time=self.batches[0][2] if self.batches else -1,
                num_rows=self.next_row_id - self._first_row_id(),
                **self.counters,
            )

    def first_row_id(self) -> int:
        with self.lock:
            return self._first_row_id()

    def end_row_id(self) -> int:
        with self.lock:
            return self.next_row_id

    def row_id_for_time(self, t: int, strictly_greater: bool) -> int:
        with self.lock:
            if not self.has_time:
                return self._first_row_id()
            for rid, planes, _, mx in self.batches:
                if (mx > t) if strictly_greater else (mx >= t):
                    times = planes[0]
                    hits = np.nonzero(times > t if strictly_greater else times >= t)[0]
                    if len(hits):
                        return rid + int(hits[0])
            return self.next_row_id

    def read(self, start_row_id: int, max_rows: int):
        """(planes, first row id read, rows read) from ``start_row_id``."""
        with self.lock:
            row_id = max(start_row_id, self._first_row_id())
            pieces = [[] for _ in self.elem_dtypes]
            copied = 0
            for rid, planes, _, _ in self.batches:
                n = len(planes[0])
                if rid + n <= row_id:
                    continue
                start = max(0, row_id + copied - rid)
                take = min(n - start, max_rows - copied)
                if take <= 0:
                    continue
                for i, p in enumerate(planes):
                    pieces[i].append(p[start : start + take])
                copied += take
                if copied >= max_rows:
                    break
            out = [
                np.concatenate(ps) if ps else np.empty(0, dtype=d)
                for ps, d in zip(pieces, self.elem_dtypes)
            ]
            return out, row_id, copied


class Table:
    """Engine-facing table: relation + dictionaries over the ring."""

    def __init__(
        self,
        name: str,
        relation: Relation | None = None,
        max_bytes: int = -1,
        dicts: dict[str, StringDictionary] | None = None,
    ):
        self.name = name
        self.relation = relation or Relation()
        # ``dicts`` may be shared across tablets of one logical table so
        # every tablet encodes strings into the same id space.
        self.dicts: dict[str, StringDictionary] = dicts if dicts is not None else {}
        self.max_bytes = max_bytes
        self._backend = None
        self._plane_layout: list[tuple[str, int]] = []  # ring order
        # Per-column (min, max) over every row ever appended, for
        # single-plane integer columns (expiry never narrows them).
        self.col_stats: dict[str, tuple[int, int]] = {}
        # Ingest sketches (sketches.py), gated by the ingest_sketches
        # flag; None until the first sketched append.
        self.sketches = None
        # Device residency: the device windows are staged to (set by the
        # engine that owns the table), the staged windows, and the
        # watermark of rows already staged at append time. The staging
        # window size defaults to the window_rows flag and is adopted
        # from the first consumer that scans at another size.
        self.device = None
        self._device_cache = DeviceWindowCache()
        self._staged_through = 0
        self.device_window_rows = int(get_flag("window_rows"))
        if len(self.relation):
            self._init_backend()

    def _init_backend(self) -> None:
        has_time = (
            self.relation.has_column(TIME_COLUMN)
            and self.relation.col_type(TIME_COLUMN) == DataType.TIME64NS
        )
        # The time plane first (the time index reads plane 0), then every
        # remaining plane in relation order.
        layout: list[tuple[str, int]] = []
        if has_time:
            layout.append((TIME_COLUMN, 0))
        for cname, dt in self.relation.items():
            for i in range(len(host_dtypes(dt))):
                if (cname, i) != (TIME_COLUMN, 0) or not has_time:
                    layout.append((cname, i))
        self._plane_layout = layout
        dts = [
            np.dtype(host_dtypes(self.relation.col_type(c))[i]) for c, i in layout
        ]
        self._backend = _PyBackend(dts, has_time, self.max_bytes)
        for cname, dt in self.relation.items():
            if dt == DataType.STRING:
                self.dicts.setdefault(cname, StringDictionary())

    # -- write path ----------------------------------------------------------
    def append(self, data, time_cols: Iterable[str] = (TIME_COLUMN,)) -> HostBatch:
        """Push path (Stirling's TransferRecordBatch analog, table.h:268)."""
        hb = (
            data
            if isinstance(data, HostBatch)
            else HostBatch.from_pydict(
                data,
                relation=self.relation if len(self.relation) else None,
                time_cols=tuple(time_cols),
                dicts=self.dicts,
            )
        )
        if not len(self.relation):
            self.relation = hb.relation
            self._init_backend()
        if hb.length == 0:
            return hb
        cols = dict(hb.cols)  # never mutate the caller's batch
        for col, d in hb.dicts.items():
            if col not in self.dicts:
                self.dicts[col] = d
            elif self.dicts[col] is not d:
                # Re-encode foreign ids into this table's dictionary,
                # extending it in place (append-only: ids already handed
                # out in earlier batches stay valid).
                mine = self.dicts[col]
                remap = np.fromiter(
                    (mine.get_or_add(s) for s in d.strings),
                    dtype=np.int32,
                    count=len(d),
                )
                ids = cols[col][0]
                cols[col] = (
                    np.where(ids >= 0, remap[np.clip(ids, 0, None)], -1).astype(
                        np.int32
                    ),
                )
        planes = [np.ascontiguousarray(cols[c][i]) for c, i in self._plane_layout]
        for (c, _i), p in zip(self._plane_layout, planes):
            if p.ndim != 1 or len(p) != hb.length:
                raise ValueError(
                    f"column {c!r} plane has shape {p.shape}; expected "
                    f"1-D of length {hb.length}"
                )
        for (c, i), p in zip(self._plane_layout, planes):
            if i == 0 and len(p) and self.relation.col_type(c) in (
                DataType.INT64, DataType.TIME64NS
            ):
                lo, hi = int(p.min()), int(p.max())
                cur = self.col_stats.get(c)
                self.col_stats[c] = (
                    (lo, hi) if cur is None else (min(cur[0], lo), max(cur[1], hi))
                )
        times = cols[TIME_COLUMN][0] if (TIME_COLUMN, 0) == self._plane_layout[0] else None
        rid = self._backend.append(planes, times)
        if (
            get_flag("ingest_sketches") and rid >= 0
            and not self.name.startswith("__")
        ):
            # Zone maps and NDV for the single-plane INT64 and STRING
            # code columns; time_ is skipped (the time index covers it),
            # and dunder telemetry tables are never sketched.
            if self.sketches is None:
                from .sketches import TableSketches

                self.sketches = TableSketches()
            self.sketches.rows += hb.length
            for (c, i), p in zip(self._plane_layout, planes):
                if i != 0 or c == TIME_COLUMN or len(p) == 0:
                    continue
                if self.relation.col_type(c) in (
                    DataType.INT64, DataType.STRING
                ) and len(host_dtypes(self.relation.col_type(c))) == 1:
                    self.sketches.update(c, p, rid)
        if get_flag("device_residency"):
            # Ship newly completed windows to the device now (the copy is
            # asynchronous on CUDA) so queries find them resident.
            self.stage_resident()
        return hb

    # -- row-id space ---------------------------------------------------------
    def first_row_id(self) -> int:
        """Oldest live row id (advances on expiry)."""
        return self._backend.first_row_id()

    def end_row_id(self) -> int:
        return self._backend.end_row_id()

    def row_id_for_time(self, t: int, strictly_greater: bool) -> int:
        return self._backend.row_id_for_time(t, strictly_greater)

    def read_rows(self, start_row_id: int, max_rows: int):
        """(planes in ring order, first row id read, rows read)."""
        return self._backend.read(start_row_id, max_rows)

    def _row_range(self, start_time, stop_time) -> tuple[int, int]:
        row = (
            self.row_id_for_time(int(start_time), False)
            if start_time is not None else self.first_row_id()
        )
        stop = self.end_row_id()
        if stop_time is not None:
            stop = min(stop, self.row_id_for_time(int(stop_time) - 1, True))
        return row, stop

    # -- read path -----------------------------------------------------------
    def scan(self, start_time=None, stop_time=None, window_rows: int = 1 << 17,
             cols: Optional[Sequence[str]] = None, prune=None):
        """Yield HostBatch windows of up to ``window_rows`` rows in row-id
        order, time-bounded to [start_time, stop_time), holding the
        columns ``cols`` (all when None).

        ``prune(row_lo, row_hi) -> bool`` (exec/zoneskip.py) is consulted
        per window BEFORE the read: True moves past [row_lo, row_hi)
        without reading it."""
        be = self._backend
        if be is None:
            return
        row, stop = self._row_range(start_time, stop_time)
        while row < stop:
            if prune is not None:
                hi = min(row + window_rows, stop)
                if prune(row, hi):
                    row = hi
                    continue
            planes, first, n = be.read(row, min(window_rows, stop - row))
            # Expiry may have moved the read past the stop snapshot.
            n = min(n, max(0, stop - first))
            if n == 0:
                return
            row = first + n
            yield self._batch_from_planes([p[:n] for p in planes], cols)

    def stage_resident(self) -> None:
        """Stage all complete windows onto the table's device."""
        if self._backend is None or self.device is None:
            return
        w = self.device_window_rows
        cache = self._device_cache
        cache.evict_before(self.first_row_id())
        end = self.end_row_id()
        self._staged_through = max(
            self._staged_through, (self.first_row_id() // w) * w
        )
        while self._staged_through + w <= end:
            k = self._staged_through // w
            first = max(k * w, self.first_row_id())
            n = min((k + 1) * w, end) - first
            if n > 0 and cache.get((w, k, first, n)) is None:
                win = stage_window(self, k, w)
                if win is not None:
                    cache.put((w, k, win.row0, win.n), win)
            self._staged_through = (k + 1) * w

    def device_scan(self, start_time=None, stop_time=None,
                    window_rows: int | None = None, prune=None, stats=None):
        """Yield (DeviceWindow, lo_row, hi_row) covering the time range.

        Windows come from the device-resident cache when staged (no
        transfer); misses (typically the partial tail window) are staged
        on demand and cached keyed by their length, so a grown tail is
        staged again while full windows stay as they are.
        ``prune(lo, hi)`` (exec/zoneskip.py) runs BEFORE the cache probe,
        so a skipped window is never staged. ``stats`` (optional) counts
        each window served as "resident" or "staged"."""
        if self._backend is None:
            return
        if self.device is None:
            raise ValueError(f"table {self.name!r} has no device to stage to")
        w = int(window_rows or self.device_window_rows)
        cache = self._device_cache
        cache.evict_before(self.first_row_id())
        if w != self.device_window_rows:
            # Adopt the consumer's window size: later appends stage at w,
            # and stagings at other sizes are reclaimed now.
            self.device_window_rows = w
            self._staged_through = 0
        cache.evict_other_window_sizes(w)
        start_row, stop_row = self._row_range(start_time, stop_time)
        if stop_row <= start_row:
            return
        for k in range(start_row // w, (stop_row + w - 1) // w):
            first = max(k * w, self.first_row_id())
            n = min((k + 1) * w, self.end_row_id()) - first
            if n <= 0:
                continue
            if prune is not None:
                plo = max(start_row, first)
                phi = min(stop_row, first + n)
                if phi > plo and prune(plo, phi):
                    continue
            win = cache.get((w, k, first, n))
            if win is None:
                win = stage_window(self, k, w)
                if win is None:
                    continue
                cache.put((w, k, win.row0, win.n), win)
                if stats is not None:
                    stats.add("staged")
            elif stats is not None:
                stats.add("resident")
            lo, hi = max(start_row, win.row0), min(stop_row, win.row0 + win.n)
            if hi > lo:
                yield win, lo, hi

    def _batch_from_planes(self, planes, cols=None) -> HostBatch:
        by_key = {k: p for k, p in zip(self._plane_layout, planes)}
        names = list(cols) if cols is not None else self.relation.column_names
        rel = self.relation.select(names)
        out_cols = {
            c: tuple(by_key[(c, i)] for i in range(len(host_dtypes(rel.col_type(c)))))
            for c in names
        }
        return HostBatch(
            relation=rel,
            cols=out_cols,
            length=len(planes[0]) if planes else 0,
            dicts={c: d for c, d in self.dicts.items() if c in set(names)},
        )

    def stats(self) -> TableStats:
        """Sizes and ring counters (the introspection UDTFs read them)."""
        if self._backend is None:
            return TableStats(0, 0, 0, 0, 0, -1, 0)
        return self._backend.stats()

    @property
    def num_rows(self) -> int:
        be = self._backend
        return be.end_row_id() - be.first_row_id() if be is not None else 0

    @property
    def resident_bytes(self) -> int:
        """Bytes of this table's windows resident on its device."""
        return self._device_cache.nbytes
