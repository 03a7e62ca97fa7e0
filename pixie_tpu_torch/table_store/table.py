"""Table: relation + dictionaries over a host slab ring, with an optional
encoded cold tier.

A port of the JAX package's ``table_store/table.py``. Rows live in host
memory in a slab ring with the reference's hot/compacted split and
byte-budget expiry: the native C++ ring (``native/table_ring.cc``, bound
here with ctypes as ``_NativeBackend``), or its pure-numpy mirror
``_PyBackend`` with the same ABI, which a table takes only when
``load_native`` gives no library. The port's ``load_native`` raises when
the ring does not build, so the numpy ring is taken only where a caller
patches ``load_native`` (the tests, ``chip_smoke.py``'s ring timing).

With the ``cold_tier_mb`` flag set, a byte-bounded table is tiered
(``tier.py``): its ring is unbounded, the oldest windows demote into an
encoded cold store (``coldstore.py``) before each append that would
pass ``max_bytes``, and only cold eviction is expiry. One monotone
row-id space spans both tiers; ``first_row_id``, ``row_id_for_time`` and
``read_rows`` merge them.

On the push path ``append`` keeps per-column (min, max) bounds
(``col_stats``, which the fragment compiler turns into dense key
domains and whose ``time_`` bound is the table's event-time watermark),
the ingest sketches (``sketches.py``, whose zone maps drive window
skipping) and the freshness bookkeeping, and, with
``device_residency`` on, stages every newly completed window onto the
table's device (``device_cache.py``). Queries read resident windows
through ``device_scan`` (whose ``start_row`` / ``stop_row`` bounds serve
the streaming cursor), or host windows through ``scan``. A table with no
device (``device`` is None until an engine sets it) stages nothing.

Reference parity: ``src/table_store/table/table.h`` (Table, Cursor,
hot/cold batch queues with unique row ids and byte-budget expiry).
"""

from __future__ import annotations

import ctypes
import threading
import time
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np

from ..config import get_flag
from ..native import load as load_native
from ..types.batch import HostBatch
from ..types.dtypes import DataType, host_dtypes
from ..types.relation import Relation
from ..types.strings import StringDictionary
from .device_cache import DeviceWindowCache, stage_window

TIME_COLUMN = "time_"
DEFAULT_COMPACTED_ROWS = 64 * 1024

#: EWMA smoothing factor of the per-append ingest rate (about the last
#: five appends dominate).
INGEST_EWMA_ALPHA = 0.2


@dataclass
class TableStats:
    """The ring's ten counters (the native stats buffer) and the
    freshness and tier fields around them, as in the JAX package."""

    bytes: int
    hot_bytes: int
    cold_bytes: int
    num_batches: int
    batches_added: int
    batches_expired: int
    bytes_added: int
    compacted_batches: int
    min_time: int
    num_rows: int
    # Freshness, kept outside the ring's buffer: row ids are never
    # reused, so end_row_id is the rows ever appended and first_row_id
    # the rows expired; the watermark is col_stats' time_ bound.
    rows_added: int = 0
    rows_expired: int = 0  # by true expiry only
    bytes_expired: int = 0
    watermark: int = -1  # max event-time ns ever appended
    last_append_unix_ns: int = 0
    ingest_rows_per_s: float = 0.0
    device_bytes: int = 0  # staged window bytes on the table's device
    # Tier split (zeros when untiered). For a tiered table hot_bytes and
    # cold_bytes are the ring and the encoded store.
    hot_rows: int = 0
    cold_rows: int = 0
    cold_raw_bytes: int = 0
    cold_windows: int = 0
    demotions: int = 0
    evictions: int = 0
    decode_seconds: float = 0.0


@dataclass(frozen=True)
class StartSpec:
    """Where a cursor begins: at a time, or the current start of table."""

    start_time: Optional[int] = None

    @classmethod
    def at_time(cls, t: int) -> "StartSpec":
        return cls(start_time=t)


@dataclass(frozen=True)
class StopSpec:
    """When a cursor is exhausted: at a time, at the end of the table
    when the cursor was made, or never (a tailing cursor, which sees
    later appends; a live query over the device windows polls with a
    ``StreamingQuery`` instead)."""

    stop_time: Optional[int] = None
    infinite: bool = False

    @classmethod
    def at_time(cls, t: int) -> "StopSpec":
        return cls(stop_time=t)

    @classmethod
    def current_end(cls) -> "StopSpec":
        return cls()

    @classmethod
    def never(cls) -> "StopSpec":
        return cls(infinite=True)


class _PyBackend:
    """Pure-numpy mirror of the native ring's ABI."""

    def __init__(self, elem_dtypes, has_time, compacted_rows, max_bytes):
        self.elem_dtypes = [np.dtype(d) for d in elem_dtypes]
        self.row_bytes = sum(d.itemsize for d in self.elem_dtypes)
        self.has_time = has_time
        self.compacted_rows = compacted_rows
        self.max_bytes = max_bytes
        self.lock = threading.Lock()
        self.hot: list = []  # [first_row_id, planes, min_t, max_t]
        self.cold: list = []
        self.next_row_id = 0
        self.counters = dict(
            batches_added=0, batches_expired=0, bytes_added=0, compacted=0
        )

    def _bytes(self, q) -> int:
        return sum(len(b[1][0]) * self.row_bytes for b in q)

    def _first_row_id(self) -> int:
        if self.cold:
            return self.cold[0][0]
        if self.hot:
            return self.hot[0][0]
        return self.next_row_id

    def append(self, planes: Sequence[np.ndarray], times) -> int:
        n = len(planes[0])
        if n == 0:
            return -1
        mn, mx = (int(times.min()), int(times.max())) if self.has_time else (0, 0)
        with self.lock:
            if self.max_bytes >= 0:
                while (
                    self._bytes(self.hot) + self._bytes(self.cold)
                    + n * self.row_bytes > self.max_bytes
                ):
                    q = self.cold if self.cold else self.hot
                    if not q:
                        break
                    q.pop(0)
                    self.counters["batches_expired"] += 1
            rid = self.next_row_id
            self.next_row_id += n
            self.hot.append([rid, [p.copy() for p in planes], mn, mx])
            self.counters["batches_added"] += 1
            self.counters["bytes_added"] += n * self.row_bytes
            return rid

    def compact(self) -> int:
        """Merge hot batches into cold batches of about
        ``compacted_rows`` rows; returns the cold batches made."""
        with self.lock:
            created = 0
            while self.hot:
                rows, take = 0, 0
                while take < len(self.hot) and rows < self.compacted_rows:
                    rows += len(self.hot[take][1][0])
                    take += 1
                group = self.hot[:take]
                del self.hot[:take]
                planes = [
                    np.concatenate([g[1][i] for g in group])
                    for i in range(len(self.elem_dtypes))
                ]
                self.cold.append([
                    group[0][0], planes,
                    min(g[2] for g in group), max(g[3] for g in group),
                ])
                self.counters["compacted"] += 1
                created += 1
            return created

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
            for q in (self.cold, self.hot):
                for rid, planes, _, mx in q:
                    if (mx > t) if strictly_greater else (mx >= t):
                        times = planes[0]
                        hits = np.nonzero(
                            times > t if strictly_greater else times >= t
                        )[0]
                        if len(hits):
                            return rid + int(hits[0])
            return self.next_row_id

    def read(self, start_row_id: int, max_rows: int):
        """(planes, first row id read, rows read) from ``start_row_id``."""
        with self.lock:
            row_id = max(start_row_id, self._first_row_id())
            pieces = [[] for _ in self.elem_dtypes]
            copied = 0
            for q in (self.cold, self.hot):
                for rid, planes, _, _ in q:
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
                if copied >= max_rows:
                    break
            out = [
                np.concatenate(ps) if ps else np.empty(0, dtype=d)
                for ps, d in zip(pieces, self.elem_dtypes)
            ]
            return out, row_id, copied

    def drop_before(self, row_id: int) -> int:
        """Drop rows with id < row_id: the cold tier's demotion handoff,
        not expiry (batches_expired does not move). A batch straddling
        row_id is split and its tail kept."""
        with self.lock:
            for q in (self.cold, self.hot):
                while q:
                    rid, planes, mn, mx = q[0]
                    n = len(planes[0])
                    if rid + n <= row_id:
                        q.pop(0)
                        continue
                    if rid < row_id:
                        drop = row_id - rid
                        tail = [p[drop:].copy() for p in planes]
                        if self.has_time:
                            mn = int(tail[0].min())
                            mx = int(tail[0].max())
                        q[0] = [row_id, tail, mn, mx]
                    return self._first_row_id()
            return self._first_row_id()

    def stats(self) -> list:
        with self.lock:
            hot_b, cold_b = self._bytes(self.hot), self._bytes(self.cold)
            min_t = (
                self.cold[0][2] if self.cold
                else (self.hot[0][2] if self.hot else -1)
            )
            return [
                hot_b + cold_b, hot_b, cold_b,
                len(self.hot) + len(self.cold),
                self.counters["batches_added"],
                self.counters["batches_expired"],
                self.counters["bytes_added"],
                self.counters["compacted"],
                min_t,
                self.next_row_id - self._first_row_id(),
            ]


class _NativeBackend:
    """ctypes binding of ``native/table_ring.cc``."""

    def __init__(self, lib, elem_dtypes, has_time, compacted_rows, max_bytes):
        self.lib = lib
        self.elem_dtypes = [np.dtype(d) for d in elem_dtypes]
        self.row_bytes = sum(d.itemsize for d in self.elem_dtypes)
        self.has_time = has_time
        self._configure(lib)
        sizes = (ctypes.c_int32 * len(self.elem_dtypes))(
            *[d.itemsize for d in self.elem_dtypes]
        )
        self.handle = lib.pxt_table_create(
            len(self.elem_dtypes), sizes, int(has_time), compacted_rows,
            max_bytes,
        )

    @staticmethod
    def _configure(lib):
        if getattr(lib, "_pxt_configured", False):
            return
        i32, i64, ptr = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
        lib.pxt_table_create.restype = ptr
        lib.pxt_table_create.argtypes = [
            i32, ctypes.POINTER(i32), i32, i64, i64,
        ]
        lib.pxt_table_destroy.argtypes = [ptr]
        lib.pxt_table_append.restype = i64
        lib.pxt_table_append.argtypes = [
            ptr, i64, ctypes.POINTER(ptr), ctypes.POINTER(i64),
        ]
        for fn in ("pxt_table_compact", "pxt_table_first_row_id",
                   "pxt_table_end_row_id"):
            f = getattr(lib, fn)
            f.restype = i64
            f.argtypes = [ptr]
        lib.pxt_table_row_id_for_time.restype = i64
        lib.pxt_table_row_id_for_time.argtypes = [ptr, i64, i32]
        lib.pxt_table_read.restype = i64
        lib.pxt_table_read.argtypes = [
            ptr, i64, i64, ctypes.POINTER(ptr), ctypes.POINTER(i64),
        ]
        lib.pxt_table_stats.argtypes = [ptr, ctypes.POINTER(i64)]
        lib.pxt_table_drop_before.restype = i64
        lib.pxt_table_drop_before.argtypes = [ptr, i64]
        lib._pxt_configured = True

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.pxt_table_destroy(self.handle)
            self.handle = None

    def append(self, planes: Sequence[np.ndarray], times) -> int:
        planes = [np.ascontiguousarray(p) for p in planes]
        ptrs = (ctypes.c_void_p * len(planes))(*[p.ctypes.data for p in planes])
        tptr = None
        if self.has_time:
            times = np.ascontiguousarray(times, dtype=np.int64)
            tptr = times.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        return self.lib.pxt_table_append(self.handle, len(planes[0]), ptrs, tptr)

    def compact(self) -> int:
        return self.lib.pxt_table_compact(self.handle)

    def first_row_id(self) -> int:
        return self.lib.pxt_table_first_row_id(self.handle)

    def end_row_id(self) -> int:
        return self.lib.pxt_table_end_row_id(self.handle)

    def row_id_for_time(self, t: int, strictly_greater: bool) -> int:
        return self.lib.pxt_table_row_id_for_time(
            self.handle, t, int(strictly_greater)
        )

    def read(self, start_row_id: int, max_rows: int):
        out = [np.empty(max_rows, dtype=d) for d in self.elem_dtypes]
        ptrs = (ctypes.c_void_p * len(out))(*[a.ctypes.data for a in out])
        first = ctypes.c_int64(0)
        n = self.lib.pxt_table_read(
            self.handle, start_row_id, max_rows, ptrs, ctypes.byref(first)
        )
        return [a[:n] for a in out], first.value, n

    def drop_before(self, row_id: int) -> int:
        return self.lib.pxt_table_drop_before(self.handle, row_id)

    def stats(self) -> list:
        buf = (ctypes.c_int64 * 10)()
        self.lib.pxt_table_stats(self.handle, buf)
        return list(buf)


class Cursor:
    """Iterates a Table without returning a row twice: its position is
    the unique id of the next unread row, so compaction, demotion and
    expiry never desynchronize it (``table.h`` Table::Cursor)."""

    def __init__(self, table: "Table", start: StartSpec, stop: StopSpec):
        self._table = table
        if start.start_time is not None:
            self._next_row_id = table.row_id_for_time(start.start_time, False)
        else:
            self._next_row_id = table.first_row_id()
        self.update_stop_spec(stop)

    def update_stop_spec(self, stop: StopSpec) -> None:
        t = self._table
        if stop.infinite:
            self._stop_row_id = None  # tails the table: never done
            return
        self._stop_row_id = t.end_row_id()
        if stop.stop_time is not None:
            # At the time or the current end, whichever comes first.
            self._stop_row_id = min(
                t.row_id_for_time(stop.stop_time, True), self._stop_row_id
            )

    def done(self) -> bool:
        if self._stop_row_id is None:
            return False
        return self._next_row_id >= self._stop_row_id

    def next_batch_ready(self) -> bool:
        """Whether ``next_batch`` has rows to return now (a tailing
        cursor: whether rows were appended past its position)."""
        if self._stop_row_id is not None:
            return not self.done()
        return self._next_row_id < self._table.end_row_id()

    def skip_to(self, row_id: int) -> None:
        """Move past rows a zone-map check proved irrelevant (never
        backwards)."""
        self._next_row_id = max(self._next_row_id, int(row_id))

    def next_batch(self, max_rows: int, cols: Optional[Sequence[str]] = None):
        """Up to max_rows rows as a HostBatch, or None when exhausted (or,
        for a tailing cursor, when no row is waiting). After expiry the
        read resumes at the first live row."""
        if self.done():
            return None
        stop = self._stop_row_id
        if stop is not None:
            max_rows = min(max_rows, stop - self._next_row_id)
        planes, first, n = self._table.read_rows(self._next_row_id, max_rows)
        if stop is not None:
            # Expiry may have moved the read past the stop snapshot.
            n = min(n, max(0, stop - first))
            planes = [p[:n] for p in planes]
        if n == 0:
            self._next_row_id = max(self._next_row_id, first)
            return None
        self._next_row_id = first + n
        return self._table._batch_from_planes(planes, cols)


class Table:
    """Engine-facing table: relation + dictionaries over the ring."""

    def __init__(
        self,
        name: str,
        relation: Relation | None = None,
        max_bytes: int = -1,
        compacted_rows: int = DEFAULT_COMPACTED_ROWS,
        dicts: dict[str, StringDictionary] | None = None,
    ):
        self.name = name
        self.relation = relation or Relation()
        # ``dicts`` may be shared across tablets of one logical table so
        # every tablet encodes strings into the same id space.
        self.dicts: dict[str, StringDictionary] = dicts if dicts is not None else {}
        self.max_bytes = max_bytes
        self.compacted_rows = compacted_rows
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
        # Freshness bookkeeping: wall time of the latest append and a
        # per-append ingest-rate EWMA (plain attribute writes on the
        # push path; readers snapshot them through stats()).
        self._last_append_unix_ns = 0
        self._last_append_mono = None
        self._last_append_rows = 0
        self._ingest_ewma = 0.0
        # The cold tier (tier.py), set by _init_backend when the
        # cold_tier_mb flag is on and the table is byte-bounded.
        self._tier = None
        # Appends to one table serialize: an agent's collector thread and
        # a flush from another thread (``poll_tracepoints``, a test) can
        # push into the same table, and the first append of a table
        # created without a relation builds its ring.
        self._append_lock = threading.Lock()
        if len(self.relation):
            self._init_backend()

    def _init_backend(self) -> None:
        has_time = (
            self.relation.has_column(TIME_COLUMN)
            and self.relation.col_type(TIME_COLUMN) == DataType.TIME64NS
        )
        # The time plane first (the ring's time index reads plane 0),
        # then every remaining plane in relation order.
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
        cold_mb = int(get_flag("cold_tier_mb"))
        tiered = cold_mb > 0 and self.max_bytes >= 0
        # A tiered ring is unbounded: the tier manager owns both budgets
        # (demote past max_bytes, evict past cold_tier_mb), so the ring
        # never expires rows under a demotion.
        args = (dts, has_time, self.compacted_rows,
                -1 if tiered else self.max_bytes)
        lib = load_native("table_ring")
        self._backend = (
            _NativeBackend(lib, *args) if lib is not None else _PyBackend(*args)
        )
        if tiered:
            from .tier import MB, TierManager

            self._tier = TierManager(self, self.max_bytes, cold_mb * MB)
        for cname, dt in self.relation.items():
            if dt == DataType.STRING:
                self.dicts.setdefault(cname, StringDictionary())

    # -- write path ----------------------------------------------------------
    def append(self, data, time_cols: Iterable[str] = (TIME_COLUMN,)) -> HostBatch:
        """Push path (Stirling's TransferRecordBatch analog, table.h:268)."""
        with self._append_lock:
            return self._append(data, time_cols)

    def _append(self, data, time_cols: Iterable[str]) -> HostBatch:
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
        if self._tier is not None:
            # Make room before the append lands: the oldest windows
            # demote (encode, then drop from the ring; not expiry), so
            # the unbounded ring never holds more than max_bytes.
            self._tier.demote_for(sum(p.nbytes for p in planes))
        rid = self._backend.append(planes, times)
        if rid >= 0:
            self._note_append_freshness(hb.length)
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

    def _note_append_freshness(self, n: int) -> None:
        """Per appended batch: the wall time and the ingest-rate EWMA
        (the watermark itself is col_stats' time_ bound)."""
        self._last_append_unix_ns = time.time_ns()
        self._last_append_rows = n
        mono = time.monotonic()
        prev, self._last_append_mono = self._last_append_mono, mono
        if prev is not None and mono > prev:
            rate = n / (mono - prev)
            self._ingest_ewma += INGEST_EWMA_ALPHA * (rate - self._ingest_ewma)

    def compact(self) -> int:
        """Merge the ring's hot batches into compacted ones
        (CompactHotToCold); returns the compacted batches made."""
        return self._backend.compact() if self._backend is not None else 0

    # -- the row-id space across both tiers -----------------------------------
    # Demotion moves a row from the ring to the cold store without
    # changing its id, so cursors and watermarks keyed by row id never
    # read a row twice or skip one across a demotion.
    def first_row_id(self) -> int:
        """Oldest live row id across both tiers: it advances only on true
        expiry (cold eviction for a tiered table, ring expiry else)."""
        if self._tier is not None:
            f = self._tier.store.first_row_id()
            if f is not None:
                return f
        return self._backend.first_row_id()

    def end_row_id(self) -> int:
        return self._backend.end_row_id()

    def row_id_for_time(self, t: int, strictly_greater: bool) -> int:
        if self._tier is not None:
            store = self._tier.store
            if not store.has_time:
                return self.first_row_id()
            r = store.row_id_for_time(t, strictly_greater)
            if r is not None:
                return r
        return self._backend.row_id_for_time(t, strictly_greater)

    def read_rows(self, start_row_id: int, max_rows: int):
        """(planes in ring order, first row id read, rows read), across
        both tiers. Rows below the ring's first row come from the cold
        store, and the ring continues them: demotion encodes into the
        cold store before it drops from the ring, so a row the ring no
        longer has is cold or truly evicted, never in flight. A read
        that starts cold copies no ring rows it does not return (a cold
        window's read used to copy a whole ring window and drop it)."""
        if self._tier is not None:
            ring_first = self._backend.first_row_id()
            if start_row_id < ring_first:
                want = min(ring_first - start_row_id, max_rows)
                c_planes, c_first, c_n = self._tier.store.read(
                    start_row_id, want
                )
                if c_n:
                    if c_n < max_rows and c_first + c_n == ring_first:
                        h_planes, h_first, h_n = self._backend.read(
                            ring_first, max_rows - c_n
                        )
                        # The ring may have demoted past ring_first since:
                        # then only the cold rows are returned.
                        if h_n and h_first == ring_first:
                            planes = [
                                np.concatenate([cp, hp])
                                for cp, hp in zip(c_planes, h_planes)
                            ]
                            return planes, c_first, c_n + h_n
                    return c_planes, c_first, c_n
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
    def cursor(self, start: StartSpec | None = None,
               stop: StopSpec | None = None) -> Cursor:
        return Cursor(self, start or StartSpec(), stop or StopSpec())

    def scan(self, start_time=None, stop_time=None, window_rows: int = 1 << 17,
             cols: Optional[Sequence[str]] = None, prune=None):
        """Yield HostBatch windows of up to ``window_rows`` rows in row-id
        order, time-bounded to [start_time, stop_time), holding the
        columns ``cols`` (all when None).

        ``prune(row_lo, row_hi) -> bool`` (exec/zoneskip.py) is consulted
        per window BEFORE the read: True moves past [row_lo, row_hi)
        without reading either tier (a cold window is never decoded)."""
        if self._backend is None:
            return
        row, stop = self._row_range(start_time, stop_time)
        while row < stop:
            if prune is not None:
                hi = min(row + window_rows, stop)
                if prune(row, hi):
                    row = hi
                    continue
            planes, first, n = self.read_rows(row, min(window_rows, stop - row))
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
        # Evict by the first live row across both tiers: demoted rows
        # keep their staged windows, only true expiry reclaims them.
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
                    window_rows: int | None = None, start_row=None,
                    stop_row=None, prune=None, stats=None):
        """Yield (DeviceWindow, lo_row, hi_row) covering the time range.

        Windows come from the device-resident cache when staged (no
        transfer); misses (typically the partial tail window) are staged
        on demand and cached keyed by their length, so a grown tail is
        staged again while full windows stay as they are. ``start_row``
        / ``stop_row`` clamp by absolute row id (the streaming cursor's
        watermarks). ``prune(lo, hi)`` (exec/zoneskip.py) runs BEFORE
        the cache probe, so a skipped window is never decoded or
        staged. ``stats`` (optional) counts each window served as
        "resident" or "staged"."""
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
        lo_row, hi_row = self._row_range(start_time, stop_time)
        if start_row is not None:
            lo_row = max(lo_row, int(start_row))
        if stop_row is not None:
            hi_row = min(hi_row, int(stop_row))
        if hi_row <= lo_row:
            return
        for k in range(lo_row // w, (hi_row + w - 1) // w):
            first = max(k * w, self.first_row_id())
            n = min((k + 1) * w, self.end_row_id()) - first
            if n <= 0:
                continue
            if prune is not None:
                plo = max(lo_row, first)
                phi = min(hi_row, first + n)
                if phi > plo and prune(plo, phi):
                    continue
            win = cache.get((w, k, first, n))
            if win is None:
                win = stage_window(self, k, w)
                if win is None:
                    continue
                cache.put((w, k, win.row0, win.n), win)
                if stats is not None:
                    stats.add("staged", nbytes=win.nbytes)
            elif stats is not None:
                stats.add("resident")
            lo, hi = max(lo_row, win.row0), min(hi_row, win.row0 + win.n)
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

    def read_all(self) -> HostBatch:
        """Every live row as one HostBatch (tests and debugging)."""
        if self._backend is None:
            from ..exec.stream import _empty_host_batch

            return _empty_host_batch(self.relation, self.dicts)
        planes, _, got = self.read_rows(self.first_row_id(), max(1, self.num_rows))
        return self._batch_from_planes([p[:got] for p in planes])

    # -- introspection -------------------------------------------------------
    @property
    def num_rows(self) -> int:
        if self._backend is None:
            return 0
        return self.end_row_id() - self.first_row_id()

    @property
    def resident_bytes(self) -> int:
        """Bytes of this table's windows resident on its device."""
        return self._device_cache.nbytes

    @property
    def watermark_ns(self):
        """Max event-time ns ever appended (None without a time index);
        expiry never moves it back."""
        st = self.col_stats.get(TIME_COLUMN)
        return st[1] if st is not None else None

    def stats(self) -> TableStats:
        """The ring's counters and the freshness and tier fields. Under
        concurrent appends the reads may straddle a batch; the fields
        reconcile exactly once appends stop."""
        if self._backend is None:
            return TableStats(0, 0, 0, 0, 0, 0, 0, 0, -1, 0)
        be = self._backend
        st = TableStats(*be.stats())
        st.rows_added = be.end_row_id()
        if self._tier is not None:
            # The whole ring is the hot tier, the encoded store the cold
            # one; only cold eviction is expiry (demotion moved rows).
            cs = self._tier.store
            st.hot_bytes = st.bytes
            st.cold_bytes = cs.nbytes
            st.bytes = st.hot_bytes + cs.nbytes
            st.hot_rows = st.num_rows
            st.cold_rows = cs.num_rows()
            st.num_rows = be.end_row_id() - self.first_row_id()
            st.num_batches += len(cs.windows)
            cold_min_t = cs.min_time()
            if cold_min_t is not None:
                st.min_time = cold_min_t
            st.rows_expired = cs.rows_evicted
            st.bytes_expired = cs.bytes_evicted_raw
            st.cold_raw_bytes = cs.raw_nbytes
            st.cold_windows = len(cs.windows)
            st.demotions = cs.demotions
            st.evictions = cs.evictions
            st.decode_seconds = cs.decode_seconds
        else:
            st.hot_rows = st.num_rows
            st.rows_expired = be.first_row_id()
            st.bytes_expired = st.bytes_added - st.bytes
        wm = self.watermark_ns
        st.watermark = wm if wm is not None else -1
        st.last_append_unix_ns = self._last_append_unix_ns
        st.ingest_rows_per_s = self._current_ingest_rate()
        st.device_bytes = self._device_cache.nbytes
        return st

    def _current_ingest_rate(self) -> float:
        """The EWMA, decayed at read time: capped at the last batch's
        rows over the silence since, so a stopped ingest decays toward 0
        while an active one reports the EWMA unchanged."""
        last = self._last_append_mono
        if last is None:
            return 0.0
        elapsed = time.monotonic() - last
        if elapsed <= 0:
            return self._ingest_ewma
        return min(self._ingest_ewma, self._last_append_rows / elapsed)

    def freshness(self) -> dict:
        """The freshness surface as a flat dict: live sizes, monotonic
        append and expiry counters, the watermark, the last append's
        wall time, the ingest rate and the tier split."""
        st = self.stats()
        return {
            "rows": st.num_rows,
            "bytes": st.bytes,
            "hot_bytes": st.hot_bytes,
            "cold_bytes": st.cold_bytes,
            "device_bytes": st.device_bytes,
            "rows_total": st.rows_added,
            "bytes_total": st.bytes_added,
            "expired_rows_total": st.rows_expired,
            "expired_bytes_total": st.bytes_expired,
            "watermark": st.watermark,
            "min_time": st.min_time,
            "last_append": st.last_append_unix_ns,
            "ingest_rows_per_s": round(st.ingest_rows_per_s, 3),
            "hot_rows": st.hot_rows,
            "cold_rows": st.cold_rows,
            "cold_raw_bytes": st.cold_raw_bytes,
            "cold_demotions_total": st.demotions,
            "cold_evictions_total": st.evictions,
            "cold_decode_seconds_total": round(st.decode_seconds, 6),
        }


def max_watermark_ns(tablets):
    """Max event-time watermark across ``tablets`` (None when none has a
    time index or a row). The one freshness sweep of a cache lookup, a
    scan or a streaming poll; callers resolve it through this module so
    a test can count the sweeps."""
    wm = -1
    for t in tablets:
        w = getattr(t, "watermark_ns", None)
        if w is not None and w > wm:
            wm = int(w)
    return None if wm < 0 else wm
