"""Table: relation + dictionaries over an append-only ring of host batches.

A port of the JAX package's ``table_store/table.py`` without its native
ring, cold tier, device-resident window cache and ingest sketches. Rows
live in host memory (numpy) in the pure-numpy ring ``_PyBackend``;
queries read them in windows that the engine copies to the device.
``Table.col_stats`` keeps per-column (min, max) over every appended
integer row, which the fragment compiler turns into dense key domains.

Reference parity: ``src/table_store/table/table.h`` (Table, Cursor,
batch queue with byte-budget expiry).
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional, Sequence

import numpy as np

from ..types.batch import HostBatch
from ..types.dtypes import DataType, host_dtypes
from ..types.relation import Relation
from ..types.strings import StringDictionary

TIME_COLUMN = "time_"


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
            rid = self.next_row_id
            self.next_row_id += n
            self.batches.append([rid, [p.copy() for p in planes], mn, mx])
            return rid

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
            if i == 0 and self.relation.col_type(c) in (
                DataType.INT64, DataType.TIME64NS
            ):
                lo, hi = int(p.min()), int(p.max())
                cur = self.col_stats.get(c)
                self.col_stats[c] = (
                    (lo, hi) if cur is None else (min(cur[0], lo), max(cur[1], hi))
                )
        times = cols[TIME_COLUMN][0] if (TIME_COLUMN, 0) == self._plane_layout[0] else None
        self._backend.append(planes, times)
        return hb

    # -- read path -----------------------------------------------------------
    def scan(self, start_time=None, stop_time=None, window_rows: int = 1 << 17,
             cols: Optional[Sequence[str]] = None):
        """Yield HostBatch windows of up to ``window_rows`` rows in row-id
        order, time-bounded to [start_time, stop_time), holding the
        columns ``cols`` (all when None)."""
        be = self._backend
        if be is None:
            return
        row = (
            be.row_id_for_time(int(start_time), False)
            if start_time is not None else be.first_row_id()
        )
        stop = be.end_row_id()
        if stop_time is not None:
            stop = min(stop, be.row_id_for_time(int(stop_time) - 1, True))
        while row < stop:
            planes, first, n = be.read(row, min(window_rows, stop - row))
            # Expiry may have moved the read past the stop snapshot.
            n = min(n, max(0, stop - first))
            if n == 0:
                return
            row = first + n
            yield self._batch_from_planes([p[:n] for p in planes], cols)

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

    @property
    def num_rows(self) -> int:
        be = self._backend
        return be.end_row_id() - be.first_row_id() if be is not None else 0
