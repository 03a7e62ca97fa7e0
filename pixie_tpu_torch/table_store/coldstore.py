"""Encoded cold storage tier: immutable compressed column windows.

A copy of the JAX package's ``table_store/coldstore.py`` (plain numpy).

The source table is explicitly hot/cold (``table/table.h:104``); the hot
ring (``table.py`` backends) holds raw fixed-width slabs sized for
zero-conversion staging, while this module holds the *demoted* tail of
the table as immutable encoded windows:

- **delta**    — monotonic non-decreasing int64 planes (``time_``, sorted
  row-id-like columns): first value + diffs downcast to the narrowest
  unsigned width that fits the largest diff.
- **rle**      — low-NDV numerics: (run values, run lengths) pairs kept
  only when they beat the raw slab by 2x.
- **dict**     — formalizes the existing string-id coding: string columns
  arrive as int32 dictionary codes already (``types/strings.py``), so the
  cold form is the code plane rebased to the narrowest unsigned width.
  Also applied to narrow-range integer planes.
- **raw**      — verbatim copy fallback; never worse than the hot slab.

Decode is bit-exact: ``decode()`` returns the original dtype and values,
so hot-vs-cold scans are bit-identical by construction (tested in
``tests/test_torch_storage_tier.py``). Windows are immutable after
``append_window`` — readers decode without holding the store lock.

Decode attribution: decoding runs on whatever thread stages the window —
under the ``WindowPipeline`` that is the prefetch producer thread, which
is exactly what overlaps decompression with device compute
(decode-on-stage). A thread-local meter accumulates (seconds, bytes) per
decode so the engine can charge each query's decode seconds
(``QueryStats.decode_s``) from the producer thread, which holds no other
query-scoped state.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

#: Run-length encoding must beat raw by this factor to be chosen (the
#: decode pass costs a ``np.repeat``; a marginal win is not worth it).
_RLE_GAIN = 2.0

# -- thread-local decode meter -----------------------------------------------

_METER = threading.local()


def take_decode_meter() -> tuple[float, int]:
    """Return and reset this thread's (decode seconds, decoded raw bytes)
    accumulated since the last take. The staging generators call this
    after each window so decode time lands in the per-query trace even
    though decoding happens on the pipeline producer thread."""
    out = (getattr(_METER, "secs", 0.0), getattr(_METER, "nbytes", 0))
    _METER.secs = 0.0
    _METER.nbytes = 0
    return out


def _meter_add(secs: float, nbytes: int) -> None:
    _METER.secs = getattr(_METER, "secs", 0.0) + secs
    _METER.nbytes = getattr(_METER, "nbytes", 0) + nbytes


# -- plane encodings ----------------------------------------------------------


def _narrowest_uint(hi: int) -> np.dtype:
    for d in (np.uint8, np.uint16, np.uint32):
        if hi <= np.iinfo(d).max:
            return np.dtype(d)
    return np.dtype(np.uint64)


@dataclass(frozen=True)
class EncodedPlane:
    """One immutable encoded column plane of a cold window."""

    kind: str  # 'raw' | 'delta' | 'rle' | 'dict'
    dtype: np.dtype  # decoded dtype
    n: int
    data: tuple  # kind-specific ndarrays / scalars

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.data if isinstance(a, np.ndarray))

    def decode(self) -> np.ndarray:
        if self.kind == "raw":
            return self.data[0]
        if self.kind == "delta":
            first, diffs = self.data
            out = np.empty(self.n, dtype=np.int64)
            np.cumsum(diffs, dtype=np.int64, out=out)
            out += first
            if self.dtype.kind == "u":  # exact mod-2^64 reinterpret
                return out.view(self.dtype)
            return out.astype(self.dtype, copy=False)
        if self.kind == "rle":
            values, lengths = self.data
            return np.repeat(values, lengths)
        if self.kind == "dict":
            codes, base = self.data
            out = codes.astype(np.int64)
            out += base  # in place: an int64 plane is not copied again
            return out.astype(self.dtype, copy=False)
        raise ValueError(f"unknown encoding {self.kind!r}")


def encode_plane(p: np.ndarray, monotonic_hint: bool = False) -> EncodedPlane:
    """Pick the cheapest lossless encoding for one column plane."""
    n = len(p)
    dt = p.dtype
    raw = EncodedPlane("raw", dt, n, (np.ascontiguousarray(p),))
    if n < 2 or dt.kind not in "iu":
        return raw
    # delta: monotonic int64-ish planes (time_, sorted ids). diffs fit a
    # narrow unsigned width when the plane is smooth. Arithmetic runs in
    # the int64-wrapped domain (exact mod 2^64, so uint64 planes round-
    # trip bit-exactly) — but ONLY when every wrapped diff is >= 0: a
    # negative wrapped diff (true step > int64 max) would lose its high
    # bits in the narrow downcast.
    if dt.itemsize == 8 and (monotonic_hint or bool(np.all(p[1:] >= p[:-1]))):
        if bool(np.all(p[1:] >= p[:-1])):
            p64 = p.view(np.int64) if dt.kind == "u" else p.astype(np.int64)
            diffs = np.diff(p64, prepend=p64[:1])
            hi = int(diffs.max()) if n else 0
            if int(diffs.min()) >= 0:
                narrow = _narrowest_uint(hi)
                if narrow.itemsize < dt.itemsize:
                    return EncodedPlane(
                        "delta", dt, n, (p64[0], diffs.astype(narrow)),
                    )
    # rle: low-NDV planes compress to (values, lengths) runs.
    change = np.nonzero(p[1:] != p[:-1])[0]
    n_runs = len(change) + 1
    rle_bytes = n_runs * (dt.itemsize + 4)
    if rle_bytes * _RLE_GAIN <= p.nbytes:
        starts = np.concatenate(([0], change + 1))
        lengths = np.diff(np.concatenate((starts, [n]))).astype(np.int32)
        return EncodedPlane("rle", dt, n, (p[starts].copy(), lengths))
    # dict/rebase: narrow-range integers (string dictionary codes are
    # int32 with a small id space — this is the formalized cold form).
    lo, hi = int(p.min()), int(p.max())
    if hi > np.iinfo(np.int64).max:  # uint64 beyond int64: rebase overflows
        return raw
    narrow = _narrowest_uint(hi - lo)
    if narrow.itemsize < dt.itemsize:
        return EncodedPlane(
            "dict", dt, n, ((p.astype(np.int64) - lo).astype(narrow), np.int64(lo))
        )
    return raw


# -- cold windows --------------------------------------------------------------


@dataclass(frozen=True)
class ColdWindow:
    """An immutable encoded run of rows [row0, row0 + n)."""

    row0: int
    n: int
    min_time: int
    max_time: int
    planes: tuple  # EncodedPlane per table plane, layout order
    nbytes: int  # encoded
    raw_nbytes: int  # decoded (hot-slab) size

    @property
    def end_row(self) -> int:
        return self.row0 + self.n


class ColdStoreError(RuntimeError):
    """A cold window failed to decode (corruption / internal bug). Raised
    from the staging path so it propagates through the pipeline like any
    stage error."""


class ColdStore:
    """Ordered, byte-budgeted collection of encoded cold windows.

    Windows are appended at the hot boundary (demotion) and evicted from
    the front (true expiry). All mutation happens under ``lock``;
    readers snapshot the window list under the lock and decode outside
    it (windows are immutable).
    """

    def __init__(self, has_time: bool):
        self.has_time = has_time
        self.lock = threading.Lock()
        self.windows: list[ColdWindow] = []
        self.nbytes = 0
        self.raw_nbytes = 0
        # lifetime counters (monotonic; exported via Table.stats())
        self.demotions = 0  # windows ever demoted into the store
        self.evictions = 0  # windows ever evicted (true expiry)
        self.rows_evicted = 0
        self.bytes_evicted_raw = 0
        self.decoded_windows = 0
        self.decoded_bytes = 0
        self.decode_seconds = 0.0

    # -- write side (tier.py only) -------------------------------------------
    def append_window(
        self, row0: int, planes: Sequence[np.ndarray], min_t: int, max_t: int,
        monotonic_planes: Sequence[bool],
    ) -> ColdWindow:
        enc = tuple(
            encode_plane(p, monotonic_hint=m)
            for p, m in zip(planes, monotonic_planes)
        )
        n = len(planes[0])
        win = ColdWindow(
            row0=row0, n=n, min_time=min_t, max_time=max_t, planes=enc,
            nbytes=sum(e.nbytes for e in enc),
            raw_nbytes=sum(p.nbytes for p in planes),
        )
        with self.lock:
            if self.windows and row0 != self.windows[-1].end_row:
                raise ColdStoreError(
                    f"non-contiguous demotion: window row0={row0} but cold "
                    f"tier ends at {self.windows[-1].end_row}"
                )
            self.windows.append(win)
            self.nbytes += win.nbytes
            self.raw_nbytes += win.raw_nbytes
            self.demotions += 1
        return win

    def evict_to(self, budget_bytes: int) -> int:
        """Evict oldest windows until encoded bytes fit the budget.
        THIS is expiry: rows leave the table for good and the eviction
        counters (which feed ``rows_expired``/``bytes_expired``) move."""
        evicted = 0
        with self.lock:
            while self.windows and self.nbytes > budget_bytes:
                w = self.windows.pop(0)
                self.nbytes -= w.nbytes
                self.raw_nbytes -= w.raw_nbytes
                self.evictions += 1
                self.rows_evicted += w.n
                self.bytes_evicted_raw += w.raw_nbytes
                evicted += 1
        return evicted

    # -- read side -----------------------------------------------------------
    def _snapshot(self) -> list[ColdWindow]:
        with self.lock:
            return list(self.windows)

    def first_row_id(self) -> Optional[int]:
        with self.lock:
            return self.windows[0].row0 if self.windows else None

    def end_row_id(self) -> Optional[int]:
        with self.lock:
            return self.windows[-1].end_row if self.windows else None

    def min_time(self) -> Optional[int]:
        with self.lock:
            return self.windows[0].min_time if self.windows else None

    def num_rows(self) -> int:
        with self.lock:
            return sum(w.n for w in self.windows)

    def _decode_window(self, w: ColdWindow) -> list[np.ndarray]:
        t0 = time.perf_counter()
        try:
            planes = [e.decode() for e in w.planes]
        except ColdStoreError:
            raise
        except Exception as e:  # corrupt window must fail the query loudly
            raise ColdStoreError(
                f"cold window [{w.row0}, {w.end_row}) failed to decode: {e!r}"
            ) from e
        for e, p in zip(w.planes, planes):
            if len(p) != w.n or p.dtype != e.dtype:
                raise ColdStoreError(
                    f"cold window [{w.row0}, {w.end_row}) decoded to "
                    f"{len(p)} rows of {p.dtype}, expected {w.n} of {e.dtype}"
                )
        dt = time.perf_counter() - t0
        with self.lock:
            self.decoded_windows += 1
            self.decoded_bytes += w.raw_nbytes
            self.decode_seconds += dt
        _meter_add(dt, w.raw_nbytes)
        return planes

    def read(self, start_row_id: int, max_rows: int):
        """Mirror of the backend ``read`` ABI over the cold tier:
        returns (planes, first_row_id, n) for rows in
        [start_row_id, start_row_id + max_rows) that live cold."""
        wins = self._snapshot()
        pieces: list[list[np.ndarray]] = []
        first = None
        copied = 0
        for w in wins:
            if w.end_row <= start_row_id:
                continue
            lo = max(start_row_id, w.row0)
            if first is None:
                first = lo
            elif w.row0 != first + copied:
                break  # non-contiguous (should not happen; be safe)
            take = min(w.end_row - lo, max_rows - copied)
            if take <= 0:
                break
            s = lo - w.row0
            planes = self._decode_window(w)
            pieces.append([p[s : s + take] for p in planes])
            copied += take
            if copied >= max_rows:
                break
        if not pieces:
            return [], start_row_id, 0
        if len(pieces) == 1:
            out = pieces[0]
        else:
            out = [
                np.concatenate([ps[i] for ps in pieces])
                for i in range(len(pieces[0]))
            ]
        return out, first, copied

    def row_id_for_time(self, t: int, strictly_greater: bool) -> Optional[int]:
        """First cold row id with time >= t (> when strict), or None when
        every cold row is older (caller falls through to the hot ring).
        Times are plane 0 by the table layout convention."""
        if not self.has_time:
            return None
        for w in self._snapshot():
            hit = (w.max_time > t) if strictly_greater else (w.max_time >= t)
            if not hit:
                continue
            times = self._decode_window(w)[0]
            idx = np.nonzero(times > t if strictly_greater else times >= t)[0]
            if len(idx):
                return w.row0 + int(idx[0])
        return None
