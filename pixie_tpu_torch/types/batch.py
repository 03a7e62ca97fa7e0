"""Columnar batches: host-side staging form and device-resident form.

Reference parity: ``src/table_store/schema/row_batch.h:40``. As in the JAX
package, a ``DeviceBatch`` is a fixed-capacity set of column planes plus
a validity mask: filters flip mask bits instead of producing
data-dependent shapes, and capacities are bucketed to powers of two. A
logical column is 1-2 physical planes (UINT128 -> hi/lo uint64).

Staging onto a CUDA device (``stage_planes``) pads each plane on the
host into a pinned buffer and copies it without blocking on a copy
stream of the device's own; the consumer waits for the copy's event at
hand-off (``handoff``). On the CPU the same call builds CPU tensors.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np
import torch

from .dtypes import DataType, device_dtypes, from_numpy_dtype, host_dtypes, pad_values
from .relation import Relation
from .strings import StringDictionary

MIN_CAPACITY = 1024


def bucket_capacity(n: int) -> int:
    """Round up to a power of two, at least MIN_CAPACITY."""
    cap = MIN_CAPACITY
    while cap < n:
        cap *= 2
    return cap


Planes = tuple  # tuple of np.ndarray | torch.Tensor, one per physical plane


@dataclass
class HostBatch:
    """Host-side columnar batch (numpy planes; strings already dict-encoded)."""

    relation: Relation
    cols: dict[str, Planes]
    length: int
    dicts: dict[str, StringDictionary] = field(default_factory=dict)
    # Stream markers (reference: eow/eos on RowBatch).
    eow: bool = False
    eos: bool = False

    @classmethod
    def from_pydict(
        cls,
        data: Mapping[str, Sequence],
        relation: Relation | None = None,
        time_cols: Sequence[str] = ("time_",),
        dicts: Mapping[str, StringDictionary] | None = None,
    ) -> "HostBatch":
        """Build from {col: values}; infers the relation when not given."""
        cols: dict[str, Planes] = {}
        out_dicts: dict[str, StringDictionary] = {}
        rel_items: list[tuple[str, DataType]] = []
        length = None
        for name, values in data.items():
            arr = np.asarray(values)
            if length is None:
                length = len(arr)
            elif len(arr) != length:
                raise ValueError(f"column {name!r} length {len(arr)} != {length}")
            if relation is not None:
                dt = relation.col_type(name)
            else:
                if arr.ndim == 2 and arr.shape[1] == 2 and arr.dtype == np.uint64:
                    dt = DataType.UINT128  # (n, 2) [hi, lo] UPID layout
                else:
                    dt = from_numpy_dtype(arr.dtype, is_time=name in time_cols)
                rel_items.append((name, dt))
            if dt == DataType.STRING:
                d = dicts[name] if dicts is not None and name in dicts else StringDictionary()
                if np.issubdtype(arr.dtype, np.integer):
                    ids = arr.astype(np.int32)  # already dict-encoded
                else:
                    ids = d.encode([str(v) for v in arr])
                out_dicts[name] = d
                cols[name] = (ids,)
            elif dt == DataType.UINT128:
                if arr.ndim == 2 and arr.shape[1] == 2:  # (n, 2) [hi, lo]
                    cols[name] = (arr[:, 0].astype(np.uint64),
                                  arr[:, 1].astype(np.uint64))
                else:  # python ints (the capture tap's upid column)
                    hi = np.fromiter(((int(v) >> 64) & (2**64 - 1) for v in values), np.uint64, length)
                    lo = np.fromiter((int(v) & (2**64 - 1) for v in values), np.uint64, length)
                    cols[name] = (hi, lo)
            else:
                (hdt,) = host_dtypes(dt)
                cols[name] = (arr.astype(hdt),)
        rel = relation if relation is not None else Relation(rel_items)
        return cls(relation=rel, cols=cols, length=length or 0, dicts=out_dicts)

    @property
    def nbytes(self) -> int:
        """Total plane bytes (the unit of staging and bridge-wire cost
        accounting; dictionary strings not included)."""
        return int(sum(
            p.nbytes for planes in self.cols.values() for p in planes
        ))

    def to_pydict(self, decode_strings: bool = True) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {}
        for name, dt in self.relation.items():
            planes = self.cols[name]
            if dt == DataType.STRING and decode_strings and name in self.dicts:
                out[name] = self.dicts[name].decode(planes[0])
            elif dt == DataType.UINT128:
                out[name] = np.stack(planes, axis=1)
            else:
                out[name] = planes[0]
        return out

    def to_device(self, capacity: int, device: torch.device) -> "DeviceBatch":
        """Pad to a fixed capacity and copy to ``device`` (``stage_planes``:
        on CUDA one pinned buffer per plane and an asynchronous copy; the
        consumer calls ``handoff`` before it reads the planes)."""
        if capacity < self.length:
            raise ValueError(f"capacity {capacity} < batch length {self.length}")
        names, planes, pads, ddts = [], [], [], []
        for name, dt in self.relation.items():
            for plane, pad, ddt in zip(
                self.cols[name], pad_values(dt), device_dtypes(dt)
            ):
                names.append(name)
                planes.append(plane)
                pads.append(pad)
                ddts.append(ddt)
        staged, event = stage_planes(planes, pads, ddts, capacity, device)
        cols: dict[str, list] = {}
        for name, t in zip(names, staged):
            cols.setdefault(name, []).append(t)
        valid = torch.arange(capacity, device=device) < self.length
        return DeviceBatch(
            relation=self.relation,
            cols={n: tuple(ps) for n, ps in cols.items()},
            valid=valid,
            event=event,
        )


@dataclass
class DeviceBatch:
    """Fixed-capacity device-resident columnar batch with validity mask.
    ``event`` marks the end of its host -> device copy (None on the CPU)."""

    relation: Relation
    cols: dict[str, Planes]
    valid: torch.Tensor
    event: object = None
    _handed: set = field(default_factory=set, repr=False)

    def handoff(self) -> None:
        """Order the consumer's current stream after the copy (once per
        consumer stream)."""
        handoff(self.cols, self.event, self._handed)

    @property
    def capacity(self) -> int:
        return self.valid.shape[-1]

    def n_valid(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(dim=-1)

    def plane(self, name: str, i: int = 0) -> torch.Tensor:
        return self.cols[name][i]

    def _with(self, relation: Relation, cols: dict, valid) -> "DeviceBatch":
        # The same copy: its event and the streams already handed it.
        return DeviceBatch(relation=relation, cols=cols, valid=valid,
                           event=self.event, _handed=self._handed)

    def with_cols(self, new_cols: Mapping[str, Planes],
                  relation: Relation) -> "DeviceBatch":
        return self._with(relation, dict(new_cols), self.valid)

    def with_valid(self, valid) -> "DeviceBatch":
        return self._with(self.relation, self.cols, valid)

    def select(self, names: Sequence[str]) -> "DeviceBatch":
        return self._with(self.relation.select(names),
                          {n: self.cols[n] for n in names}, self.valid)

    def to_host(self, dicts: Mapping[str, StringDictionary] | None = None,
                eow: bool = False, eos: bool = False) -> HostBatch:
        """Copy back to the host, compacted to the valid rows (gathered on
        the device, so only they cross; a uint64 plane goes through its
        int64 view). ``eow``/``eos`` are the host batch's stream
        markers."""
        self.handoff()
        idx = torch.nonzero(self.valid).flatten()
        cols: dict[str, Planes] = {
            name: tuple(gather_rows(p, idx).astype(h, copy=False)
                        for p, h in zip(self.cols[name], host_dtypes(dt)))
            for name, dt in self.relation.items()
        }
        return HostBatch(relation=self.relation, cols=cols, length=len(idx),
                         dicts=dict(dicts) if dicts else {}, eow=eow, eos=eos)


def gather_rows(p: torch.Tensor, idx: torch.Tensor) -> np.ndarray:
    """The rows ``idx`` of a device plane, gathered on its device and
    copied to the host (a uint64 plane through its int64 view)."""
    if p.dtype == torch.uint64:
        return p.view(torch.int64).index_select(0, idx).cpu().numpy().view(
            np.uint64
        )
    return p.index_select(0, idx).cpu().numpy()


# -- staging onto a CUDA device -----------------------------------------------
class _Slot:
    """One set of pinned host buffers (one per plane) and the event of
    the last copy out of them."""

    __slots__ = ("bufs", "event", "seq")

    def __init__(self, bufs):
        self.bufs = bufs
        self.event = None
        self.seq = 0


class _Stager:
    """Pinned host buffers and a copy stream for one CUDA device.

    Each staging takes a slot of pinned buffers whose last copy has
    completed (or, when all ``SLOTS`` are in flight, waits on the host
    for the oldest one's event), pads the planes into it, and copies
    each plane to a device tensor on the copy stream without blocking.
    A pinned buffer is refilled only after its copy's event completed,
    so a window is never overwritten mid-copy. The device tensors are
    allocated on the copy stream; ``handoff`` makes the consumer's
    stream wait for the copy and records the consumer's use with the
    caching allocator, so freed memory is not reused under a read.
    """

    SLOTS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.lock = threading.Lock()
        self.slots: dict[tuple, list[_Slot]] = {}
        self._seq = itertools.count(1)

    def _acquire(self, capacity: int, dtypes: tuple) -> _Slot:
        slots = self.slots.setdefault((capacity, dtypes), [])
        for s in slots:
            if s.event is None or s.event.query():
                return s
        if len(slots) < self.SLOTS:
            s = _Slot([
                torch.empty(capacity, dtype=d, pin_memory=True) for d in dtypes
            ])
            slots.append(s)
            return s
        s = min(slots, key=lambda x: x.seq)
        s.event.synchronize()
        return s

    def stage(self, planes, pads, dtypes, capacity: int):
        with self.lock:
            slot = self._acquire(capacity, tuple(dtypes))
            for buf, p, pad in zip(slot.bufs, planes, pads):
                n = len(p)
                if n:
                    buf[:n].copy_(torch.from_numpy(np.ascontiguousarray(p)))
                buf[n:].fill_(pad)
            out = []
            with torch.cuda.stream(self.stream):
                for buf in slot.bufs:
                    d = torch.empty(capacity, dtype=buf.dtype, device=self.device)
                    d.copy_(buf, non_blocking=True)
                    out.append(d)
                event = torch.cuda.Event()
                event.record(self.stream)
            slot.event = event
            slot.seq = next(self._seq)
        return out, event


_STAGERS: dict = {}
_STAGERS_LOCK = threading.Lock()


def stager(device: torch.device) -> _Stager:
    """The process's stager for one CUDA device (made at first use)."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    with _STAGERS_LOCK:
        st = _STAGERS.get(key)
        if st is None:
            st = _STAGERS[key] = _Stager(torch.device("cuda", key))
        return st


def stage_planes(planes, pads, dtypes, capacity: int, device: torch.device):
    """Pad each host plane to ``capacity`` with its pad value and place it
    on ``device`` in its device dtype. Returns (tensors, event): on CUDA
    the copies are asynchronous and ``event`` marks their end; on the
    CPU the tensors are ready and ``event`` is None."""
    for p in planes:
        if len(p) > capacity:
            raise ValueError(f"capacity {capacity} < plane length {len(p)}")
    if device.type == "cuda":
        return stager(device).stage(planes, pads, dtypes, capacity)
    out = []
    for p, pad, ddt in zip(planes, pads, dtypes):
        t = torch.full((capacity,), pad, dtype=ddt, device=device)
        t[: len(p)] = torch.from_numpy(np.ascontiguousarray(p)).to(ddt)
        out.append(t)
    return out, None


def handoff(cols: dict, event, handed: set) -> None:
    """Make the current stream of the planes' device wait for ``event``
    (the end of their staging copy) and record the planes' use on it, so
    the caching allocator keeps them until that stream's reads are done.
    Runs once per consumer stream (``handed`` holds the streams served)."""
    if event is None:
        return
    first = next(iter(cols.values()))[0]
    stream = torch.cuda.current_stream(first.device)
    if stream.cuda_stream in handed:
        return
    stream.wait_event(event)
    for planes in cols.values():
        for t in planes:
            t.record_stream(stream)
    handed.add(stream.cuda_stream)
