"""Columnar batches: host-side staging form and device-resident form.

Reference parity: ``src/table_store/schema/row_batch.h:40``. As in the JAX
package, a ``DeviceBatch`` is a fixed-capacity set of column planes plus
a validity mask: filters flip mask bits instead of producing
data-dependent shapes, and capacities are bucketed to powers of two. A
logical column is 1-2 physical planes (UINT128 -> hi/lo uint64).
"""

from __future__ import annotations

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
                if arr.ndim != 2 or arr.shape[1] != 2:
                    raise ValueError(f"UINT128 column {name!r} wants (n, 2) uint64")
                cols[name] = (arr[:, 0].astype(np.uint64), arr[:, 1].astype(np.uint64))
            else:
                (hdt,) = host_dtypes(dt)
                cols[name] = (arr.astype(hdt),)
        rel = relation if relation is not None else Relation(rel_items)
        return cls(relation=rel, cols=cols, length=length or 0, dicts=out_dicts)

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
        """Pad to a fixed capacity and copy to ``device``."""
        if capacity < self.length:
            raise ValueError(f"capacity {capacity} < batch length {self.length}")
        cols: dict[str, Planes] = {}
        for name, dt in self.relation.items():
            planes = []
            for plane, pad, ddt in zip(
                self.cols[name], pad_values(dt), device_dtypes(dt)
            ):
                t = torch.full((capacity,), pad, dtype=ddt)
                t[: self.length] = torch.from_numpy(
                    np.ascontiguousarray(plane)
                ).to(ddt)
                planes.append(t.to(device))
            cols[name] = tuple(planes)
        valid = torch.zeros(capacity, dtype=torch.bool)
        valid[: self.length] = True
        return DeviceBatch(relation=self.relation, cols=cols, valid=valid.to(device))


@dataclass
class DeviceBatch:
    """Fixed-capacity device-resident columnar batch with validity mask."""

    relation: Relation
    cols: dict[str, Planes]
    valid: torch.Tensor
