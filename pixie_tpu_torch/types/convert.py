"""Carry table state from the JAX package into the port.

A JAX-package ``HostBatch`` holds numpy planes, a relation and string
dictionaries. Passed across as plain values (column names, type names,
numpy arrays and string lists), they rebuild the same batch here without
importing that package, so one seeded replay can load into both engines.
"""

from __future__ import annotations

import numpy as np

from .batch import HostBatch
from .dtypes import DataType, host_dtypes
from .relation import Relation
from .strings import StringDictionary


def host_batch_from_numpy(relation_items, cols, dict_entries) -> HostBatch:
    """Rebuild a port ``HostBatch`` from plain values.

    ``relation_items``: ``[(column, type)]`` where type is a ``DataType``
    or its name (``"STRING"``); ``cols``: ``{column: tuple of numpy
    planes}``; ``dict_entries``: ``{column: list of strings}`` in id
    order, for every STRING column.
    """
    rel = Relation([
        (n, t if isinstance(t, DataType) else DataType[t])
        for n, t in relation_items
    ])
    out_cols = {}
    length = None
    for name, dt in rel.items():
        planes = tuple(
            np.asarray(p).astype(h, copy=False)
            for p, h in zip(cols[name], host_dtypes(dt))
        )
        if len(planes) != len(host_dtypes(dt)):
            raise ValueError(f"column {name!r} has {len(planes)} planes")
        n = len(planes[0])
        if length is None:
            length = n
        elif n != length:
            raise ValueError(f"column {name!r} length {n} != {length}")
        out_cols[name] = planes
    dicts = {}
    for name, dt in rel.items():
        if dt == DataType.STRING:
            if name not in dict_entries:
                raise ValueError(f"STRING column {name!r} has no dictionary")
            dicts[name] = StringDictionary(dict_entries[name])
    return HostBatch(relation=rel, cols=out_cols, length=length or 0, dicts=dicts)
