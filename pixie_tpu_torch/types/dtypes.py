"""Logical data types and their device representations.

Reference parity: the six Carnot data types
(``src/shared/types/typespb/types.proto:28-33``): BOOLEAN, INT64, UINT128,
FLOAT64, STRING, TIME64NS.

The planes keep the JAX package's device dtypes, so both packages fold
the same bits:

- BOOLEAN   -> bool
- INT64     -> int64
- UINT128   -> two uint64 planes (hi, lo)
- FLOAT64   -> logically f64, physically float32 on the device; UDA
  carries (sum/mean) are f64 and [num_groups]-sized
- STRING    -> int32 dictionary ids (encoded host-side at staging time)
- TIME64NS  -> int64 nanoseconds since epoch
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class DataType(enum.Enum):
    BOOLEAN = "boolean"
    INT64 = "int64"
    UINT128 = "uint128"
    FLOAT64 = "float64"
    STRING = "string"
    TIME64NS = "time64ns"

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"DataType.{self.name}"


# Device dtypes per plane.
_DEVICE_DTYPES = {
    DataType.BOOLEAN: (torch.bool,),
    DataType.INT64: (torch.int64,),
    DataType.UINT128: (torch.uint64, torch.uint64),
    DataType.FLOAT64: (torch.float32,),
    DataType.STRING: (torch.int32,),
    DataType.TIME64NS: (torch.int64,),
}

# Host (numpy) dtypes per plane, used by the staging path and the store.
_HOST_DTYPES = {
    DataType.BOOLEAN: (np.bool_,),
    DataType.INT64: (np.int64,),
    DataType.UINT128: (np.uint64, np.uint64),
    DataType.FLOAT64: (np.float64,),
    DataType.STRING: (np.int32,),
    DataType.TIME64NS: (np.int64,),
}

# Neutral pad value per plane for invalid (masked) rows.
_PAD_VALUES = {
    DataType.BOOLEAN: (False,),
    DataType.INT64: (0,),
    DataType.UINT128: (0, 0),
    DataType.FLOAT64: (0.0,),
    DataType.STRING: (-1,),
    DataType.TIME64NS: (0,),
}


_NUMERIC = frozenset({DataType.INT64, DataType.FLOAT64, DataType.TIME64NS})


def n_planes(dt: DataType) -> int:
    return len(_DEVICE_DTYPES[dt])


def is_numeric(dt: DataType) -> bool:
    return dt in _NUMERIC


def device_dtypes(dt: DataType) -> tuple:
    return _DEVICE_DTYPES[dt]


def host_dtypes(dt: DataType) -> tuple:
    return _HOST_DTYPES[dt]


def pad_values(dt: DataType) -> tuple:
    return _PAD_VALUES[dt]


def from_numpy_dtype(np_dtype, *, is_time: bool = False) -> DataType:
    """Infer a logical DataType from a numpy dtype (strings -> STRING)."""
    np_dtype = np.dtype(np_dtype)
    if np_dtype == np.bool_:
        return DataType.BOOLEAN
    if np.issubdtype(np_dtype, np.integer):
        return DataType.TIME64NS if is_time else DataType.INT64
    if np.issubdtype(np_dtype, np.floating):
        return DataType.FLOAT64
    if np_dtype.kind in ("U", "S", "O"):
        return DataType.STRING
    if np_dtype.kind == "M":  # datetime64
        return DataType.TIME64NS
    raise TypeError(f"no DataType mapping for numpy dtype {np_dtype}")
