"""UDF/UDA core protocol.

Reference parity: ``src/carnot/udf/udf.h`` — ``ScalarUDF`` (:78) and ``UDA``
with Update/Merge/Finalize (:91-100). As in the JAX package:

- A **ScalarUDF** is a vectorized function over whole column planes
  (torch tensors, or Python scalars for literals).
- A **UDA** is *segmented*: ``update(carry, group_ids, mask, *args)``
  folds a whole window into a ``[num_groups, ...]`` carry and
  ``merge(a, b)`` is associative.
- **Executor classes** say where a UDF runs: DEVICE (tensor code inside
  the window fold) or HOST_DICT (string -> value over the column's
  dictionary at bind time; the device applies an int32 gather).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

from ..types.dtypes import DataType

BOOLEAN = DataType.BOOLEAN
INT64 = DataType.INT64
UINT128 = DataType.UINT128
FLOAT64 = DataType.FLOAT64
STRING = DataType.STRING
TIME64NS = DataType.TIME64NS


class Executor(enum.Enum):
    DEVICE = "device"
    HOST_DICT = "host_dict"  # str -> scalar/str over the dictionary


@dataclass(frozen=True)
class ScalarUDFDef:
    """A scalar UDF overload.

    ``fn`` operates on one tensor (or Python scalar) per single-plane arg;
    UINT128 args arrive as (hi, lo) tuples.
    """

    name: str
    arg_types: tuple[DataType, ...]
    return_type: DataType
    fn: Callable
    executor: Executor = Executor.DEVICE
    # HOST_DICT only: fn is str -> python value; which arg is the string
    # column (all other args must be literals at plan time).
    dict_arg: int = 0
    # DEVICE UDFs returning STRING may carry their own output dictionary
    # (metadata lookups emit ids into an entity-name dictionary rather than
    # remapping an input dictionary).
    out_dict: object = None
    doc: str = ""
    # What the RETURN VALUE means (udf/type_inference.h analog): drives
    # ctx-property resolution and docgen. 1 == SemanticType.ST_NONE
    # (plain int default keeps the dataclass import-cycle-free).
    semantic_type: int = 1


@dataclass(frozen=True)
class UDADef:
    """A segmented user-defined aggregate.

    - ``init(num_groups, device) -> carry``: zero carry, a tensor or a
      tuple of [G, ...] tensors on ``device``.
    - ``update(carry, group_ids, mask, *args) -> carry``: fold a batch;
      ``group_ids`` int32[n] in [0, G) (rows with mask False must not
      contribute), each arg a column plane array.
    - ``merge(a, b) -> carry``: associative combine of two carries
      (the partial-agg path: per-device carries merged across the mesh).
    - ``finalize(carry) -> array`` of [G] results (or [G, k] for
      multi-valued sketches; see ``finalize_type``).
    """

    name: str
    arg_types: tuple[DataType, ...]
    return_type: DataType
    init: Callable
    update: Callable
    merge: Callable
    finalize: Callable
    # When return_type is STRING and struct_fields is set, finalize returns
    # [G, len(struct_fields)] floats; the host materializes JSON objects
    # (Carnot's QuantilesUDA returns a JSON string the same way), and the
    # planner may fuse pluck_float64(agg, field) to a direct plane read.
    struct_fields: tuple[str, ...] | None = None
    doc: str = ""
    # Semantic type of the finalized value (ST_QUANTILES for sketches
    # etc.); 1 == SemanticType.ST_NONE.
    semantic_type: int = 1


# -- overload resolution -----------------------------------------------------

# Implicit cast lattice: arg type -> param types it may widen to, with cost.
_CASTS: dict[tuple[DataType, DataType], int] = {
    (BOOLEAN, INT64): 1,
    (BOOLEAN, FLOAT64): 2,
    (INT64, FLOAT64): 1,
    (TIME64NS, INT64): 1,
    (TIME64NS, FLOAT64): 2,
    (INT64, TIME64NS): 1,  # int64_to_time-style contexts
}


def cast_cost(have: DataType, want: DataType) -> int | None:
    if have == want:
        return 0
    return _CASTS.get((have, want))


def apply_cast(x, have: DataType, want: DataType):
    """Cast a column plane between logical types (device-side).

    FLOAT64 planes are physically f32 (see types/dtypes.py). Literals
    arrive as Python scalars and are cast as Python values.
    """
    if have == want:
        return x
    if want == FLOAT64:
        return x.to(torch.float32) if isinstance(x, torch.Tensor) else float(x)
    if want in (INT64, TIME64NS):
        return x.to(torch.int64) if isinstance(x, torch.Tensor) else int(x)
    raise TypeError(f"no device cast {have} -> {want}")


def device_constant(array):
    """``get(device)``: the numpy ``array`` as a tensor on ``device``,
    copied there on the first call and kept (the id tables of device
    UDFs go to the card once, not once per window)."""
    cache: dict = {}

    def get(device):
        t = cache.get(device)
        if t is None:
            t = cache[device] = torch.from_numpy(array).to(device)
        return t

    return get


class SignatureError(TypeError):
    pass


def resolve_overload(overloads: Sequence, arg_types: Sequence[DataType]):
    """Pick the cheapest-cast overload; raise on none/ambiguous."""
    best, best_cost, tie = None, None, False
    for ov in overloads:
        if len(ov.arg_types) != len(arg_types):
            continue
        cost = 0
        ok = True
        for have, want in zip(arg_types, ov.arg_types):
            c = cast_cost(have, want)
            if c is None:
                ok = False
                break
            cost += c
        if not ok:
            continue
        if best_cost is None or cost < best_cost:
            best, best_cost, tie = ov, cost, False
        elif cost == best_cost:
            tie = True
    if best is None:
        raise SignatureError(
            f"no overload of {overloads[0].name!r} matches argument types "
            f"({', '.join(t.name for t in arg_types)})"
        )
    if tie:
        raise SignatureError(
            f"ambiguous overloads of {overloads[0].name!r} for argument types "
            f"({', '.join(t.name for t in arg_types)})"
        )
    return best
