"""Collection UDAs.

Reference parity: ``src/carnot/funcs/builtins/collections.cc`` —
AnyUDA("any", :33): an arbitrary member of the group. A port of the JAX
package's ``udf/builtins/collections.py``: a segment max (any
deterministic pick works; max merges associatively), with the same
neutral values, so both packages pick the same member.
"""

from __future__ import annotations

import torch

from ..udf import BOOLEAN, FLOAT64, INT64, STRING, TIME64NS

_I64_MIN = torch.iinfo(torch.int64).min

# (neutral value, carry dtype) per argument type. FLOAT64 planes are f32
# on the device and the carry is f64, as in the JAX package; STRING ids
# are int32 (the neutral decodes to NULL for empty groups).
_NEUTRAL = {
    INT64: (_I64_MIN, torch.int64),
    TIME64NS: (_I64_MIN, torch.int64),
    FLOAT64: (-torch.inf, torch.float64),
    STRING: (-(2**31), torch.int32),
    BOOLEAN: (False, torch.bool),
}


def _update(c, gids, mask, v, lo):
    g = c.shape[0]
    is_bool = v.dtype == torch.bool
    if is_bool:  # no bool scatter-max on every device: fold as int8
        v, lo = v.to(torch.int8), int(lo)
    contrib = torch.where(mask, v, torch.full((), lo, dtype=v.dtype,
                                              device=v.device))
    upd = torch.full((g + 1,), lo, dtype=v.dtype, device=v.device)
    upd.scatter_reduce_(0, torch.where(mask, gids, g).long(), contrib, "amax",
                        include_self=True)
    upd = upd[:g]
    upd = upd != 0 if is_bool else upd.to(c.dtype)
    return torch.maximum(c, upd)


def register(reg):
    for dt, (lo, zd) in _NEUTRAL.items():
        reg.uda(
            "any", (dt,), dt,
            init=lambda g, device, _z=zd, _lo=lo: torch.full(
                (g,), _lo, dtype=_z, device=device
            ),
            update=lambda c, gids, mask, v, _lo=lo: _update(c, gids, mask, v, _lo),
            merge=torch.maximum,
            finalize=lambda c: c,
            doc="An arbitrary value from the group.",
        )
