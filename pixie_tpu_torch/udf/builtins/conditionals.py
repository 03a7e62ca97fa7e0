"""Conditional scalar UDFs.

Reference parity: ``src/carnot/funcs/builtins/conditionals.cc`` —
SelectUDF("select", cond, then, else). A ``torch.where`` over the
planes; string branches operate on ids (the plan binder aligns both
branches to one dictionary before the call).
"""

from __future__ import annotations

import torch

from ...types.dtypes import device_dtypes
from ..udf import BOOLEAN, FLOAT64, INT64, STRING, TIME64NS


def _select_fn(dt):
    """``select`` over planes of ``dt``: the result keeps the type's
    plane dtype when both branches are literals."""
    plane_dtype = device_dtypes(dt)[0]

    def select(c, a, b):
        if not any(isinstance(x, torch.Tensor) for x in (c, a, b)):
            return a if c else b
        ref = next(x for x in (c, a, b) if isinstance(x, torch.Tensor))
        if not isinstance(c, torch.Tensor):
            c = torch.full((), bool(c), dtype=torch.bool, device=ref.device)
        return torch.where(c, a, b).to(plane_dtype)

    return select


def register(reg):
    for dt in (INT64, FLOAT64, STRING, BOOLEAN, TIME64NS):
        reg.scalar(
            "select", (BOOLEAN, dt, dt), dt, _select_fn(dt),
            doc="Elementwise: a where cond else b.",
        )
