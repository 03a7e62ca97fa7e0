"""Math scalar UDFs and numeric UDAs (the subset this slice binds).

Reference parity: ``src/carnot/funcs/builtins/math_ops.h:34-744`` — binary
arithmetic and division, comparisons, and the UDAs MeanUDA(:584)/
SumUDA(:630)/MaxUDA(:661)/MinUDA(:703)/CountUDA(:744). A port of the JAX
package's ``udf/builtins/math_ops.py``: scalars are whole-plane tensor
expressions; UDAs are segment reductions into [G] carries with
associative merges.

The segment reductions scatter into a trash slot G that masked rows
point at (``index_add_``/``scatter_reduce_``). The JAX package's sorted
64-bit forms exist only to avoid 64-bit scatters on the TPU and are not
carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from ..udf import BOOLEAN, FLOAT64, INT64, STRING, TIME64NS

_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min


def _slots(gids, mask, g: int):
    """int64 slot per row: its group, or the trash slot g when masked."""
    return torch.where(mask, gids, g).long()


def _seg_sum(carry, gids, mask, v):
    g = carry.shape[0]
    v = v.to(carry.dtype)
    upd = torch.zeros(g + 1, dtype=carry.dtype, device=carry.device)
    upd.index_add_(0, _slots(gids, mask, g), torch.where(mask, v, 0))
    return carry + upd[:g]


def _seg_count(carry, gids, mask):
    g = carry.shape[0]
    cnt = torch.zeros(g + 1, dtype=torch.int64, device=carry.device)
    cnt.index_add_(0, _slots(gids, mask, g), mask.to(torch.int64))
    return carry + cnt[:g].to(carry.dtype)


def _seg_extreme(carry, gids, mask, v, neutral, reduce: str):
    g = carry.shape[0]
    upd = torch.full((g + 1,), neutral, dtype=v.dtype, device=v.device)
    upd.scatter_reduce_(
        0, _slots(gids, mask, g), v, reduce, include_self=True
    )
    upd = upd[:g].to(carry.dtype)
    return torch.maximum(carry, upd) if reduce == "amax" else torch.minimum(carry, upd)


def _divide(a, b):
    """IEEE division on every device. Torch turns a Python-scalar operand
    into a multiplication by a reciprocal on the card (one f32 ulp off
    in a few percent of rows), so scalars become 0-d tensors on the
    plane's device first."""
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        with np.errstate(divide="ignore", invalid="ignore"):
            return float(np.float32(a) / np.float32(b))
    ref = a if isinstance(a, torch.Tensor) else b

    def as_tensor(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.full((), x, dtype=ref.dtype, device=ref.device)

    return torch.div(as_tensor(a), as_tensor(b))


def _mean_finalize(c):
    s, n = c[0].to(torch.float64), c[1].to(torch.float64)
    return torch.where(n > 0, s / torch.clamp(n, min=1.0), torch.nan)


def register(reg):
    # -- binary arithmetic ---------------------------------------------------
    for dt in (INT64, FLOAT64):
        reg.scalar("add", (dt, dt), dt, lambda a, b: a + b)
        reg.scalar("subtract", (dt, dt), dt, lambda a, b: a - b)
        reg.scalar("multiply", (dt, dt), dt, lambda a, b: a * b)
    reg.scalar("add", (TIME64NS, TIME64NS), TIME64NS, lambda a, b: a + b)
    reg.scalar("subtract", (TIME64NS, TIME64NS), TIME64NS, lambda a, b: a - b)
    # divide always yields float (Carnot: DivideUDF -> FLOAT64).
    reg.scalar(
        "divide",
        (FLOAT64, FLOAT64),
        FLOAT64,
        _divide,
        doc="Arithmetic division; inf/nan on zero divisors.",
    )

    # -- comparisons ---------------------------------------------------------
    for dt in (INT64, FLOAT64, TIME64NS, BOOLEAN, STRING):
        reg.scalar("equal", (dt, dt), BOOLEAN, lambda a, b: a == b)
        reg.scalar("notEqual", (dt, dt), BOOLEAN, lambda a, b: a != b)
    for dt in (INT64, FLOAT64, TIME64NS):
        reg.scalar("lessThan", (dt, dt), BOOLEAN, lambda a, b: a < b)
        reg.scalar("lessThanEqual", (dt, dt), BOOLEAN, lambda a, b: a <= b)
        reg.scalar("greaterThan", (dt, dt), BOOLEAN, lambda a, b: a > b)
        reg.scalar("greaterThanEqual", (dt, dt), BOOLEAN, lambda a, b: a >= b)

    # -- UDAs ----------------------------------------------------------------
    # Float carries are f64 even though column planes are f32 ([G]-sized
    # accumulators), integer carries exact i64 — the JAX package's carries.
    for dt, zd in ((INT64, torch.int64), (FLOAT64, torch.float64)):
        reg.uda(
            "sum",
            (dt,),
            dt,
            init=lambda g, device, _z=zd: torch.zeros(g, dtype=_z, device=device),
            update=_seg_sum,
            merge=lambda a, b: a + b,
            finalize=lambda c: c,
            doc="Sum of the group.",
        )
    reg.uda(
        "sum",
        (BOOLEAN,),
        INT64,
        init=lambda g, device: torch.zeros(g, dtype=torch.int64, device=device),
        update=lambda c, gids, mask, v: _seg_sum(c, gids, mask, v.to(torch.int64)),
        merge=lambda a, b: a + b,
        finalize=lambda c: c,
    )

    reg.uda(
        "count",
        (FLOAT64,),
        INT64,
        init=lambda g, device: torch.zeros(g, dtype=torch.int64, device=device),
        update=lambda c, gids, mask, v: _seg_count(c, gids, mask),
        merge=lambda a, b: a + b,
        finalize=lambda c: c,
        doc="Number of rows in the group.",
    )

    def _mean_init(zd):
        return lambda g, device: (
            torch.zeros(g, dtype=zd, device=device),
            torch.zeros(g, dtype=zd, device=device),
        )

    def _mean_update(c, gids, mask, v):
        return (_seg_sum(c[0], gids, mask, v), _seg_count(c[1], gids, mask))

    for dt, zd, doc in (
        (FLOAT64, torch.float64,
         "Arithmetic mean of the group (sum/count carry; merges exactly)."),
        (INT64, torch.int64, "Arithmetic mean (exact int64 sum/count carry)."),
        (BOOLEAN, torch.int64, "Fraction of true rows (exact integer carry)."),
    ):
        reg.uda(
            "mean",
            (dt,),
            FLOAT64,
            init=_mean_init(zd),
            update=_mean_update,
            merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
            finalize=_mean_finalize,
            doc=doc,
        )

    for dt, zd, lo, hi in (
        (INT64, torch.int64, _I64_MIN, _I64_MAX),
        (FLOAT64, torch.float64, -torch.inf, torch.inf),
        (TIME64NS, torch.int64, _I64_MIN, _I64_MAX),
    ):
        reg.uda(
            "min",
            (dt,),
            dt,
            init=lambda g, device, _z=zd, _hi=hi: torch.full(
                (g,), _hi, dtype=_z, device=device
            ),
            update=lambda c, gids, mask, v, _hi=hi: _seg_extreme(
                c, gids, mask, v, _hi, "amin"
            ),
            merge=torch.minimum,
            finalize=lambda c: c,
        )
        reg.uda(
            "max",
            (dt,),
            dt,
            init=lambda g, device, _z=zd, _lo=lo: torch.full(
                (g,), _lo, dtype=_z, device=device
            ),
            update=lambda c, gids, mask, v, _lo=lo: _seg_extreme(
                c, gids, mask, v, _lo, "amax"
            ),
            merge=torch.maximum,
            finalize=lambda c: c,
        )
