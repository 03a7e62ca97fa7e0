"""The ``px`` namespace exposed to PxL scripts.

Reference parity: ``src/carnot/planner/objects/pixie_module.h:33``
(PixieModule: DataFrame, display/debug, now/time helpers, DurationNanos
and the other semantic-type constructors, uint128, and every registered
UDF/UDA surfaced as ``px.<name>``).
"""

from __future__ import annotations

import re

from ..types.dtypes import DataType
from .objects import (
    AggFuncMarker,
    ColumnExpr,
    DataFrameObj,
    Literal,
    PlanBuilder,
    PxLError,
    ScalarFuncMarker,
    as_expr,
)

_REL_TIME = re.compile(r"^\s*(-?\d+(?:\.\d+)?)\s*(ns|us|ms|s|m|h|d)\s*$")
_UNIT_NS = {
    "ns": 1,
    "us": 1_000,
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "m": 60_000_000_000,
    "h": 3_600_000_000_000,
    "d": 86_400_000_000_000,
}


def parse_time(value, now_ns: int, lineno=None):
    """Resolve a PxL time argument to absolute nanoseconds.

    Strings are relative to now ('-30s', '-5m'); ints are absolute ns.
    Reference: the compiler's time-conversion analyzer rules
    (``compiler/analyzer/resolve_time_rule``-family).
    """
    if value is None:
        return None
    if isinstance(value, str):
        m = _REL_TIME.match(value)
        if not m:
            raise PxLError(
                f"cannot parse time {value!r} (want e.g. '-30s', '-5m')", lineno
            )
        return now_ns + int(float(m.group(1)) * _UNIT_NS[m.group(2)])
    if isinstance(value, (int, float)):
        return int(value)
    raise PxLError(f"invalid time argument {value!r}", lineno)


def _scale(ns_per_unit: int):
    def f(n):
        if isinstance(n, ColumnExpr):
            return n * ns_per_unit
        return int(n * ns_per_unit)

    return f


def _semantic_cast(name: str, dtype: DataType | None = None):
    """Semantic-type constructor: identity on values, annotation-only.

    Reference semantic types (``px.DurationNanos`` etc.) affect UI
    formatting, not computation; the engine relation keeps base dtypes.
    """

    def f(x=None):
        if x is None:
            raise PxLError(f"px.{name}() requires a value")
        return x

    f.__name__ = name
    return f


# Aggregate-capable names; True = also usable as a scalar in map context
# when the registry has a matching scalar overload.
_AGG_NAMES = {
    "count": False,
    "sum": False,
    "mean": False,
    "max": False,
    "min": False,
    "quantiles": False,
    "any": False,
    "count_distinct": False,
    "stddev": False,
    "variance": False,
}


class PxModule:
    """``import px`` — attribute access resolves helpers, semantic types,
    and registered UDF/UDA names."""

    def __init__(self, builder: PlanBuilder, now_ns: int):
        self._builder = builder
        self._now_ns = now_ns

    # -- dataframe lifecycle -------------------------------------------------
    def DataFrame(self, table=None, select=None, start_time=None,
                  end_time=None, **kwargs) -> DataFrameObj:
        if kwargs:
            raise PxLError(f"px.DataFrame: unknown arguments {sorted(kwargs)}")
        if not isinstance(table, str):
            raise PxLError("px.DataFrame requires table='name'")
        return self._builder.source(
            table,
            select=select,
            start_time=parse_time(start_time, self._now_ns),
            stop_time=parse_time(end_time, self._now_ns),
        )

    def display(self, df, name: str = "output"):
        self._builder.display(df, name)

    def to_table(self, df, name: str):
        """Persist a DataFrame's rows into the table store under ``name``
        (the MemorySink write-back; later queries can read the table)."""
        self._builder.to_table(df, name)

    def export(self, df, spec):
        """px.export(df, px.otel.Data(...)) — OTel exporter surface
        (``planner/objects/exporter.h``)."""
        self._builder.export_otel(df, spec)

    @property
    def otel(self):
        from .otel_module import OTelModule

        return OTelModule()

    def debug(self, df, name: str = "debug"):
        self._builder.display(df, "_" + name)

    # -- time helpers --------------------------------------------------------
    def now(self) -> int:
        return self._now_ns

    seconds = staticmethod(_scale(1_000_000_000))
    minutes = staticmethod(_scale(60_000_000_000))
    hours = staticmethod(_scale(3_600_000_000_000))
    days = staticmethod(_scale(86_400_000_000_000))
    millis = staticmethod(_scale(1_000_000))
    microseconds = staticmethod(_scale(1_000))

    def strptime(self, s: str, fmt: str) -> int:
        import datetime

        dt = datetime.datetime.strptime(s, fmt)
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=datetime.timezone.utc)
        return int(dt.timestamp() * 1_000_000_000)

    # -- misc constructors ---------------------------------------------------
    def uint128(self, s: str):
        import uuid

        return Literal(int(uuid.UUID(s)), DataType.UINT128)

    def equals_any(self, col, values):
        """col == values[0] or col == values[1] or ... (reference
        ``pixie_module.cc`` EqualsAny)."""
        if not values:
            raise PxLError("px.equals_any requires at least one value")
        out = None
        for v in values:
            term = col == v
            out = term if out is None else (out | term)
        return out

    def select(self, cond, if_true, if_false):
        return ScalarFuncMarker("select")(cond, if_true, if_false)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        # Semantic-type constructors (capitalized).
        if name in _SEMANTIC_TYPES:
            return _semantic_cast(name)
        reg = self._builder.registry
        if reg.has_udtf(name):
            return lambda **kw: self._builder.udtf_source(name, **kw)
        if name in _AGG_NAMES and reg.has_uda(name):
            return AggFuncMarker(name, has_scalar=reg.has_scalar(name))
        if reg.has_scalar(name):
            return ScalarFuncMarker(name)
        if reg.has_uda(name):
            return AggFuncMarker(name)
        raise PxLError(
            f"px has no attribute {name!r} (not a registered function)"
        )


_SEMANTIC_TYPES = frozenset({
    "DurationNanos", "Percent", "Bytes", "Time", "Duration",
    "Service", "Pod", "Node", "Namespace", "Container", "UPID",
    "Port", "IPAddress", "Status",
})
