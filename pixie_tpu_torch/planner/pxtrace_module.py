"""The ``pxtrace`` PxL module: probe definitions -> tracepoint mutations.

Reference parity: ``src/carnot/planner/probes/probes.h`` (``MutationsIR``)
and the ``pxtrace`` QLObject module — scripts decorate a probe function
with ``@pxtrace.probe(symbol)``, return a list of ``{column: expr}``
dicts, and register it with ``pxtrace.UpsertTracepoint``. Compiling such
a script yields *mutations* instead of (or alongside) a query plan; the
broker's mutation executor deploys them and waits for table readiness
(``mutation_executor.go:84``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..trace.spec import (
    ProbeDef,
    TraceExpr,
    TracepointDelete,
    TracepointDeployment,
    parse_ttl,
)
from .objects import PxLError

_TYPE_NAMES = {
    "int64": "INT64",
    "float64": "FLOAT64",
    "string": "STRING",
    "boolean": "BOOLEAN",
    "time64ns": "TIME64NS",
}


def _dtype(type_name):
    from ..types.dtypes import DataType

    if type_name is None:
        return DataType.INT64
    key = str(type_name).lower()
    if key not in _TYPE_NAMES:
        raise PxLError(
            f"unknown trace type {type_name!r}; one of {sorted(_TYPE_NAMES)}"
        )
    return DataType[_TYPE_NAMES[key]]


@dataclass
class _ProbeMarker:
    """A @pxtrace.probe-decorated PxL function awaiting UpsertTracepoint."""

    target: str
    fn: object  # PxFunc


class TraceModule:
    """Bound as ``pxtrace`` in script scope; collects mutations."""

    def __init__(self):
        self.mutations: list = []  # TracepointDeployment | TracepointDelete

    # -- decorators / expression constructors ------------------------------
    def probe(self, target: str):
        if not isinstance(target, str) or not target:
            raise PxLError("pxtrace.probe() expects a symbol string")

        def deco(fn):
            return _ProbeMarker(target=target, fn=fn)

        return deco

    def ArgExpr(self, expr: str, type=None) -> TraceExpr:  # noqa: N802
        return TraceExpr("arg", str(expr), _dtype(type))

    def RetExpr(self, expr: str = "", type=None) -> TraceExpr:  # noqa: N802
        return TraceExpr("ret", str(expr), _dtype(type))

    def FunctionLatency(self) -> TraceExpr:  # noqa: N802
        from ..types.dtypes import DataType

        return TraceExpr("latency", "", DataType.INT64)

    # -- mutations ----------------------------------------------------------
    def UpsertTracepoint(self, name, table_name, probe_fn,  # noqa: N802
                         target=None, ttl="10m"):
        if not isinstance(probe_fn, _ProbeMarker):
            raise PxLError(
                "UpsertTracepoint() expects a @pxtrace.probe-decorated "
                "function"
            )
        rows = probe_fn.fn()
        if (
            not isinstance(rows, list)
            or len(rows) != 1
            or not isinstance(rows[0], dict)
        ):
            raise PxLError(
                "a probe function must return a single-element list of "
                "{column: pxtrace expression} (probes.h output spec)"
            )
        outputs = []
        for col, te in rows[0].items():
            if not isinstance(te, TraceExpr):
                raise PxLError(
                    f"probe output {col!r} is not a pxtrace expression"
                )
            outputs.append((str(col), te))
        dep = TracepointDeployment(
            name=str(name),
            table_name=str(table_name),
            probe=ProbeDef(target=probe_fn.target, outputs=tuple(outputs)),
            ttl_s=parse_ttl(ttl),
        )
        self.mutations.append(dep)
        return dep

    def DeleteTracepoint(self, name):  # noqa: N802
        d = TracepointDelete(name=str(name))
        self.mutations.append(d)
        return d
