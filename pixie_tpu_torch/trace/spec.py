"""Tracepoint specifications: the pxtrace compile target.

Reference parity: the probe DSL compiles PxL probe definitions into
``TracepointDeployment`` protos (``src/carnot/planner/probes/probes.h``,
``tracepoint_generator.h``); those deploy through the MDS tracepoint
registry to PEMs, whose dynamic tracer compiles them into attached
programs (``src/stirling/source_connectors/dynamic_tracer/
dynamic_tracer.h:48``).

Divergence (documented): the reference resolves argument/return types
from DWARF at attach time; this runtime instruments in-process Python
callables, so ``ArgExpr``/``RetExpr`` carry a declared logical type
(default INT64) instead.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..types.dtypes import DataType
from ..types.relation import Relation


@dataclass(frozen=True)
class TraceExpr:
    """One captured value: a function argument, the return value, or the
    call latency (probes.h ProbeIR output expressions)."""

    kind: str  # 'arg' | 'ret' | 'latency'
    expr: str = ""  # 'arg0'..'argN' or a keyword argument name; '' for ret
    dtype: DataType = DataType.INT64

    def __post_init__(self):
        if self.kind not in ("arg", "ret", "latency"):
            raise ValueError(f"unknown trace expr kind {self.kind!r}")


@dataclass(frozen=True)
class ProbeDef:
    """A probe function's compiled body: target symbol + named outputs."""

    target: str  # symbol to instrument, e.g. 'app.handle_request'
    outputs: tuple = ()  # tuple[(column name, TraceExpr)]


@dataclass(frozen=True)
class TracepointDeployment:
    """One UpsertTracepoint request (TracepointDeployment proto analog)."""

    name: str
    table_name: str
    probe: ProbeDef
    ttl_s: float = 600.0

    def relation(self) -> Relation:
        items = [
            ("time_", DataType.TIME64NS),
            ("upid", DataType.UINT128),
        ]
        for col, te in self.probe.outputs:
            items.append((col, te.dtype))
        return Relation(items)


@dataclass(frozen=True)
class TracepointDelete:
    """A DeleteTracepoint request."""

    name: str


def parse_ttl(ttl) -> float:
    """'30s' / '10m' / '2h' / number-of-seconds -> seconds."""
    if isinstance(ttl, (int, float)):
        return float(ttl)
    s = str(ttl).strip()
    units = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
    if s and s[-1] in units:
        return float(s[:-1]) * units[s[-1]]
    return float(s)
