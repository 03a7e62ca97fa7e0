"""Physical plan representation: operators + scalar expression trees.

Reference parity: ``src/carnot/plan/operators.h:49`` (Operator hierarchy:
MemorySource/Map/Filter/BlockingAgg/Join/Limit/MemorySink/GRPCSink...) and
``src/carnot/plan/scalar_expression.h`` (ScalarValue/Column/ScalarFunc/
AggregateExpression). The plan is a DAG of nodes; linear runs of
Map/Filter/Agg compile into ONE jitted fragment program instead of a
push-based exec-node chain.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

from ..types.dtypes import DataType


# -- scalar expressions ------------------------------------------------------
class Expr:
    pass


@dataclass(frozen=True)
class ColumnRef(Expr):
    name: str

    def __repr__(self):
        return f"col({self.name})"


@dataclass(frozen=True)
class Literal(Expr):
    value: object
    dtype: DataType

    def __repr__(self):
        return f"lit({self.value!r})"


@dataclass(frozen=True)
class FuncCall(Expr):
    name: str
    args: tuple

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


@dataclass(frozen=True)
class AggExpr:
    """One aggregate output: out_name = uda_name(*args)."""

    out_name: str
    uda_name: str
    args: tuple  # tuple[Expr]; evaluated pre-aggregation


def trace_map_renames(map_op: "MapOp", mapping: dict) -> dict | None:
    """One reverse step of column-provenance tracing through a MapOp:
    remap each tracked (output name -> current name) entry through the
    map's exprs, or None when any tracked column is computed rather
    than a pure ``ColumnRef`` — upstream statistics (ingest sketches)
    then no longer describe its values. Shared by the executor's join
    stream walk and the planner's plan walk so the two can never
    disagree about when sketches apply."""
    exprs = dict(map_op.exprs)
    new = {}
    for out, src in mapping.items():
        e = exprs.get(src)
        if not isinstance(e, ColumnRef):
            return None
        new[out] = e.name
    return new


# -- operators ---------------------------------------------------------------
class Op:
    pass


@dataclass(frozen=True)
class MemorySourceOp(Op):
    """Stream a table out of the table store, time-bounded.

    Reference: ``src/carnot/exec/memory_source_node.h:42``.
    """

    table: str
    columns: Optional[tuple] = None  # None = all
    start_time: Optional[int] = None
    stop_time: Optional[int] = None


@dataclass(frozen=True)
class MapOp(Op):
    """Full projection: output columns are exactly ``exprs``.

    Reference: ``src/carnot/exec/map_node.h``.
    """

    exprs: tuple  # tuple[(name, Expr)]


@dataclass(frozen=True)
class FilterOp(Op):
    """Reference: ``src/carnot/exec/filter_node.h`` — here a mask &=, no copy."""

    predicate: Expr


@dataclass(frozen=True)
class AggOp(Op):
    """Group-by aggregate (blocking).

    Reference: ``src/carnot/exec/agg_node.h:66``. ``partial``/``finalize``
    mirror the distributed splitter's partial-op protocol
    (``planner/distributed/splitter/partial_op_mgr``): a partial agg emits
    carries; a finalize agg merges carries. The single-chip path runs both
    fused.
    """

    group_cols: tuple  # tuple[str]
    aggs: tuple  # tuple[AggExpr]
    max_groups: int = 4096
    # 'full' (single-fragment), 'partial' (emit mergeable carries — the
    # PEM/prepare half), 'finalize' (merge carries — the Kelvin half).
    mode: str = "full"


@dataclass(frozen=True)
class JoinOp(Op):
    """Equijoin of the left (probe) side against the right (build) side.

    Reference: ``src/carnot/exec/equijoin_node.h:48``. Small unique-key
    (N:1) inner/left joins run on host; everything else — N:M fan-out,
    right/outer, large inputs — routes to the sort-based device join
    (``pixie_tpu.ops.join``). how: 'inner' | 'left' | 'right' | 'outer'.
    """

    left_on: tuple
    right_on: tuple
    how: str = "inner"
    suffix: str = "_y"


@dataclass(frozen=True)
class LookupJoinOp(Op):
    """Fused N:1 equijoin stage inside a streaming fragment.

    Engine-internal (never produced by the planner): when a JoinOp's
    build side resolves to a dense-domain table — a dense aggregate's
    slot-aligned device state, or a unique-key host batch — the probe
    side's fragment gains this stage instead of materializing the join.
    Each probe row maps its key to a slot (``slot = key - lo``), checks a
    found bitmap, and gathers the build side's value columns on device —
    the TPU-first form of ``equijoin_node.cc``'s build+probe (output-row
    assembly never leaves the device; cf. VERDICT r03 device_join).

    The build arrays ride the fragment's side-input pytree
    (``cols['__side__']``), keyed ``{prefix}:found`` and
    ``{prefix}:{out_name}:{plane}`` — runtime arguments, not closure
    constants, so compiled fragments cache across queries.
    """

    key_col: str  # probe key column (single device plane)
    how: str  # 'inner' | 'left'
    prefix: str  # side-input key prefix, unique per join in a query
    lo: int  # dense domain offset (0 for dictionary codes)
    dom: int  # dense domain size
    out_cols: tuple  # ((out_name, DataType, n_planes), ...)


@dataclass(frozen=True)
class LimitOp(Op):
    """Reference: ``src/carnot/exec/limit_node.h`` (+ source abort signal)."""

    n: int


@dataclass(frozen=True)
class UnionOp(Op):
    """Concatenate inputs with identical schemas (k-way, time-ordered at
    materialization). Reference: ``src/carnot/exec/union_node.h``."""


@dataclass(frozen=True)
class UDTFSourceOp(Op):
    """Run a registered UDTF as a source.

    Reference: ``src/carnot/exec/udtf_source_node.h`` — used for cluster
    introspection (agent status, schema listing, registry listing).
    ``args`` are the compile-time init args (udtf.h UDTFInitArgs).
    """

    name: str
    args: tuple = ()  # tuple[(name, value)]


@dataclass(frozen=True)
class EmptySourceOp(Op):
    """Zero-row source with a declared relation
    (``src/carnot/exec/empty_source_node.h``)."""

    relation_items: tuple = ()  # tuple[(name, DataType)]


@dataclass(frozen=True)
class BridgeSinkOp(Op):
    """End of a per-agent fragment: hand the fragment's output to a
    cross-fragment bridge. GRPCSinkNode analog
    (``src/carnot/exec/grpc_sink_node.h:54``); on TPU the bridge is an XLA
    collective over the mesh, not a gRPC stream (SURVEY.md §2.7)."""

    bridge_id: int


@dataclass(frozen=True)
class BridgeSourceOp(Op):
    """Start of a merge fragment: consume a bridge's output.
    GRPCSourceNode analog (``src/carnot/exec/grpc_source_node.h``)."""

    bridge_id: int


@dataclass(frozen=True)
class OTelExportSinkOp(Op):
    """Export result rows as OTel metrics/spans.

    Reference: ``src/carnot/exec/otel_export_sink_node.h:40``; ``spec``
    is an ``exec.otel.OTelDataSpec``.
    """

    spec: object = None


@dataclass(frozen=True)
class TableSinkOp(Op):
    """Write result rows back into a named table-store table.

    Reference: MemorySinkNode (``src/carnot/exec/memory_sink_node.h``) —
    query outputs land in the table store so later queries (or a cron
    ScriptRunner stage) can read them.
    """

    table: str = "output"


@dataclass(frozen=True)
class ResultSinkOp(Op):
    """Terminal sink: materialize to the client result stream.

    Reference: GRPCSinkNode/MemorySinkNode (``src/carnot/exec/grpc_sink_node.h:54``).
    """

    name: str = "output"


@dataclass
class PlanNode:
    id: int
    op: Op
    inputs: list = field(default_factory=list)  # list[int]
    # Output schema, populated by the planner for rule passes (the engine
    # resolves schemas itself; manual plans may leave this None).
    relation: object = None


@dataclass
class Plan:
    """Operator DAG. Nodes are topologically ordered by construction."""

    nodes: dict = field(default_factory=dict)  # id -> PlanNode
    _counter: itertools.count = field(default_factory=itertools.count)

    def add(self, op: Op, inputs: list | None = None, relation=None) -> int:
        nid = next(self._counter)
        self.nodes[nid] = PlanNode(
            id=nid, op=op, inputs=list(inputs or []), relation=relation
        )
        return nid

    def sinks(self) -> list:
        used = {i for n in self.nodes.values() for i in n.inputs}
        return [nid for nid in self.nodes if nid not in used]

    def topo_order(self) -> list:
        seen, out = set(), []

        def visit(nid):
            if nid in seen:
                return
            seen.add(nid)
            for i in self.nodes[nid].inputs:
                visit(i)
            out.append(nid)

        for s in self.sinks():
            visit(s)
        return out
