"""Plan debugger: human-readable rendering of compiled plans + stats.

Reference parity: the planner's plan debugger / ``px debug plan`` dump
(``src/carnot/planner/compiler/...`` graphviz export and
``src/pixie_cli`` plan rendering). The rendering annotates which linear
chains fuse into one fragment (one window fold) and, when analyze stats
are attached, the per-fragment stage wall times. A copy of the JAX
package's ``planner/debug.py``; the text is the same for the same plan.
"""

from __future__ import annotations

from ..exec.plan import (
    AggOp,
    BridgeSinkOp,
    BridgeSourceOp,
    EmptySourceOp,
    FilterOp,
    JoinOp,
    LimitOp,
    MapOp,
    MemorySourceOp,
    OTelExportSinkOp,
    Plan,
    ResultSinkOp,
    UDTFSourceOp,
    UnionOp,
)


def _op_label(op) -> str:
    if isinstance(op, MemorySourceOp):
        cols = "*" if op.columns is None else ",".join(op.columns)
        rng = ""
        if op.start_time is not None or op.stop_time is not None:
            rng = f" time=[{op.start_time}, {op.stop_time})"
        return f"MemorySource table={op.table!r} cols={cols}{rng}"
    if isinstance(op, MapOp):
        exprs = ", ".join(f"{n}={e!r}" for n, e in op.exprs)
        return f"Map {exprs}"
    if isinstance(op, FilterOp):
        return f"Filter {op.predicate!r}"
    if isinstance(op, AggOp):
        aggs = ", ".join(
            f"{a.out_name}={a.uda_name}({', '.join(map(repr, a.args))})"
            for a in op.aggs
        )
        by = ",".join(op.group_cols) or "<global>"
        mode = "" if op.mode == "full" else f" mode={op.mode}"
        return f"Agg by=[{by}] {aggs} max_groups={op.max_groups}{mode}"
    if isinstance(op, JoinOp):
        return (
            f"Join how={op.how} left_on={list(op.left_on)} "
            f"right_on={list(op.right_on)}"
        )
    if isinstance(op, LimitOp):
        return f"Limit n={op.n}"
    if isinstance(op, UnionOp):
        return "Union (time-ordered)"
    if isinstance(op, UDTFSourceOp):
        args = ", ".join(f"{k}={v!r}" for k, v in op.args)
        return f"UDTFSource {op.name}({args})"
    if isinstance(op, EmptySourceOp):
        return f"EmptySource {[n for n, _ in op.relation_items]}"
    if isinstance(op, BridgeSinkOp):
        return f"BridgeSink id={op.bridge_id}"
    if isinstance(op, BridgeSourceOp):
        return f"BridgeSource id={op.bridge_id}"
    if isinstance(op, OTelExportSinkOp):
        return "OTelExportSink"
    if isinstance(op, ResultSinkOp):
        return f"ResultSink {op.name!r}"
    return type(op).__name__


def _fragment_breaks(plan: Plan) -> set:
    """Node ids that START a new fragment (sources, joins, unions, and
    any op consumed by >1 node — everything the engine materializes)."""
    consumers: dict[int, int] = {}
    for n in plan.nodes.values():
        for i in n.inputs:
            consumers[i] = consumers.get(i, 0) + 1
    breaks = set()
    for nid, node in plan.nodes.items():
        op = node.op
        if not isinstance(op, (MapOp, FilterOp, AggOp, LimitOp, ResultSinkOp)):
            breaks.add(nid)
        elif node.inputs and consumers.get(node.inputs[0], 0) > 1:
            breaks.add(nid)
    return breaks


def explain_plan(plan: Plan, stats=None) -> str:
    """Text tree of the plan, sinks last, annotated with fragment fusion.

    ``stats`` is an optional ``exec.analyze.QueryStats`` (from
    ``execute_plan(analyze=True)``) — per-fragment stage seconds are
    appended when given.
    """
    lines = []
    breaks = _fragment_breaks(plan)
    frag_stats = list(getattr(stats, "fragments", []) or [])
    fi = 0
    for nid in plan.topo_order():
        node = plan.nodes[nid]
        fused = nid not in breaks and node.inputs
        prefix = "  | " if fused else "  "  # "| " = fused into the chain above
        rel = ""
        if node.relation is not None:
            rel = f"  :: {node.relation}"
        lines.append(f"{prefix}[{nid}] {_op_label(node.op)}{rel}")
        if stats is not None and isinstance(node.op, AggOp) and fi < len(frag_stats):
            fs = frag_stats[fi]
            fi += 1
            stages = ", ".join(
                f"{k}={v.seconds * 1e3:.1f}ms"
                for k, v in sorted(fs.stages.items())
            )
            lines.append(
                f"  |    stats: windows={fs.windows} rows_in={fs.rows_in} "
                f"rows_out={fs.rows_out} {stages}"
            )
    header = f"Plan: {len(plan.nodes)} ops, sinks={plan.sinks()}"
    return "\n".join([header] + lines)


def explain_pxl(query: str, schemas: dict, registry=None) -> str:
    """Compile a PxL script and render its physical plan (px explain)."""
    from ..udf.registry import default_registry
    from .compiler import CompilerState, compile_pxl

    state = CompilerState(
        schemas=schemas, registry=registry or default_registry()
    )
    compiled = compile_pxl(query, state)
    return explain_plan(compiled.plan)
