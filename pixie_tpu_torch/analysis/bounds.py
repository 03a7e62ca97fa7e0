"""pxbound: plan-time resource-bound verification via abstract
interpretation.

A copy of the JAX package's ``analysis/bounds.py``. Runs as an always-on
pass AFTER the plan verifier (``verifier.py``) in ``compile_pxl`` and
(for distributed plans) after ``check_distributed_plan`` in
``DistributedPlanner.plan``. Where the verifier answers "is this plan
well-formed?", pxbound answers "what can this plan COST?": it propagates
a per-node resource domain through the operator DAG —

- **row-count interval** ``[lo, hi]`` (``hi=None`` = unbounded),
  seeded from ingest-sketch row counts (``CompilerState.table_stats``,
  maintained by ``table_store/sketches.py`` at append time),
- **bytes per row** from the propagated relation's host plane widths
  (``types/dtypes.host_dtypes``: the numpy planes the table store
  keeps, the same widths as the JAX package's, so both packages count
  the same bytes),
- **group-count bound** for aggregates (HLL NDV product of the group
  columns traced through renames to the source sketches, clamped by
  ``max_groups_limit``),
- **join output bound** reusing the runtime's own
  ``exec/joins.estimate_join_capacity`` (NDV fan-out x zone overlap)
  with side statistics synthesized from the table stats,
- **bridge wire-bytes bound** at every ``BridgeSinkOp``.

The walk produces a :class:`PlanResourceReport`, the query's
*predicted* resource use, which the engine uses to pre-size aggregate
group capacity (``presize_plan_aggs``: grow ``AggOp.max_groups`` to the
NDV bound so a first run starts at the predicted rung instead of
climbing the overflow-doubling ladder, one whole-table re-fold per rung)
and to seed join output capacities where run-time sketches cannot see
(post-aggregate build sides). ``merged_cost`` is the summary a query
broker schedules admission on; the port has no broker yet.

Soundness contract: every bound is an inclusive UPPER bound on the
observed counter under the ``bounds_safety`` factor. Two deliberate
exceptions, both with run-time escape hatches: join output bounds are
NDV *estimates* (adversarial key skew can exceed them; the kernel's
overflow-retry ladder absorbs it, counted in ``join_retries``), and
bounds are sketch-seeded, so concurrent ingest between compile and
execution can raise the true row count (the safety factor absorbs
normal churn). Sketch-less inputs degrade to unbounded (``hi=None``) —
conservative, never a crash, and never a rejection.

Reference grounding: PAPERS.md "Online Sketch-based Query
Optimization" (arXiv:2102.02440) and "Sketched Sum-Product Networks
for Joins" (arXiv:2506.14034) run the same sketch-driven estimation
loop as best-effort optimizer hints.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

import numpy as np

from ..exec.plan import (
    AggOp,
    BridgeSinkOp,
    BridgeSourceOp,
    EmptySourceOp,
    FilterOp,
    JoinOp,
    LimitOp,
    LookupJoinOp,
    MapOp,
    MemorySourceOp,
    Plan,
    UDTFSourceOp,
    UnionOp,
    trace_map_renames,
)
from .diagnostics import Diagnostic, PlanCheckError, Severity
from .verifier import _Ctx, _topo

#: Per-slot aggregate-state byte estimate multiplier: a group slot
#: carries the packed key planes + one or two f64/i64 carries per
#: aggregate (mean = sum+count) + validity. 24 bytes per (slot, column)
#: is a deliberate over-estimate of the 8-16 real bytes.
_AGG_SLOT_BYTES = 24

#: Device bytes per join row across the kernel's output planes
#: (probe idx, probe take, build idx, build take + the staged key).
_JOIN_ROW_BYTES = 40


def _unb(*vals):
    """None-propagating helper: any unbounded operand -> unbounded."""
    return any(v is None for v in vals)


@dataclass
class Interval:
    """Row-count interval; ``hi=None`` means unbounded (no sketch)."""

    lo: int = 0
    hi: int | None = None

    def cap(self, n: int | None) -> "Interval":
        if n is None:
            return Interval(self.lo, self.hi)
        hi = n if self.hi is None else min(self.hi, n)
        return Interval(min(self.lo, hi), hi)

    def zero_lo(self) -> "Interval":
        return Interval(0, self.hi)


@dataclass
class NodeBound:
    """The resource domain at one plan node."""

    rows: Interval
    row_bytes: int | None = None  # host bytes/row of the out relation
    groups: int | None = None  # agg: NDV-derived group bound
    join_capacity: int | None = None  # join: estimated output capacity
    wire_bytes: int | None = None  # bridge sink: payload bound
    cold_rows: int | None = None  # source: rows resident in the cold tier
    origin: str = "none"  # 'sketch' | 'derived' | 'none'


@dataclass
class PlanResourceReport:
    """Predicted resource envelope of one plan — the plan-time
    counterpart of ``QueryResourceUsage``. ``None`` totals mean
    unbounded (some input had no sketches); consumers must treat them
    as "unknown, admit/skip", never as zero."""

    plan_name: str = "logical"
    safety: float = 1.0
    nodes: dict = field(default_factory=dict)  # nid -> NodeBound
    rows_in_hi: int | None = None
    rows_out_hi: int | None = None
    bytes_staged_hi: int | None = None
    wire_bytes_hi: int | None = None
    peak_node_bytes_hi: int | None = None
    #: Upper bound on raw bytes that must be DECODED from the cold
    #: storage tier to serve the scan. Zone-map
    #: window skipping only lowers the realized value. 0 for untiered
    #: sources; None when a tiered source's rows are unbounded.
    cold_decode_bytes_hi: int | None = None
    agg_groups: dict = field(default_factory=dict)  # nid -> group bound
    join_capacity: dict = field(default_factory=dict)  # nid -> capacity
    diagnostics: list = field(default_factory=list)

    @property
    def origin(self) -> str:
        origins = {b.origin for b in self.nodes.values()}
        if origins <= {"none"} or not origins:
            return "none"
        return "sketch" if "none" not in origins else "mixed"

    def cost(self) -> dict:
        """Wire-safe summary: what the broker attaches to dispatches as
        ``predicted_cost`` and stamps on the query trace (the
        predicted-vs-observed columns of ``px debug queries``)."""
        return {
            "bytes_staged_hi": self.bytes_staged_hi,
            "rows_in_hi": self.rows_in_hi,
            "rows_out_hi": self.rows_out_hi,
            "wire_bytes_hi": self.wire_bytes_hi,
            "peak_node_bytes_hi": self.peak_node_bytes_hi,
            "cold_decode_bytes_hi": self.cold_decode_bytes_hi,
            "origin": self.origin,
            "safety": self.safety,
        }


_DT_BYTES: dict = {}  # DataType -> host bytes/row (lazy: import order)


def _row_bytes(rel) -> int | None:
    """Host bytes per row of ``rel`` (sum of host plane itemsizes — the
    unit ``HostBatch.nbytes`` reports). The host planes, not the device
    ones: FLOAT64 is 8 bytes here though the card holds it as f32, as in
    the JAX package's model."""
    if rel is None:
        return None
    if not _DT_BYTES:
        from ..types.dtypes import DataType, host_dtypes

        for dt in DataType:
            _DT_BYTES[dt] = int(sum(
                np.dtype(hd).itemsize for hd in host_dtypes(dt)
            ))
    return sum(_DT_BYTES[dt] for _n, dt in rel.items())


def _source_col_stats(plan: Plan, nid: int, cols, table_stats):
    """Trace ``cols`` at node ``nid`` back through Map renames /
    Filter / Limit to a MemorySourceOp's sketch stats. Returns
    ``(rows, {col: (ndv, lo, hi)})`` or ``(None, None)`` when any hop
    computes the columns or stats are missing (sketches then no longer
    describe the values — same reverse walk as
    ``exec/joins._chain_key_sources``)."""
    if not table_stats:
        return None, None
    mapping = {c: c for c in cols}
    while True:
        node = plan.nodes.get(nid)
        if node is None:
            return None, None
        op = node.op
        if isinstance(op, MemorySourceOp):
            st = table_stats.get(op.table)
            if not isinstance(st, dict):
                return None, None
            ndvs = st.get("ndv") or {}
            zones = st.get("zones") or {}
            out = {}
            for want, src in mapping.items():
                ndv = ndvs.get(src)
                if ndv is None:
                    return None, None
                lo, hi = (zones.get(src) or (None, None))[:2] \
                    if zones.get(src) else (None, None)
                out[want] = (int(ndv), lo, hi)
            return st.get("rows"), out
        if isinstance(op, (FilterOp, LimitOp)) and node.inputs:
            nid = node.inputs[0]
        elif isinstance(op, MapOp) and node.inputs:
            mapping = trace_map_renames(op, mapping)
            if mapping is None:
                return None, None
            nid = node.inputs[0]
        else:
            return None, None


def _join_side_stats(plan: Plan, nid: int, on_cols, table_stats,
                     rows_hi: int | None):
    """Synthesize a ``JoinSideStats`` for one join input from the
    traced source sketches, falling back to the propagated row bound
    alone (NDV-less) when tracing fails."""
    from ..exec.joins import JoinSideStats

    rows, stats = _source_col_stats(plan, nid, list(on_cols), table_stats)
    if stats is not None and len(on_cols) == 1:
        ndv, lo, hi = stats[on_cols[0]]
        r = rows if rows_hi is None else min(int(rows or 0), rows_hi)
        return JoinSideStats(
            rows=int(r or 0), lo=lo, hi=hi,
            ndv=max(1, min(ndv, int(r or ndv))), origin="sketch",
        )
    if rows_hi is not None:
        return JoinSideStats(rows=int(rows_hi), origin="none")
    return None


def _node_bound(plan, nid, node, in_bounds, ctx, table_stats,
                max_groups_limit):
    """One transfer step of the abstract interpreter: the node's
    resource domain from its inputs' domains."""
    op = node.op
    rel = ctx.rels.get(nid)
    rb = _row_bytes(rel)
    first = in_bounds[0] if in_bounds else None

    if isinstance(op, MemorySourceOp):
        st = (table_stats or {}).get(op.table)
        rows = st.get("rows") if isinstance(st, dict) else None
        tier = st.get("tier") if isinstance(st, dict) else None
        cold_rows = None
        if isinstance(tier, dict):
            # Per-tier seeding from the table's freshness envelope
            # (a tiered table store; the port's has no tiers yet, so
            # its snapshot carries no "tier" entry): the OBSERVED raw
            # bytes/row of the
            # resident data. Taken as a max with the schema-derived
            # width so the staged-bytes bound never narrows below
            # either; the cold row count seeds the decode-bytes bound.
            obs = tier.get("raw_row_bytes")
            if obs:
                rb = max(rb or 0, int(math.ceil(obs)))
            cr = tier.get("cold_rows")
            if cr is not None:
                cold_rows = int(cr)
        if rows is not None:
            return NodeBound(
                Interval(0, int(rows)), rb,
                cold_rows=cold_rows, origin="sketch",
            )
        return NodeBound(Interval(0, None), rb, cold_rows=cold_rows)

    if isinstance(op, EmptySourceOp):
        return NodeBound(Interval(0, 0), rb, origin="derived")

    if isinstance(op, UDTFSourceOp):
        return NodeBound(Interval(0, None), rb)

    if isinstance(op, BridgeSourceOp):
        # Seeded by the distributed walk (data-side sink bound x agent
        # count) via ctx.bridge_relations' sibling dict; standalone
        # merge plans degrade to unbounded.
        hi = getattr(ctx, "bridge_rows", {}).get(op.bridge_id)
        return NodeBound(
            Interval(0, hi), rb,
            origin="derived" if hi is not None else "none",
        )

    if first is None:
        return NodeBound(Interval(0, None), rb)

    if isinstance(op, MapOp):
        return NodeBound(
            Interval(first.rows.lo, first.rows.hi), rb, origin=first.origin
        )

    if isinstance(op, FilterOp):
        return NodeBound(first.rows.zero_lo(), rb, origin=first.origin)

    if isinstance(op, LimitOp):
        return NodeBound(
            first.rows.zero_lo().cap(max(op.n, 0)), rb, origin=first.origin
        )

    if isinstance(op, AggOp):
        if not op.group_cols:
            return NodeBound(Interval(0, 1), rb, origin="derived")
        hi = first.rows.hi
        groups = None
        _rows, stats = _source_col_stats(
            plan, node.inputs[0], list(op.group_cols), table_stats
        )
        if stats is not None:
            groups = 1
            for _c, (ndv, _lo, _hi) in stats.items():
                groups *= max(int(ndv), 1)
        if groups is not None:
            hi = groups if hi is None else min(hi, groups)
        if hi is not None:
            hi = min(hi, int(max_groups_limit))
        origin = "sketch" if groups is not None else (
            first.origin if hi is not None else "none"
        )
        return NodeBound(Interval(0, hi), rb, groups=groups, origin=origin)

    if isinstance(op, JoinOp):
        left, right = (in_bounds + [None, None])[:2]
        l_hi = left.rows.hi if left else None
        r_hi = right.rows.hi if right else None
        l_stats = _join_side_stats(
            plan, node.inputs[0], op.left_on, table_stats, l_hi
        ) if node.inputs else None
        r_stats = _join_side_stats(
            plan, node.inputs[1], op.right_on, table_stats, r_hi
        ) if len(node.inputs) > 1 else None
        from ..exec.joins import estimate_join_capacity

        # N:1 structural bound: a build side aggregated ON the join
        # keys has unique keys by construction (the eager-agg rewrite's
        # shape), so each probe row matches at most once — no NDV
        # estimate needed, and l_hi x r_hi would be absurdly loose.
        build = plan.nodes.get(node.inputs[1]) if len(node.inputs) > 1 \
            else None
        n_to_1 = (
            build is not None
            and isinstance(build.op, AggOp)
            and set(build.op.group_cols) == set(op.right_on)
        )
        capacity = None
        hi = None
        if l_hi is not None and r_hi is not None:
            if n_to_1:
                hi = l_hi + (r_hi if op.how in ("right", "outer") else 0)
                capacity = hi
            else:
                # Sound worst case: every probe row matches every build
                # row (+ unmatched emits for the outer flavors).
                hi = l_hi * max(r_hi, 1) + (l_hi + r_hi)
                if r_stats is not None and r_stats.ndv:
                    # NDV-estimate refinement (the runtime's own sizing
                    # model — an ESTIMATE; the kernel's overflow retry
                    # is the escape hatch, so the bound stays the min
                    # of both).
                    capacity = estimate_join_capacity(
                        l_hi, r_stats, l_stats, op.how
                    )
                    hi = min(hi, capacity)
                else:
                    capacity = estimate_join_capacity(
                        l_hi, r_stats, l_stats, op.how
                    )
        origin = (
            "sketch"
            if r_stats is not None and r_stats.origin == "sketch"
            else ("derived" if hi is not None else "none")
        )
        return NodeBound(
            Interval(0, hi), rb, join_capacity=capacity, origin=origin
        )

    if isinstance(op, LookupJoinOp):
        # Fused N:1 lookup: at most one build row per probe row.
        return NodeBound(first.rows.zero_lo(), rb, origin=first.origin)

    if isinstance(op, UnionOp):
        his = [b.rows.hi for b in in_bounds if b is not None]
        hi = None if (_unb(*his) or not his) else sum(his)
        return NodeBound(
            Interval(0, hi), rb,
            origin="derived" if hi is not None else "none",
        )

    if isinstance(op, BridgeSinkOp):
        wb = None
        if first.rows.hi is not None and first.row_bytes:
            # Rows payloads ship the relation's planes; agg-state
            # payloads ship carries (sum+count per mean, etc.) — the
            # x4 factor over-covers the carry expansion.
            wb = first.rows.hi * first.row_bytes * 4
        return NodeBound(
            Interval(first.rows.lo, first.rows.hi), first.row_bytes,
            wire_bytes=wb, origin=first.origin,
        )

    # Sinks and anything unknown: pass the first input through (sinks
    # don't change cardinality; unknown operators stay conservative).
    return NodeBound(first.rows.zero_lo(), rb or first.row_bytes,
                     origin=first.origin)


def _node_peak_bytes(node, bound, in_bounds, window_rows) -> int | None:
    """Rough per-node device-allocation demand (the ``bounds_device_
    budget_mb`` unit): staged window planes, aggregate group state, or
    join build+output buffers. Estimates, deliberately generous."""
    op = node.op
    if isinstance(op, MemorySourceOp):
        if bound.rows.hi is None or not bound.row_bytes:
            return None if bound.rows.hi is None else 0
        return min(bound.rows.hi, window_rows) * bound.row_bytes
    if isinstance(op, AggOp):
        groups = bound.groups
        if groups is None:
            groups = bound.rows.hi
        if groups is None:
            return None
        width = len(op.aggs) + len(op.group_cols) + 1
        return int(groups) * width * _AGG_SLOT_BYTES
    if isinstance(op, JoinOp):
        right = in_bounds[1] if len(in_bounds) > 1 else None
        build_hi = right.rows.hi if right is not None else None
        cap = bound.join_capacity
        if build_hi is None and cap is None:
            return None
        total = 0
        if build_hi is not None:
            total += build_hi * 16  # staged sorted keys + order
        if cap is not None:
            total += cap * _JOIN_ROW_BYTES
        return total
    return 0


def plan_bounds(plan: Plan, schemas, registry, table_stats=None, *,
                plan_name: str = "logical", bridge_rows=None,
                bridge_relations=None, safety: float | None = None,
                ) -> PlanResourceReport:
    """Abstract-interpret ``plan``: per-node bounds + predicted query
    totals. Never raises on missing statistics — sketch-less inputs
    propagate as unbounded (``None``) bounds.

    ``bridge_rows`` maps bridge id -> row bound for merge fragments
    (the distributed walk seeds it from the data side);
    ``bridge_relations`` is the verifier's bridge schema dict.
    """
    from ..config import get_flag

    if safety is None:
        safety = float(get_flag("bounds_safety"))
    window_rows = int(get_flag("window_rows"))
    max_groups_limit = int(get_flag("max_groups_limit"))
    report = PlanResourceReport(plan_name=plan_name, safety=safety)
    if not plan.nodes:
        report.rows_in_hi = report.rows_out_hi = 0
        report.bytes_staged_hi = report.wire_bytes_hi = 0
        report.peak_node_bytes_hi = report.cold_decode_bytes_hi = 0
        return report

    # Relation propagation: planner-built plans already carry per-node
    # relations (PlanNode.relation, maintained by the rule passes) —
    # reuse them so the always-on pass costs arithmetic, not a second
    # schema walk. Split/manual plans with gaps fall back to the
    # verifier's walk (the plan already verified clean in compile;
    # diagnostics here are dropped).
    from .verifier import _node_out_relation

    ctx = _Ctx(plan, schemas, registry, plan_name, bridge_relations)
    ctx.bridge_rows = dict(bridge_rows or {})
    order = _topo(plan)
    for nid in order:
        node = plan.nodes[nid]
        if node.relation is not None:
            ctx.rels[nid] = node.relation
        else:
            in_rels = [
                ctx.rels.get(i) for i in node.inputs if i in plan.nodes
            ]
            ctx.rels[nid] = _node_out_relation(ctx, node, in_rels)

    consumers: dict[int, int] = {}
    for n in plan.nodes.values():
        for i in n.inputs:
            consumers[i] = consumers.get(i, 0) + 1

    rows_in: int | None = 0
    bytes_staged: int | None = 0
    rows_out: int | None = 0
    wire: int | None = 0
    peak: int | None = 0
    cold_decode: int | None = 0
    for nid in order:
        node = plan.nodes[nid]
        in_bounds = [
            report.nodes.get(i) for i in node.inputs if i in plan.nodes
        ]
        b = _node_bound(plan, nid, node, in_bounds, ctx, table_stats,
                        max_groups_limit)
        report.nodes[nid] = b
        if b.groups is not None:
            report.agg_groups[nid] = b.groups
        if b.join_capacity is not None:
            report.join_capacity[nid] = b.join_capacity

        # -- ledger ----------------------------------------------------------
        # Any node's output may materialize host-side and re-stage in
        # windows for a downstream fragment (join outputs feeding an
        # aggregate are the common case), so EVERY node contributes its
        # row bound once; sources contribute once per consumer (pure-
        # scan fan-out re-executes the scan — the engine's materialize-
        # once rule exempts pure table scans) and join inputs once more
        # (the windowed device drivers re-stage the materialized probe
        # side and count its rows in ``stats.rows_in``). Over-counts
        # fused chains — a sound, deliberately simple model.
        op = node.op
        mult = (
            max(1, consumers.get(nid, 0))
            if isinstance(op, MemorySourceOp) else 1
        )
        events = [(b, mult)]
        if isinstance(op, JoinOp):
            events += [(s, 1) for s in in_bounds if s is not None]
        for side, m in events:
            if side.rows.hi is None:
                rows_in = bytes_staged = None
            else:
                if rows_in is not None:
                    rows_in += side.rows.hi * m
                if side.row_bytes is None:
                    # Rows known but the relation (hence the per-row
                    # width) is not: a silent 0-byte contribution would
                    # understate the total — degrade it to unbounded.
                    bytes_staged = None
                elif bytes_staged is not None:
                    bytes_staged += side.rows.hi * side.row_bytes * m
        # Cold-tier decode demand: each consumer's scan decodes the
        # source's cold windows afresh (same fan-out rule as staging);
        # zone maps can only skip BELOW this.
        if isinstance(op, MemorySourceOp) and b.cold_rows:
            if b.rows.hi is None or not b.row_bytes:
                cold_decode = None
            elif cold_decode is not None:
                cold_decode += (
                    min(b.cold_rows, b.rows.hi) * b.row_bytes * mult
                )
        if b.rows.hi is None:
            rows_out = None
        elif rows_out is not None:
            rows_out += b.rows.hi
        if b.wire_bytes is not None and wire is not None:
            wire += b.wire_bytes
        elif isinstance(op, BridgeSinkOp) and b.wire_bytes is None:
            wire = None
        pb = _node_peak_bytes(node, b, in_bounds, window_rows)
        if pb is None:
            peak = None
        elif peak is not None:
            peak = max(peak, pb)

    s = safety

    def scaled(v):
        return None if v is None else int(v * s)

    report.rows_in_hi = scaled(rows_in)
    report.rows_out_hi = scaled(rows_out)
    report.bytes_staged_hi = scaled(bytes_staged)
    report.wire_bytes_hi = scaled(wire)
    report.peak_node_bytes_hi = scaled(peak)
    report.cold_decode_bytes_hi = scaled(cold_decode)
    _budget_diagnostics(report, plan)
    return report


def _budget_diagnostics(report: PlanResourceReport, plan: Plan) -> None:
    """Budget checks (both flags default 0 = disabled, so the always-on
    pass adds no behavior until an operator opts in)."""
    from ..config import get_flag

    qb = float(get_flag("bounds_query_budget_mb")) * (1 << 20)
    if qb > 0 and report.bytes_staged_hi is not None \
            and report.bytes_staged_hi > qb:
        report.diagnostics.append(Diagnostic(
            code="resource-bound",
            message=(
                f"predicted staged bytes {report.bytes_staged_hi} "
                f"(x{report.safety} safety) exceed the per-query budget "
                f"{int(qb)} (bounds_query_budget_mb="
                f"{get_flag('bounds_query_budget_mb')}); the plan would "
                "be admitted only to fail or thrash at run time"
            ),
            plan=report.plan_name,
        ))
    db = float(get_flag("bounds_device_budget_mb")) * (1 << 20)
    if db > 0:
        for nid, b in report.nodes.items():
            node = plan.nodes.get(nid)
            if node is None:
                continue
            pb = _node_peak_bytes(
                node, b,
                [report.nodes.get(i) for i in node.inputs],
                int(get_flag("window_rows")),
            )
            if pb is not None and pb > db:
                report.diagnostics.append(Diagnostic(
                    code="resource-bound",
                    message=(
                        f"predicted device allocation {pb} bytes exceeds "
                        f"the device budget {int(db)} "
                        "(bounds_device_budget_mb)"
                    ),
                    node=nid, op=type(node.op).__name__,
                    plan=report.plan_name,
                ))


def check_plan_bounds(report: PlanResourceReport) -> None:
    """Raise :class:`PlanCheckError` on any error-severity bound
    diagnostic (compile-time rejection — the ``never an OOM at run
    time`` half of the soundness contract)."""
    errors = [
        d for d in report.diagnostics if d.severity == Severity.ERROR
    ]
    if errors:
        raise PlanCheckError(errors)


def presize_plan_aggs(plan: Plan, report: PlanResourceReport) -> int:
    """Grow ``AggOp.max_groups`` to the sketch-NDV group bound (x1.25
    HLL slack, next power of two, clamped to ``max_groups_limit``) —
    the same sizing rule ``push_agg_through_join`` applies to its
    partial agg, generalized to every aggregate whose group columns
    trace to sketches. Growth only: results are identical at any
    sufficient capacity, and a too-small capacity re-folds the whole
    table once per doubling rung. Returns the number of resized nodes.
    """
    import dataclasses

    from ..config import get_flag

    if not report.agg_groups:
        return 0
    limit = int(get_flag("max_groups_limit"))
    resized = 0
    for nid, groups in report.agg_groups.items():
        node = plan.nodes.get(nid)
        if node is None or not isinstance(node.op, AggOp):
            continue
        want = int(groups * 1.25) + 1
        sized = min(1 << (want - 1).bit_length(), limit)
        if sized > node.op.max_groups:
            node.op = dataclasses.replace(node.op, max_groups=sized)
            resized += 1
    return resized


# Report memo, mirroring the verifier's clean-verification cache: the
# compiler is deterministic, so two compiles of one script against one
# schema set, registry, and STATS SNAPSHOT produce plans with identical
# bounds (node ids included — the per-plan counter is deterministic).
# Repeat compiles — bench warm/timed rounds, dashboard refresh traffic
# between ingest batches — skip the walk entirely (~2µs hit), keeping
# the always-on pass inside the <5%-of-compile-span budget; any ingest
# changes the stats snapshot and naturally misses. Reports cache
# whether clean or over-budget: check_plan_bounds re-raises from the
# cached diagnostics either way.
_BOUNDS_CACHE: dict = {}
_BOUNDS_CACHE_MAX = 256
_BOUNDS_CACHE_LOCK = threading.Lock()


def _stats_key(table_stats: dict) -> str:
    """Cache key for a table_stats snapshot. ``repr`` is one C-level
    pass (a recursive freeze dominated the memo hit); it keys on dict
    ORDER as well as content, so a semantically-equal snapshot built in
    a different order merely misses the cache — never a wrong hit.
    ``__observed__`` (every script's observed cardinalities, which grow
    with each run under telemetry) is left out: the walk never reads
    it, and the compiled script's own entry rides in as
    ``__observed_self__``, which the key keeps."""
    if "__observed__" in table_stats:
        table_stats = {k: v for k, v in table_stats.items()
                       if k != "__observed__"}
    return repr(table_stats)


def apply_plan_bounds(plan: Plan, schemas, registry, table_stats=None, *,
                      plan_name: str = "logical",
                      script: str | None = None,
                      plan_params: tuple = ()) -> PlanResourceReport:
    """The compile-path entry point (``compile_pxl``): compute bounds,
    enforce budgets, pre-size aggregates, and attach the report to the
    plan (``plan.resource_report``) for the engine and broker.
    ``script`` enables the repeat-compile memo; ``plan_params`` must
    carry every compile input that shapes the plan beyond the script
    text (max_output_rows sizes the injected LimitOp that caps row/byte
    bounds, max_groups sizes AggOps) — same contract as
    ``check_script_plan``."""
    from ..config import get_flag, get_flags

    key = None
    if script is not None:
        key = (
            script,
            # A Relation caches its hash (it is immutable): hashing ~20
            # canonical tables' columns per compile was the dominant
            # cost of a memo hit. Table names are unique, so the sort
            # never compares two relations.
            tuple(sorted((schemas or {}).items())),
            id(registry),
            _stats_key(table_stats or {}),
            plan_params,
            # Every flag the walk or its budget checks read.
            get_flags(
                "bounds_safety", "bounds_query_budget_mb",
                "bounds_device_budget_mb", "window_rows",
                "max_groups_limit", "bounds_presize",
            ),
        )
    report = None
    if key is not None:
        try:
            with _BOUNDS_CACHE_LOCK:
                cached = _BOUNDS_CACHE.get(key)
        except TypeError:  # an unhashable plan parameter: no memo
            key = cached = None
        if cached is not None:
            report, _registry_pin = cached
    if report is None:
        report = plan_bounds(
            plan, schemas, registry, table_stats, plan_name=plan_name
        )
        if key is not None:
            with _BOUNDS_CACHE_LOCK:
                if len(_BOUNDS_CACHE) >= _BOUNDS_CACHE_MAX:
                    _BOUNDS_CACHE.pop(next(iter(_BOUNDS_CACHE)))
                # Pin the registry (id-keyed; a freed registry's id
                # could be recycled) — same discipline as _VERIFY_CACHE.
                _BOUNDS_CACHE[key] = (report, registry)
    check_plan_bounds(report)
    if bool(get_flag("bounds_presize")):
        presize_plan_aggs(plan, report)
    plan.resource_report = report
    return report


def distributed_bounds(dplan, schemas, registry, table_stats=None,
                       n_agents: int = 1) -> dict:
    """Bounds for a split plan: the data fragment per agent (each
    agent's shard is at most the whole table), the merge fragment with
    bridge row bounds seeded from the data side x ``n_agents``, and the
    total bridge wire bound. Attached as ``dplan.resource_report``."""
    split = dplan.split
    data = plan_bounds(
        split.before_blocking, schemas, registry, table_stats,
        plan_name="data",
    )
    bridge_rows: dict = {}
    bridge_rels: dict = {}
    for nid, n in split.before_blocking.nodes.items():
        if isinstance(n.op, BridgeSinkOp):
            b = data.nodes.get(nid)
            if b is not None and b.rows.hi is not None:
                bridge_rows[n.op.bridge_id] = b.rows.hi * max(n_agents, 1)
    wire = data.wire_bytes_hi
    if wire is not None:
        wire *= max(n_agents, 1)
    merge = plan_bounds(
        split.after_blocking, schemas, registry, table_stats,
        plan_name="merge", bridge_rows=bridge_rows,
    )
    # Fragment plans travel to the agents in dispatch messages; riding
    # the report on them gives each agent engine the same join-buffer
    # pre-sizing seam local queries get (engine reads
    # plan.resource_report).
    split.before_blocking.resource_report = data
    split.after_blocking.resource_report = merge
    report = {"data": data, "merge": merge, "wire_bytes_hi": wire}
    dplan.resource_report = report
    return report


def merged_cost(logical: PlanResourceReport | None,
                distributed: dict | None) -> dict | None:
    """The broker's ``predicted_cost``: the logical plan's envelope
    (scan work happens once across the shard set — each agent scans its
    SLICE, the union of which the logical bound covers, so no per-agent
    scaling here; ``distributed_bounds`` already scaled the wire bound
    by the agent count) with the distributed wire bound folded in."""
    if logical is None:
        return None
    cost = logical.cost()
    if distributed:
        # Unconditional: the logical plan's wire bound is a known 0 (no
        # BridgeSinkOps), but a distributed query ships bridge bytes —
        # an unknown wire bound (sketch-less data fragment) must stay
        # None per PlanResourceReport's contract, never that stale 0.
        cost["wire_bytes_hi"] = distributed.get("wire_bytes_hi")
        # Merge-side staging (bridge payload re-staging on the kelvin)
        # rides the safety factor; per-agent peak is the data fragment's.
        data = distributed.get("data")
        if data is not None and data.peak_node_bytes_hi is not None:
            cost["peak_node_bytes_hi"] = data.peak_node_bytes_hi
    return cost
