"""Plan verifier: static schema/dtype/topology checks on compiled plans.

A copy of the JAX package's ``analysis/verifier.py``. Always-on pass
between ``planner/compiler.py`` and ``exec/engine.py`` (and, for
distributed queries, after ``DistributedPlanner.plan``). Walks the
operator DAG in topological order doing exactly the schema
propagation the engine's fragment binder will do at execution time —
but eagerly, over every node, with diagnostics that carry plan-node
provenance instead of a device-side shape error three windows into a
fold.

Checks:

- **Topology**: input arity per operator, references to missing nodes,
  unreachable/cyclic nodes, and outputs nobody consumes (every
  non-sink node must feed something — a dangling fragment output is a
  plan bug, not dead code, because the rule pass already pruned).
- **Column binding**: every ``ColumnRef`` in every Map/Filter/Agg/Join
  expression resolves in the propagated input relation.
- **Dtypes**: every ``FuncCall`` resolves an overload in the UDF
  registry under the implicit-cast lattice (``udf/udf.py``); filter
  predicates are BOOLEAN; host-dict UDF non-dict args are literals
  (the binder's compile-time-constant rule).
- **UDA definitions**: referenced UDAs have init/update/merge/finalize
  callables of the segmented-UDA arity (init(G, device); update(carry,
  gids, mask, *args); merge(a, b); finalize(carry)). The port's init
  takes the device its carry is made on (``udf/udf.py`` UDADef), so it
  expects two arguments where the JAX package's init takes one.
- **Distributed invariants** (``verify_distributed_plan``): every
  bridge sink pairs with exactly one bridge source and a BridgeSpec;
  agg-state bridges feed a finalize AggOp (and only they do); the data
  fragment holds no blocking operators; the dispatch agent set matches
  the merge fragment's expected set (``verify_dispatch_sets``).

Semantic types ride the registry definitions (``semantic_type`` on
ScalarUDFDef/UDADef); relations carry dtypes only, so semantic checking
happens where it is representable: overload resolution + the cast
lattice. The JAX package's ``docs/ANALYSIS.md`` describes the checks.
"""

from __future__ import annotations

import inspect
import threading

from ..exec.plan import (
    AggOp,
    BridgeSinkOp,
    BridgeSourceOp,
    ColumnRef,
    EmptySourceOp,
    FilterOp,
    FuncCall,
    JoinOp,
    LimitOp,
    Literal,
    LookupJoinOp,
    MapOp,
    MemorySourceOp,
    OTelExportSinkOp,
    Plan,
    ResultSinkOp,
    TableSinkOp,
    UDTFSourceOp,
    UnionOp,
)
from ..types.dtypes import DataType
from ..types.relation import Relation
from ..udf.udf import Executor, SignatureError
from .diagnostics import Diagnostic, PlanCheckError, Severity

# Terminal operators: legitimately have no consumer.
_SINK_OPS = (ResultSinkOp, TableSinkOp, OTelExportSinkOp, BridgeSinkOp)

# Expected input arity per operator class (None = any >= 1).
_ARITY = {
    MemorySourceOp: 0,
    UDTFSourceOp: 0,
    EmptySourceOp: 0,
    BridgeSourceOp: 0,
    MapOp: 1,
    FilterOp: 1,
    AggOp: 1,
    LimitOp: 1,
    LookupJoinOp: 1,
    ResultSinkOp: 1,
    TableSinkOp: 1,
    OTelExportSinkOp: 1,
    BridgeSinkOp: 1,
    JoinOp: 2,
    UnionOp: None,
}


class _Ctx:
    """One verification walk: diagnostics + per-node relations."""

    def __init__(self, plan: Plan, schemas, registry, plan_name: str,
                 bridge_relations=None):
        self.plan = plan
        self.schemas = schemas or {}
        self.registry = registry
        self.plan_name = plan_name
        self.bridge_relations = bridge_relations or {}
        self.diags: list[Diagnostic] = []
        self.rels: dict[int, Relation | None] = {}
        self._seen: set = set()
        self._checked_udas: set = set()

    def add(self, code: str, message: str, node=None,
            severity=Severity.ERROR):
        op = None
        if node is not None and node in self.plan.nodes:
            op = type(self.plan.nodes[node].op).__name__
        key = (code, message, node, self.plan_name)
        if key in self._seen:
            return
        self._seen.add(key)
        self.diags.append(Diagnostic(
            code=code, message=message, severity=severity,
            node=node, op=op, plan=self.plan_name,
        ))


def _callable_arity_ok(fn, n_expected: int) -> bool:
    """True when ``fn`` accepts exactly ``n_expected`` positional args
    (or cannot be introspected — builtins/partials get the benefit of
    the doubt; the goal is catching hand-written UDA protocol slips)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return True
    req = opt = 0
    var = False
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            if p.default is p.empty:
                req += 1
            else:
                opt += 1
        elif p.kind == p.VAR_POSITIONAL:
            var = True
    if var:
        return n_expected >= req
    return req <= n_expected <= req + opt


# UDADef -> tuple of protocol-violation messages (() = clean). UDADefs
# are frozen and live as long as their registry; caching here keeps the
# inspect.signature cost out of the per-query verify pass (it dominated
# the walk before: ~70% of verify time).
_UDA_PROTOCOL_CACHE: dict = {}


def _uda_protocol_errors(uda) -> tuple:
    try:
        cached = _UDA_PROTOCOL_CACHE.get(uda)
    except TypeError:
        cached = None  # unhashable exotic def: check uncached
    if cached is not None:
        return cached
    msgs = []
    expect = (
        ("init", uda.init, 2),  # init(num_groups, device)
        ("update", uda.update, 3 + len(uda.arg_types)),
        ("merge", uda.merge, 2),
        ("finalize", uda.finalize, 1),
    )
    for part, fn, n in expect:
        if not callable(fn):
            msgs.append(f"UDA {uda.name!r} {part} is not callable")
        elif not _callable_arity_ok(fn, n):
            msgs.append(
                f"UDA {uda.name!r} {part} must accept {n} positional "
                f"argument(s) ({part} of a segmented UDA over "
                f"{len(uda.arg_types)} arg column(s))"
            )
    out = tuple(msgs)
    try:
        _UDA_PROTOCOL_CACHE[uda] = out
    except TypeError:
        pass
    return out


def _check_uda_def(ctx: _Ctx, uda, node) -> None:
    """Segmented-UDA protocol arity: init(G, device); update(carry,
    gids, mask, *args); merge(a, b); finalize(carry) (udf/udf.py
    UDADef)."""
    key = (uda.name, uda.arg_types)
    if key in ctx._checked_udas:
        return
    ctx._checked_udas.add(key)
    for msg in _uda_protocol_errors(uda):
        ctx.add("uda-arity", msg, node)


def _expr_type(ctx: _Ctx, expr, rel: Relation, node) -> DataType | None:
    """Propagated dtype of ``expr`` against ``rel``; None (after adding
    a diagnostic) when the expression cannot bind. Mirrors
    ``exec/expr.bind_expr``'s type resolution without dictionaries."""
    if isinstance(expr, ColumnRef):
        if not rel.has_column(expr.name):
            ctx.add(
                "unbound-column",
                f"column {expr.name!r} is not in the input relation "
                f"{rel!r}",
                node,
            )
            return None
        return rel.col_type(expr.name)
    if isinstance(expr, Literal):
        return expr.dtype
    if isinstance(expr, FuncCall):
        arg_types = [_expr_type(ctx, a, rel, node) for a in expr.args]
        if any(t is None for t in arg_types):
            return None  # upstream diagnostics already explain it
        try:
            udf = ctx.registry.get_scalar(expr.name, arg_types)
        except SignatureError as e:
            ctx.add(
                "udf-signature",
                f"{e} (in expression {expr!r})",
                node,
            )
            return None
        if udf.executor == Executor.HOST_DICT:
            for i, a in enumerate(expr.args):
                if i != udf.dict_arg and not isinstance(a, Literal):
                    ctx.add(
                        "udf-signature",
                        f"{udf.name}: argument {i} must be a literal "
                        "(host-dict UDFs take compile-time-constant "
                        f"args; in expression {expr!r})",
                        node,
                    )
                    return None
        return udf.return_type
    ctx.add("bad-expression", f"cannot type expression {expr!r}", node)
    return None


def _agg_out_relation(ctx: _Ctx, op: AggOp, in_rel: Relation, node):
    """Relation of an AggOp's finalized output, checking group cols,
    agg arg binding, UDA overload resolution and UDA definitions."""
    items = []
    ok = True
    for c in op.group_cols:
        if not in_rel.has_column(c):
            ctx.add(
                "unbound-column",
                f"group column {c!r} is not in the input relation "
                f"{in_rel!r}",
                node,
            )
            ok = False
        else:
            items.append((c, in_rel.col_type(c)))
    for ae in op.aggs:
        arg_types = [_expr_type(ctx, a, in_rel, node) for a in ae.args]
        if any(t is None for t in arg_types):
            ok = False
            continue
        try:
            uda = ctx.registry.get_uda(ae.uda_name, arg_types)
        except SignatureError as e:
            ctx.add(
                "udf-signature",
                f"{e} (aggregate {ae.out_name} = "
                f"{ae.uda_name}({', '.join(map(repr, ae.args))}))",
                node,
            )
            ok = False
            continue
        _check_uda_def(ctx, uda, node)
        items.append((ae.out_name, uda.return_type))
    if not ok:
        return None
    try:
        return Relation(items)
    except ValueError as e:
        ctx.add("duplicate-column", str(e), node)
        return None


def _node_out_relation(ctx: _Ctx, node, in_rels):
    """Output relation of one node given its input relations (None
    entries = unknown upstream, checks involving them are skipped)."""
    op = node.op
    nid = node.id

    if isinstance(op, MemorySourceOp):
        rel = ctx.schemas.get(op.table)
        if rel is None:
            ctx.add(
                "unknown-table",
                f"no table named {op.table!r} in the compile schemas",
                nid,
            )
            return None
        if op.columns is not None:
            missing = [c for c in op.columns if not rel.has_column(c)]
            if missing:
                ctx.add(
                    "unbound-column",
                    f"source columns {missing!r} are not in table "
                    f"{op.table!r} ({rel!r})",
                    nid,
                )
                return None
            return rel.select(op.columns)
        return rel

    if isinstance(op, UDTFSourceOp):
        if ctx.registry is None or not ctx.registry.has_udtf(op.name):
            ctx.add("unknown-udtf", f"no UDTF named {op.name!r}", nid)
            return None
        return Relation(list(ctx.registry.get_udtf(op.name).relation))

    if isinstance(op, EmptySourceOp):
        return Relation(list(op.relation_items))

    if isinstance(op, BridgeSourceOp):
        return ctx.bridge_relations.get(op.bridge_id)

    in_rel = in_rels[0] if in_rels else None

    if isinstance(op, MapOp):
        if in_rel is None:
            return None
        items = []
        ok = True
        for name, e in op.exprs:
            dt = _expr_type(ctx, e, in_rel, nid)
            if dt is None:
                ok = False
            else:
                items.append((name, dt))
        if not ok:
            return None
        try:
            return Relation(items)
        except ValueError as e:
            ctx.add("duplicate-column", str(e), nid)
            return None

    if isinstance(op, FilterOp):
        if in_rel is None:
            return None
        dt = _expr_type(ctx, op.predicate, in_rel, nid)
        if dt is not None and dt != DataType.BOOLEAN:
            ctx.add(
                "dtype-mismatch",
                f"filter predicate {op.predicate!r} has type {dt.name}, "
                "want BOOLEAN",
                nid,
            )
        return in_rel

    if isinstance(op, AggOp):
        if in_rel is None:
            return None
        return _agg_out_relation(ctx, op, in_rel, nid)

    if isinstance(op, JoinOp):
        left, right = (in_rels + [None, None])[:2]
        if len(op.left_on) != len(op.right_on) or not op.left_on:
            ctx.add(
                "join-keys",
                f"join key lists differ in length or are empty "
                f"(left_on={op.left_on!r}, right_on={op.right_on!r})",
                nid,
            )
            return None
        for side, rel, cols in (("left", left, op.left_on),
                                ("right", right, op.right_on)):
            if rel is None:
                continue
            for c in cols:
                if not rel.has_column(c):
                    ctx.add(
                        "unbound-column",
                        f"{side} join key {c!r} is not in the {side} "
                        f"input relation {rel!r}",
                        nid,
                    )
        if left is None or right is None:
            return None
        # Mirror exec/joins._join_out_schema: all left columns, then
        # right value columns with collision suffixing.
        return left.merge(
            right.select(
                [c for c in right.column_names if c not in op.right_on]
            ),
            suffix=op.suffix,
        )

    if isinstance(op, UnionOp):
        known = [r for r in in_rels if r is not None]
        if not known:
            return None
        first = known[0]
        for r in known[1:]:
            if tuple(r.column_names) != tuple(first.column_names):
                ctx.add(
                    "union-schema",
                    f"union inputs must share a schema "
                    f"({first!r} vs {r!r})",
                    nid,
                )
                return None
            for c in first.column_names:
                if r.col_type(c) != first.col_type(c):
                    ctx.add(
                        "union-schema",
                        f"union input dtypes differ on {c!r} "
                        f"({first.col_type(c).name} vs "
                        f"{r.col_type(c).name})",
                        nid,
                        severity=Severity.WARNING,
                    )
        return first

    if isinstance(op, LookupJoinOp):
        # Engine-internal (never planner-emitted); keep the schema walk
        # alive if one ever shows up in a verified plan.
        if in_rel is None:
            return None
        return Relation(
            list(in_rel.items()) + [(n, dt) for n, dt, _p in op.out_cols]
        )

    if isinstance(op, LimitOp):
        if op.n < 0:
            ctx.add("bad-limit", f"negative limit {op.n}", nid)
        return in_rel

    if isinstance(op, _SINK_OPS):
        return in_rel

    ctx.add(
        "unknown-operator",
        f"unsupported operator {type(op).__name__}",
        nid,
        severity=Severity.WARNING,
    )
    return None


def _topo(plan: Plan) -> list:
    """plan.topo_order(), but tolerant of inputs referencing missing
    nodes (the verifier must diagnose malformed plans, not crash)."""
    seen: set = set()
    out: list = []

    def visit(nid):
        if nid in seen or nid not in plan.nodes:
            return
        seen.add(nid)
        for i in plan.nodes[nid].inputs:
            visit(i)
        out.append(nid)

    for s in plan.sinks():
        visit(s)
    return out


def _walk(ctx: _Ctx, require_consumers: bool = True) -> None:
    plan = ctx.plan
    consumers: dict[int, int] = {}
    for n in plan.nodes.values():
        for i in n.inputs:
            consumers[i] = consumers.get(i, 0) + 1
            if i not in plan.nodes:
                ctx.add(
                    "dangling-input",
                    f"input node {i} does not exist in the plan",
                    n.id,
                )

    order = _topo(plan)
    placed = set(order)
    for nid in plan.nodes:
        if nid not in placed:
            ctx.add(
                "unreachable-node",
                "node is unreachable from every sink (cycle or "
                "orphaned subgraph)",
                nid,
            )

    done: set = set()
    for nid in order:
        node = plan.nodes[nid]
        for i in node.inputs:
            if i in plan.nodes and i not in done:
                ctx.add(
                    "plan-cycle",
                    f"node depends on {i} which does not precede it "
                    "(cycle in the operator DAG)",
                    nid,
                )
        done.add(nid)

        want = _ARITY.get(type(node.op), None)
        n_in = len([i for i in node.inputs if i in plan.nodes])
        if want is None:
            if isinstance(node.op, UnionOp) and n_in < 1:
                ctx.add("bad-arity", "union has no inputs", nid)
        elif n_in != want:
            ctx.add(
                "bad-arity",
                f"{type(node.op).__name__} takes {want} input(s), "
                f"has {n_in}",
                nid,
            )
            ctx.rels[nid] = None
            continue

        in_rels = [ctx.rels.get(i) for i in node.inputs if i in plan.nodes]
        ctx.rels[nid] = _node_out_relation(ctx, node, in_rels)

        if (
            require_consumers
            and not consumers.get(nid)
            and not isinstance(node.op, _SINK_OPS)
        ):
            ctx.add(
                "dangling-output",
                f"{type(node.op).__name__} output has no consumer "
                "(fragment output feeds no sink)",
                nid,
            )


def verify_plan(plan: Plan, schemas, registry, *, plan_name: str = "logical",
                bridge_relations=None,
                require_consumers: bool = True) -> list[Diagnostic]:
    """Verify one operator DAG; returns diagnostics (empty = clean).

    ``schemas`` maps table name -> Relation (the CompilerState view);
    ``bridge_relations`` maps bridge id -> payload Relation for plans
    that start from BridgeSourceOps (merge fragments).
    """
    ctx = _Ctx(plan, schemas, registry, plan_name, bridge_relations)
    if plan.nodes:
        _walk(ctx, require_consumers=require_consumers)
    return ctx.diags


def check_plan(plan: Plan, schemas, registry, **kw) -> None:
    """``verify_plan`` raising ``PlanCheckError`` on any error finding."""
    diags = verify_plan(plan, schemas, registry, **kw)
    errors = [d for d in diags if d.severity == Severity.ERROR]
    if errors:
        raise PlanCheckError(errors)


# Clean-verification memo, keyed on (script, schemas, registry): the
# compiler is deterministic at the TYPE level — two compiles of one
# script against one schema set and registry produce plans that differ
# at most in folded literal VALUES (now_ns time arithmetic), never in
# column names, dtypes, or topology, so their verification outcome is
# identical. Only CLEAN results cache (a failing script re-verifies to
# rebuild its diagnostics); repeat compiles of one script — bench's
# warm/timed/AB rounds, dashboard refresh traffic — skip the walk,
# keeping the always-on pass inside the <5%-of-compile-span budget.
_VERIFY_CACHE: dict = {}
_VERIFY_CACHE_MAX = 256
_VERIFY_CACHE_LOCK = threading.Lock()


def check_script_plan(plan: Plan, script: str, schemas, registry,
                      plan_params: tuple = ()) -> None:
    """``check_plan`` memoized by (script, schemas, registry,
    plan_params). ``plan_params`` must carry every compile input that
    changes plan VALUES the verifier checks (max_output_rows shapes the
    injected LimitOp.n the bad-limit check reads) — type-level inputs
    are covered by script+schemas+registry."""
    try:
        key = (
            script,
            # items_tuple(): cached on the immutable Relation (see
            # apply_plan_bounds' key — same memo-hit cost argument).
            tuple(sorted(
                (t, r.items_tuple()) for t, r in schemas.items()
            )),
            id(registry),
            plan_params,
        )
        hash(key)
    except TypeError:
        check_plan(plan, schemas, registry)
        return
    # Locked: brokers/agents compile on their dispatcher threads, and
    # an unguarded evict-while-insert can raise "dict changed size".
    with _VERIFY_CACHE_LOCK:
        if key in _VERIFY_CACHE:
            return
    check_plan(plan, schemas, registry)
    with _VERIFY_CACHE_LOCK:
        if len(_VERIFY_CACHE) >= _VERIFY_CACHE_MAX:
            _VERIFY_CACHE.pop(next(iter(_VERIFY_CACHE)))
        # Pin the registry: a freed registry's id could be recycled by
        # a different one with different signatures.
        _VERIFY_CACHE[key] = registry


# -- distributed plans --------------------------------------------------------

def verify_distributed_plan(dplan, schemas=None,
                            registry=None) -> list[Diagnostic]:
    """Invariants of a split/assigned DistributedPlan.

    Structural checks always run; when ``schemas`` + ``registry`` are
    given the data and merge fragments also get the full schema walk,
    with each bridge's payload relation propagated from the data side
    so merge-side expressions bind against real schemas.
    """
    from ..planner.distributed.splitter import AGG_STATE_MERGE, ROW_GATHER

    split = dplan.split
    before, after = split.before_blocking, split.after_blocking
    diags: list[Diagnostic] = []

    def add(code, message, node=None, plan_name=""):
        diags.append(Diagnostic(
            code=code, message=message, node=node,
            op=(
                type(
                    (before if plan_name == "data" else after)
                    .nodes[node].op
                ).__name__
                if node is not None else None
            ),
            plan=plan_name,
        ))

    spec_ids = [b.bridge_id for b in split.bridges]
    if len(set(spec_ids)) != len(spec_ids):
        add("dangling-bridge", f"duplicate bridge specs: {spec_ids!r}")
    sinks_by_bridge: dict[int, int] = {}
    for nid, n in before.nodes.items():
        if isinstance(n.op, BridgeSinkOp):
            if n.op.bridge_id in sinks_by_bridge:
                add(
                    "dangling-bridge",
                    f"bridge {n.op.bridge_id} has two sinks",
                    nid, "data",
                )
            sinks_by_bridge[n.op.bridge_id] = nid
    sources_by_bridge: dict[int, int] = {}
    for nid, n in after.nodes.items():
        if isinstance(n.op, BridgeSourceOp):
            if n.op.bridge_id in sources_by_bridge:
                add(
                    "dangling-bridge",
                    f"bridge {n.op.bridge_id} has two sources",
                    nid, "merge",
                )
            sources_by_bridge[n.op.bridge_id] = nid

    for bid in set(spec_ids) | set(sinks_by_bridge) | set(sources_by_bridge):
        missing = []
        if bid not in spec_ids:
            missing.append("spec")
        if bid not in sinks_by_bridge:
            missing.append("GRPC-sink analog (BridgeSinkOp)")
        if bid not in sources_by_bridge:
            missing.append("GRPC-source analog (BridgeSourceOp)")
        if missing:
            add(
                "dangling-bridge",
                f"bridge {bid} is missing its {' + '.join(missing)}",
                sinks_by_bridge.get(bid, sources_by_bridge.get(bid)),
                "data" if bid in sinks_by_bridge else "merge",
            )

    # The data fragment runs shard-local: no blocking operators (full/
    # finalize aggs, joins, unions, result sinks — splitter.h:75).
    # Exception (pushdown_union_agg): a UnionOp whose sole consumer
    # chain through row-wise ops ends at a PARTIAL AggOp — it unions
    # shard-LOCAL rows only, and the partial agg's carry merge makes
    # the per-agent interleaving unobservable downstream.
    before_consumers: dict[int, list] = {}
    for n in before.nodes.values():
        for i in n.inputs:
            before_consumers.setdefault(i, []).append(n.id)

    def _feeds_partial_agg(union_nid: int) -> bool:
        cur = union_nid
        while True:
            outs = before_consumers.get(cur, [])
            if len(outs) != 1:
                return False
            nxt = before.nodes[outs[0]].op
            if isinstance(nxt, AggOp):
                return nxt.mode == "partial"
            if not isinstance(nxt, (MapOp, FilterOp)):
                return False
            cur = outs[0]

    for nid, n in before.nodes.items():
        op = n.op
        blocking = (
            isinstance(op, (JoinOp, ResultSinkOp))
            or (isinstance(op, UnionOp) and not _feeds_partial_agg(nid))
            or (isinstance(op, AggOp) and op.mode != "partial")
        )
        if blocking:
            add(
                "fragment-invariant",
                f"blocking operator {type(op).__name__}"
                f"{' (mode=' + op.mode + ')' if isinstance(op, AggOp) else ''}"
                " in the shard-local data fragment",
                nid, "data",
            )
    # Every data-fragment output must reach a bridge (dangling outputs
    # would compute rows nobody ships).
    for nid in before.sinks():
        if not isinstance(before.nodes[nid].op, _SINK_OPS):
            add(
                "dangling-output",
                f"{type(before.nodes[nid].op).__name__} output has no "
                "consumer in the data fragment",
                nid, "data",
            )
    for nid in after.sinks():
        if not isinstance(after.nodes[nid].op, _SINK_OPS):
            add(
                "dangling-output",
                f"{type(after.nodes[nid].op).__name__} output has no "
                "consumer in the merge fragment",
                nid, "merge",
            )

    # Agg bridges must feed a finalize AggOp (the engine's
    # merge_agg_bridge contract) and finalize aggs must be fed by one.
    after_consumers: dict[int, list] = {}
    for n in after.nodes.values():
        for i in n.inputs:
            after_consumers.setdefault(i, []).append(n.id)
    kinds = {b.bridge_id: b.kind for b in split.bridges}
    for bid, src_nid in sources_by_bridge.items():
        kind = kinds.get(bid)
        feeds = [
            after.nodes[c] for c in after_consumers.get(src_nid, [])
        ]
        feeds_finalize = any(
            isinstance(c.op, AggOp) and c.op.mode == "finalize"
            for c in feeds
        )
        if kind == AGG_STATE_MERGE and not feeds_finalize:
            add(
                "bridge-kind",
                f"agg-state bridge {bid} must feed its finalize AggOp "
                "(merge would receive carries with no merge/finalize "
                "step)",
                src_nid, "merge",
            )
        if kind == ROW_GATHER and feeds_finalize:
            add(
                "bridge-kind",
                f"row-gather bridge {bid} feeds a finalize AggOp, "
                "which expects mergeable agg carries, not rows",
                src_nid, "merge",
            )

    if schemas is not None and registry is not None:
        ctx = _Ctx(before, schemas, registry, "data")
        if before.nodes:
            _walk(ctx)
        bridge_rels: dict[int, Relation | None] = {}
        for bid, sink_nid in sinks_by_bridge.items():
            producer = before.nodes[sink_nid].inputs
            producer = producer[0] if producer else None
            if producer is None or producer not in before.nodes:
                continue
            pnode = before.nodes[producer]
            if (
                kinds.get(bid) == AGG_STATE_MERGE
                and isinstance(pnode.op, AggOp)
                and pnode.inputs
            ):
                # Carry payload: the finalize half re-binds group cols
                # and agg args against the PRE-agg relation.
                bridge_rels[bid] = ctx.rels.get(pnode.inputs[0])
            else:
                bridge_rels[bid] = ctx.rels.get(producer)
        diags += ctx.diags
        diags += verify_plan(
            after, schemas, registry, plan_name="merge",
            bridge_relations=bridge_rels,
        )
    return diags


def check_distributed_plan(dplan, schemas=None, registry=None) -> None:
    errors = [
        d for d in verify_distributed_plan(dplan, schemas, registry)
        if d.severity == Severity.ERROR
    ]
    if errors:
        raise PlanCheckError(errors)


def verify_dispatch_sets(dplan, merge_expected, dispatched,
                         merge_agent=None) -> list[Diagnostic]:
    """The broker's dispatch set vs the merge fragment's expected set.

    ``merge_expected`` is the agent list shipped in the merge dispatch
    (what the merge waits for); ``dispatched`` the agents actually sent
    an execute fragment. Any asymmetry means either a merge that waits
    forever for an agent that was never dispatched, or an agent whose
    bridge payload the merge will drop on the floor.
    """
    diags: list[Diagnostic] = []
    exp, got = set(merge_expected), set(dispatched)
    plan_set = set(dplan.data_agent_ids)
    if exp != got:
        diags.append(Diagnostic(
            code="dispatch-set-mismatch",
            message=(
                "merge expected-agent set != dispatched set: "
                f"merge waits for {sorted(exp - got)!r} never "
                f"dispatched; dispatched {sorted(got - exp)!r} the "
                "merge will ignore"
            ),
            plan="distributed",
        ))
    if got != plan_set:
        diags.append(Diagnostic(
            code="dispatch-set-mismatch",
            message=(
                f"dispatched set {sorted(got)!r} != planned data-agent "
                f"set {sorted(plan_set)!r}"
            ),
            plan="distributed",
        ))
    if merge_agent is not None and dplan.kelvin_agent_ids and \
            merge_agent not in dplan.kelvin_agent_ids:
        diags.append(Diagnostic(
            code="dispatch-set-mismatch",
            message=(
                f"merge agent {merge_agent!r} is not one of the "
                f"planned kelvins {list(dplan.kelvin_agent_ids)!r}"
            ),
            plan="distributed",
        ))
    return diags
