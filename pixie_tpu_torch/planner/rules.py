"""Plan rewrite rules (analyzer/optimizer batches).

Reference parity: ``src/carnot/planner/compiler/analyzer/`` +
``optimizer/`` rule passes run by RuleExecutor
(``planner/rules/rule_executor.h:120``). The rules here operate on the
exec-layer Plan DAG:

- ``fuse_quantile_plucks``: pluck_float64(quantiles(x), 'p99') inside the
  aggregating fragment becomes a direct ``_quantile_p99`` UDA output, so
  the hot path never materializes JSON sketch strings (TPU-specific; the
  reference evaluates pluck per row).
- ``prune_unused_columns``: projection pushdown to sources + dropping
  dead Map/Agg outputs (reference ``prune_unused_columns_rule``).
- ``add_limit_to_result_sinks``: cap result streams (reference
  ``add_limit_to_batch_result_sink_rule``, 10k default).
- ``prune_unreachable``: drop operators not feeding any result sink
  (reference ``prune_unconnected_operators_rule``).
"""

from __future__ import annotations

from ..types.dtypes import DataType
from ..exec.plan import (
    AggExpr,
    AggOp,
    ColumnRef,
    FilterOp,
    FuncCall,
    JoinOp,
    LimitOp,
    Literal,
    MapOp,
    MemorySourceOp,
    Plan,
    ResultSinkOp,
    UnionOp,
)
from ..udf.builtins.math_sketches import QUANTILE_FIELDS

_PLUCK_FUNCS = frozenset({"pluck", "pluck_float64", "pluck_int64"})
ALL = None  # "requires every column" marker


def run_rules(plan: Plan, max_output_rows: int = 10_000,
              table_stats: dict | None = None) -> Plan:
    prune_unreachable(plan)
    fold_constants(plan)
    prune_noop_filters(plan)
    fuse_quantile_plucks(plan)
    push_filters_below_maps(plan)
    merge_consecutive_filters(plan)
    push_limit_below_maps(plan)
    fuse_consecutive_maps(plan)
    drop_noop_maps(plan)
    merge_nodes(plan)
    push_agg_through_join(plan, table_stats)
    prune_unused_columns(plan)
    add_limit_to_result_sinks(plan, max_output_rows)
    return plan


def _consumers(plan: Plan) -> dict:
    out: dict[int, list] = {nid: [] for nid in plan.nodes}
    for n in plan.nodes.values():
        for i in n.inputs:
            out[i].append(n.id)
    return out


def _expr_columns(expr, acc: set):
    if isinstance(expr, ColumnRef):
        acc.add(expr.name)
    elif isinstance(expr, FuncCall):
        for a in expr.args:
            _expr_columns(a, acc)
    return acc


def _rewrite_expr(expr, fn):
    """Bottom-up expression rewrite; ``fn`` maps a node to a replacement
    (or returns it unchanged)."""
    if isinstance(expr, FuncCall):
        expr = FuncCall(expr.name, tuple(_rewrite_expr(a, fn) for a in expr.args))
    return fn(expr)


# -- quantile pluck fusion ----------------------------------------------------
def fuse_quantile_plucks(plan: Plan) -> None:
    consumers = _consumers(plan)

    def find_quantile_agg(start_nid: int, col: str):
        """Walk up a single-consumer chain to the AggOp producing ``col``
        via the 'quantiles' UDA. Returns (agg_nid, path_map_nids,
        agg_out_name) or None."""
        nid = start_nid
        path_maps = []
        while True:
            if len(consumers.get(nid, [])) > 1:
                return None  # materialization boundary: host pluck works
            node = plan.nodes[nid]
            op = node.op
            if isinstance(op, AggOp):
                for ae in op.aggs:
                    if ae.out_name == col:
                        if ae.uda_name == "quantiles":
                            return nid, path_maps, col
                        return None
                return None
            if isinstance(op, (FilterOp, LimitOp)):
                nid = node.inputs[0]
            elif isinstance(op, MapOp):
                src = next((e for n, e in op.exprs if n == col), None)
                if not isinstance(src, ColumnRef):
                    return None
                col = src.name
                path_maps.append(nid)
                nid = node.inputs[0]
            else:
                return None

    for nid in list(plan.topo_order()):
        node = plan.nodes[nid]
        op = node.op
        if not isinstance(op, (MapOp, FilterOp)):
            continue

        def rewrite(e, _node=node):
            if not (
                isinstance(e, FuncCall)
                and e.name in _PLUCK_FUNCS
                and len(e.args) == 2
                and isinstance(e.args[0], ColumnRef)
                and isinstance(e.args[1], Literal)
                and e.args[1].value in QUANTILE_FIELDS
            ):
                return e
            if not _node.inputs:
                return e
            found = find_quantile_agg(_node.inputs[0], e.args[0].name)
            if found is None:
                return e
            agg_nid, path_maps, agg_out = found
            agg_node = plan.nodes[agg_nid]
            field = e.args[1].value
            src_ae = next(
                ae for ae in agg_node.op.aggs if ae.out_name == agg_out
            )
            new_name = f"_q_{field}_{src_ae.out_name}"
            if all(ae.out_name != new_name for ae in agg_node.op.aggs):
                agg_node.op = AggOp(
                    group_cols=agg_node.op.group_cols,
                    aggs=agg_node.op.aggs
                    + (AggExpr(new_name, f"_quantile_{field}", src_ae.args),),
                    max_groups=agg_node.op.max_groups,
                )
            # Thread the new column through intermediate full projections.
            for mid in path_maps:
                mop = plan.nodes[mid].op
                if all(n != new_name for n, _ in mop.exprs):
                    plan.nodes[mid].op = MapOp(
                        exprs=mop.exprs + ((new_name, ColumnRef(new_name)),)
                    )
            return ColumnRef(new_name)

        if isinstance(op, MapOp):
            node.op = MapOp(
                exprs=tuple((n, _rewrite_expr(e, rewrite)) for n, e in op.exprs)
            )
        else:
            node.op = FilterOp(predicate=_rewrite_expr(op.predicate, rewrite))


# -- column pruning -----------------------------------------------------------
def prune_unused_columns(plan: Plan) -> None:
    """Two phases: propagate per-node column requirements from the sinks,
    then rewrite Map/Agg/Source ops to drop dead columns."""
    order = plan.topo_order()
    required: dict[int, object] = {nid: set() for nid in plan.nodes}

    def require(nid, cols):
        if cols is ALL or required[nid] is ALL:
            required[nid] = ALL
        else:
            required[nid] = required[nid] | cols

    for nid in reversed(order):
        node = plan.nodes[nid]
        op = node.op
        req = required[nid]
        if isinstance(op, ResultSinkOp):
            require(node.inputs[0], ALL)
        elif isinstance(op, (LimitOp, UnionOp)):
            for i in node.inputs:
                require(i, req)
        elif isinstance(op, FilterOp):
            pred_cols = _expr_columns(op.predicate, set())
            require(node.inputs[0], ALL if req is ALL else req | pred_cols)
        elif isinstance(op, MapOp):
            kept = _kept_map_exprs(op, req)
            needed = set()
            for _n, e in kept:
                _expr_columns(e, needed)
            require(node.inputs[0], needed)
        elif isinstance(op, AggOp):
            needed = set(op.group_cols)
            for ae in op.aggs:
                if req is ALL or ae.out_name in req:
                    for a in ae.args:
                        _expr_columns(a, needed)
            require(node.inputs[0], needed)
        elif isinstance(op, JoinOp):
            l_rel = plan.nodes[node.inputs[0]].relation
            r_rel = plan.nodes[node.inputs[1]].relation
            if req is ALL or l_rel is None or r_rel is None:
                require(node.inputs[0], ALL)
                require(node.inputs[1], ALL)
            else:
                l_req, r_req = set(op.left_on), set(op.right_on)
                taken = set(l_rel.column_names)
                for c in l_rel.column_names:
                    if c in req:
                        l_req.add(c)
                for c in r_rel.column_names:
                    if c in op.right_on:
                        continue
                    out_n = c
                    while out_n in taken:
                        out_n += op.suffix
                    taken.add(out_n)
                    if out_n in req:
                        r_req.add(c)
                require(node.inputs[0], l_req)
                require(node.inputs[1], r_req)
        elif isinstance(op, MemorySourceOp):
            pass
        else:
            for i in node.inputs:
                require(i, ALL)

    # Phase 2: rewrite.
    for nid in order:
        node = plan.nodes[nid]
        op = node.op
        req = required[nid]
        if req is ALL:
            continue
        if isinstance(op, MapOp):
            kept = _kept_map_exprs(op, req)
            if len(kept) != len(op.exprs):
                node.op = MapOp(exprs=kept)
        elif isinstance(op, AggOp):
            kept = tuple(ae for ae in op.aggs if ae.out_name in req)
            if len(kept) != len(op.aggs):
                node.op = AggOp(
                    group_cols=op.group_cols, aggs=kept,
                    max_groups=op.max_groups,
                )
        elif isinstance(op, MemorySourceOp):
            if node.relation is not None:
                cols = tuple(
                    c for c in node.relation.column_names if c in req
                )
                if len(cols) != len(node.relation.column_names):
                    node.op = MemorySourceOp(
                        table=op.table, columns=cols,
                        start_time=op.start_time, stop_time=op.stop_time,
                    )


def _kept_map_exprs(op: MapOp, req):
    """Map exprs surviving pruning (shared by both phases so requirement
    propagation matches the rewrite): at least one expr is kept to
    preserve row cardinality."""
    if req is ALL:
        return op.exprs
    kept = tuple((n, e) for n, e in op.exprs if n in req)
    if not kept and op.exprs:
        kept = op.exprs[:1]
    return kept


# -- limits -------------------------------------------------------------------
def add_limit_to_result_sinks(plan: Plan, max_rows: int) -> None:
    for nid in list(plan.nodes):
        node = plan.nodes[nid]
        if not isinstance(node.op, ResultSinkOp):
            continue
        src = node.inputs[0]
        src_op = plan.nodes[src].op
        if isinstance(src_op, LimitOp) and src_op.n <= max_rows:
            continue
        lim = plan.add(LimitOp(max_rows), [src])
        plan.nodes[lim].relation = plan.nodes[src].relation
        node.inputs[0] = lim


# -- reachability -------------------------------------------------------------
# op -> (fn, allowed arg dtypes): folding must not change type/error
# behavior — arithmetic on BOOLEAN literals or logicalAnd on INT64 would
# fold to values the unfolded expression's UDF bind would have rejected.
_FOLDABLE = {
    "add": (lambda a, b: a + b, "num"),
    "subtract": (lambda a, b: a - b, "num"),
    "multiply": (lambda a, b: a * b, "num"),
    "lessThan": (lambda a, b: a < b, "num"),
    "lessThanEqual": (lambda a, b: a <= b, "num"),
    "greaterThan": (lambda a, b: a > b, "num"),
    "greaterThanEqual": (lambda a, b: a >= b, "num"),
    "equal": (lambda a, b: a == b, "any"),
    "notEqual": (lambda a, b: a != b, "any"),
    "logicalAnd": (lambda a, b: bool(a and b), "bool"),
    "logicalOr": (lambda a, b: bool(a or b), "bool"),
}


def fold_constants(plan: Plan) -> None:
    """Evaluate literal-only scalar subtrees at compile time (the
    reference's constant-folding analyzer pass). Only pure arithmetic /
    comparison / boolean ops fold — everything else keeps its runtime
    semantics (e.g. divide's inf-on-zero stays on device)."""
    from ..types.dtypes import DataType

    def fold(e):
        if not (isinstance(e, FuncCall) and e.name in _FOLDABLE):
            return e
        if not all(isinstance(a, Literal) for a in e.args) or len(e.args) != 2:
            return e
        a, b = e.args
        fn, kinds = _FOLDABLE[e.name]
        allowed = {
            "num": (DataType.INT64, DataType.FLOAT64, DataType.TIME64NS),
            "bool": (DataType.BOOLEAN,),
            "any": (
                DataType.INT64, DataType.FLOAT64, DataType.BOOLEAN,
                DataType.TIME64NS,
            ),
        }[kinds]
        if a.dtype != b.dtype or a.dtype not in allowed:
            return e
        try:
            v = fn(a.value, b.value)
        except Exception:
            return e
        if isinstance(v, bool):
            return Literal(v, DataType.BOOLEAN)
        return Literal(v, a.dtype)

    for node in plan.nodes.values():
        op = node.op
        if isinstance(op, MapOp):
            node.op = MapOp(
                exprs=tuple((n, _rewrite_expr(e, fold)) for n, e in op.exprs)
            )
        elif isinstance(op, FilterOp):
            node.op = FilterOp(predicate=_rewrite_expr(op.predicate, fold))


def push_filters_below_maps(plan: Plan) -> None:
    """Swap Filter(Map(x)) -> Map(Filter'(x)) when every column the
    predicate references is a pure pass-through of the map (the
    reference's filter-pushdown pass). Within one fused fragment the win
    is evaluation-order freedom for XLA; across a materialization
    boundary it prunes rows before the map computes."""
    consumers = _consumers(plan)
    for nid in list(plan.topo_order()):
        node = plan.nodes[nid]
        if not isinstance(node.op, FilterOp) or not node.inputs:
            continue
        up_id = node.inputs[0]
        up = plan.nodes[up_id]
        if not isinstance(up.op, MapOp) or len(consumers.get(up_id, [])) != 1:
            continue
        # Predicate columns must map 1:1 onto upstream columns.
        pred_cols = _expr_columns(node.op.predicate, set())
        renames = {
            n: e.name
            for n, e in up.op.exprs
            if isinstance(e, ColumnRef)
        }
        if not pred_cols <= set(renames):
            continue

        def rename(e):
            if isinstance(e, ColumnRef):
                return ColumnRef(renames[e.name])
            return e

        new_pred = _rewrite_expr(node.op.predicate, rename)
        # Rewire in place, keeping ids stable for downstream consumers:
        # nid (what consumers point at) becomes the Map; up_id becomes
        # the renamed Filter over the map's old input.
        x_inputs = list(up.inputs)
        map_op, map_rel = up.op, up.relation
        up.op = FilterOp(predicate=new_pred)
        up.inputs = x_inputs
        up.relation = (
            plan.nodes[x_inputs[0]].relation if x_inputs else None
        )
        node.op = map_op
        node.inputs = [up_id]
        node.relation = map_rel



# -- eager aggregation through joins ------------------------------------------
_PAJ_DECOMPOSABLE = frozenset({"count", "sum", "min", "max"})


def _source_key_ndv(plan: Plan, nid: int, cols, table_stats):
    """Estimated NDV product of ``cols`` at node ``nid`` from ingest
    sketches (walking renames/filters down to a MemorySourceOp), or
    None when the subtree computes the keys or stats are missing."""
    if not table_stats:
        return None
    mapping = {c: c for c in cols}
    while True:
        node = plan.nodes.get(nid)
        if node is None:
            return None
        op = node.op
        if isinstance(op, MemorySourceOp):
            st = table_stats.get(op.table)
            if not st:
                return None
            prod = 1
            for c in mapping.values():
                v = (st.get("ndv") or {}).get(c)
                if v is None:
                    return None
                prod *= max(int(v), 1)
            rows = st.get("rows")
            return min(prod, int(rows)) if rows else prod
        if isinstance(op, (FilterOp, LimitOp)) and node.inputs:
            nid = node.inputs[0]
        elif isinstance(op, MapOp) and node.inputs:
            from ..exec.plan import trace_map_renames

            mapping = trace_map_renames(op, mapping)
            if mapping is None:
                return None
            nid = node.inputs[0]
        else:
            return None


def push_agg_through_join(plan: Plan, table_stats: dict | None = None) -> None:
    """Eager aggregation (Yan & Larson): rewrite GroupBy(Join(L, R)) so
    the build side pre-aggregates below the join.

    When every group key comes from the probe (left) side and every
    aggregate decomposes, the N:M join never materializes: R partial-aggs
    by its join keys (adding a ``__paj_cnt`` multiplicity), the join
    becomes N:1 — which the engine executes as a fused in-fragment device
    lookup — and the top aggregate reweights:

        count(x)        -> sum(__paj_cnt)
        sum(r_col)      -> sum(__paj_s_<col>)
        min/max(r_col)  -> min/max(__paj_m*_<col>)
        min/max(l_col)  -> min/max(l_col)   (fan-out can't change extremes)

    The reference's optimizer has no analog (Carnot always hash-joins,
    ``src/carnot/exec/equijoin_node.cc``); on TPU this turns the worst
    exec-node shape (host hash join) into two dense scatter aggregates.
    Inner joins only: outer variants change null/row semantics.
    """
    consumers = _consumers(plan)
    for nid in list(plan.nodes):
        node = plan.nodes.get(nid)
        if node is None or not isinstance(node.op, AggOp):
            continue
        agg: AggOp = node.op
        if agg.mode != "full" or not node.inputs:
            continue
        if any(ae.out_name.startswith("__paj_") for ae in agg.aggs):
            continue  # already rewritten
        jid = node.inputs[0]
        jnode = plan.nodes.get(jid)
        if jnode is None or not isinstance(jnode.op, JoinOp):
            continue
        join: JoinOp = jnode.op
        if join.how != "inner" or consumers.get(jid, []) != [nid]:
            continue
        if len(jnode.inputs) != 2:
            continue
        left_id, right_id = jnode.inputs
        lrel = plan.nodes[left_id].relation
        rrel = plan.nodes[right_id].relation
        if lrel is None or rrel is None:
            continue
        # Already N:1? A build side grouped by exactly the join keys is
        # unique on them — pre-aggregating again would just stack a
        # pointless blocking agg (and the engine's fused lookup join
        # consumes the grouped state directly).
        rid = right_id
        while isinstance(plan.nodes[rid].op, (MapOp, FilterOp)) and plan.nodes[rid].inputs:
            rid = plan.nodes[rid].inputs[0]
        rop = plan.nodes[rid].op
        if isinstance(rop, AggOp) and set(rop.group_cols) >= set(join.right_on):
            continue
        lcols = set(lrel.column_names)
        # Join-output name -> (side, source column), mirroring the
        # engine's _join_out_schema (left names win; right value columns
        # take the suffix on collision).
        src_of: dict = {c: ("l", c) for c in lrel.column_names}
        for c in rrel.column_names:
            if c in join.right_on:
                continue
            out = c + join.suffix if c in lcols else c
            src_of.setdefault(out, ("r", c))
        if not all(
            c in src_of and src_of[c][0] == "l" for c in agg.group_cols
        ):
            continue

        # Every aggregate must be a decomposable UDA over one column.
        plan_ok = True
        right_needs: dict = {}  # right col -> set of partial kinds
        rewritten: list = []  # (tmp_name, final AggExpr builder data)
        for ae in agg.aggs:
            if (
                ae.uda_name not in _PAJ_DECOMPOSABLE
                or len(ae.args) != 1
                or not isinstance(ae.args[0], ColumnRef)
                or ae.args[0].name not in src_of
            ):
                plan_ok = False
                break
            side, src = src_of[ae.args[0].name]
            if ae.uda_name == "count":
                rewritten.append((ae, "sum", "__paj_cnt"))
            elif side == "r":
                kind = {"sum": "s", "min": "mn", "max": "mx"}[ae.uda_name]
                right_needs.setdefault(src, set()).add(kind)
                rewritten.append((ae, ae.uda_name, f"__paj_{kind}_{src}"))
            elif ae.uda_name in ("min", "max"):
                rewritten.append((ae, ae.uda_name, ae.args[0].name))
            else:
                plan_ok = False  # sum/mean over a left column: needs
                break  # cnt-weighted reweighting (not yet)
        if not plan_ok:
            continue
        # The partial count needs a castable (non-string) column on R.
        cnt_src = next(
            (
                c
                for c in rrel.column_names
                if rrel.col_type(c)
                in (DataType.INT64, DataType.FLOAT64, DataType.TIME64NS,
                    DataType.BOOLEAN)
            ),
            None,
        )
        if cnt_src is None:
            continue

        from ..types.relation import Relation

        partial_aggs = [AggExpr("__paj_cnt", "count", (ColumnRef(cnt_src),))]
        partial_items = [(rc, rrel.col_type(rc)) for rc in join.right_on]
        partial_items.append(("__paj_cnt", DataType.INT64))
        for src, kinds in sorted(right_needs.items()):
            for kind in sorted(kinds):
                uda = {"s": "sum", "mn": "min", "mx": "max"}[kind]
                partial_aggs.append(
                    AggExpr(f"__paj_{kind}_{src}", uda, (ColumnRef(src),))
                )
                partial_items.append(
                    (f"__paj_{kind}_{src}", rrel.col_type(src))
                )
        # Partial-agg group capacity: the join key's sketched NDV (x1.25
        # slack for HLL error, rounded to a power of two) instead of a
        # blind 64K default — a mis-sized capacity climbs the overflow-
        # doubling ladder at run time, one jit recompile per rung.
        # Clamped to the rebucket ceiling: sketch NDV is table-LIFETIME
        # (expiry never decrements), and under-sizing self-corrects at
        # run time while a stale over-size pre-allocates real memory.
        from ..config import get_flag

        groups = max(agg.max_groups, 1 << 16)
        ndv = _source_key_ndv(
            plan, right_id, list(join.right_on), table_stats
        )
        if ndv:
            want = int(ndv * 1.25) + 1
            groups = max(
                agg.max_groups,
                min(1 << (want - 1).bit_length(),
                    int(get_flag("max_groups_limit"))),
            )
        # Telemetry feedback floor: a past run of THIS script observed
        # its largest aggregate's true output cardinality (the partial
        # agg is itself a fragment, so the max covers it). A drifted
        # sketch NDV can under-size the capacity and pay the overflow-
        # doubling ladder at run time — floor at reality instead;
        # over-size is the cheaper error (see join_capacity_safety).
        observed = (table_stats or {}).get("__observed_self__") or {}
        ogroups = int(observed.get("agg_groups", 0) or 0)
        if ogroups:
            owant = int(ogroups * 1.25) + 1
            groups = max(
                groups,
                min(1 << (owant - 1).bit_length(),
                    int(get_flag("max_groups_limit"))),
            )
        partial_id = plan.add(
            AggOp(
                group_cols=tuple(join.right_on),
                aggs=tuple(partial_aggs),
                max_groups=groups,
            ),
            inputs=[right_id],
            relation=Relation(partial_items),
        )

        # The join (id kept) now probes the aggregated build side: N:1.
        jnode.op = JoinOp(
            left_on=join.left_on, right_on=join.right_on, how="inner",
            suffix=join.suffix,
        )
        jnode.inputs = [left_id, partial_id]
        jnode.relation = Relation(
            list(lrel.items())
            + [(n, t) for n, t in partial_items if n not in join.right_on]
        )

        # Final aggregate under a projection that restores the original
        # output names/order (node id kept so consumers stay valid).
        final_aggs = tuple(
            AggExpr(f"__paj_o_{ae.out_name}", uda, (ColumnRef(src),))
            for ae, uda, src in rewritten
        )
        final_items = [(c, lrel.col_type(c)) for c in agg.group_cols] + [
            (f"__paj_o_{ae.out_name}", _paj_out_type(ae, uda, src, lrel, dict(partial_items)))
            for ae, uda, src in rewritten
        ]
        final_id = plan.add(
            AggOp(
                group_cols=agg.group_cols, aggs=final_aggs,
                max_groups=agg.max_groups,
            ),
            inputs=[jid],
            relation=Relation(final_items),
        )
        node.op = MapOp(
            exprs=tuple((c, ColumnRef(c)) for c in agg.group_cols)
            + tuple(
                (ae.out_name, ColumnRef(f"__paj_o_{ae.out_name}"))
                for ae, _uda, _src in rewritten
            )
        )
        node.inputs = [final_id]
        consumers = _consumers(plan)


def _paj_out_type(ae, uda, src, lrel, partial_types):
    if ae.uda_name == "count":
        return DataType.INT64
    if src in partial_types:
        return partial_types[src]
    return lrel.col_type(src)


# -- common-subplan dedup -----------------------------------------------------
def merge_nodes(plan: Plan) -> None:
    """Unify structurally identical subplans so shared work executes
    once (reference ``optimizer/merge_nodes_rule.h``).

    Bottom-up over the topo order: a node whose (op, canonical inputs)
    pair was already seen redirects its consumers to the first
    occurrence. The engine materializes any fan-out node once, so a
    multi-output script whose branches re-state the same filter/map
    prefix computes it one time. Sinks never merge (each display/export
    is its own effect).
    """
    from ..exec.plan import (
        BridgeSinkOp,
        BridgeSourceOp,
        OTelExportSinkOp,
        TableSinkOp,
        UDTFSourceOp,
    )

    never = (
        ResultSinkOp, TableSinkOp, OTelExportSinkOp, BridgeSinkOp,
        BridgeSourceOp,
        # UDTFs may be stateful/impure (cluster introspection snapshots).
        UDTFSourceOp,
    )
    canon: dict = {}
    remap: dict = {}
    for nid in plan.topo_order():
        node = plan.nodes[nid]
        node.inputs = [remap.get(i, i) for i in node.inputs]
        if isinstance(node.op, never):
            continue
        try:
            key = (node.op, tuple(node.inputs))
            hash(key)
        except TypeError:
            continue
        if key in canon:
            remap[nid] = canon[key]
        else:
            canon[key] = nid
    for nid in remap:
        del plan.nodes[nid]


# -- plan-level simplifications ----------------------------------------------
def prune_noop_filters(plan: Plan) -> None:
    """Drop FilterOps whose predicate folded to literal True."""
    for nid in list(plan.nodes):
        node = plan.nodes.get(nid)
        if node is None or not isinstance(node.op, FilterOp):
            continue
        p = node.op.predicate
        if isinstance(p, Literal) and p.value is True and node.inputs:
            src = node.inputs[0]
            for m in plan.nodes.values():
                m.inputs = [src if i == nid else i for i in m.inputs]
            del plan.nodes[nid]


def merge_consecutive_filters(plan: Plan) -> None:
    """Filter(Filter(x)) -> one Filter over ``logicalAnd(inner, outer)``
    when the inner filter has a single consumer (reference
    ``analyzer/combine_consecutive_filters``-style pass). Row masks
    conjoin exactly, and one FilterOp keeps the fused fragment's op
    chain (and fold_constants' view of the predicate) whole."""
    from .pattern import Pat, match, single_consumer

    changed = True
    while changed:
        changed = False
        consumers = _consumers(plan)
        for nid in list(plan.nodes):
            m = match(
                plan, nid,
                Pat(FilterOp, inputs=[Pat(FilterOp, name="inner")]),
            )
            if m is None or not single_consumer(
                plan, m["inner"].id, consumers
            ):
                continue
            node, inner = m[0], m["inner"]
            node.op = FilterOp(
                predicate=FuncCall(
                    "logicalAnd",
                    (inner.op.predicate, node.op.predicate),
                )
            )
            node.inputs = list(inner.inputs)
            del plan.nodes[inner.id]
            consumers = _consumers(plan)
            changed = True


def push_limit_below_maps(plan: Plan) -> None:
    """Limit(Map(x)) -> Map(Limit(x)) when the map has a single consumer
    (reference analyzer limit-pushdown). Maps are row-wise and order-
    preserving, so projecting the first n input rows equals taking the
    first n projected rows — and the limit's early source abort now
    fires before the projection computes."""
    from .pattern import Pat, match, single_consumer

    changed = True
    while changed:
        changed = False
        consumers = _consumers(plan)
        for nid in list(plan.topo_order()):
            m = match(
                plan, nid,
                Pat(LimitOp, inputs=[Pat(MapOp, name="map")]),
            )
            if m is None or not single_consumer(plan, m["map"].id, consumers):
                continue
            node, up = m[0], m["map"]
            # Id-stable swap (consumers keep pointing at nid): nid
            # becomes the Map, the map's node becomes the Limit over x.
            x_inputs = list(up.inputs)
            map_op, map_rel = up.op, up.relation
            up.op = node.op
            up.inputs = x_inputs
            up.relation = (
                plan.nodes[x_inputs[0]].relation if x_inputs else None
            )
            node.op = map_op
            node.inputs = [up.id]
            node.relation = map_rel
            changed = True


def drop_noop_maps(plan: Plan) -> None:
    """Remove MapOps that are identity projections of their input — the
    reference's ``analyzer/drop_noop_rule``-class cleanup. A map is a
    no-op when every output is ``name = col(name)`` and the output
    column set equals the input relation's, so dropping it cannot
    change schema or values."""
    from .pattern import Pat, match

    def identity(node) -> bool:
        if any(
            not isinstance(e, ColumnRef) or e.name != n
            for n, e in node.op.exprs
        ):
            return False
        if not node.inputs:
            return False
        src = plan.nodes[node.inputs[0]].relation
        return src is not None and (
            [n for n, _ in node.op.exprs] == list(src.column_names)
        )

    for nid in list(plan.nodes):
        m = match(plan, nid, Pat(MapOp, where=identity))
        if m is None:
            continue
        src = m[0].inputs[0]
        for n in plan.nodes.values():
            n.inputs = [src if i == nid else i for i in n.inputs]
        del plan.nodes[nid]


def fuse_consecutive_maps(plan: Plan) -> None:
    """Inline Map(Map(x)) into one projection when the inner map has a
    single consumer (reference ``combine_consecutive_maps_rule``): the
    outer expressions substitute the inner's column definitions."""
    consumers = _consumers(plan)
    changed = True
    while changed:
        changed = False
        for nid in list(plan.nodes):
            node = plan.nodes.get(nid)
            if node is None or not isinstance(node.op, MapOp):
                continue
            if not node.inputs:
                continue
            inner = plan.nodes.get(node.inputs[0])
            if (
                inner is None
                or not isinstance(inner.op, MapOp)
                or consumers.get(inner.id, []) != [nid]
            ):
                continue
            defs = dict(inner.op.exprs)
            # Inlining duplicates an inner expression once per outer
            # reference; only pass-through/literal defs may be inlined
            # into multiple sites (the reference rule's copyability
            # guard) — an expensive expr referenced twice must not run
            # twice in the fused fragment.
            # Count reference SITES, not referencing expressions: a
            # single outer expr using an inner column twice (a*a) still
            # inlines the definition twice.
            refs: dict = {}

            def count_sites(e):
                if isinstance(e, ColumnRef):
                    refs[e.name] = refs.get(e.name, 0) + 1
                elif isinstance(e, FuncCall):
                    for a in e.args:
                        count_sites(a)

            for _n, e in node.op.exprs:
                count_sites(e)
            if any(
                refs.get(name, 0) > 1
                and not isinstance(e, (ColumnRef, Literal))
                for name, e in defs.items()
            ):
                continue

            def subst(e):
                if isinstance(e, ColumnRef) and e.name in defs:
                    return defs[e.name]
                return e

            node.op = MapOp(exprs=tuple(
                (n, _rewrite_expr(e, subst)) for n, e in node.op.exprs
            ))
            node.inputs = list(inner.inputs)
            del plan.nodes[inner.id]
            consumers = _consumers(plan)
            changed = True


def prune_unreachable(plan: Plan) -> None:
    from ..exec.plan import OTelExportSinkOp, TableSinkOp

    sink_ids = [
        nid
        for nid, n in plan.nodes.items()
        if isinstance(n.op, (ResultSinkOp, OTelExportSinkOp, TableSinkOp))
    ]
    if not sink_ids:
        return
    seen: set = set()

    def visit(nid):
        if nid in seen:
            return
        seen.add(nid)
        for i in plan.nodes[nid].inputs:
            visit(i)

    for s in sink_ids:
        visit(s)
    for nid in list(plan.nodes):
        if nid not in seen:
            del plan.nodes[nid]
