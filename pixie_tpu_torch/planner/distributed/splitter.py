"""Splitter: cut a logical plan at blocking operators.

Reference parity: ``planner/distributed/splitter/splitter.h:75`` — the
plan is partitioned into ``before_blocking`` (runs on every data agent,
ends in bridge sinks, contains no blocking nodes) and ``after_blocking``
(runs on the merge tier, fed by bridge sources, holds the blocking nodes
and everything downstream). The partial-op manager
(``splitter/partial_op_mgr/partial_op_mgr.h``) splits aggregates into a
prepare (partial, mergeable-carry) half and a merge (finalize) half, and
limits into local + global caps.

Each bridge records the collective that implements it —
``agg_state_merge`` (per-device UDA carries folded over the mesh axis;
the reference's UDA Serialize/DeSerialize path, ``udf.h:99-100``) or
``row_gather`` (all_gather of surviving rows; the reference's plain
GRPCSink row stream). A copy of the JAX package's ``splitter.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ...exec.plan import (
    AggOp,
    BridgeSinkOp,
    BridgeSourceOp,
    EmptySourceOp,
    JoinOp,
    LimitOp,
    MemorySourceOp,
    Op,
    Plan,
    ResultSinkOp,
    UDTFSourceOp,
    UnionOp,
)

AGG_STATE_MERGE = "agg_state_merge"
ROW_GATHER = "row_gather"


@dataclass
class BridgeSpec:
    """One PEM->Kelvin bridge (GRPCSink/Source pair analog)."""

    bridge_id: int
    kind: str  # AGG_STATE_MERGE | ROW_GATHER
    # Filled by the stitcher (distributed_stitcher_rules.h analog):
    # mesh axes the implementing collective reduces/gathers over.
    axes: tuple = ()


@dataclass
class BlockingSplitPlan:
    """splitter.h BlockingSplitPlan analog."""

    before_blocking: Plan
    after_blocking: Plan
    bridges: list = field(default_factory=list)  # list[BridgeSpec]
    # Which agents run the data fragment: "pem" (data agents only) or
    # "all_agents" (Kelvins too — an ALL_AGENTS UDTF is present). The
    # splitter decides once; the coordinator only reads it.
    data_tier: str = "pem"

    def bridge(self, bridge_id: int) -> BridgeSpec:
        return next(b for b in self.bridges if b.bridge_id == bridge_id)


def _is_blocking(op: Op) -> bool:
    """Blocking = cannot run shard-local without a cross-agent exchange."""
    from ...exec.plan import OTelExportSinkOp

    return isinstance(
        op, (AggOp, JoinOp, UnionOp, LimitOp, ResultSinkOp, OTelExportSinkOp)
    )


def _pushdown_unions(plan: Plan) -> set:
    """UnionOp node ids safe to keep on the PEM side (pushdown_union_agg).

    A union is blocking in general — its output interleaves rows from
    every agent. But when (1) every transitive input is shard-local and
    row-wise (MemorySource/EmptySource leaves through Map/Filter only)
    and (2) its sole consumer chain through row-wise ops ends at a full
    AggOp, the union can run per-agent: the downstream agg then splits
    into a partial half on the PEM side and its AGG_STATE_MERGE bridge
    ships sketch-sized mergeable carries (HLL registers, t-digest
    centroids) instead of the union's pre-agg rows over one ROW_GATHER
    bridge per branch. Order-insensitivity of the agg's update/merge is
    what makes the per-agent interleaving unobservable.
    """
    from ...config import get_flag

    if not get_flag("pushdown_union_agg"):
        return set()
    consumers: dict[int, list[int]] = {}
    for nid, node in plan.nodes.items():
        for i in node.inputs:
            consumers.setdefault(i, []).append(nid)
    safe: set = set()
    for nid, node in plan.nodes.items():
        if not isinstance(node.op, UnionOp):
            continue
        # (1) every transitive input is PEM-resident and non-blocking.
        stack, ok = list(node.inputs), True
        while stack and ok:
            i = stack.pop()
            iop = plan.nodes[i].op
            if isinstance(iop, (MemorySourceOp, EmptySourceOp)):
                continue
            if _is_blocking(iop) or isinstance(iop, UDTFSourceOp):
                ok = False
            else:  # Map/Filter: row-wise, keep walking up
                stack.extend(plan.nodes[i].inputs)
        if not ok:
            continue
        # (2) sole consumer chain through row-wise ops ends at a full agg.
        cur = nid
        while ok:
            outs = consumers.get(cur, [])
            if len(outs) != 1:
                ok = False
                break
            cop = plan.nodes[outs[0]].op
            if isinstance(cop, AggOp):
                break  # the splitter walk will make this a partial agg
            if _is_blocking(cop) or isinstance(cop, UDTFSourceOp):
                ok = False
                break
            cur = outs[0]
        if ok:
            safe.add(nid)
    return safe


class Splitter:
    """Splits one logical plan; ``registry`` resolves UDTF executor
    classes (udtf.h UDTFSourceExecutor -> which tier runs the source)."""

    def __init__(self, registry=None):
        self.registry = registry

    def _udtf_executor(self, op: UDTFSourceOp):
        from ...udf.udtf import UDTFExecutor

        if self.registry is None or not self.registry.has_udtf(op.name):
            return UDTFExecutor.ONE_KELVIN  # default: one merge instance
        return self.registry.get_udtf(op.name).executor

    def split(self, plan: Plan) -> BlockingSplitPlan:
        before, after = Plan(), Plan()
        bridges: list[BridgeSpec] = []
        data_tier = "pem"
        pushdown = _pushdown_unions(plan)
        # logical node id -> ('pem', new_id) | ('kelvin', new_id)
        placed: dict[int, tuple[str, int]] = {}

        def to_kelvin(nid: int) -> int:
            """Id of nid's output within after_blocking, bridging if the
            producer ran on the PEM side."""
            side, new_id = placed[nid]
            if side == "kelvin":
                return new_id
            bid = len(bridges)
            node = plan.nodes[nid]
            before.add(BridgeSinkOp(bid), [new_id])
            src = after.add(BridgeSourceOp(bid))
            if isinstance(node.op, AggOp):
                # Partial-op manager (AggOperatorMgr): the PEM half is a
                # partial agg, the bridge ships mergeable carries, and an
                # explicit finalize agg runs on the merge side.
                bridges.append(BridgeSpec(bid, AGG_STATE_MERGE))
                src = after.add(replace(node.op, mode="finalize"), [src])
            else:
                bridges.append(BridgeSpec(bid, ROW_GATHER))
            placed[nid] = ("kelvin", src)
            return src

        for nid in plan.topo_order():
            node = plan.nodes[nid]
            op = node.op
            inputs_kelvin = any(placed[i][0] == "kelvin" for i in node.inputs)
            if isinstance(op, (MemorySourceOp, EmptySourceOp)):
                placed[nid] = ("pem", before.add(op))
            elif isinstance(op, UDTFSourceOp):
                from ...udf.udtf import UDTFExecutor

                ex = self._udtf_executor(op)
                if ex in (UDTFExecutor.ALL_AGENTS, UDTFExecutor.ALL_PEM):
                    placed[nid] = ("pem", before.add(op))
                    if ex == UDTFExecutor.ALL_AGENTS:
                        data_tier = "all_agents"
                else:
                    placed[nid] = ("kelvin", after.add(op))
            elif isinstance(op, AggOp) and not inputs_kelvin:
                # Split: prepare (partial) stays on the PEM side; when the
                # result is consumed downstream it bridges as a carry
                # merge and the consumer reads finalized output.
                new_id = before.add(replace(op, mode="partial"), [
                    placed[i][1] for i in node.inputs
                ])
                placed[nid] = ("pem", new_id)
                to_kelvin(nid)  # aggs always bridge (their output is global)
            elif (isinstance(op, UnionOp) and nid in pushdown
                  and not inputs_kelvin):
                # Push-down: a PEM-safe union stays on the data tier so
                # the downstream agg takes the partial-split branch and
                # its bridge ships merge state, not the union's rows.
                placed[nid] = ("pem", before.add(
                    op, [placed[i][1] for i in node.inputs]
                ))
            elif isinstance(op, LimitOp) and not inputs_kelvin:
                # LimitOperatorMgr: local cap on each agent, global cap
                # after the gather.
                local = before.add(op, [placed[i][1] for i in node.inputs])
                placed[nid] = ("pem", local)
                src = to_kelvin(nid)
                placed[nid] = ("kelvin", after.add(op, [src]))
            elif _is_blocking(op) or inputs_kelvin:
                placed[nid] = (
                    "kelvin",
                    after.add(op, [to_kelvin(i) for i in node.inputs]),
                )
            else:  # Map/Filter fed only by PEM-side nodes
                placed[nid] = (
                    "pem",
                    before.add(op, [placed[i][1] for i in node.inputs]),
                )
        return BlockingSplitPlan(before, after, bridges, data_tier=data_tier)
