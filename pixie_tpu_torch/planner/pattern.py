"""Typed pattern matching over plan DAGs.

Reference parity: ``src/carnot/planner/compiler/analyzer`` rules are
written against a pattern-matcher over the typed IR
(``planner/ir/pattern_match.h`` — ``Match(ir_node, Filter(Map()))``
style predicates). Plan ops double as the IR here, so the matcher works
directly on :class:`~pixie_tpu.exec.plan.PlanNode` chains: a pattern is
an op type plus optional guards and input sub-patterns, and a match
binds each pattern's node so rewrites read like the reference's rules::

    m = match(plan, nid, Pat(FilterOp, inputs=[Pat(MapOp, name="map")]))
    if m and single_consumer(plan, m["map"].id):
        ...rewrite using m["map"], m[0]...

``m`` maps pattern names (and positional index of the root = 0) to
PlanNodes. Guards (``where``) run on the candidate node before inputs
recurse, so expensive checks stay local.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(frozen=True)
class Pat:
    """One node pattern: op type(s) + optional guard + input patterns.

    ``op``: a plan Op class or tuple of classes (isinstance check).
    ``inputs``: sub-patterns matched positionally against the node's
    inputs (fewer patterns than inputs is fine — extras are ignored;
    more is a non-match). ``where``: guard on the candidate PlanNode.
    ``name``: binding key in the match result.
    """

    op: object
    inputs: tuple = field(default=())
    where: Optional[Callable] = None
    name: Optional[str] = None

    def __init__(self, op, inputs=(), where=None, name=None):
        object.__setattr__(self, "op", op)
        object.__setattr__(self, "inputs", tuple(inputs))
        object.__setattr__(self, "where", where)
        object.__setattr__(self, "name", name)


def match(plan, nid: int, pat: Pat) -> Optional[dict]:
    """Match ``pat`` rooted at node ``nid``; returns {name_or_index:
    PlanNode} bindings (root at key 0) or None. Shared sub-DAGs are
    fine — the matcher only walks edges, it never mutates."""
    out: dict = {}

    def walk(node_id, p, idx):
        node = plan.nodes.get(node_id)
        if node is None or not isinstance(node.op, p.op):
            return False
        if p.where is not None and not p.where(node):
            return False
        if len(p.inputs) > len(node.inputs):
            return False
        out[p.name if p.name is not None else idx] = node
        return all(
            walk(node.inputs[i], sp, f"{idx}.{i}")
            for i, sp in enumerate(p.inputs)
        )

    return out if walk(nid, pat, 0) else None


def single_consumer(plan, nid: int, consumers: Optional[dict] = None) -> bool:
    """True when exactly one node consumes ``nid`` exactly once (the
    precondition for every fuse/inline rewrite). Pass a prebuilt
    ``consumers`` map (``rules._consumers(plan)``) inside sweep loops —
    the fallback walks every node per call."""
    if consumers is not None:
        return len(consumers.get(nid, ())) == 1
    count = 0
    for n in plan.nodes.values():
        count += sum(1 for i in n.inputs if i == nid)
        if count > 1:
            return False
    return count == 1
