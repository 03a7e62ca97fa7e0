"""Distributed planner: logical plan -> per-agent fragments + collectives.

Reference parity: ``src/carnot/planner/distributed/`` — Splitter cuts the
plan at blocking operators, the partial-op manager splits aggregates and
limits into prepare/merge halves, the Coordinator assigns fragments to
live agents (pruning sources no agent can serve), and the Stitcher wires
the cross-fragment bridges. Each bridge names the collective pattern
that implements it (partial-agg state merge, row gather) and the mesh
axes it runs over (the ``agents`` axis of data agents, plus ``kelvin``
when a second merge tier exists).

A copy of the JAX package's distributed planner: it plans, verifies and
bounds a distributed plan; ``exec/bridge.py`` and ``services/`` (the
broker and the agents) execute one.
"""

from .coordinator import Coordinator, DistributedPlan, prune_unavailable_sources
from .distributed_state import AgentInfo, DistributedState
from .planner import DistributedPlanner
from .splitter import BlockingSplitPlan, BridgeSpec, Splitter

__all__ = [
    "AgentInfo",
    "BlockingSplitPlan",
    "BridgeSpec",
    "Coordinator",
    "DistributedPlan",
    "DistributedPlanner",
    "DistributedState",
    "Splitter",
    "prune_unavailable_sources",
]
