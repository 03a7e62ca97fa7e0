"""Coordinator: assign split fragments to live agents.

Reference parity: ``planner/distributed/coordinator/coordinator.h`` —
decides which agents run the data fragment (pruning sources an agent
cannot serve: ``prune_unavailable_sources_rule.h``) and which run the
merge fragment, deduplicating identical per-agent plans into clusters
(``plan_clusters.h``). A cluster is one program over the mesh's
``agents`` axis: agents in one cluster run the same data fragment on
their own shard. A copy of the JAX package's ``coordinator.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ...exec.plan import MemorySourceOp, Plan
from .distributed_state import AgentInfo, DistributedState
from .splitter import BlockingSplitPlan


class PlanningError(Exception):
    pass


def source_tables(plan: Plan) -> set[str]:
    return {
        n.op.table for n in plan.nodes.values() if isinstance(n.op, MemorySourceOp)
    }


def prune_unavailable_sources(
    plan: Plan, agent: AgentInfo
) -> tuple[bool, set[str]]:
    """(can_run_entire_fragment, missing_tables) for one agent.

    Reference: ``prune_unavailable_sources_rule.h`` removes sources (and
    dependent subtrees) an agent cannot serve. Fixed-shape SPMD wants
    identical programs per shard, so instead of rewriting per-agent plans
    we exclude the agent from the cluster: its shard simply isn't in the
    mesh (degraded mesh = reference's pruned plan).
    """
    missing = {t for t in source_tables(plan) if not agent.has_table(t)}
    return (not missing, missing)


@dataclass
class PlanCluster:
    """Agents sharing one SPMD data-fragment program (plan_clusters.h)."""

    agent_ids: tuple
    plan: Plan


@dataclass
class DistributedPlan:
    """Per-query physical assignment (distributedpb::DistributedPlan)."""

    split: BlockingSplitPlan
    clusters: list = field(default_factory=list)  # list[PlanCluster]
    kelvin_agent_ids: tuple = ()
    pruned_agent_ids: tuple = ()

    @property
    def merge_plan(self) -> Plan:
        return self.split.after_blocking

    @property
    def data_agent_ids(self) -> tuple:
        return tuple(a for c in self.clusters for a in c.agent_ids)

    @property
    def n_data_shards(self) -> int:
        return len(self.data_agent_ids)


class Coordinator:
    def assign(
        self, split: BlockingSplitPlan, state: DistributedState
    ) -> DistributedPlan:
        needed = source_tables(split.before_blocking)
        # The splitter already resolved the data tier (udtf.h executor
        # semantics: ALL_AGENTS fragments run on Kelvins too).
        candidates = (
            state.agents if split.data_tier == "all_agents" else state.pems
        )
        eligible, pruned = [], []
        for a in candidates:
            missing = {t for t in needed if not a.has_table(t)}
            (eligible if not missing else pruned).append(a.agent_id)
        if not eligible and needed:
            raise PlanningError(f"no live agent can serve {sorted(needed)}")
        kelvins = tuple(a.agent_id for a in state.kelvins)
        if not kelvins and len(split.after_blocking.nodes) > 0:
            # Degrade: a data agent doubles as the merge tier (the
            # reference runs Kelvin-less in standalone mode).
            kelvins = tuple(eligible[:1])
        clusters = (
            [PlanCluster(tuple(eligible), split.before_blocking)]
            if eligible and split.before_blocking.nodes
            else []
        )
        return DistributedPlan(
            split=split,
            clusters=clusters,
            kelvin_agent_ids=kelvins,
            pruned_agent_ids=tuple(pruned),
        )
