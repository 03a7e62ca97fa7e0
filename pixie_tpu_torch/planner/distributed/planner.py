"""DistributedPlanner: split -> coordinate -> stitch.

Reference parity: ``planner/distributed/distributed_planner.h:66``
(DistributedPlanner::Plan) and the stitcher rules
(``distributed_stitcher_rules.h``) that wire each GRPCSink's destination
address to its GRPCSource. Here stitching assigns each bridge the mesh
axes its collective runs over: the ``agents`` axis, plus the ``kelvin``
axis when a second reduction tier exists.

A copy of the JAX package's ``planner.py``. ``stitch(mesh=)`` reads a
mesh duck-typed, from its ``axis_names`` and ``devices.shape``
(``parallel/mesh.py``'s ``AgentMesh``).
"""

from __future__ import annotations

from ...exec.plan import Plan
from ...parallel.mesh import AGENTS, KELVIN
from .coordinator import Coordinator, DistributedPlan
from .distributed_state import DistributedState
from .splitter import Splitter


class DistributedPlanner:
    """Combines splitter + coordinator + stitcher (logical_planner.h:40
    drives this from the query broker's compile path)."""

    def __init__(self, registry=None):
        self.splitter = Splitter(registry)
        self.coordinator = Coordinator()

    def plan(
        self, logical_plan: Plan, state: DistributedState, mesh=None,
        schemas=None, table_stats=None,
    ) -> DistributedPlan:
        split = self.splitter.split(logical_plan)
        dplan = self.coordinator.assign(split, state)
        self.stitch(dplan, state, mesh=mesh)
        # Always-on structural verification (pixie_tpu/analysis): bridge
        # sink/source/spec pairing, no blocking ops in the data
        # fragment, agg bridges feeding their finalize half — a bad
        # split fails HERE, not as a hung merge or a device error on an
        # agent. (The schema walk already ran on the logical plan in
        # compile_pxl; the broker re-checks dispatch sets per query.)
        from ...analysis.verifier import check_distributed_plan

        check_distributed_plan(dplan)
        # Resource-bound pass over the split (pxbound): per-agent data
        # fragment bounds + merge bounds with bridge rows seeded from
        # the data side x agent count + total wire bound. Attached as
        # dplan.resource_report; the broker folds it into the
        # predicted_cost its admission control schedules on. Optional:
        # callers without schemas (tests building raw splits) skip it.
        if schemas is not None:
            from ...analysis.bounds import distributed_bounds

            distributed_bounds(
                dplan, schemas, self.splitter.registry, table_stats,
                n_agents=max(len(dplan.data_agent_ids), 1),
            )
        return dplan

    def stitch(self, dplan: DistributedPlan, state: DistributedState, mesh=None) -> None:
        """Wire bridges to the mesh axes implementing them.

        When the executing ``mesh`` is known it is authoritative (a bridge
        folds over exactly the axes the mesh has, size>1); without one
        (planning-only use) axes are derived from the agent state.
        """
        if mesh is not None:
            sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
            axes = (AGENTS,) + ((KELVIN,) if sizes.get(KELVIN, 1) > 1 else ())
        else:
            axes = (AGENTS,) + ((KELVIN,) if len(state.kelvins) > 1 else ())
        for b in dplan.split.bridges:
            b.axes = axes
