"""Distributed execution over an agent mesh of virtual PEMs.

A port of the JAX package's ``parallel/``. Pixie's distributed plan fans
a query out across per-node PEM agents and reduces on Kelvin compute
nodes (``src/carnot/planner/distributed/``). Here:

- each mesh slot is a "virtual PEM" holding a row shard of every window
  (``mesh.py``: ``agent_mesh``, ``row_shards``); slots may repeat one
  device, so a single card (or the CPU) holds several PEMs;
- each slot runs the fragment's window fold on its shard, and the
  per-slot partial-aggregate states tree-merge over the ``agents`` axis,
  then over ``kelvin`` (``executor.py``: ``distributed_agg_step``,
  ``DistributedEngine``); row chains concatenate their shards' rows in
  shard order.

Control-plane messaging (plan dispatch, heartbeats) stays in
``services/``. ``DistributedEngine`` and the steps load on first use, so
the distributed planner can import ``mesh`` without importing the
engine.
"""

from .mesh import AGENTS, KELVIN, AgentMesh, agent_mesh, row_shards  # noqa: F401

__all__ = ["AGENTS", "KELVIN", "AgentMesh", "DistributedEngine",
           "agent_mesh", "distributed_agg_step", "distributed_rows_step",
           "row_shards"]

_EXECUTOR = ("DistributedEngine", "distributed_agg_step",
             "distributed_rows_step")


def __getattr__(name):
    if name in _EXECUTOR:
        from . import executor

        return getattr(executor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
