"""Live-cluster state consumed by the distributed planner.

Reference parity: ``distributedpb::DistributedState`` and ``CarnotInfo``
(``src/carnot/planner/distributedpb/distributed_plan.proto:48,102``) —
one entry per live agent, carrying its role (PEM processes data and has
local tables; Kelvin accepts remote data and runs merge fragments) and
table availability. The planner replans against this on every query
(elasticity: ``query_executor.go:415`` pulls it fresh per script).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class AgentInfo:
    """CarnotInfo analog for one agent."""

    agent_id: str
    processes_data: bool = True  # PEM: runs source fragments
    accepts_remote_sources: bool = False  # Kelvin: runs merge fragments
    # Tables this agent holds locally. None = unknown -> assume all
    # (the reference's schema-less default before metadata sync).
    tables: frozenset[str] | None = None
    asid: int = 0

    def has_table(self, name: str) -> bool:
        return self.tables is None or name in self.tables


@dataclass
class DistributedState:
    agents: list[AgentInfo] = field(default_factory=list)
    # Live agents excluded from planning by the tracker's flap
    # quarantine (services/tracker.py): visible for statusz/debugging,
    # never scheduled.
    quarantined: list[str] = field(default_factory=list)

    @property
    def pems(self) -> list[AgentInfo]:
        return [a for a in self.agents if a.processes_data]

    @property
    def kelvins(self) -> list[AgentInfo]:
        return [a for a in self.agents if a.accepts_remote_sources]

    def pems_with_table(self, table: str) -> list[AgentInfo]:
        return [a for a in self.pems if a.has_table(table)]

    @classmethod
    def homogeneous(cls, n_pems: int, n_kelvins: int = 1) -> "DistributedState":
        """Synthetic state for tests/benchmarks (the reference test idiom:
        fake CarnotInfos, no processes — distributed_planner_test.cc)."""
        agents = [AgentInfo(agent_id=f"pem-{i}", asid=i + 1) for i in range(n_pems)]
        agents += [
            AgentInfo(
                agent_id=f"kelvin-{i}",
                processes_data=False,
                accepts_remote_sources=True,
                asid=1000 + i,
            )
            for i in range(n_kelvins)
        ]
        return cls(agents=agents)
