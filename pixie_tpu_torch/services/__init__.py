"""Service shell: agents, control plane, query brokering (agent mode).

Reference parity: ``src/vizier/services``: the agent runtime (PEM and
Kelvin managers over NATS, ``agent/manager/manager.h:102``), the
metadata service's agent tracker (``controllers/agent/agent.go``) and
the query broker (``query_broker/controllers/server.go``). The control
plane is an in-process message bus with NATS semantics (topics, fan-out,
queued delivery, one dispatcher thread per subscription); the data plane
passes payload objects in-process where the reference streams protobuf
over gRPC.

A port of the JAX package's ``services/``. Agents in other processes dial
the broker's bus over the framed-TCP netbus (``netbus.py``, frames in the
``wire.py`` codec); ``deploy.py`` starts the roles. Agents fold their
own traces into telemetry tables (``telemetry.py``). ``BrokerReplica``
(``broker_ha.py``) runs N brokers on one bus with leases, epoch fencing
and failover of in-flight queries; ``FaultInjector`` (``faults.py``)
drops, delays, duplicates and partitions bus traffic from one seeded
RNG; ``load_tester.py`` and ``chaos.py`` drive them under load. The
operator's ``Reconciler`` (``operator.py``) keeps the deployed roles'
processes at their replica counts.
"""

from .agent import Agent, KelvinAgent, PEMAgent
from .broker_ha import BrokerReplica
from .faults import FaultInjector
from .msgbus import BusTimeout, MessageBus
from .operator import Reconciler, RoleSpec, specs_from_config
from .query_broker import (
    AdmissionError,
    AgentLost,
    QueryAbandoned,
    QueryBroker,
    QueryResultForwarder,
    QueryTimeout,
)
from .telemetry import (
    ClusterTraceView,
    TelemetryCollector,
    enable_self_telemetry,
)
from .tracker import AgentTracker

__all__ = [
    "AdmissionError",
    "Agent",
    "AgentLost",
    "AgentTracker",
    "BrokerReplica",
    "BusTimeout",
    "ClusterTraceView",
    "FaultInjector",
    "KelvinAgent",
    "MessageBus",
    "PEMAgent",
    "QueryAbandoned",
    "QueryBroker",
    "QueryResultForwarder",
    "QueryTimeout",
    "Reconciler",
    "RoleSpec",
    "TelemetryCollector",
    "enable_self_telemetry",
    "specs_from_config",
]
