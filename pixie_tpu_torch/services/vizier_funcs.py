"""Service-context UDTFs: cluster state via control-plane requests.

Reference parity: ``src/vizier/funcs/`` — the vizier-level UDTF registry
whose funcs hold gRPC stubs into the metadata service
(``md_udtfs_impl.h:258`` GetAgentStatus). Here the stub is a bus
request/reply to the agent tracker's MDS topic.
"""

from __future__ import annotations

from ..types.dtypes import DataType
from ..udf.udtf import UDTFExecutor
from .msgbus import MessageBus

S = DataType.STRING
I = DataType.INT64
F = DataType.FLOAT64


# Names owned by this module; bind_service_registry excludes them before
# re-registering so clones never collide.
SERVICE_UDTF_NAMES = ("GetAgentStatus",)


def bind_service_registry(registry, bus: MessageBus, name: str):
    """Clone ``registry`` and (re)bind every service UDTF to ``bus``.
    The one place that knows the service UDTF name list."""
    reg = registry.clone(name, exclude=SERVICE_UDTF_NAMES)
    register_vizier_udtfs(reg, bus)
    return reg


def register_vizier_udtfs(registry, bus: MessageBus) -> None:
    """Bind service UDTFs to a control-plane connection. Called by agents
    at startup (the VizierFuncFactoryContext analog)."""

    def _get_agent_status(engine):
        reply = bus.request("mds.agent_status", {}, timeout_s=5.0)
        rows = reply["agents"]
        return {
            "agent_id": [r["agent_id"] for r in rows],
            "asid": [r["asid"] for r in rows],
            "kind": [r["kind"] for r in rows],
            "last_heartbeat_s": [r["last_heartbeat_s"] for r in rows],
            "num_tables": [r["num_tables"] for r in rows],
        }

    registry.udtf(
        "GetAgentStatus",
        [
            ("agent_id", S),
            ("asid", I),
            ("kind", S),
            ("last_heartbeat_s", F),
            ("num_tables", I),
        ],
        _get_agent_status,
        executor=UDTFExecutor.ONE_KELVIN,
        doc="Live agents with heartbeat ages, from the metadata tracker.",
    )
