"""Process entrypoints for deployed roles (the agent/service mains).

Reference parity: the per-process mains — PEM (``src/vizier/services/
agent/pem/pem_main.cc``), Kelvin (``kelvin/kelvin_main.go``), and the
query-broker service (``src/vizier/services/query_broker``). One module,
three roles:

  python -m pixie_tpu_torch.deploy broker  # tracker + broker + netbus + obs
  python -m pixie_tpu_torch.deploy pem     # data agent + source collectors
  python -m pixie_tpu_torch.deploy kelvin  # merge agent

PEM/Kelvin dial the broker's netbus (``PIXIE_TPU_BROKER`` host:port); the
broker serves the bus (NATS analog), the script APIs, and healthz/
statusz/metrics.

A port of the JAX package's ``deploy.py``. Every role runs on the CUDA
card; ``PIXIE_TPU_TORCH_DEVICE`` names another device (``cpu`` for tests
and development). Without a card and without that variable a role exits
non-zero with the engine's error; nothing carries on on the CPU. Every
role samples its own stacks under the ``self_profiling`` flag
(``PIXIE_TPU_SELF_PROFILING``, on by default) and serves them at
``/debug/pprof`` and ``/debug/flamez``; agents fold self-telemetry under
``self_telemetry``. ``PIXIE_TPU_BROKER_HA=1`` makes ``broker`` one
replica of an N-broker control plane (``services/broker_ha.py``;
``PIXIE_TPU_BROKER_ID`` names it, ``PIXIE_TPU_BROKER_ROLE=standby``
boots it as a mirror), and ``PIXIE_TPU_LOCKDEP=1`` (the ``lockdep``
flag) enables runtime lock-order validation before any role builds its
engine. Not in this slice, and refused when asked for: the operator
role.
"""

from __future__ import annotations

import os
import signal
import sys
import threading

#: The environment variable that names the device of every role's engine
#: (and of ``cli run --local``): unset means the CUDA card.
DEVICE_ENV = "PIXIE_TPU_TORCH_DEVICE"


def env_device():
    """The device named by ``PIXIE_TPU_TORCH_DEVICE`` (the CUDA card when
    unset), resolved by the engine's rule: raises without a card unless
    the variable names the CPU."""
    from .exec.engine import resolve_device

    return resolve_device(os.environ.get(DEVICE_ENV) or None)


def _agent_id(default: str) -> str:
    return os.environ.get("PIXIE_TPU_AGENT_ID", default)


def _broker_addr() -> tuple[str, int]:
    addr = os.environ.get("PIXIE_TPU_BROKER", "127.0.0.1:6100")
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def run_broker() -> int:
    from .services.msgbus import MessageBus
    from .services.netbus import BusServer
    from .services.observability import ObservabilityServer
    from .services.query_broker import QueryBroker
    from .services.script_runner import ScriptRunner
    from .services.tracepoints import TracepointRegistry
    from .services.tracker import AgentTracker

    bus = MessageBus()
    # Broker HA (PIXIE_TPU_BROKER_HA=1): this process is one replica of
    # an N-broker control plane — PIXIE_TPU_BROKER_ID names it,
    # PIXIE_TPU_BROKER_ROLE=standby boots it as a lease-watching mirror
    # (default: leader). Standbys fold the leader's broker.state log
    # and take over in-flight queries when the lease lapses.
    replica = None
    if os.environ.get("PIXIE_TPU_BROKER_HA"):
        from .services.broker_ha import BrokerReplica

        replica = BrokerReplica(
            bus,
            os.environ.get("PIXIE_TPU_BROKER_ID", "broker-0"),
            leader=os.environ.get(
                "PIXIE_TPU_BROKER_ROLE", "leader"
            ) != "standby",
        )
        tracker, broker = replica.tracker, replica.broker
    else:
        tracker = AgentTracker(bus)
        broker = QueryBroker(bus, tracker)
        broker.serve()
    broker.tracepoints = TracepointRegistry(bus, tracker)
    runner = ScriptRunner(broker)
    if replica is not None:
        # Cron scripts run on the LEADER only — a standby executing the
        # same schedule would double-run every script cluster-wide. The
        # gate follows failover: a promoted standby starts ticking.
        _tick = runner.tick
        runner.tick = (
            lambda: _tick() if replica.role == "leader" else None
        )
    runner.run_forever()
    netbus_port = int(os.environ.get("PIXIE_TPU_NETBUS_PORT", "6100"))
    server = BusServer(bus, host="0.0.0.0", port=netbus_port)
    # Broker self-profiling (self_profiling flag): the broker has no
    # agent engine, so its attributed stacks land in a process-local
    # TableStore, and merge into /debug/pprof and /debug/flamez through
    # broker.profile_rows (agent_id "broker").
    prof_store, prof_coll = _self_profiler("broker")

    def statusz():
        out = {
            "agents": tracker.agents_info(),
            "tables": sorted(tracker.schemas()),
            "quarantined": tracker.quarantined(),
        }
        if replica is not None:
            # HA role/epoch/lease-age/replay-lag on every replica's
            # /statusz (leader AND standbys serve obs).
            out["ha"] = replica.statusz()
        if prof_coll is not None:
            beta = prof_store.get_table("stack_traces.beta")
            out["profiler"] = {
                "stacks": beta.num_rows if beta is not None else 0,
                "collector": dict(prof_coll.stats),
            }
        return out

    obs = ObservabilityServer(
        statusz_fn=statusz,
        # Broker-side distributed-query traces (dispatch/retry/failover
        # spans) back /debug/queryz on this role; the cluster-stitched
        # view (broker + agent spans per trace id) backs /debug/tracez.
        tracer=broker.tracer,
        trace_view=broker.trace_view,
        programs=_program_registry(),
        # Cluster-merged storage-tier snapshot: watermark = max across
        # agents, counters summed, per-agent lag spread.
        tablez_fn=lambda: {
            "scope": "cluster",
            "tables": tracker.table_freshness(),
        },
        cachez_fn=broker.result_cache.cachez,
        # Profiling tier: cluster-merged CPU flames (agents' heartbeat
        # summaries + the broker's own sampler) back /debug/pprof and
        # /debug/flamez.
        profilez_fn=broker.profile_rows,
        # Transport tier: cluster-merged agent bus summaries + the
        # broker's local bus + the BusServer's per-connection wire
        # accounting.
        busz_fn=lambda: {
            **broker.busz(),
            "connections": server.busz(),
        },
    )
    obs_port = obs.start(int(os.environ.get("PIXIE_TPU_OBS_PORT", "6101")))
    print(
        f"[broker] netbus :{server.port} obs :{obs_port}", flush=True
    )
    _wait_forever()
    runner.stop()
    if prof_coll is not None:
        prof_coll.stop()
    obs.stop()
    server.close()
    broker.tracepoints.close()
    if replica is not None:
        replica.close()
    else:
        broker.close()
        tracker.close()
    bus.close()
    return 0


def _dial_broker(host: str, port: int):
    """RemoteBus with startup retry: deploy roles come up in any order
    (k8s gives no sequencing), so a PEM that boots before the broker's
    netbus listens must keep dialing, not crash."""
    import time as _time

    from .services.netbus import RemoteBus
    from .services.observability import default_counter

    deadline = _time.monotonic() + float(
        os.environ.get("PIXIE_TPU_DIAL_TIMEOUT_S", "60")
    )
    retries = default_counter(
        "pixie_net_dial_retries_total",
        "Failed broker-netbus dial attempts during role startup "
        "(roles come up in any order; each retry counts here).",
    )
    while True:
        try:
            return RemoteBus(host, port)
        except (ConnectionError, OSError):
            retries.inc()
            if _time.monotonic() >= deadline:
                raise
            _time.sleep(0.5)


def _engine():
    from .exec.engine import Engine

    return Engine(device=env_device())


def run_pem() -> int:
    from .config import get_flag
    from .ingest.connectors import (
        NetworkStatsConnector,
        PIDRuntimeConnector,
        ProcExitConnector,
        ProcStatConnector,
        ProcessStatsConnector,
        SeqGenConnector,
        StirlingErrorConnector,
    )
    from .services.agent import PEMAgent

    engine = _engine()
    host, port = _broker_addr()
    bus = _dial_broker(host, port)
    agent = PEMAgent(bus, _agent_id("pem"), engine=engine)
    # The agent's own collector (wired to its engine) runs the sources.
    coll = agent.collector
    coll.register_source(ProcessStatsConnector())
    coll.register_source(ProcStatConnector())
    coll.register_source(PIDRuntimeConnector())
    coll.register_source(ProcExitConnector())
    coll.register_source(NetworkStatsConnector(pod=_agent_id("pem")))
    coll.register_source(StirlingErrorConnector())
    if get_flag("self_profiling"):
        from .ingest.profiler import PerfProfilerConnector

        coll.register_source(PerfProfilerConnector(pod=agent.agent_id))
    if os.environ.get("PIXIE_TPU_SEQGEN"):
        coll.register_source(SeqGenConnector())
    agent.start()
    obs = _agent_obs(agent, extra=lambda: {"collector": dict(coll.stats)})
    print(
        f"[pem] {agent.agent_id} -> {host}:{port} obs :{obs.port} "
        f"device {engine.device}", flush=True
    )
    _wait_forever()
    _stop_agent(agent, obs)
    return 0


def run_kelvin() -> int:
    from .config import get_flag
    from .services.agent import KelvinAgent

    engine = _engine()
    host, port = _broker_addr()
    bus = _dial_broker(host, port)
    agent = KelvinAgent(bus, _agent_id("kelvin"), engine=engine).start()
    if get_flag("self_profiling"):
        # The kelvin's own collector thread (Agent.start ran it) drains
        # the profiler into its local tables: merge-tier stacks are
        # queryable through the agent's own engine.
        from .ingest.profiler import PerfProfilerConnector

        agent.collector.register_source(
            PerfProfilerConnector(pod=agent.agent_id)
        )
    obs = _agent_obs(agent)
    print(
        f"[kelvin] {agent.agent_id} -> {host}:{port} obs :{obs.port} "
        f"device {engine.device}", flush=True
    )
    _wait_forever()
    _stop_agent(agent, obs)
    return 0


def _stop_agent(agent, obs) -> None:
    obs.stop()
    agent.stop()
    agent.bus.close()


def _agent_obs(agent, extra=None):
    """healthz/statusz/metrics/queryz for an agent process; returns the
    started server (its ``port`` attribute is the bound port). The
    engine's tracer backs /debug/queryz and the query-latency
    histograms; the engine collector refreshes table/cache/pipeline
    gauges at each scrape, the device-memory monitor the card's."""
    from .services.observability import (
        ObservabilityServer,
        default_registry,
        engine_collector,
    )

    def statusz():
        out = {
            "agent_id": agent.agent_id,
            "device": str(agent.engine.device),
            "tables": sorted(agent.engine.table_store.table_names()),
        }
        if extra is not None:
            out.update(extra())
        return out

    default_registry.register_collector(engine_collector(agent.engine))
    obs = ObservabilityServer(
        statusz_fn=statusz, tracer=agent.engine.tracer,
        # The process program registry backs /debug/programz.
        programs=_program_registry(),
        # Storage tier: this agent's local freshness snapshot (the
        # broker's /debug/tablez serves the cluster merge).
        tablez_fn=lambda: {
            "scope": "agent",
            "agent_id": agent.agent_id,
            "tables": agent.engine.table_store.freshness(),
        },
        # Local-engine result cache + registered materialized views.
        cachez_fn=lambda: {
            **agent.engine.result_cache.cachez(),
            "views": agent.engine.views.viewz(),
        },
        # This agent's own flames (the broker serves the cluster merge).
        profilez_fn=_local_profilez(agent.agent_id),
        # Transport tier: this agent's RemoteBus — frames/RTT to the
        # broker plus its subscription queue state.
        busz_fn=lambda: {
            "scope": "agent",
            "agent_id": agent.agent_id,
            **agent.bus.busz(),
        },
    )
    obs.port = obs.start(int(os.environ.get("PIXIE_TPU_OBS_PORT", "0")))
    return obs


def _local_profilez(own_agent_id: str):
    """profilez_fn over this process's profiler roster, filtered to one
    agent's samples (plus the handler's tenant/script filters)."""
    def fn(agent_id=None, tenant=None, script_hash=None):
        from .ingest.profiler import profile_summary

        rows = profile_summary(agent_id=agent_id or own_agent_id, top=0)
        return [
            r for r in rows
            if (tenant is None or r.get("tenant", "") == tenant)
            and (script_hash is None
                 or r.get("script_hash", "") == script_hash)
        ]
    return fn


def _self_profiler(role: str):
    """Broker-role self-profiling (``self_profiling`` flag): a
    Collector + PerfProfilerConnector sampling this process into a
    local TableStore (attributed ``__stacks__`` rows + the anonymous
    ``stack_traces.beta`` aggregate). Returns (store, collector), or
    (None, None) when the flag is off. The connector registers itself
    in the profiler's roster, so its cumulative summary merges into
    /debug/pprof through broker.profile_rows. Agent roles run their
    profiler on the agent's own collector instead."""
    from .config import get_flag

    if not get_flag("self_profiling"):
        return None, None
    from .ingest.collector import Collector
    from .ingest.profiler import PerfProfilerConnector
    from .table_store import TableStore

    store = TableStore()
    coll = Collector()
    coll.wire_to(store)
    coll.register_source(PerfProfilerConnector(pod=role))
    coll.run_as_thread()
    return store, coll


def _program_registry():
    from .exec.programs import default_program_registry

    return default_program_registry()


def _wait_forever() -> None:
    stop = threading.Event()

    def on_stop(*_):
        # Last-gasp flushes before the role's own teardown runs
        # (crash.register_fatal_handler's SIGTERM contract — the crash
        # module's own SIGTERM handler is disabled for deploy roles).
        from .services.crash import run_fatal_handlers

        run_fatal_handlers()
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, on_stop)
    stop.wait()


def run_operator() -> int:
    """The operator role reconciles the roles as processes from a YAML
    spec; it is a later slice of the port."""
    print(
        "[operator] not in this slice of the port "
        "(services/operator.py)", file=sys.stderr,
    )
    return 2


def main(argv=None) -> int:
    roles = {"broker": run_broker, "pem": run_pem, "kelvin": run_kelvin,
             "operator": run_operator}
    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 1 or args[0] not in roles:
        print(f"usage: python -m pixie_tpu_torch.deploy "
              f"{{{'|'.join(roles)}}}", file=sys.stderr)
        return 2
    # Crash machinery before anything else (signal_action.h parity):
    # hard faults dump stacks to the crash log, uncaught exceptions run
    # registered last-gasp handlers. SIGTERM stays with _wait_forever's
    # graceful teardown.
    from .services.crash import install as install_crash

    install_crash(role=args[0], sigterm_exits=False)
    # Every role runs on the card unless the device variable names
    # another: resolve it before anything starts, so a role without a
    # card exits here with the engine's error.
    try:
        env_device()
    except (RuntimeError, ValueError) as e:
        print(f"[{args[0]}] {e} ({DEVICE_ENV}=cpu runs the role on the "
              "CPU)", file=sys.stderr)
        return 1
    # Runtime lock-order validation: with the lockdep flag set, enable
    # BEFORE the role constructs any engine/broker/agent — only locks
    # created after enable() are tracked.
    from .config import get_flag

    if get_flag("lockdep"):
        from .analysis import lockdep

        lockdep.enable()
    return roles[args[0]]()


if __name__ == "__main__":
    sys.exit(main())
