"""Distributed trace stitching and the cluster's self-telemetry on the
port, against the JAX package's.

Two PEMs, a Kelvin, a tracker and a broker on one in-process bus (CPU
engines), and the same cluster of the JAX package over the same seeded
rows. One distributed query is one stitched trace: every agent's
fragment or merge trace carries the broker's trace id under its dispatch
span, and the broker's ``ClusterTraceView`` (``/debug/tracez``) holds the
spans of every participant. The per-agent usage flows to the broker and
into each agent's ``__queries__``, and each of the 13 shipped scripts
over the telemetry tables returns rows with the JAX cluster's columns.
The JAX file's OTLP cases belong to the OpenTelemetry slice.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
import types

import numpy as np
import pytest

import pixie_tpu.services as jax_services
from pixie_tpu.exec import threadmap as jax_threadmap
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.ingest.collector import Collector as JaxCollector
from pixie_tpu.ingest.profiler import (
    PerfProfilerConnector as JaxProfiler,
)
import pixie_tpu_torch.services as port_services
from pixie_tpu_torch.exec import threadmap
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.ingest.collector import Collector
from pixie_tpu_torch.ingest.profiler import PerfProfilerConnector
from pixie_tpu_torch.scripts import load_script
from pixie_tpu_torch.services.observability import (
    MetricsRegistry,
    ObservabilityServer,
)

FAST = dict(heartbeat_interval_s=0.05)

AGG_SCRIPT = (
    "import px\n"
    "df = px.DataFrame(table='http_events')\n"
    "df = df.groupby('service').agg(\n"
    "    n=('latency_ns', px.count), s=('latency_ns', px.sum))\n"
    "px.display(df, 'o')\n"
)

#: The shipped scripts that read the telemetry tables.
TELEMETRY_SCRIPTS = (
    "px/agent_health", "px/bound_accuracy", "px/bus_health",
    "px/cache_stats", "px/flame_diff", "px/ingest_lag", "px/program_cost",
    "px/query_cost", "px/query_cpu", "px/rpc_latency", "px/slow_queries",
    "px/table_health", "px/tenant_cpu",
)

PKGS = {
    "port": types.SimpleNamespace(
        services=port_services, threadmap=threadmap,
        profiler=PerfProfilerConnector, collector=Collector,
        engine=lambda: Engine(window_rows=1024, device="cpu")),
    "jax": types.SimpleNamespace(
        services=jax_services, threadmap=jax_threadmap,
        profiler=JaxProfiler, collector=JaxCollector,
        engine=lambda: JaxEngine(window_rows=1024)),
}


def _wait_for(pred, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)
    return True


@contextlib.contextmanager
def _cluster(pkg_name: str):
    """Two PEMs + a Kelvin + a broker over the same seeded rows; each PEM
    has a profiler on a collector of its own wired to its engine, which
    the test samples and drains by hand."""
    pkg = PKGS[pkg_name]
    s = pkg.services
    bus = s.MessageBus()
    tracker = s.AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
    agents, conns, broker = [], [], None
    try:
        pems = []
        for i in range(2):
            pem = s.PEMAgent(bus, f"pem-{i}", engine=pkg.engine(), **FAST)
            conn = pkg.profiler(pod=f"test/pem-{i}", agent_id=f"pem-{i}",
                                sampling_period_s=0.0, push_period_s=0.0)
            coll = pkg.collector()
            coll.wire_to(pem.engine)
            coll.register_source(conn)
            conns.append((conn, coll))
            pems.append(pem)
            agents.append(pem.start())
        kelvin = s.KelvinAgent(bus, "kelvin-0", engine=pkg.engine(), **FAST)
        agents.append(kelvin.start())
        rng = np.random.default_rng(1)
        for i, pem in enumerate(pems):
            n = 1500 + 500 * i
            pem.append_data("http_events", {
                "time_": np.arange(n, dtype=np.int64),
                "latency_ns": rng.integers(1000, 1_000_000, n),
                "resp_status": rng.choice(np.array([200, 404]), n),
                "service": [f"svc-{(i + j) % 3}" for j in range(n)],
            })
        for pem in pems:
            pem._register()
        assert _wait_for(lambda: "http_events" in tracker.schemas())
        broker = s.QueryBroker(bus, tracker)
        yield types.SimpleNamespace(bus=bus, tracker=tracker, pems=pems,
                                    kelvin=kelvin, broker=broker,
                                    conns=conns, pkg=pkg)
    finally:
        for _conn, coll in conns:
            coll.stop()
        if broker is not None:
            broker.close()
        for a in agents:
            a.stop()
        tracker.close()
        bus.close()


@pytest.fixture
def cluster():
    with _cluster("port") as c:
        yield c


class TestOneStitchedTrace:
    def test_engine_tracers_share_trace_and_parents(self, cluster):
        c = cluster
        c.broker.execute_script(AGG_SCRIPT)
        btr = c.broker.tracer.last()
        dispatch = next(s for s in btr.spans if s.name == "dispatch")
        for agent, kind in ((c.pems[0], "fragment"), (c.pems[1], "fragment"),
                            (c.kelvin, "merge")):
            tr = agent.engine.tracer.last()
            assert tr.trace_id == btr.trace_id
            assert tr.kind == kind and tr.qid == btr.qid
            assert tr.root.parent_id == dispatch.span_id

    def test_tracez_stitches_cluster_wide(self, cluster):
        c = cluster
        c.broker.execute_script(AGG_SCRIPT)
        btr = c.broker.tracer.last()
        assert _wait_for(lambda: len(
            (c.broker.trace_view.get(btr.trace_id) or {}).get("agents", ())
        ) >= 4)
        row = c.broker.trace_view.get(btr.trace_id)
        assert set(row["agents"]) == {"broker", "pem-0", "pem-1",
                                      "kelvin-0"}
        srv = ObservabilityServer(registry=MetricsRegistry(),
                                  trace_view=c.broker.trace_view)
        code, ctype, body = srv.handle("/debug/tracez")
        assert code == 200 and "json" in ctype
        assert any(t["trace_id"] == btr.trace_id
                   for t in json.loads(body)["traces"])
        code, _, body = srv.handle(f"/debug/tracez/{btr.trace_id}")
        assert code == 200
        one = json.loads(body)
        assert {"query", "dispatch", "fragment", "compile"} <= {
            s["name"] for s in one["spans"]}
        # Every agent root parents under the broker's dispatch span.
        dispatch = next(s for s in one["spans"] if s["name"] == "dispatch")
        roots = [s for s in one["spans"]
                 if s["parent_id"] == dispatch["span_id"]]
        assert len(roots) == 3  # two fragments and the merge
        code, _, _ = srv.handle("/debug/tracez/nope")
        assert code == 404
        code, _, _ = ObservabilityServer().handle("/debug/tracez")
        assert code == 404

    def test_trace_view_equals_jax(self):
        """The stitched view's participants and span names equal the JAX
        broker's for the same query."""
        got = {}
        for name in ("port", "jax"):
            with _cluster(name) as c:
                c.broker.execute_script(AGG_SCRIPT)
                tid = c.broker.tracer.last().trace_id
                assert _wait_for(lambda: len(
                    (c.broker.trace_view.get(tid) or {}).get("agents", ())
                ) >= 4)
                row = c.broker.trace_view.get(tid)
                got[name] = (row["agents"],
                             {s["name"] for s in row["spans"]
                              if not s["name"].startswith("window.")})
        # Span names as a set: the port's Kelvin records its state merge
        # as a fragment span of its own, beside the limit's (the JAX
        # Kelvin records the limit's alone).
        assert got["port"] == got["jax"]


class TestResourceAccounting:
    def test_per_agent_usage_flows_to_broker(self, cluster):
        c = cluster
        res = c.broker.execute_script(AGG_SCRIPT)
        assert set(res["agent_stats"]) == {"pem-0", "pem-1"}
        for entry in res["agent_stats"].values():
            u = entry["usage"]
            assert u["rows_in"] > 0 and u["windows"] >= 1
            assert u["wire_bytes"] > 0
        btr = c.broker.tracer.last()
        assert btr.usage.rows_in == sum(
            e["usage"]["rows_in"] for e in res["agent_stats"].values()
        ) + sum(e.get("usage", {}).get("rows_in", 0)
                for e in res.get("merge_stats", {}).values())
        assert set(btr.agent_usage) >= {"pem-0", "pem-1"}

    def test_pxl_query_cost_over_cluster_telemetry(self, cluster):
        """The cluster queries its own telemetry through the distributed
        engine path, attributed from each agent's ``__queries__``."""
        c = cluster
        qid = c.broker.execute_script(AGG_SCRIPT)["qid"]
        for a in c.pems + [c.kelvin]:
            a._register()
        assert _wait_for(lambda: "__queries__" in c.tracker.schemas())
        out = c.broker.execute_script(
            "import px\n"
            "df = px.DataFrame(table='__queries__')\n"
            "df = df.groupby(['qid', 'agent_id']).agg(\n"
            "    bytes_staged=('bytes_staged', px.sum),\n"
            "    wire_bytes=('wire_bytes', px.sum),\n"
            ")\n"
            "px.display(df, 'cost')\n",
            max_output_rows=1000,
        )
        d = out["tables"]["cost"].to_pydict()
        mine = {a: w for q, a, w in zip(d["qid"], d["agent_id"],
                                        d["wire_bytes"]) if q == qid}
        assert set(mine) == {"pem-0", "pem-1"}
        assert all(w > 0 for w in mine.values())

    def test_broker_observed_costs_index_the_query(self, cluster):
        c = cluster
        c.broker.execute_script(AGG_SCRIPT)
        h = c.broker.tracer.last().script_hash
        assert c.broker.observed_costs.observed(h)["runs"] == 1


def _spin(stop):
    while not stop.is_set():
        sum(range(200))


def _history(c) -> None:
    """What the telemetry scripts read: two runs of a script, bus round
    trips (``px/rpc_latency``), profiler samples attributed to the run's
    fragment hash (``px/query_cpu``, ``px/flame_diff``), heartbeat folds
    of ``__tables__`` and ``__bus__``, and a registration that shows the
    broker every telemetry table."""
    c.broker.serve()
    for _ in range(2):
        c.broker.execute_script(AGG_SCRIPT)
    for _ in range(8):
        c.bus.request("broker.agents", {}, timeout_s=5.0)
    for pem, (conn, coll) in zip(c.pems, c.conns):
        frag = next(t for t in pem.engine.tracer.recent()
                    if t.get("kind") == "fragment")
        stop = threading.Event()
        trace = types.SimpleNamespace(qid=frag["qid"],
                                      script_hash=frag["script_hash"],
                                      tenant="")

        def run(tm=c.pkg.threadmap, trace=trace, stop=stop):
            tok = tm.bind(trace=trace, phase="host")
            try:
                _spin(stop)
            finally:
                tm.unbind(tok)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        try:
            for _ in range(10):
                conn.sample()
                time.sleep(0.002)
        finally:
            stop.set()
            t.join(5)
        conn.transfer_data(coll, coll._data_tables)
        coll.flush()
    time.sleep(0.2)  # heartbeats fold __tables__ and __bus__
    for a in c.pems + [c.kelvin]:
        a._register()
    want = {"__queries__", "__stacks__", "__tables__", "__bus__",
            "__programs__", "__agents__"}
    assert _wait_for(lambda: want <= set(c.tracker.schemas()))


@pytest.fixture(scope="module")
def telemetry_results():
    """Each telemetry script's answer on both clusters."""
    out = {}
    for name in ("port", "jax"):
        with _cluster(name) as c:
            _history(c)
            out[name] = {
                s: c.broker.execute_script(
                    load_script(s).pxl, max_output_rows=10_000,
                )["tables"]["output"]
                for s in TELEMETRY_SCRIPTS
            }
    return out


@pytest.mark.parametrize("script", TELEMETRY_SCRIPTS)
def test_telemetry_script_rows_with_jax_columns(telemetry_results, script):
    port = telemetry_results["port"][script]
    jax = telemetry_results["jax"][script]
    assert [(n, t.name) for n, t in port.relation.items()] == [
        (n, t.name) for n, t in jax.relation.items()]
    assert port.length > 0 and jax.length > 0, (port.length, jax.length)


@pytest.mark.parametrize("script,keys", [
    ("px/agent_health", ("agent_id", "kind", "queries_total")),
    ("px/table_health", ("table", "agents")),
    ("px/slow_queries", ("kind", "status", "n", "rows_out")),
])
def test_telemetry_script_keys_equal_jax(telemetry_results, script, keys):
    """Scripts whose groups do not depend on timings or on what each
    package compiles give the JAX cluster's groups."""
    def rows(hb):
        d = hb.to_pydict()
        return sorted(zip(*(list(np.asarray(d[k]).astype(str))
                            for k in keys)))

    assert rows(telemetry_results["port"][script]) == rows(
        telemetry_results["jax"][script])
