"""Dynamic tracing (the pxtrace mutation path) of the port against the
JAX package.

Each case of ``tests/test_pxtrace.py`` has a counterpart here, run with
the port on the CPU:

- compiling: ``compile_mutations`` and ``compile_pxl(...).mutations``
  give equal deployments in both packages (name, table, probe target,
  outputs with their types, TTL), and so does ``parse_ttl``; a
  deployment crosses from one package to the other through the wire
  codec's bytes and decodes equal;
- the connector: both packages' ``DynamicTraceConnector`` attach to the
  same kind of object, capture the same calls into equal columns
  (``latency_ns`` is measured, so it is held only to >= 0), splice out of
  a chain of wrappers and detach the same way, and drop the same oldest
  rows past their 2^16-row ring;
- end to end: each ``TestEndToEnd`` case runs on a port cluster and on a
  JAX cluster driven with the same calls, with equal mutation states,
  equal aggregates of the captured arguments and equal row counts.
"""

import contextlib
import time

import numpy as np
import pytest

from pixie_tpu.exec import Engine as JaxEngine
from pixie_tpu.exec.engine import QueryError as JaxQueryError
from pixie_tpu.ingest.core import DataTable as JaxDataTable
import pixie_tpu.ingest.dynamic as jax_dynamic
import pixie_tpu.planner as jax_planner
import pixie_tpu.services as jax_services
import pixie_tpu.services.tracepoints as jax_tracepoints
import pixie_tpu.services.wire as jax_wire
import pixie_tpu.trace.spec as jax_spec
from pixie_tpu.udf.registry import default_registry as jax_registry
from pixie_tpu_torch import Engine
from pixie_tpu_torch.exec.engine import QueryError
from pixie_tpu_torch.ingest.core import DataTable
import pixie_tpu_torch.ingest.dynamic as dynamic
import pixie_tpu_torch.planner as planner
import pixie_tpu_torch.services as services
import pixie_tpu_torch.services.tracepoints as tracepoints
import pixie_tpu_torch.services.wire as wire
import pixie_tpu_torch.trace.spec as spec
from pixie_tpu_torch.udf.registry import default_registry

from test_pxtrace import TRACE_PXL
from test_torch_planner import _mutation_fields

FAST = {"heartbeat_interval_s": 0.05}
WINDOW = 1 << 10
CALLS_PXL = (
    "import px\n"
    "df = px.DataFrame(table='demo_calls')\n"
    "s = df.groupby('who').agg(n=('arg0', px.count),\n"
    "                          total=('ret', px.sum))\n"
    "px.display(s)\n"
)
ROWS_PXL = (
    "import px\n"
    "df = px.DataFrame(table='demo_calls')\n"
    "px.display(df[['arg0', 'who', 'ret', 'latency_ns']])\n"
)


class Demo:
    """The instrumented 'binary': a plain in-process callable."""

    def handle(self, x, who="anon"):
        return x * 2


#: Each package's modules, by the name the cases use.
PKGS = {
    "jax": dict(planner=jax_planner, dynamic=jax_dynamic, spec=jax_spec,
                services=jax_services, tracepoints=jax_tracepoints,
                wire=jax_wire, registry=jax_registry, DataTable=JaxDataTable,
                engine=lambda: JaxEngine(window_rows=WINDOW),
                QueryError=JaxQueryError),
    "port": dict(planner=planner, dynamic=dynamic, spec=spec,
                 services=services, tracepoints=tracepoints, wire=wire,
                 registry=default_registry, DataTable=DataTable,
                 engine=lambda: Engine(window_rows=WINDOW, device="cpu"),
                 QueryError=QueryError),
}


def _state(pkg):
    p = PKGS[pkg]
    return p["planner"].CompilerState(
        schemas={}, registry=p["registry"](), now_ns=10**18)


def _both(fn):
    """fn(pkg) for each package: (jax result, port result)."""
    return fn("jax"), fn("port")


# -- compiling --------------------------------------------------------------------
def test_mutation_extraction():
    jax_muts, muts = _both(
        lambda k: PKGS[k]["planner"].compile_mutations(TRACE_PXL, _state(k)))
    assert [_mutation_fields(m) for m in muts] == [
        _mutation_fields(m) for m in jax_muts]
    (dep,) = muts
    assert isinstance(dep, spec.TracepointDeployment)
    assert dep.name == "demo_tp" and dep.table_name == "demo_calls"
    assert dep.ttl_s == 600.0
    rel, jax_rel = dep.relation(), jax_muts[0].relation()
    assert list(rel.column_names) == list(jax_rel.column_names) == [
        "time_", "upid", "latency_ns", "arg0", "who", "ret"]
    assert [t.name for _c, t in rel.items()] == [
        t.name for _c, t in jax_rel.items()]


def test_full_compile_carries_mutations():
    jax_c, c = _both(
        lambda k: PKGS[k]["planner"].compile_pxl(TRACE_PXL, _state(k)))
    assert len(c.mutations) == 1
    assert c.outputs == jax_c.outputs == []
    assert ([_mutation_fields(m) for m in c.mutations]
            == [_mutation_fields(m) for m in jax_c.mutations])


@pytest.mark.parametrize("query", [
    "df = px.DataFrame(table='demo_calls')\npx.display(df)\n",
    "pxtrace.DeleteTracepoint('demo_tp')\n",
    "df = px.DataFrame(table='nope')\npxtrace.DeleteTracepoint('old')\n",
], ids=["query_after", "delete", "delete_after_a_failing_query"])
def test_mutation_plus_query_extraction(query):
    """Best effort past statements that fail before deployment."""
    pxl = TRACE_PXL + query
    jax_muts, muts = _both(
        lambda k: PKGS[k]["planner"].compile_mutations(pxl, _state(k)))
    assert [_mutation_fields(m) for m in muts] == [
        _mutation_fields(m) for m in jax_muts]
    assert muts[0].name == "demo_tp"


TTL_SECONDS = {"30s": 30.0, "2h": 7200.0, 5: 5.0, "10m": 600.0,
               "1d": 86400.0, "45": 45.0, 2.5: 2.5}


@pytest.mark.parametrize("ttl", list(TTL_SECONDS))
def test_ttl_parse(ttl):
    assert spec.parse_ttl(ttl) == jax_spec.parse_ttl(ttl) == TTL_SECONDS[ttl]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_deployment_crosses_the_wire(direction):
    src, dst = ("jax", "port") if direction == "jax_to_port" else ("port", "jax")
    muts = PKGS[src]["planner"].compile_mutations(
        TRACE_PXL + "pxtrace.DeleteTracepoint('old')\n", _state(src))
    assert len(muts) == 2
    for m in muts:
        got = PKGS[dst]["wire"].decode(PKGS[src]["wire"].encode(
            {"op": "deploy", "deployment": m}))
        assert type(got["deployment"]).__module__ == (
            PKGS[dst]["spec"].__name__)
        assert _mutation_fields(got["deployment"]) == _mutation_fields(m)


# -- the connector ------------------------------------------------------------------
def _deployment(pkg, pxl=TRACE_PXL):
    (dep,) = PKGS[pkg]["planner"].compile_mutations(pxl, _state(pkg))
    return dep


def _drain(pkg, conn, dep) -> dict:
    dt = PKGS[pkg]["DataTable"](dep.table_name, dep.relation(),
                                 max_buffer_rows=1 << 20)
    conn.transfer_data(None, {dep.table_name: dt})
    return dt.drain() or {}


def test_attach_capture_detach():
    got = {}
    for pkg in ("jax", "port"):
        demo = Demo()
        reg = PKGS[pkg]["dynamic"].TraceTargetRegistry()
        reg.register("demo.handle", demo, "handle")
        dep = _deployment(pkg)
        conn = PKGS[pkg]["dynamic"].compile_program(dep, reg, asid=7)
        conn.init()
        assert [demo.handle(5, who="alice"), demo.handle(9)] == [10, 18]
        records = _drain(pkg, conn, dep)
        assert (records["latency_ns"] >= 0).all()
        assert (records["upid"][:, 0] >> np.uint64(32) == 7).all()
        conn.stop()
        assert demo.handle.__func__ is Demo.handle  # restored
        got[pkg] = records
    for col in ("arg0", "who", "ret"):
        assert list(got["port"][col]) == list(got["jax"][col])
        assert got["port"][col].dtype == got["jax"][col].dtype
    assert list(got["port"]["who"]) == ["alice", "anon"]
    assert sorted(got["port"]) == sorted(got["jax"])


@pytest.mark.parametrize("stop_first", ["outer", "inner"])
def test_chained_wrappers_spliced(stop_first):
    """Two tracepoints on one symbol: stopping either leaves the other
    recording, and stopping both restores the original callable."""
    counts = {}
    for pkg in ("jax", "port"):
        demo = Demo()
        reg = PKGS[pkg]["dynamic"].TraceTargetRegistry()
        reg.register("demo.handle", demo, "handle")
        deps = [_deployment(pkg), _deployment(
            pkg, TRACE_PXL.replace("'demo_tp', 'demo_calls'",
                                   "'demo_tp2', 'demo_calls2'"))]
        inner, outer = (PKGS[pkg]["dynamic"].compile_program(d, reg)
                        for d in deps)
        inner.init()
        outer.init()
        demo.handle(1)
        first, second = (outer, inner) if stop_first == "outer" else (inner, outer)
        first.stop()
        demo.handle(2, who="b")
        rows = [len(_drain(pkg, c, d).get("arg0", []))
                for c, d in ((inner, deps[0]), (outer, deps[1]))]
        second.stop()
        assert demo.handle.__func__ is Demo.handle
        assert demo.handle(3) == 6
        counts[pkg] = rows
    assert counts["port"] == counts["jax"]
    assert counts["port"] == ([2, 1] if stop_first == "outer" else [1, 2])


def test_ring_drops_its_oldest_rows():
    """Past 2^16 undrained calls the ring keeps the newest 2^16."""
    got = {}
    for pkg in ("jax", "port"):
        demo = Demo()
        reg = PKGS[pkg]["dynamic"].TraceTargetRegistry()
        reg.register("demo.handle", demo, "handle")
        dep = _deployment(pkg)
        conn = PKGS[pkg]["dynamic"].compile_program(dep, reg)
        conn.init()
        n = (1 << 16) + 100
        for i in range(n):
            demo.handle(i)
        got[pkg] = _drain(pkg, conn, dep)["arg0"]
        conn.stop()
    assert np.array_equal(got["port"], got["jax"])
    assert np.array_equal(got["port"], np.arange(100, (1 << 16) + 100))


def test_unknown_symbol_fails_fast():
    msgs = []
    for pkg in ("jax", "port"):
        dyn = PKGS[pkg]["dynamic"]
        with pytest.raises(dyn.TraceError, match="demo.handle") as ei:
            dyn.compile_program(_deployment(pkg), dyn.TraceTargetRegistry())
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_register_rejects_a_non_callable():
    for pkg in ("jax", "port"):
        dyn = PKGS[pkg]["dynamic"]
        with pytest.raises(dyn.TraceError, match="not callable"):
            dyn.TraceTargetRegistry().register("x", Demo(), "nope")


# -- end to end -------------------------------------------------------------------
@contextlib.contextmanager
def _trace_cluster(pkg):
    """test_pxtrace.py's trace_cluster in one package: a PEM with a seed
    table and ``demo.handle`` registered, a Kelvin, a tracker and a
    broker with a TracepointRegistry."""
    p = PKGS[pkg]
    s = p["services"]
    bus = s.MessageBus()
    tracker = s.AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
    agents, broker = [], None
    try:
        pem = s.PEMAgent(bus, "pem-0", engine=p["engine"](), **FAST).start()
        agents.append(pem)
        kelvin = s.KelvinAgent(bus, "kelvin-0", engine=p["engine"](), **FAST)
        agents.append(kelvin.start())
        pem.append_data("seed", {"time_": np.arange(4, dtype=np.int64),
                                 "v": np.arange(4, dtype=np.int64)})
        pem._register()
        broker = s.QueryBroker(bus, tracker)
        broker.tracepoints = p["tracepoints"].TracepointRegistry(bus, tracker)
        demo = Demo()
        pem.trace_targets.register("demo.handle", demo, "handle")
        yield type("C", (), dict(bus=bus, tracker=tracker, pem=pem,
                                 kelvin=kelvin, broker=broker, demo=demo,
                                 pkg=pkg))
    finally:
        if broker is not None:
            broker.tracepoints.close()
            broker.close()
        for a in agents:
            a.stop()
        tracker.close()
        bus.close()


def _both_clusters(drive):
    """drive(cluster) on a JAX cluster and on a port cluster."""
    out = {}
    for pkg in ("jax", "port"):
        with _trace_cluster(pkg) as c:
            out[pkg] = drive(c)
    return out["jax"], out["port"]


def _sorted_answer(res) -> dict:
    d = res["tables"]["output"].to_pydict()
    order = np.argsort(d["who"].astype(str))
    return {k: np.asarray(v)[order].tolist() for k, v in d.items()}


def _rows(c) -> dict:
    d = c.broker.execute_script(ROWS_PXL)["tables"]["output"].to_pydict()
    assert (d["latency_ns"] >= 0).all()
    return d


def test_deploy_then_query():
    def drive(c):
        res = c.broker.execute_script(TRACE_PXL)
        assert c.broker.tracepoints.state("demo_tp") == "RUNNING"
        assert "demo_calls" in c.tracker.schemas()
        for i in range(20):
            c.demo.handle(i, who=f"user-{i % 3}")
        c.pem.poll_tracepoints()
        out = _sorted_answer(c.broker.execute_script(CALLS_PXL))
        rows = _rows(c)
        # The latencies, held to numpy over this package's own rows.
        lat = c.broker.execute_script(
            "import px\ndf = px.DataFrame(table='demo_calls')\n"
            "px.display(df.agg(m=('latency_ns', px.max),"
            " n=('latency_ns', px.count)))")["tables"]["output"].to_pydict()
        assert int(lat["m"][0]) == int(rows["latency_ns"].max())
        assert int(lat["n"][0]) == len(rows["latency_ns"]) == 20
        return res["mutations"], out

    jax, port = _both_clusters(drive)
    assert port == jax
    mutations, out = port
    assert mutations == {"demo_tp": "RUNNING"}
    assert out["who"] == ["user-0", "user-1", "user-2"]
    assert sum(out["n"]) == 20
    assert sum(out["total"]) == sum(2 * i for i in range(20))


def test_mutation_and_query_one_script():
    pxl = TRACE_PXL + (
        "df = px.DataFrame(table='demo_calls')\n"
        "px.display(df.head(10))\n"
    )

    def drive(c):
        res = c.broker.execute_script(pxl)
        out = res["tables"]["output"]
        return res["mutations"], list(out.relation.column_names), out.length

    jax, port = _both_clusters(drive)
    assert port == jax
    assert port[0] == {"demo_tp": "RUNNING"}
    assert port[2] == 0  # empty table, but schema-ready


def test_failed_deploy_surfaces():
    bad = TRACE_PXL.replace("demo.handle", "no.such.symbol")

    def drive(c):
        with pytest.raises(PKGS[c.pkg]["QueryError"], match="deploy failed") as ei:
            c.broker.execute_script(bad, mutation_timeout_s=15.0)
        deadline = time.time() + 5
        while (c.broker.tracepoints.state("demo_tp") != "FAILED"
               and time.time() < deadline):
            time.sleep(0.01)
        return c.broker.tracepoints.state("demo_tp"), str(ei.value)

    jax, port = _both_clusters(drive)
    assert port == jax
    assert port[0] == "FAILED"
    assert "no traceable target registered for symbol" in port[1]
    assert "no.such.symbol" in port[1]


def test_ttl_expiry_detaches():
    def drive(c):
        c.broker.execute_script(TRACE_PXL)
        deadline = time.time() + 2
        while "demo_tp" not in c.pem._tracepoints and time.time() < deadline:
            time.sleep(0.01)
        assert "demo_tp" in c.pem._tracepoints
        expired = c.broker.tracepoints.tick(now=time.monotonic() + 601)
        deadline = time.time() + 2
        while "demo_tp" in c.pem._tracepoints and time.time() < deadline:
            time.sleep(0.01)
        assert "demo_tp" not in c.pem._tracepoints
        assert c.demo.handle.__func__ is Demo.handle  # unpatched
        return expired, c.broker.tracepoints.state("demo_tp")

    jax, port = _both_clusters(drive)
    assert port == jax == (["demo_tp"], "TERMINATED")


def test_redeploy_same_name_single_wrapper():
    def drive(c):
        c.broker.execute_script(TRACE_PXL)
        # Changed TTL -> a genuinely new deployment under the same name.
        c.broker.execute_script(TRACE_PXL.replace("ttl='10m'", "ttl='20m'"))
        time.sleep(0.1)
        n_tracepoints = len(c.pem._tracepoints)
        c.demo.handle(4)
        c.pem.poll_tracepoints()
        return n_tracepoints, _sorted_answer(c.broker.execute_script(CALLS_PXL))

    jax, port = _both_clusters(drive)
    assert port == jax
    assert port[0] == 1
    assert sum(port[1]["n"]) == 1  # single wrapper: no duplicate rows


def test_upsert_idempotent():
    def drive(c):
        c.broker.execute_script(TRACE_PXL)
        # Re-running the same script refreshes TTL, does not redeploy.
        res = c.broker.execute_script(TRACE_PXL)
        return res["mutations"], len(c.pem._tracepoints)

    jax, port = _both_clusters(drive)
    assert port == jax == ({"demo_tp": "RUNNING"}, 1)


def test_delete_restores_the_handler():
    """DeleteTracepoint detaches the PEM's connector (its rows stay) and
    restores the original callable."""
    def drive(c):
        c.broker.execute_script(TRACE_PXL)
        c.demo.handle(1, who="a")
        c.pem.poll_tracepoints()
        res = c.broker.execute_script(
            "import pxtrace\npxtrace.DeleteTracepoint('demo_tp')\n")
        deadline = time.time() + 2
        while "demo_tp" in c.pem._tracepoints and time.time() < deadline:
            time.sleep(0.01)
        restored = c.demo.handle.__func__ is Demo.handle
        c.demo.handle(2, who="b")
        c.pem.poll_tracepoints()
        out = _sorted_answer(c.broker.execute_script(CALLS_PXL))
        return (res["mutations"], restored,
                c.broker.tracepoints.state("demo_tp"), out)

    jax, port = _both_clusters(drive)
    assert port == jax
    assert port[1] is True and port[2] == "TERMINATED"
    assert port[3]["who"] == ["a"] and port[3]["n"] == [1]


def test_broker_without_registry_refuses_mutations():
    msgs = []
    for pkg in ("jax", "port"):
        with _trace_cluster(pkg) as c:
            c.broker.tracepoints.close()
            reg, c.broker.tracepoints = c.broker.tracepoints, None
            try:
                with pytest.raises(PKGS[pkg]["QueryError"]) as ei:
                    c.broker.execute_script(TRACE_PXL)
            finally:
                c.broker.tracepoints = reg
            msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "no TracepointRegistry" in msgs[1]


def test_served_result_carries_mutations():
    """``broker.execute`` over the bus answers with the mutation states."""
    def drive(c):
        c.broker.serve()
        got = c.bus.request("broker.execute", {"query": TRACE_PXL},
                            timeout_s=30.0)
        return got["ok"], got["mutations"]

    jax, port = _both_clusters(drive)
    assert port == jax == (True, {"demo_tp": "RUNNING"})
