"""The port's HTTP observability surface and cron script runner against
the JAX package's.

``ObservabilityServer`` (``pixie_tpu_torch/services/observability.py``)
over a port engine and the JAX server over a JAX engine holding the same
rows after the same query: every wired endpoint answers with the JAX
server's status code, content type and keys (for ``/metrics``, the
engine collector's metric names and table rows); an endpoint whose
source is not wired answers as the JAX server does. Wired to a trace
view, a program registry and a profile source fed the same spans and
stacks, ``/debug/tracez``, ``/debug/pprof`` and ``/debug/flamez`` answer
the JAX server's bodies, and ``/debug/programz`` its keys. The
``ScriptRunner``'s ticks against a port broker equal the
JAX runner's against a JAX broker, and against a bare engine.
"""

from __future__ import annotations

import contextlib
import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import pixie_tpu.services as jax_services
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.services import observability as jax_obs
from pixie_tpu.services import script_runner as jax_runner
import pixie_tpu_torch.services as port_services
from pixie_tpu_torch import Engine
from pixie_tpu_torch.services import observability as port_obs
from pixie_tpu_torch.services import script_runner as port_runner

QUERY = (
    "import px\ndf = px.DataFrame(table='http_events')\n"
    "df = df.groupby('service').agg(n=('latency_ns', px.count))\n"
    "px.display(df)\n"
)
PATHS = ("/healthz", "/statusz", "/version", "/metrics", "/debug/queryz",
         "/debug/tablez", "/debug/cachez", "/debug/busz", "/debug/tracez",
         "/debug/tracez/abc", "/debug/pprof", "/debug/flamez",
         "/debug/programz", "/nope")
WIRED = {"/healthz", "/statusz", "/version", "/metrics", "/debug/queryz",
         "/debug/tablez", "/debug/cachez", "/debug/busz"}


def _rows(n: int = 3000, seed: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "time_": np.arange(n, dtype=np.int64),
        "latency_ns": rng.integers(1000, 1_000_000, n),
        "service": [f"svc-{k}" for k in rng.integers(0, 4, n)],
    }


def _server(obs_mod, engine, bus):
    reg = obs_mod.MetricsRegistry()
    reg.register_collector(obs_mod.engine_collector(engine))
    return obs_mod.ObservabilityServer(
        registry=reg,
        statusz_fn=lambda: {"agent_id": "pem-0",
                            "tables": sorted(engine.tables)},
        tracer=engine.tracer,
        tablez_fn=lambda: {"scope": "agent",
                           "tables": engine.table_store.freshness()},
        cachez_fn=engine.result_cache.cachez,
        busz_fn=bus.busz,
    )


@pytest.fixture(scope="module")
def servers():
    out = {}
    for name, eng, bus, obs_mod in (
        ("port", Engine(window_rows=1024, device="cpu"),
         port_services.MessageBus(), port_obs),
        ("jax", JaxEngine(window_rows=1024), jax_services.MessageBus(),
         jax_obs),
    ):
        eng.append_data("http_events", _rows())
        eng.execute_query(QUERY)
        out[name] = (_server(obs_mod, eng, bus), bus)
    yield {k: v[0] for k, v in out.items()}
    for _srv, bus in out.values():
        bus.close()


def _metric_names(body: str) -> dict:
    """{metric name: sorted label strings} of a Prometheus exposition."""
    out: dict = {}
    for ln in body.splitlines():
        if ln.startswith("#") or not ln.strip():
            continue
        name, _, rest = ln.partition("{")
        name = name.split()[0]
        out.setdefault(name, set()).add(rest.rpartition("}")[0])
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("path", PATHS)
def test_endpoint_matches_jax_server(servers, path):
    code, ctype, body = servers["port"].handle(path)
    jcode, jctype, jbody = servers["jax"].handle(path)
    assert (code, ctype) == (jcode, jctype), (body, jbody)
    assert (code == 200) == (path in WIRED)
    if code != 200:
        assert body == jbody
        return
    if ctype == "application/json":
        got, want = json.loads(body), json.loads(jbody)
        if path == "/debug/cachez":
            # The port's result cache also lists its hit and miss counts
            # as plain integers (the JAX cache keeps them in the metrics
            # registry).
            assert set(want) <= set(got)
        else:
            assert sorted(got) == sorted(want)
        if path == "/debug/queryz":
            assert len(got["recent"]) == len(want["recent"]) == 1
            assert got["recent"][0]["status"] == want["recent"][0]["status"]
        if path == "/debug/tablez":
            assert sorted(got["tables"]) == sorted(want["tables"])
    elif path == "/metrics":
        got, want = _metric_names(body), _metric_names(jbody)
        table = {k: v for k, v in want.items() if k.startswith("pixie_table")}
        assert {k: got.get(k) for k in table} == table
        for name in ("pixie_device_cache_bytes", "pixie_pipeline_depth",
                     "pixie_pipeline_windows_total"):
            assert name in got and name in want
        rows = [ln for ln in body.splitlines()
                if ln.startswith("pixie_table_rows{")]
        assert rows == [ln for ln in jbody.splitlines()
                        if ln.startswith("pixie_table_rows{")]
    else:
        assert body == jbody


_SPANS = [
    {"span_id": f"{i:016x}", "parent_id": "" if i == 0 else f"{0:016x}",
     "name": ("query", "compile", "dispatch", "fragment")[i % 4],
     "start_unix_nano": 1000 * i, "end_unix_nano": 1000 * i + 500}
    for i in range(6)
]
_PROFILE = [
    {"stack": "a.py:f;b.py:g", "count": 7, "qid": "q1", "script_hash": "h1",
     "tenant": "alpha", "phase": "host"},
    {"stack": "a.py:f;c.py:h", "count": 3, "qid": "q2", "script_hash": "h2",
     "tenant": "beta", "phase": "device_dispatch"},
]


def _profilez(agent_id=None, tenant=None, script_hash=None):
    return [r for r in _PROFILE
            if (tenant is None or r["tenant"] == tenant)
            and (script_hash is None or r["script_hash"] == script_hash)]


@pytest.fixture(scope="module")
def wired_servers():
    from pixie_tpu.exec.programs import default_program_registry as jreg
    from pixie_tpu.services.telemetry import ClusterTraceView as JaxView
    from pixie_tpu_torch.exec.programs import default_program_registry
    from pixie_tpu_torch.services.telemetry import ClusterTraceView

    out = {}
    for name, view_cls, programs, obs_mod in (
        ("port", ClusterTraceView, default_program_registry(), port_obs),
        ("jax", JaxView, jreg(), jax_obs),
    ):
        view = view_cls()
        view._ingest("ab" * 16, "pem-0", [dict(s) for s in _SPANS])
        out[name] = obs_mod.ObservabilityServer(
            registry=obs_mod.MetricsRegistry(), trace_view=view,
            programs=programs, profilez_fn=_profilez)
    return out


@pytest.mark.parametrize("path", [
    "/debug/tracez", "/debug/tracez/" + "ab" * 16, "/debug/tracez/nope",
    "/debug/pprof", "/debug/pprof?tenant=alpha", "/debug/pprof?script=h2",
    "/debug/flamez", "/debug/flamez?tenant=beta", "/debug/programz",
])
def test_wired_debug_endpoint_matches_jax(wired_servers, path):
    code, ctype, body = wired_servers["port"].handle(path)
    jcode, jctype, jbody = wired_servers["jax"].handle(path)
    assert (code, ctype) == (jcode, jctype), (body, jbody)
    assert code == (404 if path.endswith("nope") else 200)
    if path == "/debug/programz":
        assert sorted(json.loads(body)) == sorted(json.loads(jbody))
    elif path == "/debug/tracez":
        got, want = json.loads(body), json.loads(jbody)
        for row in got["traces"] + want["traces"]:
            row.pop("updated_unix_nano")  # the clock at ingest
        assert got == want
    else:
        assert body == jbody


def test_http_transport(servers):
    srv = servers["port"]
    port = srv.start(0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=5) as r:
            assert r.status == 200 and r.read() == b"ok\n"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/statusz",
                                    timeout=5) as r:
            st = json.loads(r.read())
            assert st["agent_id"] == "pem-0" and "window_rows" in st["flags"]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/pprof",
                                   timeout=5)
        assert e.value.code == 404
    finally:
        srv.stop()


def test_health_fn_and_counters():
    reg = port_obs.MetricsRegistry()
    srv = port_obs.ObservabilityServer(
        registry=reg, health_fn=lambda: (False, "draining"))
    assert srv.handle("/healthz") == (503, "text/plain", "draining\n")
    reg.counter("pixie_x_total", "x").inc(2)
    assert "pixie_x_total 2" in srv.handle("/metrics")[2]


PKGS = {
    "port": types.SimpleNamespace(
        services=port_services, runner=port_runner,
        engine=lambda: Engine(window_rows=1024, device="cpu")),
    "jax": types.SimpleNamespace(
        services=jax_services, runner=jax_runner,
        engine=lambda: JaxEngine(window_rows=1024)),
}


@contextlib.contextmanager
def _cluster(pkg):
    s = pkg.services
    bus = s.MessageBus()
    tracker = s.AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
    agents, broker = [], None
    try:
        for i in range(2):
            pem = s.PEMAgent(bus, f"pem-{i}", engine=pkg.engine(),
                             heartbeat_interval_s=0.05)
            agents.append(pem.start())
            pem.append_data("http_events", _rows(1000 + 500 * i, seed=i))
            pem._register()
        agents.append(s.KelvinAgent(bus, "kelvin-0", engine=pkg.engine(),
                                    heartbeat_interval_s=0.05).start())
        deadline = time.monotonic() + 5.0
        while "http_events" not in tracker.schemas():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        broker = s.QueryBroker(bus, tracker)
        yield broker
    finally:
        if broker is not None:
            broker.close()
        for a in agents:
            a.stop()
        tracker.close()
        bus.close()


def _ticks(pkg, target):
    r = pkg.runner
    seen = []
    runner = r.ScriptRunner(target, on_result=lambda s, out: seen.append(
        (s.script_id, sorted(k for k in out if isinstance(k, str)))))
    runner.upsert(r.CronScript("counts", QUERY, frequency_s=10.0))
    runner.upsert(r.CronScript(
        "broken", "import px\npx.display(px.DataFrame(table='nope'))", 5.0))
    runner.upsert(r.CronScript("off", QUERY, 1.0, enabled=False))
    ticks = []
    for now in (0.0, 4.0, 5.0, 10.0, 12.0):
        ticks.append([(rec.script_id, rec.ok, rec.row_counts,
                       bool(rec.error))
                      for rec in runner.tick(now_s=now)])
    runner.compare_state({"counts": r.CronScript("counts", QUERY, 20.0)})
    ticks.append(sorted(runner.scripts()))
    ticks.append([(rec.script_id, rec.ok) for rec in runner.tick(now_s=40.0)])
    return ticks, seen


@pytest.mark.parametrize("target", ["broker", "engine"])
def test_script_runner_ticks_match_jax(target):
    out = {}
    for name, pkg in PKGS.items():
        if target == "broker":
            with _cluster(pkg) as broker:
                out[name] = _ticks(pkg, broker)
        else:
            eng = pkg.engine()
            eng.append_data("http_events", _rows())
            out[name] = _ticks(pkg, eng)
    assert out["port"] == out["jax"]
    ticks, seen = out["port"]
    assert ticks[0] == [("broken", False, {}, True),
                        ("counts", True, {"output": 4}, False)]
    assert ticks[1] == [] and ticks[-2] == ["counts"]
    assert seen[0] == ("counts", ["output"])


def test_datastore_backends(tmp_path):
    from pixie_tpu_torch.utils.datastore import MemoryDatastore, SqliteDatastore

    for ds in (MemoryDatastore(), SqliteDatastore(str(tmp_path / "kv.db"))):
        ds.set("a/1", b"x")
        ds.set("a/2", b"y")
        ds.set("b/1", b"z")
        assert ds.get("a/1") == b"x" and ds.get("nope") is None
        assert ds.get_with_prefix("a/") == [("a/1", b"x"), ("a/2", b"y")]
        ds.delete_with_prefix("a/")
        assert ds.get_with_prefix("a/") == [] and ds.get("b/1") == b"z"
        ds.close()
    again = SqliteDatastore(str(tmp_path / "kv.db"))
    assert again.get("b/1") == b"z"  # persisted
    again.close()
