"""The port stands alone: no file of ``pixie_tpu_torch/`` (nor
``chip_smoke.py`` or ``chip_ab.py``) imports JAX or the JAX package, a CPU
query through every module of the window path (device cache, sketches,
zone skipping, pipeline), the group-by over UINT128 keys (the hash
form, the ``any`` UDA) and a windowed radix join leaves neither in
``sys.modules``, neither does a query through a CPU cluster of agents
(bus, tracker, PEMs, Kelvin, broker, bridges), neither does a query
through PEMs on the framed-TCP netbus with the entry points' modules
(wire, netbus, ingest, deploy, cli, api, observability, cron runner)
loaded, neither does a failover across two broker replicas under
lockdep and a fault injector with the load tester and the chaos soak
loaded, and nothing falls back to the CPU or to a plain version on its
own: an engine or an agent built without an engine raises when there is
no card, and a deploy role, ``cli run --local``, the load tester's
``--local`` or the chaos soak started without a card and without
``PIXIE_TPU_TORCH_DEVICE`` exits non-zero, and so does ``deploy
operator``. Neither does an OTel export pushed over OTLP with the
operator and the source lint loaded, nor a query through the mesh
executor (``parallel/``: a ``DistributedEngine`` over 8 virtual PEMs on
the CPU, on its base mesh and replanned onto a degraded one)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "pixie_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "chip_ab.py",
]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "pixie_tpu")


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES]
)
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_cpu_query_loads_neither_jax_nor_the_jax_package():
    code = """
import sys
import numpy as np
from pixie_tpu_torch import Engine
eng = Engine(window_rows=1024, device="cpu")
eng.append_data("t", {"time_": np.arange(3000), "k": ["a", "b", "c"] * 1000,
                      "v": np.arange(3000)})
out = eng.execute_query(
    "import px\\ndf = px.DataFrame(table='t')\\n"
    "px.display(df.groupby('k').agg(n=('v', px.count), s=('v', px.sum)))"
)["output"].to_pydict()
assert sorted(out["n"].tolist()) == [1000, 1000, 1000], out
import threading
conc, barrier = [], threading.Barrier(2, timeout=30)
def run():
    barrier.wait()
    conc.append(eng.execute_query(
        "import px\\ndf = px.DataFrame(table='t')\\n"
        "px.display(df.groupby('k').agg(n=('v', px.count)))"
    )["output"].to_pydict()["n"].tolist())
threads = [threading.Thread(target=run) for _ in range(2)]
for t in threads:
    t.start()
for t in threads:
    t.join()
assert [sorted(n) for n in conc] == [[1000] * 3] * 2, conc
assert eng.max_inflight >= 1 and not eng.tracer.in_flight()
eng = Engine(window_rows=1024, device="cpu", pipeline_depth=2)
for lo in range(0, 3072, 1024):  # one zone-map entry per window
    r = np.arange(lo, lo + 1024)
    eng.append_data("t", {"time_": r, "v": r})
rows = eng.execute_query(
    "import px\\ndf = px.DataFrame(table='t')\\n"
    "df = df[df.v >= 2500]\\npx.display(df.head(10))"
)["output"].to_pydict()
assert rows["v"].tolist() == list(range(2500, 2510)), rows
st = eng.last_stats
assert (st.resident_windows, st.skipped_windows) == (1, 2), st
eng.append_data("p", {"time_": np.arange(3000),
                      "upid": np.stack([np.arange(3000) % 7,
                                        np.arange(3000) % 5], 1).astype(np.uint64),
                      "pod": ["a", "b", "c"] * 1000, "v": np.arange(3000)})
out = eng.execute_query(
    "import px\\ndf = px.DataFrame(table='p')\\n"
    "px.display(df.groupby('upid').agg(n=('v', px.count), pod=('pod', px.any)))"
)["output"].to_pydict()
assert sorted(out["n"].tolist()) == [85] * 10 + [86] * 25, out
from pixie_tpu_torch.config import clear_flag, set_flag
set_flag("join_strategy", "radix")
set_flag("join_probe_window_rows", 512)
out = eng.execute_query(
    "import px\\nr = px.DataFrame(table='p')\\nl = r[r.v < 9]\\n"
    "g = l.merge(r, how='inner', left_on=['pod'], right_on=['pod'],"
    " suffixes=['', '_r'])\\npx.display(g)"
)["output"].to_pydict()
assert eng.last_join_decision.strategy == "radix", eng.last_join_decision
assert len(out["v_r"]) == 9000 and out["v_r"].sum() == 3 * 2999 * 3000 // 2, out
clear_flag("join_strategy")
clear_flag("join_probe_window_rows")
tables = eng.execute_query(
    "import px\\npx.display(px.GetTables())"
)["output"].to_pydict()
assert sorted(tables["table_name"].tolist()) == ["p", "t"], tables
from pixie_tpu_torch.metadata import MetadataState, UPID
md = MetadataState()
md.add_service("s-1", "payments", "prod")
md.add_pod("p-1", "payments-0", "prod", service_uids=("s-1",))
for pid in range(3):
    md.add_process(UPID(0, pid, pid), "p-1")
eng.set_metadata_state(md)
out = eng.execute_query(
    "import px\\ndf = px.DataFrame(table='p')\\ndf.svc = df.ctx['service']\\n"
    "px.display(df.groupby('svc').agg(n=('v', px.count),"
    " pods=('pod', px.count_distinct)))"
)["output"].to_pydict()
# upid (hi, lo) = (pid, pid) for pid < 3 is known: rows i = pid mod 35.
assert sorted(zip(out["svc"].tolist(), out["n"].tolist(),
                  out["pods"].tolist())) == [
    ("", 2742, 3), ("prod/payments", 258, 3)], out
for mod in ("exec.pipeline", "exec.zoneskip", "exec.stream",
            "table_store.device_cache", "table_store.sketches", "ops.hll",
            "ops.groupby", "udf.builtins.collections", "exec.joins",
            "ops.join", "ops.hashtable", "metadata.funcs",
            "metadata.resolver", "udf.builtins.introspection"):
    assert "pixie_tpu_torch." + mod in sys.modules, mod
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "pixie_tpu")]
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_cpu_cluster_query_loads_neither_jax_nor_the_jax_package():
    code = """
import sys, time
import numpy as np
from pixie_tpu_torch import Engine
from pixie_tpu_torch.services import (
    AgentTracker, KelvinAgent, MessageBus, PEMAgent, QueryBroker)
bus = MessageBus()
tracker = AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
agents = []
try:
    for i in range(2):
        pem = PEMAgent(bus, f"pem-{i}", heartbeat_interval_s=0.05,
                       engine=Engine(window_rows=1024, device="cpu")).start()
        agents.append(pem)
        pem.append_data("t", {"time_": np.arange(3000),
                              "k": ["a", "b", "c"] * 1000,
                              "v": np.arange(3000)})
        pem._register()
    agents.append(KelvinAgent(bus, "kelvin-0", heartbeat_interval_s=0.05,
                              engine=Engine(device="cpu")).start())
    # Every PEM's table, not the schemas' union: a PEM whose
    # registration has not landed is left out of the plan.
    deadline = time.monotonic() + 30
    while (sum(p.has_table("t") for p in tracker.distributed_state().pems)
           < 2 and time.monotonic() < deadline):
        time.sleep(0.01)
    broker = QueryBroker(bus, tracker)
    res = broker.execute_script(
        "import px\\ndf = px.DataFrame(table='t')\\n"
        "px.display(df.groupby('k').agg(n=('v', px.count)), 'o')"
    )
    out = res["tables"]["o"].to_pydict()
    assert sorted(out["n"].tolist()) == [2000] * 3, out
    broker.close()
finally:
    for a in agents:
        a.stop()
    tracker.close()
    bus.close()
for mod in ("services.agent", "services.query_broker", "services.msgbus",
            "services.tracker", "exec.bridge", "exec.trace"):
    assert "pixie_tpu_torch." + mod in sys.modules, mod
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "pixie_tpu")]
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_entry_points_load_neither_jax_nor_the_jax_package():
    code = """
import sys, time
import numpy as np
from pixie_tpu_torch import Engine
from pixie_tpu_torch.cli import main as cli_main
from pixie_tpu_torch.services import AgentTracker, MessageBus, PEMAgent
from pixie_tpu_torch.services.netbus import BusServer, RemoteBus
from pixie_tpu_torch.services.observability import ObservabilityServer
import pixie_tpu_torch.api, pixie_tpu_torch.deploy
import pixie_tpu_torch.services.crash, pixie_tpu_torch.services.tracepoints
import pixie_tpu_torch.services.script_runner, pixie_tpu_torch.ingest
import pixie_tpu_torch.planner.debug, pixie_tpu_torch.utils
bus = MessageBus()
server = BusServer(bus)
tracker = AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
rb = RemoteBus("127.0.0.1", server.port)
pem = PEMAgent(rb, "pem-0", heartbeat_interval_s=0.05,
               engine=Engine(window_rows=1024, device="cpu"))
try:
    pem.start()
    pem.append_data("t", {"time_": np.arange(300), "v": np.arange(300)})
    pem._register()
    deadline = time.monotonic() + 5
    while "t" not in tracker.schemas() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert "t" in tracker.schemas()
finally:
    pem.stop()
    rb.close()
    tracker.close()
    server.close()
    bus.close()
assert ObservabilityServer().handle("/healthz")[0] == 200
assert cli_main(["script", "list"]) == 0
for mod in ("services.wire", "services.netbus", "ingest.collector",
            "ingest.connectors", "ingest.replay", "trace.spec", "exec.otel",
            "utils.upid", "utils.datastore", "cli", "api", "deploy"):
    assert "pixie_tpu_torch." + mod in sys.modules, mod
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "pixie_tpu")]
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_resilience_path_loads_neither_jax_nor_the_jax_package():
    code = """
import sys, time
import numpy as np
from pixie_tpu_torch import Engine
from pixie_tpu_torch.analysis import lockdep
st = lockdep.enable()
from pixie_tpu_torch.services import (FaultInjector, KelvinAgent, MessageBus,
                                      PEMAgent)
from pixie_tpu_torch.services.broker_ha import BrokerReplica
import pixie_tpu_torch.services.chaos, pixie_tpu_torch.services.load_tester
bus = MessageBus()
reps = [BrokerReplica(bus, f"broker-{i}", leader=i == 0,
                      lease_interval_s=0.05, lease_expiry_s=0.3)
        for i in range(2)]
pem = PEMAgent(bus, "pem-0", heartbeat_interval_s=5.0,
               engine=Engine(window_rows=1024, device="cpu"))
pem.engine.append_data("t", {"time_": np.arange(300), "v": np.arange(300) % 3})
kel = KelvinAgent(bus, "kelvin-0", heartbeat_interval_s=5.0,
                  engine=Engine(window_rows=1024, device="cpu"))
q = ("import px\\ndf = px.DataFrame(table='t')\\n"
     "px.display(df.groupby('v').agg(n=('v', px.count)), 'o')")
try:
    pem.start(); kel.start()
    deadline = time.monotonic() + 5
    while ("t" not in reps[0].tracker.schemas()
           or reps[1].epoch < 1) and time.monotonic() < deadline:
        time.sleep(0.01)
    inj = FaultInjector(seed=0)
    inj.duplicate("agent.*.execute")
    bus.fault_injector = inj
    res = bus.request("broker.execute", {"query": q}, timeout_s=20)
    assert res["ok"] and sorted(res["tables"]["o"].to_pydict()["n"]) == [
        100, 100, 100], res
    reps[0].kill()
    deadline = time.monotonic() + 5
    while reps[1].role != "leader" and time.monotonic() < deadline:
        time.sleep(0.01)
    res = None
    while res is None and time.monotonic() < deadline:
        try:
            res = bus.request("broker.execute", {"query": q}, timeout_s=20)
        except Exception:
            time.sleep(0.05)
    assert res["ok"] and res["partial"] is False, res
    assert inj.fired("duplicate") >= 2
finally:
    bus.fault_injector = None
    pem.stop(); kel.stop()
    for r in reps:
        r.close()
    bus.close()
assert lockdep.disable() is st and st.violations == [] and st.edges
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "pixie_tpu")]
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_export_operator_and_lint_load_neither_jax_nor_the_jax_package():
    """A CPU query whose ``px.export`` is pushed by ``OTLPHttpExporter``
    to a loopback receiver, with the trace push on, the operator's
    ``Reconciler`` over one short-lived child, and the source lint over
    the port's OTel module: none of it loads JAX or the JAX package."""
    code = """
import http.server, json, sys, threading
import numpy as np
from pixie_tpu_torch import Engine
from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch.exec.otel import OTLPHttpExporter
from pixie_tpu_torch.services import Reconciler, RoleSpec
from pixie_tpu_torch.analysis.lint import run_lint
import pixie_tpu_torch.planner.otel_module, pixie_tpu_torch.native
got = []
class H(http.server.BaseHTTPRequestHandler):
    def do_POST(self):
        got.append((self.path, json.loads(self.rfile.read(
            int(self.headers["Content-Length"])))))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()
    def log_message(self, *a):
        pass
httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
t = threading.Thread(target=httpd.serve_forever, daemon=True)
t.start()
url = "http://127.0.0.1:%d" % httpd.server_address[1]
eng = Engine(window_rows=1024, device="cpu")
eng.append_data("t", {"time_": np.arange(300), "v": np.arange(300) % 3})
eng.export_otel = OTLPHttpExporter(url)
with override_flag("trace_export_url", url):
    eng.execute_query(
        "import px\\ndf = px.DataFrame(table='t')\\n"
        "df = df.groupby('v').agg(n=('v', px.count))\\n"
        "px.export(df, px.otel.Data(data=[\\n"
        "    px.otel.metric.Gauge(name='n', value=df.n)]))\\n")
httpd.shutdown()
httpd.server_close()
assert [p for p, _b in got] == ["/v1/metrics", "/v1/traces"], got
rec = Reconciler({"s": RoleSpec("s", command=(sys.executable, "-c", "0"))})
rec.reconcile()
rec.stop()
assert run_lint([pixie_tpu_torch.exec.otel.__file__]).ok
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "pixie_tpu")]
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_tracepoints_and_capture_tap_load_neither_jax_nor_the_jax_package():
    """A pxtrace deploy-and-query through a CPU cluster's broker, and a
    capture of all eleven protocols through the tap into a CPU engine
    with a stats script over it: none of it loads JAX or the JAX
    package."""
    code = """
import sys, time
import numpy as np
from pixie_tpu_torch import Engine
from pixie_tpu_torch.ingest.capture_gen import PROTOCOLS, gen_capture
from pixie_tpu_torch.ingest.collector import Collector
from pixie_tpu_torch.ingest.schemas import init_schemas
from pixie_tpu_torch.ingest.tap import CaptureTapConnector
from pixie_tpu_torch.services import (
    AgentTracker, KelvinAgent, MessageBus, PEMAgent, QueryBroker)
from pixie_tpu_torch.services.tracepoints import TracepointRegistry
from pixie_tpu_torch.utils.dwarf import DwarfReader
from pixie_tpu_torch.utils.elf import ELFReader
from pixie_tpu_torch.utils import BloomFilter

class App:
    def handle(self, service, status, size_kb):
        return status

bus = MessageBus()
tracker = AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
app = App()
pem = PEMAgent(bus, "pem-0", heartbeat_interval_s=0.05,
               engine=Engine(window_rows=1024, device="cpu")).start()
kelvin = KelvinAgent(bus, "kelvin-0", heartbeat_interval_s=0.05,
                     engine=Engine(device="cpu")).start()
broker = QueryBroker(bus, tracker)
broker.tracepoints = TracepointRegistry(bus, tracker)
pem.trace_targets.register("app.handle", app, "handle")
try:
    res = broker.execute_script(
        "import pxtrace\\n"
        "@pxtrace.probe('app.handle')\\n"
        "def probe_fn():\\n"
        "    return [{'latency_ns': pxtrace.FunctionLatency(),\\n"
        "             'service': pxtrace.ArgExpr('service', type='string')}]\\n"
        "pxtrace.UpsertTracepoint('tp', 'app_calls', probe_fn, ttl='5m')\\n")
    assert res["mutations"] == {"tp": "RUNNING"}, res
    for i in range(30):
        app.handle(f"svc-{i % 3}", 200, 1.5)
    pem.poll_tracepoints()
    out = broker.execute_script(
        "import px\\ndf = px.DataFrame(table='app_calls')\\n"
        "px.display(df.groupby('service').agg(n=('latency_ns', px.count)))"
    )["tables"]["output"].to_pydict()
    assert sorted(out["n"].tolist()) == [10, 10, 10], out
finally:
    broker.tracepoints.close()
    broker.close()
    pem.stop()
    kelvin.stop()
    tracker.close()
    bus.close()
cap = gen_capture(5, {p: 64 for p in PROTOCOLS})
eng = Engine(window_rows=1024, device="cpu")
init_schemas(eng)
coll = Collector()
coll.wire_to(eng)
tap = CaptureTapConnector(feed=cap.events, service="svc", pod="ns/p")
coll.register_source(tap)
tap.transfer_data(coll, coll._data_tables, budget=len(cap.events))
coll.flush()
for p in PROTOCOLS:
    assert getattr(tap, p).parse_errors == 0, p
out = eng.execute_query("import px\\n"
    "df = px.DataFrame(table='redis_events')\\n"
    "px.display(df.groupby('req_cmd').agg(n=('latency_ns', px.count)))"
)["output"].to_pydict()
assert int(out["n"].sum()) == 64, out
for mod in ("ingest.dynamic", "ingest.tap", "planner.pxtrace_module",
            "ingest.http2_parser", "ingest.amqp_parser"):
    assert "pixie_tpu_torch." + mod in sys.modules, mod
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "pixie_tpu")]
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_mesh_executor_loads_neither_jax_nor_the_jax_package():
    """A CPU query through ``pixie_tpu_torch.parallel.DistributedEngine``
    over 8 virtual PEMs, on the base mesh and on a degraded 3-slot one:
    neither loads JAX or the JAX package."""
    code = """
import sys
import numpy as np
import torch
import pixie_tpu_torch.planner.distributed as pd
from pixie_tpu_torch.parallel import DistributedEngine, agent_mesh

n = 3 * 1024 + 17
rng = np.random.default_rng(0)
data = {"time_": np.arange(n, dtype=np.int64),
        "latency_ns": rng.integers(1000, 10**7, n),
        "service": rng.choice(["a", "b", "c"], n)}
q = ("import px\\ndf = px.DataFrame(table='t')\\n"
     "df.ms = df.latency_ns / 1000000.0\\n"
     "px.display(df.groupby('service').agg(n=('ms', px.count), "
     "m=('ms', px.mean)))")
state = pd.DistributedState(agents=[
    pd.AgentInfo(agent_id=f"pem-{i}", processes_data=True,
                 tables=frozenset({"t"})) for i in range(3)
] + [pd.AgentInfo(agent_id="kelvin-0", processes_data=False,
                  accepts_remote_sources=True)])
mesh = agent_mesh(8, devices=[torch.device("cpu")] * 8)
for st in (None, state):
    eng = DistributedEngine(window_rows=1024, mesh=mesh,
                            distributed_state=st)
    eng.append_data("t", data)
    out = eng.execute_query(q)["output"].to_pydict()
    assert int(out["n"].sum()) == n, out
assert eng.last_distributed_plan.n_data_shards == 3
assert "pixie_tpu_torch.parallel.executor" in sys.modules
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "pixie_tpu")]
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("argv", [
    ["pixie_tpu_torch.deploy", "broker"],
    ["pixie_tpu_torch.deploy", "pem"],
    ["pixie_tpu_torch.deploy", "kelvin"],
    ["pixie_tpu_torch.deploy", "operator"],
    ["pixie_tpu_torch.cli", "run", "px/http_stats", "--local",
     "--synthetic", "100"],
    ["pixie_tpu_torch.services.load_tester", "--local", "--rows", "100"],
    ["pixie_tpu_torch.services.chaos", "--agents", "4"],
], ids=["broker", "pem", "kelvin", "operator", "cli_run_local",
        "load_tester_local", "chaos"])
def test_entry_point_without_a_card_exits_non_zero(argv, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PIXIE_TPU_TORCH_DEVICE")}
    env.update(PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               PIXIE_TPU_BROKER="127.0.0.1:9", PIXIE_TPU_DIAL_TIMEOUT_S="0")
    res = subprocess.run(
        [sys.executable, "-m", *argv], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr, res.stderr
    assert "PIXIE_TPU_TORCH_DEVICE=cpu" in res.stderr


def test_agent_without_an_engine_raises_without_a_card(monkeypatch):
    from pixie_tpu_torch import Engine
    from pixie_tpu_torch.services import KelvinAgent, MessageBus, PEMAgent

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bus = MessageBus()
    try:
        for cls in (PEMAgent, KelvinAgent):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls(bus, "a")
        agent = PEMAgent(bus, "a", engine=Engine(device="cpu"))
        assert agent.engine.device.type == "cpu"
    finally:
        bus.close()


def test_engine_without_a_card_raises(monkeypatch):
    from pixie_tpu_torch import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine()
    assert Engine(device="cpu").device.type == "cpu"


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    from pixie_tpu_torch.ops import cuda_lib

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(cuda_lib.KernelBuildError, match="nvcc not found"):
        cuda_lib.build()
