"""The port's entry points (``pixie_tpu_torch/cli.py``, ``api.py``,
``deploy.py``, ``planner/debug.py``) against the JAX package's.

``script list|show``, ``docs`` and ``explain`` print what the JAX CLI
prints; ``run --local`` over the synthetic replay (and a saved npz) gives
the JAX CLI's table; ``run``, ``tables``, ``agents`` and ``api.Client``
against a served port broker (over the framed-TCP netbus) give what the
JAX CLI gives against a served JAX broker over the same rows; a secured
broker refuses a client without the secret; and the three deploy roles,
started as processes on the CPU (``PIXIE_TPU_TORCH_DEVICE=cpu``), answer
the CLI within a 60 s deadline. ``run --local`` runs on the CPU here
through the same variable.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time
import types
import urllib.request
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

import pixie_tpu.services as jax_services
from pixie_tpu.cli import main as jax_cli
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.services.netbus import BusServer as JaxBusServer
import pixie_tpu_torch.services as port_services
from pixie_tpu_torch import Engine
from pixie_tpu_torch.cli import main as port_cli
from pixie_tpu_torch.config import clear_flag, set_flag
from pixie_tpu_torch.scripts import list_scripts
from pixie_tpu_torch.services.netbus import BusServer

REPO = Path(__file__).resolve().parent.parent
AGENT_STATUS = "px/agent_status"
QUERY = """
import px
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(n=('latency_ns', px.count))
px.display(df)
"""
SEQ_QUERY = (
    "import px\n"
    "df = px.DataFrame(table='sequences')\n"
    "s = df.groupby('modulo10').agg(n=('x', px.count))\n"
    "px.display(s)\n"
)


def _run(cli, *argv, rc: int = 0) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        got = cli(list(argv))
    assert got == rc, buf.getvalue()
    return buf.getvalue()


@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setenv("PIXIE_TPU_TORCH_DEVICE", "cpu")


def test_script_list_and_show_match():
    assert _run(port_cli, "script", "list") == _run(jax_cli, "script", "list")
    for name in ("px/http_stats", "px/service_stats", AGENT_STATUS):
        assert _run(port_cli, "script", "show", name) == _run(
            jax_cli, "script", "show", name)


def test_docs_match():
    out = _run(port_cli, "docs")
    assert "## Scalar functions" in out
    assert out == _run(jax_cli, "docs")


@pytest.mark.parametrize(
    "name", [n for n in list_scripts() if n != AGENT_STATUS])
def test_explain_matches(name):
    assert _run(port_cli, "explain", name) == _run(jax_cli, "explain", name)


def test_explain_of_agent_status_fails_alike():
    """Offline explain has no service bus: both CLIs refuse the script's
    GetAgentStatus with the same message."""
    errs = []
    for cli in (port_cli, jax_cli):
        with pytest.raises(Exception) as e:
            _run(cli, "explain", AGENT_STATUS)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]


def _json_tables(out: str) -> dict:
    return {t["table"]: t["rows"] for t in map(json.loads, out.splitlines())}


def _same_rows(got: list, want: list, keys, loose=()) -> None:
    """Rows in any order: keys and integers exact, floats rtol 1e-5, the
    ``loose`` (t-digest quantile) columns rtol 0.05."""
    assert len(got) == len(want)
    order = lambda rows: sorted(rows, key=lambda r: tuple(r[k] for k in keys))
    for g, w in zip(order(got), order(want)):
        assert sorted(g) == sorted(w)
        for c in g:
            if isinstance(w[c], float):
                np.testing.assert_allclose(
                    g[c], w[c], rtol=0.05 if c in loose else 1e-5)
            else:
                assert g[c] == w[c], (c, g, w)


@pytest.mark.parametrize("script,keys", [
    ("px/http_stats", ("service", "req_path")),
    ("px/service_stats", ("service",)),
])
def test_run_local_synthetic_matches(cpu_device, script, keys):
    argv = ("run", script, "--local", "--synthetic", "4000", "-o", "json")
    got = _json_tables(_run(port_cli, *argv))
    want = _json_tables(_run(jax_cli, *argv))
    assert sorted(got) == sorted(want) == ["output"]
    _same_rows(got["output"], want["output"], keys, loose=("p50", "p99"))


def test_run_local_replay_matches(cpu_device, tmp_path):
    from pixie_tpu_torch.ingest.replay import save_npz

    path = str(tmp_path / "events.npz")
    save_npz(path, 3000, chunk=1024, seed=9)
    argv = ("run", "px/http_stats", "--local", "--replay", path,
            "-o", "json")
    _same_rows(_json_tables(_run(port_cli, *argv))["output"],
               _json_tables(_run(jax_cli, *argv))["output"],
               ("service", "req_path"))


def test_run_local_without_a_card_exits_non_zero(monkeypatch, capsys):
    import torch

    monkeypatch.delenv("PIXIE_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_cli(["run", "px/http_stats", "--local",
                     "--synthetic", "100"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("var,rc", [("PIXIE_TPU_SELF_PROFILING", 1),
                                    ("PIXIE_TPU_BROKER_HA", 1),
                                    ("PIXIE_TPU_LOCKDEP", 1)])
def test_deploy_options_of_later_slices(monkeypatch, capsys, var, rc):
    """Self-profiling, broker HA and lockdep are accepted: without a card
    the role then exits 1 on the device, and nothing is refused as a
    later slice."""
    import torch

    from pixie_tpu_torch import deploy

    monkeypatch.delenv("PIXIE_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("pixie_tpu_torch.services.crash.install",
                        lambda **kw: None)
    monkeypatch.setenv(var, "1")
    assert deploy.main(["pem"]) == rc
    err = capsys.readouterr().err
    assert ("not in this slice" in err) == (rc == 2), err


def test_profile_is_not_in_this_slice():
    """``profile`` came with the telemetry slice: on served clusters of
    both packages (no profiler runs in them) every form answers 0 with
    the JAX CLI's output."""
    outs = {}
    for name in ("port", "jax"):
        cli = PKGS[name].cli
        with _served(name) as (addr, _broker):
            outs[name] = [
                _run(cli, "profile", "--broker", addr),
                json.loads(_run(cli, "profile", "--broker", addr,
                                "-o", "json")),
                _run(cli, "profile", "--broker", addr, "--diff", "a", "b"),
            ]
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == {"agents": [], "stacks": []}


def _wait_for(pred, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)
    return True


PKGS = {
    "port": types.SimpleNamespace(
        services=port_services, server=BusServer, cli=port_cli,
        engine=lambda: Engine(window_rows=1024, device="cpu")),
    "jax": types.SimpleNamespace(
        services=jax_services, server=JaxBusServer, cli=jax_cli,
        engine=lambda: JaxEngine(window_rows=1024)),
}


@contextlib.contextmanager
def _served(pkg_name: str, secret: str = ""):
    """Two PEMs and a Kelvin behind a served broker and a BusServer."""
    pkg = PKGS[pkg_name]
    s = pkg.services
    bus = s.MessageBus()
    tracker = s.AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
    agents, broker, server = [], None, None
    try:
        rng = np.random.default_rng(0)
        for i in range(2):
            pem = s.PEMAgent(bus, f"pem-{i}", engine=pkg.engine(),
                             heartbeat_interval_s=0.05)
            agents.append(pem.start())
            n = 1500
            pem.append_data("http_events", {
                "time_": np.arange(n, dtype=np.int64),
                "latency_ns": rng.integers(1000, 1_000_000, n),
                "resp_status": rng.choice(np.array([200, 404]), n),
                "service": [f"svc-{(i + j) % 3}" for j in range(n)],
                "req_path": [f"/api/v{j % 2}/x" for j in range(n)],
            })
            pem._register()
        agents.append(s.KelvinAgent(bus, "kelvin-0", engine=pkg.engine(),
                                    heartbeat_interval_s=0.05).start())
        assert _wait_for(lambda: "http_events" in tracker.schemas())
        broker = s.QueryBroker(bus, tracker, secret=secret)
        broker.serve()
        server = pkg.server(bus, secret=secret)
        yield f"127.0.0.1:{server.port}", broker
    finally:
        if server is not None:
            server.close()
        if broker is not None:
            broker.close()
        for a in agents:
            a.stop()
        tracker.close()
        bus.close()


def _table_part(out: str) -> list:
    """The printed tables without the run's timing line."""
    return [ln for ln in out.splitlines() if not ln.startswith("[")]


def test_run_tables_agents_against_served_brokers(tmp_path):
    qfile = tmp_path / "q.pxl"
    qfile.write_text(QUERY)
    outs = {}
    for name in ("port", "jax"):
        cli = PKGS[name].cli
        with _served(name) as (addr, _broker):
            outs[name] = [
                _table_part(_run(cli, "run", str(qfile), "--broker", addr)),
                _run(cli, "run", "px/http_stats", "--broker", addr,
                     "-o", "json"),
                _run(cli, "tables", "--broker", addr).splitlines(),
                sorted(ln.split()[0] for ln in
                       _run(cli, "agents", "--broker", addr).splitlines()),
            ]
    port, jax = outs["port"], outs["jax"]
    assert port[0] == jax[0]
    assert "== output (3 rows) ==" in port[0]
    _same_rows(_json_tables(port[1])["output"],
               _json_tables(jax[1])["output"], ("service", "req_path"))
    assert port[2] == jax[2]
    assert port[3] == jax[3] == ["kelvin-0", "pem-0", "pem-1"]


def test_api_client_with_record_handlers():
    from pixie_tpu_torch.api import (
        Client, ScriptExecutionError, TableRecordHandler)

    rows_seen, done = [], []

    class Recorder(TableRecordHandler):
        def handle_record(self, record):
            rows_seen.append(record)

        def handle_done(self, table_name):
            done.append(table_name)

    with _served("port") as (addr, _broker):
        host, _, port = addr.rpartition(":")
        with Client(host, int(port)) as client:
            assert "px/http_stats" in client.list_scripts()
            assert "http_events" in client.schemas()
            assert sorted(a["agent_id"] for a in client.agents()) == [
                "kelvin-0", "pem-0", "pem-1"]
            out = client.execute_script(
                QUERY, handler_factory=lambda t: Recorder())
            assert sorted(out["output"]["service"]) == [
                "svc-0", "svc-1", "svc-2"]
            assert int(np.sum(out["output"]["n"])) == 3000
            assert sorted(out.agent_stats) == ["pem-0", "pem-1"]
            assert out.partial is False and out.qid
            assert len(rows_seen) == 3 and done == ["output"]
            assert {"service", "n"} == set(rows_seen[0])
            assert sum(r["n"] for r in rows_seen) == 3000
            assert all(isinstance(r["n"], int) for r in rows_seen)
            with pytest.raises(ScriptExecutionError, match="nope"):
                client.execute_script(
                    "import px\npx.display(px.DataFrame(table='nope'))")
            updates = []
            sub = client.stream_script(QUERY, updates.append,
                                       poll_interval_s=0.05)
            try:
                assert _wait_for(lambda: any("rows" in u for u in updates),
                                 timeout_s=10.0), updates
            finally:
                sub.cancel()
            first = next(u for u in updates if "rows" in u)
            assert int(np.sum(first["rows"]["n"])) == 3000


def test_secured_broker_refuses_an_unauthenticated_client():
    from pixie_tpu_torch.api import Client
    from pixie_tpu_torch.services.auth import sign_token
    from pixie_tpu_torch.services.netbus import RemoteBus

    with _served("port", secret="deploy-secret") as (addr, _broker):
        host, _, port = addr.rpartition(":")
        port = int(port)
        with pytest.raises(ConnectionError, match="auth"):
            RemoteBus(host, port, token=sign_token("wrong", "intruder"))
        set_flag("bus_secret", "wrong")
        try:
            with pytest.raises(ConnectionError, match="auth"):
                Client(host, port)
        finally:
            clear_flag("bus_secret")
        # No token at all: the server drops the connection before any op
        # reaches the broker's bus.
        rb = RemoteBus(host, port)
        with pytest.raises((TimeoutError, ConnectionError)):
            rb.request("broker.schemas", {}, timeout_s=0.5)
        rb.close()
        set_flag("bus_secret", "deploy-secret")
        try:
            with Client(host, port) as client:
                assert "http_events" in client.schemas()
            out = _run(port_cli, "run", "px/http_stats", "--broker", addr)
            assert "== output" in out
        finally:
            clear_flag("bus_secret")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_three_deploy_roles_answer_the_cli(tmp_path):
    """broker, a PEM with the seq-gen source and a Kelvin as processes on
    the CPU, with self-profiling asked for by its environment variable;
    the CLI runs the sequences group-by, lists the agents and prints the
    cluster profile, the API client gets the same counts, and the
    broker's HTTP surface answers, its trace view, profile and program
    registry included. The whole test has a 60 s deadline."""
    from pixie_tpu_torch.api import Client

    deadline = time.monotonic() + 60.0
    port, obs = _free_port(), _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(
        PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
        PIXIE_TPU_TORCH_DEVICE="cpu",
        PIXIE_TPU_NETBUS_PORT=str(port), PIXIE_TPU_OBS_PORT=str(obs),
        PIXIE_TPU_BROKER=f"127.0.0.1:{port}", PIXIE_TPU_SEQGEN="1",
        PIXIE_TPU_SELF_PROFILING="1",
    )
    qfile = tmp_path / "q.pxl"
    qfile.write_text(SEQ_QUERY)
    procs, logs = [], []
    try:
        for role, aid in (("broker", ""), ("pem", "pem-e2e"),
                          ("kelvin", "kelvin-e2e")):
            e = dict(env)
            if aid:
                e["PIXIE_TPU_AGENT_ID"] = aid
                e["PIXIE_TPU_OBS_PORT"] = "0"
            logs.append(open(tmp_path / f"{role}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pixie_tpu_torch.deploy", role],
                env=e, cwd=str(tmp_path), stdout=logs[-1],
                stderr=subprocess.STDOUT,
            ))

        def alive():
            for p, f in zip(procs, logs):
                if p.poll() is not None:
                    f.seek(0)
                    raise AssertionError(
                        f"role exited rc={p.returncode}: {f.read()[-2000:]}")

        client = None
        while client is None:
            alive()
            assert time.monotonic() < deadline, "broker never listened"
            try:
                client = Client("127.0.0.1", port, connect_timeout_s=1.0)
            except OSError:
                time.sleep(0.2)
        with client:
            while "sequences" not in client.schemas() or len(
                    client.agents()) < 2:
                alive()
                assert time.monotonic() < deadline, "schemas never arrived"
                time.sleep(0.2)
            r = subprocess.run(
                [sys.executable, "-m", "pixie_tpu_torch.cli", "run",
                 "--broker", f"127.0.0.1:{port}", "--timeout", "20",
                 str(qfile)],
                env=env, cwd=str(tmp_path), capture_output=True, text=True,
                timeout=max(1.0, deadline - time.monotonic()),
            )
            assert r.returncode == 0, r.stdout + r.stderr
            assert "== output (10 rows) ==" in r.stdout, r.stdout
            r = subprocess.run(
                [sys.executable, "-m", "pixie_tpu_torch.cli", "agents",
                 "--broker", f"127.0.0.1:{port}"],
                env=env, cwd=str(tmp_path), capture_output=True, text=True,
                timeout=max(1.0, deadline - time.monotonic()),
            )
            assert "pem-e2e" in r.stdout and "kelvin-e2e" in r.stdout, (
                r.stdout + r.stderr)
            # The seq-gen rows with x < 64 exist once pushed: the group-by's
            # counts sum to the count of the same rows without it.
            bounded = SEQ_QUERY.replace(
                "df = px.DataFrame(table='sequences')\n",
                "df = px.DataFrame(table='sequences')\ndf = df[df.x < 64]\n")
            grouped = client.execute_script(bounded)["output"]
            whole = client.execute_script(bounded.replace(
                "df.groupby('modulo10').agg", "df.agg"))["output"]
            assert sorted(grouped["modulo10"].tolist()) == list(range(10))
            assert int(np.sum(grouped["n"])) == int(whole["n"][0]) == 64
            r = subprocess.run(
                [sys.executable, "-m", "pixie_tpu_torch.cli", "profile",
                 "--broker", f"127.0.0.1:{port}", "-o", "json"],
                env=env, cwd=str(tmp_path), capture_output=True, text=True,
                timeout=max(1.0, deadline - time.monotonic()),
            )
            assert r.returncode == 0, r.stdout + r.stderr
            assert "broker" in json.loads(r.stdout)["agents"], r.stdout
        for path in ("/healthz", "/metrics", "/debug/tracez",
                     "/debug/pprof", "/debug/flamez", "/debug/programz"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{obs}{path}", timeout=5) as resp:
                assert resp.status == 200
        alive()
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        for f in logs:
            f.seek(0)
            text = f.read()
            f.close()
            assert "Traceback" not in text, text[-2000:]


def test_deploy_broker_under_ha_and_lockdep(tmp_path):
    """``deploy broker`` with ``PIXIE_TPU_BROKER_HA=1`` (as replica
    broker-7) and ``PIXIE_TPU_LOCKDEP=1`` on the CPU: it starts,
    ``/statusz`` carries the ``ha`` block (leader, epoch 1),
    ``api.Client.resolve_leader`` names it, and ``cli agents`` prints the
    replica's id as the JAX CLI prints it against a JAX replica. A 60 s
    deadline."""
    import pixie_tpu.services.broker_ha as jax_ha
    from pixie_tpu_torch.api import Client

    deadline = time.monotonic() + 60.0
    port, obs = _free_port(), _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(
        PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
        PIXIE_TPU_TORCH_DEVICE="cpu", PIXIE_TPU_NETBUS_PORT=str(port),
        PIXIE_TPU_OBS_PORT=str(obs), PIXIE_TPU_BROKER_HA="1",
        PIXIE_TPU_BROKER_ID="broker-7", PIXIE_TPU_LOCKDEP="1",
        PIXIE_TPU_SELF_PROFILING="0",
    )
    log = open(tmp_path / "broker.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pixie_tpu_torch.deploy", "broker"],
        env=env, cwd=str(tmp_path), stdout=log, stderr=subprocess.STDOUT)
    try:
        client = None
        while client is None:
            if proc.poll() is not None:
                log.seek(0)
                raise AssertionError(f"broker exited: {log.read()[-2000:]}")
            assert time.monotonic() < deadline, "broker never listened"
            try:
                client = Client("127.0.0.1", port, connect_timeout_s=1.0)
            except OSError:
                time.sleep(0.2)
        with client:
            lead = client.resolve_leader()
            assert (lead["broker"], lead["epoch"], lead["answered_by"]) == (
                "broker-7", 1, "broker-7")
            assert client.agents_status() == {"agents": [],
                                              "broker": "broker-7"}
        with urllib.request.urlopen(
                f"http://127.0.0.1:{obs}/statusz", timeout=5) as resp:
            ha = json.loads(resp.read())["ha"]
        assert ha["broker"] == "broker-7" and ha["role"] == "leader"
        assert ha["epoch"] >= 1 and ha["leader"] == "broker-7"
        port_out = _run(port_cli, "agents", "--broker", f"127.0.0.1:{port}")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        log.seek(0)
        text = log.read()
        log.close()
    assert "Traceback" not in text, text[-2000:]
    bus = jax_services.MessageBus()
    rep = jax_ha.BrokerReplica(bus, "broker-7", leader=True)
    server = JaxBusServer(bus)
    try:
        jax_out = _run(jax_cli, "agents", "--broker",
                       f"127.0.0.1:{server.port}")
    finally:
        server.close()
        rep.close()
        bus.close()
    assert port_out == jax_out == "broker: broker-7\n"
