"""The port's framed-TCP netbus (``pixie_tpu_torch/services/netbus.py``)
and a port cluster whose PEMs are processes of their own.

Request and reply, subscriptions, ``busz`` and bearer tokens over a
``BusServer`` and ``RemoteBus`` clients; then two PEM worker processes
(this file run as a script, with ``PIXIE_TPU_TORCH_DEVICE=cpu``) dial an
in-process broker and Kelvin, and the cluster's answer equals a JAX
cluster's over the same rows (the query of ``tests/test_wire.py``'s
multi-process test). Every wait has a deadline; worker stderr goes to a
file.

Run as a worker: ``python tests/test_torch_netbus.py PORT AGENT_ID SEED
N_ROWS``. It appends a seeded http_events replay, starts a PEM agent on
a ``RemoteBus``, prints READY and serves until its stdin closes or it
gets SIGTERM.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
N_ROWS = 1500
QUERY = (
    "import px\n"
    "df = px.DataFrame(table='http_events')\n"
    "s = df.groupby('service').agg(\n"
    "    n=('latency_ns', px.count),\n"
    "    mean_lat=('latency_ns', px.mean),\n"
    ")\n"
    "px.display(s)\n"
)


def _rows(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "time_": np.arange(n, dtype=np.int64),
        "latency_ns": rng.integers(1000, 1_000_000, n),
        "resp_status": rng.choice(np.array([200, 200, 404, 500]), n),
        "service": [f"svc-{(seed + j) % 4}" for j in range(n)],
    }


def _worker(argv) -> int:
    import signal

    sys.path.insert(0, str(REPO))
    from pixie_tpu_torch import Engine
    from pixie_tpu_torch.deploy import env_device
    from pixie_tpu_torch.services.agent import PEMAgent
    from pixie_tpu_torch.services.netbus import RemoteBus

    port, agent_id, seed, n = int(argv[0]), argv[1], int(argv[2]), int(argv[3])
    bus = RemoteBus("127.0.0.1", port)
    pem = PEMAgent(bus, agent_id, heartbeat_interval_s=0.2,
                   engine=Engine(window_rows=1024, device=env_device()))
    pem.append_data("http_events", _rows(seed, n))
    pem.start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    print("READY", flush=True)
    threading.Thread(
        target=lambda: (sys.stdin.read(), stop.set()), daemon=True
    ).start()
    stop.wait()
    pem.stop()
    bus.close()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))

import pytest  # noqa: E402

from pixie_tpu_torch import Engine  # noqa: E402
from pixie_tpu_torch.services import (  # noqa: E402
    AgentTracker, KelvinAgent, MessageBus, QueryBroker)
from pixie_tpu_torch.services.auth import sign_token  # noqa: E402
from pixie_tpu_torch.services.msgbus import BusTimeout  # noqa: E402
from pixie_tpu_torch.services.netbus import (  # noqa: E402
    MAX_FRAME, BusServer, RemoteBus)


def _wait_for(pred, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)
    return True


@pytest.fixture
def served():
    bus = MessageBus()
    server = BusServer(bus)
    clients = []

    def dial(**kw):
        clients.append(RemoteBus("127.0.0.1", server.port, **kw))
        return clients[-1]

    try:
        yield bus, server, dial
    finally:
        for c in clients:
            c.close()
        server.close()
        bus.close()


def test_request_reply_both_ways(served):
    bus, _server, dial = served
    bus.subscribe("echo", lambda m: bus.publish(
        m["_reply_to"], {"ok": True, "x": m["x"] * 2}))
    rb = dial()
    assert rb.request("echo", {"x": 21}, timeout_s=5.0)["x"] == 42
    rb.subscribe("remote.echo", lambda m: rb.publish(
        m["_reply_to"], {"y": np.arange(m["n"])}))
    # The server subscribes on the broker's bus when the frame arrives.
    assert _wait_for(lambda: len(bus._subs.get("remote.echo", [])) == 1)
    rep = bus.request("remote.echo", {"n": 4}, timeout_s=5.0)
    assert rep["y"].tolist() == [0, 1, 2, 3]
    with pytest.raises(BusTimeout):
        rb.request("nobody.home", {}, timeout_s=0.2)


def test_subscriptions_fan_out_and_unsubscribe(served):
    bus, _server, dial = served
    a, b = dial(), dial()
    got_a, got_b = [], []
    sa = a.subscribe("t", got_a.append)
    b.subscribe("t", got_b.append)
    assert _wait_for(lambda: len(bus._subs.get("t", [])) == 2)
    bus.publish("t", {"v": 1})
    a.publish("t", {"v": 2})
    assert _wait_for(lambda: len(got_a) == 2 and len(got_b) == 2)
    assert sorted(m["v"] for m in got_b) == [1, 2]
    sa.unsubscribe()
    assert _wait_for(lambda: len(bus._subs.get("t", [])) == 1)
    bus.publish("t", {"v": 3})
    assert _wait_for(lambda: len(got_b) == 3)
    assert len(got_a) == 2


def test_busz_counts_frames_and_bytes(served):
    bus, server, dial = served
    rb = dial()
    got = []
    rb.subscribe("t", got.append)
    assert _wait_for(lambda: len(bus._subs.get("t", [])) == 1)
    for i in range(5):
        bus.publish("t", {"i": i, "pad": "x" * 100})
    assert _wait_for(lambda: len(got) == 5)
    (conn,) = server.busz()
    assert conn["peer"] == "anon" and conn["subscriptions"] == 1
    assert conn["frames_sent"] == 5 and conn["bytes_sent"] > 500
    assert conn["frames_recv"] >= 1 and conn["bytes_recv"] > 0
    z = rb.busz()
    assert sorted(z) == ["handler_errors_total", "queues", "recent_errors",
                         "rows"]
    assert z["handler_errors_total"] == 0
    assert MAX_FRAME == 1 << 30


_SOCKET_OPTIONS = (
    ("SOL_SOCKET", "SO_SNDTIMEO"), ("SOL_SOCKET", "SO_KEEPALIVE"),
    ("IPPROTO_TCP", "TCP_NODELAY"), ("IPPROTO_TCP", "TCP_KEEPIDLE"),
    ("IPPROTO_TCP", "TCP_KEEPINTVL"), ("IPPROTO_TCP", "TCP_KEEPCNT"),
)


def _socket_options(sock) -> dict:
    import socket

    out = {}
    for level, name in _SOCKET_OPTIONS:
        if hasattr(socket, name):
            out[name] = sock.getsockopt(getattr(socket, level),
                                        getattr(socket, name), 16)
    return out


def test_socket_options_equal_jax(served):
    """Both ends of a connection carry the JAX netbus's socket options
    (send timeout, keepalive and its probes, Nagle's algorithm left on),
    and ``_harden_socket`` sets what the JAX one sets."""
    import socket

    from pixie_tpu.services import netbus as jax_netbus
    from pixie_tpu_torch.services import netbus as port_netbus

    fresh = []
    try:
        for timeout_s in (1, 10):
            pair = [socket.socket(), socket.socket()]
            fresh += pair
            jax_netbus._harden_socket(pair[0], send_timeout_s=timeout_s)
            port_netbus._harden_socket(pair[1], send_timeout_s=timeout_s)
            assert _socket_options(pair[1]) == _socket_options(pair[0])
        bus, server, dial = served
        rb = dial()
        assert _wait_for(lambda: len(server._clients) == 1)
        want = _socket_options(fresh[0])
        del want["SO_SNDTIMEO"]  # each end's own timeout, checked above
        for sock in (rb.sock, server._clients[0].sock):
            got = _socket_options(sock)
            del got["SO_SNDTIMEO"]
            assert got == want
    finally:
        for sock in fresh:
            sock.close()


def test_token_accepted_and_refused():
    bus = MessageBus()
    server = BusServer(bus, secret="hunter2")
    try:
        ok = RemoteBus("127.0.0.1", server.port,
                       token=sign_token("hunter2", "tester"))
        try:
            got = []
            ok.subscribe("t", got.append)
            assert _wait_for(lambda: len(bus._subs.get("t", [])) == 1)
            bus.publish("t", {"v": 1})
            assert _wait_for(lambda: got == [{"v": 1}])
            assert server.busz()[0]["peer"] == "tester"
        finally:
            ok.close()
        with pytest.raises(ConnectionError, match="auth"):
            RemoteBus("127.0.0.1", server.port,
                      token=sign_token("wrong", "tester"))
        with pytest.raises(ConnectionError, match="auth"):
            RemoteBus("127.0.0.1", server.port, token="not-a-token")
        # No token at all: the server refuses the first frame and drops
        # the connection, so nothing the client publishes arrives.
        anon = RemoteBus("127.0.0.1", server.port, token="")
        seen = []
        bus.subscribe("leak", seen.append)
        try:
            anon.publish("leak", {"v": 1})
        except (ConnectionError, OSError):
            pass
        time.sleep(0.2)
        assert seen == []
        anon.close()
    finally:
        server.close()
        bus.close()


def _jax_cluster_answer(seeds, n):
    """The same two PEMs' rows through an in-process JAX cluster."""
    import pixie_tpu.services as js
    from pixie_tpu.exec.engine import Engine as JaxEngine

    bus = js.MessageBus()
    tracker = js.AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
    agents, broker = [], None
    try:
        for seed in seeds:
            pem = js.PEMAgent(bus, f"pem-{seed}", heartbeat_interval_s=0.05,
                              engine=JaxEngine(window_rows=1024))
            agents.append(pem.start())
            pem.append_data("http_events", _rows(seed, n))
            pem._register()
        agents.append(js.KelvinAgent(bus, "kelvin-0", heartbeat_interval_s=0.05,
                                     engine=JaxEngine()).start())
        assert _wait_for(lambda: "http_events" in tracker.schemas())
        broker = js.QueryBroker(bus, tracker)
        res = broker.execute_script(QUERY, timeout_s=60.0)
        return res["tables"]["output"].to_pydict()
    finally:
        if broker is not None:
            broker.close()
        for a in agents:
            a.stop()
        tracker.close()
        bus.close()


def test_cluster_of_pem_processes_matches_jax_cluster(tmp_path):
    bus = MessageBus()
    server = BusServer(bus)
    tracker = AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
    kelvin = KelvinAgent(bus, "kelvin-0", heartbeat_interval_s=0.2,
                         engine=Engine(device="cpu")).start()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), PIXIE_TPU_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    workers, errs, broker = [], [], None
    seeds = (0, 1)
    try:
        for seed in seeds:
            # stderr to a FILE: an undrained pipe would block the worker
            # before it registers.
            errs.append(open(tmp_path / f"pem-{seed}.err", "w+"))
            workers.append(subprocess.Popen(
                [sys.executable, __file__, str(server.port), f"pem-{seed}",
                 str(seed), str(N_ROWS)],
                env=env, cwd=str(tmp_path), stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL, stderr=errs[-1], text=True,
            ))
        deadline = time.monotonic() + 60.0
        while len(tracker.agent_ids()) < 3 or (
                "http_events" not in tracker.schemas()):
            for w, ef in zip(workers, errs):
                if w.poll() is not None:
                    ef.seek(0)
                    raise AssertionError(
                        f"worker died rc={w.returncode}: {ef.read()[-2000:]}")
            assert time.monotonic() < deadline, tracker.agent_ids()
            time.sleep(0.05)
        broker = QueryBroker(bus, tracker)
        res = broker.execute_script(QUERY, timeout_s=60.0)
        assert sorted(res["agent_stats"]) == ["pem-0", "pem-1"]
        got = res["tables"]["output"].to_pydict()
        want = _jax_cluster_answer(seeds, N_ROWS)
        og, ow = np.argsort(got["service"]), np.argsort(want["service"])
        assert got["service"][og].tolist() == want["service"][ow].tolist()
        assert got["n"][og].tolist() == want["n"][ow].tolist()
        np.testing.assert_allclose(got["mean_lat"][og], want["mean_lat"][ow],
                                   rtol=1e-5)
        assert int(np.sum(got["n"])) == len(seeds) * N_ROWS
        wire_in = sum(c["bytes_recv"] for c in server.busz())
        assert wire_in > 0
    finally:
        if broker is not None:
            broker.close()
        for w in workers:
            try:
                w.stdin.close()
                w.terminate()
                w.wait(timeout=10)
            except (OSError, subprocess.TimeoutExpired):
                w.kill()
                w.wait(timeout=10)
        for ef in errs:
            ef.seek(0)
            text = ef.read()
            ef.close()
            assert "Traceback" not in text, text[-2000:]
        kelvin.stop()
        tracker.close()
        server.close()
        bus.close()
