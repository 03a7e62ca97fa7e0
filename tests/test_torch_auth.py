"""Bearer-token auth on the port (``services/auth.py``, the netbus
connect gate and the broker API gate) against the JAX package's.

Each case of ``tests/test_auth.py`` runs on both packages and the two
runs' observations are compared: the token's claims and the errors it
raises, what a remote client sees at connect and on publish, and what
the broker's ``broker.execute`` answers with and without a token. A
token minted by one package verifies in the other (the two share the
wire format), and a client of one package connects to the other's
server. The broker cases wait for the PEM's table in the tracker before
they serve, and stop every agent afterwards.
"""

from __future__ import annotations

import contextlib
import time
import types

import numpy as np
import pytest

import pixie_tpu.services as jax_services
import pixie_tpu.services.auth as jax_auth
import pixie_tpu.services.netbus as jax_netbus
import pixie_tpu_torch.services as port_services
import pixie_tpu_torch.services.auth as port_auth
import pixie_tpu_torch.services.netbus as port_netbus
from pixie_tpu import config as jax_config
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu_torch import config as port_config
from pixie_tpu_torch.exec.engine import Engine

PKGS = {
    "port": types.SimpleNamespace(
        auth=port_auth, netbus=port_netbus, services=port_services,
        config=port_config, engine=lambda: Engine(device="cpu"),
    ),
    "jax": types.SimpleNamespace(
        auth=jax_auth, netbus=jax_netbus, services=jax_services,
        config=jax_config, engine=lambda: JaxEngine(),
    ),
}


@pytest.fixture(autouse=True)
def _no_ambient_secret():
    for p in PKGS.values():
        p.config.set_flag("bus_secret", "")
    yield
    for p in PKGS.values():
        p.config.set_flag("bus_secret", "")


def _both(fn):
    return {name: fn(p) for name, p in PKGS.items()}


def _wait_for(pred, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)
    return True


class TestTokens:
    def test_roundtrip_carries_subject_and_claims(self):
        def run(p):
            t = p.auth.sign_token("s3cret", "cli", claims={"role": "admin"})
            ctx = p.auth.verify_token("s3cret", t)
            assert ctx.subject == "cli"
            assert ctx.claims == {"role": "admin"}
            assert ctx.authenticated
            assert ctx.expiry_s > time.time()
            return (ctx.subject, ctx.claims, ctx.authenticated, t.count("."))

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_bad_signature_rejected(self):
        def run(p):
            t = p.auth.sign_token("s3cret", "cli")
            msgs = []
            for secret, tok in (("other", t), ("s3cret", t[:-4] + "0000")):
                with pytest.raises(p.auth.AuthError, match="signature") as ei:
                    p.auth.verify_token(secret, tok)
                msgs.append(str(ei.value))
            return msgs

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_expired_rejected(self):
        def run(p):
            t = p.auth.sign_token("s3cret", "cli", ttl_s=-1)
            with pytest.raises(p.auth.AuthError, match="expired") as ei:
                p.auth.verify_token("s3cret", t)
            return str(ei.value)

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_missing_token_rejected(self):
        def run(p):
            msgs = []
            for bad in (None, "", "garbage"):
                with pytest.raises(p.auth.AuthError) as ei:
                    p.auth.verify_token("s3cret", bad)
                msgs.append(str(ei.value))
            return msgs

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_disabled_auth_is_anonymous(self):
        def run(p):
            ctx = p.auth.verify_token("", "anything")
            assert ctx is p.auth.ANONYMOUS
            return (ctx.subject, ctx.authenticated)

        got = _both(run)
        assert got["port"] == got["jax"]

    @pytest.mark.parametrize("signer", ["jax", "port"])
    def test_token_from_one_package_verifies_in_the_other(self, signer):
        t = PKGS[signer].auth.sign_token("k", "svc", claims={"a": 1})
        for p in PKGS.values():
            ctx = p.auth.verify_token("k", t)
            assert (ctx.subject, ctx.claims) == ("svc", {"a": 1})
            with pytest.raises(p.auth.AuthError, match="signature"):
                p.auth.verify_token("other", t)


class TestNetbusAuth:
    def test_valid_token_connects_and_works(self):
        def run(p):
            bus = p.services.MessageBus()
            server = p.netbus.BusServer(bus, secret="hunter2")
            try:
                rb = p.netbus.RemoteBus(
                    "127.0.0.1", server.port,
                    token=p.auth.sign_token("hunter2", "worker"))
                got = []
                bus.subscribe("t", got.append)
                rb.publish("t", {"x": 1})
                assert _wait_for(lambda: got)
                rb.close()
                return got
            finally:
                server.close()
                bus.close()

        got = _both(run)
        assert got["port"] == got["jax"] == [{"x": 1}]

    def test_wrong_token_rejected_at_connect(self):
        def run(p):
            bus = p.services.MessageBus()
            server = p.netbus.BusServer(bus, secret="hunter2")
            try:
                with pytest.raises(ConnectionError, match="auth") as ei:
                    p.netbus.RemoteBus(
                        "127.0.0.1", server.port,
                        token=p.auth.sign_token("wrong", "worker"))
                return str(ei.value)
            finally:
                server.close()
                bus.close()

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_tokenless_client_cannot_reach_the_bus(self):
        def run(p):
            bus = p.services.MessageBus()
            server = p.netbus.BusServer(bus, secret="hunter2")
            try:
                got = []
                bus.subscribe("t", got.append)
                rb = p.netbus.RemoteBus("127.0.0.1", server.port)
                rb.publish("t", {"x": 1})  # dropped: closed on first op
                time.sleep(0.3)
                return got
            finally:
                server.close()
                bus.close()

        got = _both(run)
        assert got["port"] == got["jax"] == []

    def test_flag_supplies_secret_end_to_end(self):
        def run(p):
            p.config.set_flag("bus_secret", "flagged")
            bus = p.services.MessageBus()
            server = p.netbus.BusServer(bus)  # secret from the flag
            try:
                rb = p.netbus.RemoteBus("127.0.0.1", server.port)
                got = []
                bus.subscribe("t", got.append)
                rb.publish("t", {"ok": True})
                assert _wait_for(lambda: got)
                rb.close()
                return got
            finally:
                server.close()
                bus.close()
                p.config.set_flag("bus_secret", "")

        got = _both(run)
        assert got["port"] == got["jax"] == [{"ok": True}]

    @pytest.mark.parametrize("server_pkg", ["jax", "port"])
    def test_client_of_one_package_passes_the_others_gate(self, server_pkg):
        """The connect handshake is the same on both packages: a client
        with the right token gets through the other package's gate, and
        one with a wrong token is refused."""
        sp = PKGS[server_pkg]
        cp = PKGS["port" if server_pkg == "jax" else "jax"]
        bus = sp.services.MessageBus()
        server = sp.netbus.BusServer(bus, secret="hunter2")
        try:
            got = []
            bus.subscribe("t", got.append)
            rb = cp.netbus.RemoteBus("127.0.0.1", server.port,
                                     token=cp.auth.sign_token("hunter2", "w"))
            rb.publish("t", {"x": 2})
            assert _wait_for(lambda: got)
            rb.close()
            with pytest.raises(ConnectionError, match="auth"):
                cp.netbus.RemoteBus("127.0.0.1", server.port,
                                    token=cp.auth.sign_token("nope", "w"))
            assert got == [{"x": 2}]
        finally:
            server.close()
            bus.close()


QUERY = (
    "import px\ndf = px.DataFrame(table='t')\n"
    "s = df.groupby('v').agg(n=('v', px.count))\npx.display(s)"
)


@contextlib.contextmanager
def _broker(p, secret):
    s = p.services
    bus = s.MessageBus()
    tracker = s.AgentTracker(bus)
    broker = s.QueryBroker(bus, tracker, secret=secret)
    agents = []
    try:
        pem = s.PEMAgent(bus, agent_id="pem-0", engine=p.engine())
        pem.append_data("t", {
            "time_": np.arange(100, dtype=np.int64),
            "v": np.arange(100, dtype=np.int64) % 5,
        })
        agents.append(pem.start())
        kelvin = s.KelvinAgent(bus, agent_id="kelvin-0", engine=p.engine())
        agents.append(kelvin.start())
        # The PEM's own table in the tracker, and the Kelvin, before
        # serving: a plan made earlier would leave the PEM out.
        assert _wait_for(lambda: sum(
            a.has_table("t") for a in tracker.distributed_state().pems
        ) == 1 and tracker.distributed_state().kelvins)
        broker.serve()
        yield bus
    finally:
        broker.close()
        for a in agents:
            a.stop()
        tracker.close()
        bus.close()


def _counts(res):
    d = res["tables"]["output"].to_pydict()
    return sorted((int(v), int(n)) for v, n in zip(d["v"], d["n"]))


class TestBrokerAuth:
    def test_execute_requires_token(self):
        def run(p):
            with _broker(p, secret="brk") as bus:
                res = bus.request("broker.execute", {"query": QUERY},
                                  timeout_s=10)
            assert res["ok"] is False
            assert "AuthError" in res["error"]
            return res["error"]

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_execute_with_token_succeeds(self):
        def run(p):
            with _broker(p, secret="brk") as bus:
                res = bus.request(
                    "broker.execute",
                    {"query": QUERY,
                     "token": p.auth.sign_token("brk", "test")},
                    timeout_s=30,
                )
            assert res["ok"] is True
            assert "output" in res["tables"]
            return _counts(res)

        got = _both(run)
        assert got["port"] == got["jax"] == [(v, 20) for v in range(5)]

    def test_no_secret_means_open(self):
        def run(p):
            with _broker(p, secret="") as bus:
                res = bus.request("broker.execute", {"query": QUERY},
                                  timeout_s=30)
            assert res["ok"] is True
            return _counts(res)

        got = _both(run)
        assert got["port"] == got["jax"] == [(v, 20) for v in range(5)]
