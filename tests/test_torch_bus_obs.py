"""The transport tier's telemetry on the port: the ``__bus__`` fold
(``BusStatsCollector``), the tracker's merge of heartbeat summaries,
``/debug/busz`` and the shipped ``px/bus_health`` and ``px/rpc_latency``
scripts, against the JAX package's.

The cases of ``tests/test_bus_obs.py`` that this slice brings: ``__bus__``
rows on every participant of a CPU cluster, the cluster merge, a slow
subscriber's lag and queue high-water in ``px/bus_health``, request round
trips in ``px/rpc_latency`` (the repeats binding no new fragment), and
the fold's change cursor. The bus's own counters were ported with the
bus; the JAX file's fault-injection and overhead cases belong to later
slices and to the card.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from pixie_tpu.exec import Engine as JaxEngine
from pixie_tpu.services.msgbus import MessageBus as JaxMessageBus
from pixie_tpu.services.telemetry import (
    BusStatsCollector as JaxBusStatsCollector,
)
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.exec.programs import default_program_registry
from pixie_tpu_torch.ingest.schemas import TELEMETRY_SCHEMAS
from pixie_tpu_torch.scripts import load_script
from pixie_tpu_torch.services.msgbus import MessageBus
from pixie_tpu_torch.services.observability import ObservabilityServer
from pixie_tpu_torch.services.telemetry import BusStatsCollector


def _wait(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _drive(bus) -> None:
    """The same traffic on either package's bus: a published burst to a
    subscriber and a few request round trips."""
    got = threading.Event()
    seen = []

    def on(msg):
        seen.append(msg)
        if len(seen) == 10:
            got.set()

    bus.subscribe("obs.burst", on)
    bus.subscribe("svc.sum", lambda m: bus.publish(
        m["_reply_to"], {"sum": m["a"] + m["b"]}))
    for i in range(10):
        bus.publish("obs.burst", {"i": i})
    assert got.wait(5)
    for i in range(3):
        assert bus.request("svc.sum", {"a": i, "b": 1},
                           timeout_s=5.0)["sum"] == i + 1


class TestBusStatsCollector:
    def test_fold_rows_equal_jax(self):
        """The same traffic folds into the same ``__bus__`` keys and
        counts. Left out: ``time_`` and the latency quantiles (the
        host's clock)."""
        got = {}
        for name, bus, eng, coll in (
            ("port", MessageBus(), Engine(device="cpu"), BusStatsCollector),
            ("jax", JaxMessageBus(), JaxEngine(), JaxBusStatsCollector),
        ):
            try:
                _drive(bus)
                c = coll(eng, "a0", bus=bus)
                assert c.fold(end_ns=1, force=True) > 0
                rows: dict = {}
                for tb in eng.table_store.tablets("__bus__"):
                    for k, v in tb.read_all().to_pydict().items():
                        rows.setdefault(k, []).extend(
                            x.item() if isinstance(x, np.generic) else x
                            for x in v)
                keep = ("kind", "topic_class", "direction", "msgs", "errors",
                        "queue_high_water", "agent_id")
                got[name] = sorted(
                    tuple(rows[k][i] for k in keep)
                    for i in range(len(rows["kind"]))
                    if rows["topic_class"][i] in ("obs.burst", "svc.sum",
                                                  "local"))
            finally:
                bus.close()
        assert got["port"] == got["jax"]
        assert got["port"]

    def test_change_cursor_idle_appends_nothing(self):
        bus = MessageBus()
        try:
            _drive(bus)
            c = BusStatsCollector(Engine(device="cpu"), "a0", bus=bus)
            assert c.fold() > 0
            assert c.fold() == 0
            bus.publish("obs.more", {"x": 1})
            assert _wait(lambda: any(r["topic_class"] == "obs.more"
                                     for r in bus.stats.snapshot()))
            assert c.fold() >= 1
        finally:
            bus.close()

    def test_statsless_bus_folds_nothing(self):
        c = BusStatsCollector(Engine(device="cpu"), "a0", bus=None)
        assert c.fold(force=True) == 0


@pytest.fixture
def cluster():
    from pixie_tpu_torch.services import (
        AgentTracker, KelvinAgent, PEMAgent, QueryBroker)

    bus = MessageBus()
    tracker = AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
    pems = [PEMAgent(bus, f"pem-{i}", engine=Engine(device="cpu"),
                     heartbeat_interval_s=0.1).start() for i in range(2)]
    kelvin = KelvinAgent(bus, "kelvin-0", engine=Engine(device="cpu"),
                         heartbeat_interval_s=0.1).start()
    broker = None
    try:
        now = time.time_ns()
        rng = np.random.default_rng(5)
        for pem in pems:
            n = 500
            pem.append_data("http_events", {
                "time_": np.full(n, now, dtype=np.int64),
                "latency_ns": rng.integers(1000, 1_000_000, n),
                "resp_status": rng.choice(np.array([200, 404]), n),
                "service": [f"svc-{j % 3}" for j in range(n)],
            })
        for pem in pems:
            pem._register()
        assert _wait(lambda: len(tracker.schemas()) >= 1)
        broker = QueryBroker(bus, tracker)
        yield bus, tracker, pems, kelvin, broker
    finally:
        if broker is not None:
            broker.close()
        for a in pems + [kelvin]:
            a.stop()
        tracker.close()
        bus.close()


class TestClusterBusFold:
    def test_bus_rows_on_every_participant(self, cluster):
        bus, tracker, pems, kelvin, broker = cluster
        for agent in pems + [kelvin]:
            assert _wait(lambda a=agent: (
                a.engine.table_store.get_table("__bus__") is not None
                and a.engine.table_store.get_table("__bus__").num_rows > 0
            )), f"no __bus__ rows on {agent.agent_id}"

    def test_tracker_merges_heartbeat_summaries(self, cluster):
        """Heartbeats ride the shared bus: their publish count, summed
        over the three agents' latest summaries, reaches 3 once each
        agent has reported a heartbeat it sent."""
        bus, tracker, pems, kelvin, broker = cluster

        def heartbeats():
            t = tracker.bus_stats()
            return sum(r["msgs"] for r in t["merged"]
                       if (r["kind"], r["topic_class"], r["direction"])
                       == ("bus", "agent.heartbeat", "pub"))

        assert _wait(lambda: len(tracker.bus_stats()["agents"]) == 3
                     and heartbeats() >= 3)
        assert set(tracker.bus_stats()["agents"]) == {
            "pem-0", "pem-1", "kelvin-0"}

    def test_debug_busz_endpoint(self, cluster):
        bus, tracker, pems, kelvin, broker = cluster
        assert _wait(lambda: len(tracker.bus_stats()["agents"]) == 3)
        code, ctype, body = ObservabilityServer(
            busz_fn=broker.busz).handle("/debug/busz")
        assert code == 200 and ctype == "application/json"
        payload = json.loads(body)
        assert payload["scope"] == "cluster" and payload["merged"]
        assert set(payload["agents"]) == {"pem-0", "pem-1", "kelvin-0"}

    def test_bus_health_script_shows_slow_subscriber(self, cluster):
        bus, tracker, pems, kelvin, broker = cluster
        done = threading.Event()
        n_msgs, seen = 30, []

        def slow(msg):
            time.sleep(0.003)
            seen.append(msg)
            if len(seen) == n_msgs:
                done.set()

        bus.subscribe("soak.blast", slow)
        for i in range(n_msgs):
            bus.publish("soak.blast", {"i": i, "pad": "x" * 32})
        assert done.wait(10)
        assert _wait(lambda: any(r["topic_class"] == "soak.blast"
                                 for r in tracker.bus_stats()["merged"]))
        d = broker.execute_script(
            load_script("px/bus_health").pxl)["tables"]["output"].to_pydict()
        idx = [i for i, (tc, dr) in enumerate(zip(d["topic_class"],
                                                  d["direction"]))
               if tc == "soak.blast" and dr == "deliver"]
        assert idx, f"no soak.blast deliver row in {set(d['topic_class'])}"
        assert max(d["msgs"][i] for i in idx) >= n_msgs
        assert max(d["queue_high_water"][i] for i in idx) > 1
        assert max(float(d["lag_p99_ms"][i]) for i in idx) > 0.0
        assert {"pem-0", "pem-1"} <= set(d["agent_id"])
        # Repeats bind the same fragments: no new program record. The
        # heartbeat fold is frozen first so the ring does not grow in
        # between.
        for a in pems + [kelvin]:
            a.telemetry.bus_stats.fold = lambda *args, **kw: 0
        broker.execute_script(load_script("px/bus_health").pxl)
        before = default_program_registry().programz()["count"]
        res = broker.execute_script(load_script("px/bus_health").pxl)
        assert res["tables"]["output"].length > 0
        assert default_program_registry().programz()["count"] == before

    def test_rpc_latency_script(self, cluster):
        bus, tracker, pems, kelvin, broker = cluster
        bus.subscribe("svc.sum", lambda m: bus.publish(
            m["_reply_to"], {"sum": m["a"] + m["b"]}))
        for i in range(5):
            assert bus.request("svc.sum", {"a": i, "b": 1})["sum"] == i + 1
        assert _wait(lambda: any(r["kind"] == "rpc"
                                 for r in tracker.bus_stats()["merged"]))
        d = broker.execute_script(
            load_script("px/rpc_latency").pxl)["tables"]["output"].to_pydict()
        i = list(d["topic_class"]).index("local")
        assert d["requests"][i] >= 5
        assert float(d["rtt_p99_ms"][i]) > 0.0


def test_bus_relation_registered():
    cols = [c for c, _ in TELEMETRY_SCHEMAS["__bus__"].items()]
    assert cols[0] == "time_"
    for want in ("agent_id", "kind", "topic_class", "direction", "msgs",
                 "lag_p99_ms", "queue_high_water"):
        assert want in cols
