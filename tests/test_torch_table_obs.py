"""The storage tier's telemetry on the port: the ``__tables__`` fold
(``TableStatsCollector``), its cluster merge through the shipped scripts,
``/debug/tablez``, and the deploy roles' profiler wiring, against the
JAX package's.

The cases of ``tests/test_table_obs.py`` that this slice brings: the
change-cursored fold per finished trace and the forced fold per
heartbeat, on the native ring and on the numpy one; ``px/table_health``
and ``px/ingest_lag`` merged across two PEMs whose watermarks differ by
2 s; and the broker's self-profiler behind the ``self_profiling`` flag,
which stops without leaking a thread. The table's own freshness counters
were ported with the storage tier.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from pixie_tpu.exec import Engine as JaxEngine
from pixie_tpu.services.telemetry import (
    enable_self_telemetry as jax_enable_self_telemetry,
)
from pixie_tpu_torch import config
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.ingest.schemas import TELEMETRY_SCHEMAS
from pixie_tpu_torch.scripts import load_script
from pixie_tpu_torch.services.observability import ObservabilityServer
from pixie_tpu_torch.services.telemetry import (
    TableStatsCollector,
    enable_self_telemetry,
)
from pixie_tpu_torch.table_store import table as tbl

W = 1 << 10


def _wait(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _t_rows(n: int, t0: int = 0, ts=None) -> dict:
    return {
        "time_": (np.arange(t0, t0 + n, dtype=np.int64) if ts is None
                  else np.full(n, ts, dtype=np.int64)),
        "v": np.arange(n, dtype=np.int64),
    }


@pytest.mark.parametrize("py_backend", [False, True],
                         ids=["native", "python"])
class TestTableStatsCollector:
    @pytest.fixture(autouse=True)
    def _backend(self, py_backend, monkeypatch):
        if py_backend:
            monkeypatch.setattr(tbl, "load_native", lambda name: None)

    def _engine(self):
        eng = Engine(window_rows=W, device="cpu")
        enable_self_telemetry(eng, agent_id="eng0")
        return eng

    def _read(self, eng, table="__tables__"):
        return eng.execute_query(
            f"import px\npx.display(px.DataFrame(table='{table}'))\n",
            max_output_rows=100_000,
        )["output"].to_pydict()

    def test_fold_rows_per_changed_table(self, py_backend):
        eng = self._engine()
        now = time.time_ns()
        eng.append_data("t", _t_rows(100, ts=now))
        assert eng.telemetry.table_stats.fold() >= 1
        d = self._read(eng)
        i = list(d["table"]).index("t")
        assert d["rows_total"][i] == 100
        assert d["watermark"][i] == now
        assert d["agent_id"][i] == "eng0"

    def test_change_cursor_idle_appends_nothing(self, py_backend):
        eng = self._engine()
        eng.append_data("t", _t_rows(10))
        assert eng.telemetry.table_stats.fold() >= 1
        assert eng.telemetry.table_stats.fold() == 0
        eng.append_data("t", _t_rows(10, t0=10))
        assert eng.telemetry.table_stats.fold() == 1

    def test_tables_table_itself_excluded(self, py_backend):
        eng = self._engine()
        eng.append_data("t", _t_rows(10))
        for _ in range(3):
            eng.telemetry.table_stats.fold()
        assert "__tables__" not in set(self._read(eng)["table"])

    def test_fold_runs_per_finished_trace(self, py_backend):
        eng = self._engine()
        eng.append_data("t", _t_rows(200, ts=time.time_ns()))
        eng.execute_query(
            "import px\ndf = px.DataFrame(table='t')\n"
            "df = df.groupby('v').agg(n=('v', px.count))\npx.display(df)\n"
        )
        assert "t" in set(self._read(eng)["table"])

    def test_trace_cadence_fold_skips_dunder_tables(self, py_backend):
        eng = self._engine()
        eng.append_data("t", _t_rows(10))
        for _ in range(3):
            eng.execute_query("import px\npx.display(px.DataFrame(table='t'))\n")
        assert set(self._read(eng)["table"]) == {"t"}
        assert eng.telemetry.table_stats.fold(force=True) > 1
        assert "__queries__" in set(self._read(eng)["table"])

    def test_fold_accepts_shared_snapshot(self, py_backend):
        eng = self._engine()
        eng.append_data("t", _t_rows(10))
        snap = eng.table_store.freshness()
        assert eng.telemetry.table_stats.fold(force=True, snapshot=snap) >= 1

    def test_collector_standalone_without_telemetry(self, py_backend):
        eng = Engine(window_rows=W, device="cpu")
        eng.append_data("t", _t_rows(10))
        assert TableStatsCollector(eng, agent_id="bare").fold() >= 1
        assert eng.table_store.get_table("__tables__") is not None


def test_tables_rows_equal_jax():
    """The same appends and folds give the JAX engine's ``__tables__``
    rows. Left out: ``time_`` (the fold's clock), ``last_append`` (the
    append's clock), ``ingest_rows_per_s`` (a rate over that clock) and
    ``device_bytes`` (the port stages its windows at its own window
    size; the JAX engine at its own)."""
    skip = {"time_", "last_append", "ingest_rows_per_s", "device_bytes"}
    got = {}
    for name, eng, enable in (
        ("port", Engine(window_rows=W, device="cpu"), enable_self_telemetry),
        ("jax", JaxEngine(window_rows=W), jax_enable_self_telemetry),
    ):
        enable(eng, agent_id="eng0")
        eng.append_data("t", _t_rows(100, ts=123_456_789))
        eng.telemetry.table_stats.fold(end_ns=1)
        eng.append_data("t", _t_rows(50, t0=200_000_000))
        eng.telemetry.table_stats.fold(end_ns=2)
        rows: dict = {}
        for tb in eng.table_store.tablets("__tables__"):
            for k, v in tb.read_all().to_pydict().items():
                rows.setdefault(k, []).extend(
                    x.item() if isinstance(x, np.generic) else x for x in v)
        got[name] = {k: v for k, v in rows.items() if k not in skip}
    assert got["port"] == got["jax"]
    assert got["port"]["rows_total"] == [100, 150]


@pytest.fixture
def cluster():
    from pixie_tpu_torch.services import (
        AgentTracker, KelvinAgent, MessageBus, PEMAgent, QueryBroker)

    bus = MessageBus()
    tracker = AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
    pems = [PEMAgent(bus, f"pem-{i}", engine=Engine(device="cpu"),
                     heartbeat_interval_s=0.1).start() for i in range(2)]
    kelvin = KelvinAgent(bus, "kelvin-0", engine=Engine(device="cpu"),
                         heartbeat_interval_s=0.1).start()
    now = time.time_ns()
    rng = np.random.default_rng(5)
    broker = None
    try:
        for i, pem in enumerate(pems):
            n = 1000 + 500 * i
            pem.append_data("http_events", {
                # pem-1's watermark trails pem-0's by 2 s.
                "time_": np.full(n, now - (2_000_000_000 * i),
                                 dtype=np.int64),
                "latency_ns": rng.integers(1000, 1_000_000, n),
                "resp_status": rng.choice(np.array([200, 404]), n),
                "service": [f"svc-{j % 3}" for j in range(n)],
            })
        for pem in pems:
            pem._register()
        assert _wait(lambda: len(tracker.schemas()) >= 1)
        broker = QueryBroker(bus, tracker)
        yield bus, tracker, pems, kelvin, broker, now
    finally:
        if broker is not None:
            broker.close()
        for a in pems + [kelvin]:
            a.stop()
        tracker.close()
        bus.close()


class TestClusterMerge:
    def test_distributed_scripts_cluster_merged(self, cluster):
        """px/table_health and px/ingest_lag through the broker: the
        watermark is the max across agents, counters sum, and pem-1
        trails by the injected 2 s; repeats bind no new fragment."""
        from pixie_tpu_torch.exec.programs import default_program_registry

        bus, tracker, pems, kelvin, broker, now = cluster
        assert _wait(lambda: all(
            p.engine.table_store.get_table("__tables__") is not None
            and p.engine.table_store.get_table("__tables__").num_rows > 0
            for p in pems))
        d = broker.execute_script(
            load_script("px/table_health").pxl)["tables"]["output"].to_pydict()
        tables = list(d["table"])
        i = tables.index("http_events")
        assert d["rows_total"][i] == 2500
        assert d["watermark"][i] == now
        assert d["agents"][i] == 2
        assert 1900 <= float(d["lag_spread_ms"][i]) <= 2100
        d = broker.execute_script(
            load_script("px/ingest_lag").pxl)["tables"]["output"].to_pydict()
        lag = {(t, a): float(x) for t, a, x in
               zip(d["table"], d["agent_id"], d["lag_ms"])}
        assert lag[("http_events", "pem-1")] - lag[
            ("http_events", "pem-0")] == pytest.approx(2000, abs=150)
        # The repeats bind the same fragments: no new program record.
        for name in ("px/table_health", "px/ingest_lag"):
            broker.execute_script(load_script(name).pxl)
        before = default_program_registry().programz()["count"]
        for name in ("px/table_health", "px/ingest_lag"):
            res = broker.execute_script(load_script(name).pxl)
            assert res["tables"]["output"].length > 0
        assert default_program_registry().programz()["count"] == before

    def test_debug_tablez_same_snapshot(self, cluster):
        bus, tracker, pems, kelvin, broker, now = cluster
        assert _wait(lambda: "http_events" in tracker.table_freshness())
        obs = ObservabilityServer(tablez_fn=lambda: {
            "scope": "cluster", "tables": tracker.table_freshness()})
        code, ctype, body = obs.handle("/debug/tablez")
        assert code == 200 and ctype == "application/json"
        payload = json.loads(body)
        f = payload["tables"]["http_events"]
        assert f["rows_total"] == 2500 and f["watermark"] == now

    def test_heartbeat_folds_every_table(self, cluster):
        """The heartbeat's forced fold writes a row per table, telemetry
        tables included, on every PEM."""
        bus, tracker, pems, kelvin, broker, now = cluster
        for p in pems:
            assert _wait(lambda p=p: {"http_events", "__queries__"} <= set(
                p.engine.table_store.get_table("__tables__").read_all()
                .to_pydict()["table"]))


class TestProfilerWiring:
    def test_flag_defaults_on(self):
        assert config.get_flag("self_profiling") is True
        assert config.get_flag("self_telemetry") is True

    def test_broker_self_profiler_off(self):
        from pixie_tpu_torch.deploy import _self_profiler

        with config.override_flag("self_profiling", False):
            assert _self_profiler("broker") == (None, None)

    def test_broker_self_profiler_collects_and_stops_clean(self):
        from pixie_tpu_torch.deploy import _self_profiler
        from pixie_tpu_torch.ingest.profiler import profile_summary

        before = {t.ident for t in threading.enumerate()}
        with config.override_flag("self_profiling", True):
            store, coll = _self_profiler("broker")
        assert store is not None
        try:
            # The 100 Hz sampler may not have taken a sample when the
            # first transfer runs (a loaded host), so transfer until it
            # has pushed rows, within the file's bounded wait.
            def pushed():
                for conn in coll._connectors:
                    conn.transfer_data(coll, coll._data_tables)
                coll.flush()
                t = store.get_table("stack_traces.beta")
                return t is not None and t.num_rows > 0

            _wait(pushed)
            t = store.get_table("stack_traces.beta")
            assert t is not None and t.num_rows > 0
            assert profile_summary(agent_id="broker", top=1)
        finally:
            coll.stop()
        assert _wait(lambda: not {
            t for t in threading.enumerate()
            if t.ident not in before and t.is_alive()})

    def test_agent_collector_profiler_shutdown_no_leak(self):
        from pixie_tpu_torch.ingest.collector import Collector
        from pixie_tpu_torch.ingest.profiler import PerfProfilerConnector

        eng = Engine(window_rows=W, device="cpu")
        before = {t.ident for t in threading.enumerate()}
        coll = Collector()
        coll.wire_to(eng)
        conn = PerfProfilerConnector(pod="test")
        conn.sampling_freq.period_s = 0.01
        conn.push_freq.period_s = 0.01
        coll.register_source(conn)
        coll.run_as_thread()

        def has_rows():
            t = eng.table_store.get_table("stack_traces.beta")
            return t is not None and t.num_rows > 0

        assert _wait(has_rows, timeout=5)
        coll.stop()
        assert _wait(lambda: not {
            t for t in threading.enumerate()
            if t.ident not in before and t.is_alive()})


def test_tables_relation_registered():
    cols = [c for c, _ in TELEMETRY_SCHEMAS["__tables__"].items()]
    assert cols[0] == "time_"
    for want in ("table", "agent_id", "rows_total", "watermark",
                 "expired_bytes_total", "ingest_rows_per_s"):
        assert want in cols
