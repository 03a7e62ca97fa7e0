"""The port's ingest edge (``pixie_tpu_torch/ingest/``) against the JAX
package's: the collector's push period, push threshold and thread; each
connector's published relation; ``SeqGenConnector``'s rows for the same
ticks; ``gen_http_events`` bit for bit and the npz round trip; and an
agent's own collector pushing into its engine.

Each scenario runs through both packages (a port ``Engine`` on the CPU,
a JAX ``Engine``) and the observables are held to each other.
"""

from __future__ import annotations

import time
import types

import numpy as np
import pytest

import pixie_tpu.ingest as jax_ingest
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.ingest import replay as jax_replay
import pixie_tpu_torch.ingest as port_ingest
from pixie_tpu_torch import Engine
from pixie_tpu_torch.ingest import replay as port_replay

PKGS = {
    "port": types.SimpleNamespace(ingest=port_ingest,
                                  engine=lambda: Engine(device="cpu")),
    "jax": types.SimpleNamespace(ingest=jax_ingest, engine=JaxEngine),
}
CONNECTORS = ("SeqGenConnector", "ProcessStatsConnector",
              "NetworkStatsConnector", "ProcStatConnector",
              "PIDRuntimeConnector", "ProcExitConnector",
              "StirlingErrorConnector")


def _rows(eng, table: str) -> dict:
    if table not in eng.tables:
        return {}
    return eng.tables[table].read_all().to_pydict()


def _push_period(pkg):
    """Sample every cycle, push only at flush: two transfers, one push."""
    ing = pkg.ingest
    e, col = pkg.engine(), ing.Collector()
    c = ing.SeqGenConnector(rows_per_transfer=10, sampling_period_s=0.0,
                            push_period_s=3600.0)
    c.push_freq.reset()  # start the push cycle (clocks begin expired)
    col.register_source(c)
    col.wire_to(e)
    col.run_core(once=True)
    col.run_core(once=True)
    before = len(_rows(e, "sequences").get("x", []))
    col.flush()
    d = _rows(e, "sequences")
    return before, d["x"].tolist(), d["fibonacci"].tolist(), dict(col.stats)


def _threshold(pkg):
    """A 150-row threshold forces a push on the second 100-row transfer."""
    ing = pkg.ingest
    e, col = pkg.engine(), ing.Collector()
    c = ing.SeqGenConnector(rows_per_transfer=100, sampling_period_s=0.0,
                            push_period_s=3600.0)
    c.push_freq.reset()
    col.register_source(c)
    col._data_tables["sequences"].push_threshold_rows = 150
    col.wire_to(e)
    col.run_core(once=True)
    first = col.stats["pushes"]
    col.run_core(once=True)
    return first, col.stats["pushes"], len(_rows(e, "sequences")["x"])


@pytest.mark.parametrize("scenario", [_push_period, _threshold],
                         ids=["push_period", "threshold"])
def test_collector_cycles_match(scenario):
    assert scenario(PKGS["port"]) == scenario(PKGS["jax"])


def test_run_as_thread_pushes_and_stops():
    col = port_ingest.Collector()
    eng = Engine(device="cpu")
    col.register_source(port_ingest.SeqGenConnector(
        rows_per_transfer=16, sampling_period_s=0.005, push_period_s=0.01))
    col.wire_to(eng)
    t = col.run_as_thread()
    deadline = time.monotonic() + 5.0
    while ("sequences" not in eng.tables
           or eng.tables["sequences"].num_rows < 32):
        assert time.monotonic() < deadline, col.stats
        time.sleep(0.01)
    col.stop()
    assert not t.is_alive()
    assert col.stats["transfer_calls"] >= 2 and col.stats["pushes"] >= 1
    n = eng.tables["sequences"].num_rows
    time.sleep(0.05)
    assert eng.tables["sequences"].num_rows == n  # stopped means stopped
    d = _rows(eng, "sequences")
    np.testing.assert_array_equal(d["linear"], 2 * d["x"] + 1)
    np.testing.assert_array_equal(d["modulo10"], d["x"] % 10)


@pytest.mark.parametrize("name", CONNECTORS)
def test_connector_relations_match(name):
    port = getattr(port_ingest, name)()
    jax = getattr(jax_ingest, name)()
    assert [t for t, _ in port.tables] == [t for t, _ in jax.tables]
    for (_, pr), (_, jr) in zip(port.tables, jax.tables):
        assert [(n, t.value) for n, t in pr.items()] == [
            (n, t.value) for n, t in jr.items()]
    assert (port.default_sampling_period_s, port.default_push_period_s) == (
        jax.default_sampling_period_s, jax.default_push_period_s)


@pytest.mark.parametrize("ticks", [1, 3, 40])
def test_seq_gen_rows_match_for_the_same_ticks(ticks):
    out = {}
    for k, pkg in PKGS.items():
        c = getattr(pkg.ingest, "SeqGenConnector")(rows_per_transfer=17)
        dt = pkg.ingest.DataTable("sequences", c.tables[0][1])
        for _ in range(ticks):
            c.transfer_data(None, {"sequences": dt})
        out[k] = dt.drain()
    for col in ("x", "linear", "modulo10", "square", "fibonacci"):
        np.testing.assert_array_equal(out["port"][col], out["jax"][col])
        assert out["port"][col].dtype == out["jax"][col].dtype
    assert len(out["port"]["time_"]) == 17 * ticks


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_gen_http_events_bit_equal(seed):
    kw = dict(chunk=700, seed=seed, n_services=5, n_pods=9, n_paths=6, t0=123)
    port = list(port_replay.gen_http_events(2000, **kw))
    jax = list(jax_replay.gen_http_events(2000, **kw))
    assert len(port) == len(jax) == 3
    for p, j in zip(port, jax):
        assert list(p) == list(j)
        for k in p:
            a, b = np.asarray(p[k]), np.asarray(j[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert [(n, t.value) for n, t in port_replay.HTTP_EVENTS_RELATION.items()] == [
        (n, t.value) for n, t in jax_replay.HTTP_EVENTS_RELATION.items()]


def test_npz_round_trip_and_replay_into(tmp_path):
    p = str(tmp_path / "replay.npz")
    port_replay.save_npz(p, 5000, chunk=2048, seed=5)
    chunks = list(port_replay.load_npz(p, chunk=1000))
    assert sum(len(c["resp_status"]) for c in chunks) == 5000
    want = list(jax_replay.gen_http_events(5000, chunk=2048, seed=5))
    for k in want[0]:
        got = np.concatenate([c[k] for c in chunks])
        np.testing.assert_array_equal(
            got, np.concatenate([np.asarray(w[k]) for w in want]))
    eng = Engine(device="cpu")
    eng.create_table("http_events", port_replay.HTTP_EVENTS_RELATION)
    assert port_replay.replay_into(eng, 3000, chunk=1024, seed=5) == 3000
    jeng = JaxEngine()
    jeng.create_table("http_events", jax_replay.HTTP_EVENTS_RELATION)
    jax_replay.replay_into(jeng, 3000, chunk=1024, seed=5)
    q = ("import px\ndf = px.DataFrame(table='http_events')\n"
         "df = df.groupby('service').agg(n=('resp_status', px.count),"
         " e=('resp_body_size', px.max))\npx.display(df, 'o')\n")
    got = eng.execute_query(q)["o"].to_pydict()
    ref = jeng.execute_query(q)["o"].to_pydict()
    og, orf = np.argsort(got["service"]), np.argsort(ref["service"])
    for c in ("service", "n", "e"):
        assert got[c][og].tolist() == ref[c][orf].tolist()


def test_agent_collector_pushes_into_its_engine():
    from pixie_tpu_torch.services import MessageBus, PEMAgent

    bus = MessageBus()
    pem = PEMAgent(bus, "pem-0", heartbeat_interval_s=0.05,
                   engine=Engine(device="cpu"))
    try:
        pem.collector.register_source(port_ingest.SeqGenConnector(
            rows_per_transfer=8, sampling_period_s=0.005,
            push_period_s=0.01))
        pem.start()
        eng = pem.engine
        deadline = time.monotonic() + 5.0
        while ("sequences" not in eng.tables
               or eng.tables["sequences"].num_rows < 24):
            assert time.monotonic() < deadline, pem.collector.stats
            time.sleep(0.01)
        out = eng.execute_query(
            "import px\ndf = px.DataFrame(table='sequences')\n"
            "px.display(df.agg(n=('x', px.count)), 'o')\n")["o"].to_pydict()
        assert int(out["n"][0]) >= 24
        assert "sequences" in pem._schemas()
    finally:
        pem.stop()
        bus.close()
    assert not pem.collector._thread.is_alive()
