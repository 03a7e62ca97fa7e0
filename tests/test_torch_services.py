"""Agent mode on the port (``services/``) against the JAX package's.

Each test of ``tests/test_services.py`` runs on a port cluster of CPU
engines (three PEMs and a Kelvin on one in-process bus, with a tracker
and a broker) and on a JAX cluster over the same seeded rows, and the
answers are held to each other and to numpy: keys, strings and integers
exactly, FLOAT64 at rtol 1e-5, t-digest quantiles at rtol 0.05. Then a
distributed live query against the JAX broker's, the trace stitching,
``px/agent_status``, the bus API and the tracepoint refusal.

Heartbeats run at 0.05 s; every wait is a poll with a deadline of 5 s
or less; every cluster stops its agents, tracker and broker and closes
its bus in a ``finally``.
"""

from __future__ import annotations

import contextlib
import json
import time
import types

import numpy as np
import pytest

from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.exec.engine import QueryError as JaxQueryError
from pixie_tpu.planner.objects import PxLError as JaxPxLError
import pixie_tpu.services as jax_services
from pixie_tpu_torch.exec.engine import Engine, QueryError
from pixie_tpu_torch.planner.objects import PxLError
import pixie_tpu_torch.services as port_services
from pixie_tpu_torch.scripts import load_script

FAST = dict(heartbeat_interval_s=0.05)
W = 1 << 10
N_PEMS = 3

PKGS = {
    "port": types.SimpleNamespace(
        services=port_services, QueryError=QueryError, PxLError=PxLError,
        engine=lambda: Engine(window_rows=W, device="cpu"),
        relation_mod="pixie_tpu_torch.types.relation",
        dtypes_mod="pixie_tpu_torch.types.dtypes",
    ),
    "jax": types.SimpleNamespace(
        services=jax_services, QueryError=JaxQueryError, PxLError=JaxPxLError,
        engine=lambda: JaxEngine(window_rows=W),
        relation_mod="pixie_tpu.types.relation",
        dtypes_mod="pixie_tpu.types.dtypes",
    ),
}


def _rows(i: int, n: int | None = None, off: int = 0):
    """PEM i's rows: unequal sizes, services in a per-PEM first-seen
    order (the dictionaries differ per agent)."""
    n = 2000 + 500 * i if n is None else n
    rng = np.random.default_rng(100 + i + off)
    return {
        "time_": np.arange(off, off + n, dtype=np.int64),
        "latency_ns": rng.integers(1000, 1_000_000, n),
        "resp_status": rng.choice(np.array([200, 200, 404, 500]), n),
        "service": [f"svc-{(i + j) % 4}" for j in range(n)],
    }


def _wait_for(pred, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)
    return True


@contextlib.contextmanager
def _cluster(pkg_name: str, n_pems: int = N_PEMS):
    pkg = PKGS[pkg_name]
    s = pkg.services
    bus = s.MessageBus()
    tracker = s.AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
    agents, broker = [], None
    try:
        pems = []
        for i in range(n_pems):
            pems.append(s.PEMAgent(bus, f"pem-{i}", engine=pkg.engine(), **FAST))
            agents.append(pems[-1].start())
        kelvin = s.KelvinAgent(bus, "kelvin-0", engine=pkg.engine(), **FAST)
        agents.append(kelvin.start())
        for i, pem in enumerate(pems):
            pem.append_data("http_events", _rows(i))
        # Re-register so the tracker sees the post-ingest schemas.
        for pem in pems:
            pem._register()
        assert _wait_for(lambda: "http_events" in tracker.schemas())
        broker = s.QueryBroker(bus, tracker)
        yield types.SimpleNamespace(
            bus=bus, tracker=tracker, pems=pems, kelvin=kelvin, broker=broker,
            pkg=pkg,
        )
    finally:
        if broker is not None:
            broker.close()
        for a in agents:
            a.stop()
        tracker.close()
        bus.close()


@pytest.fixture
def clusters():
    with _cluster("port") as port, _cluster("jax") as jax:
        yield port, jax


def _run(clusters, query, **kw):
    return [c.broker.execute_script(query, **kw) for c in clusters]


def _truth(pems):
    rows = [pem.engine.tables["http_events"].read_all().to_pydict()
            for pem in pems]
    return {c: np.concatenate([np.asarray(r[c]) for r in rows])
            for c in rows[0]}


def _sorted(batch, key):
    d = {k: np.asarray(v) for k, v in batch.to_pydict().items()}
    o = np.argsort(d[key].astype(str), kind="stable")
    return {k: v[o] for k, v in d.items()}


GROUPBY_MEAN = """import px
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(
    n=('latency_ns', px.count), avg=('latency_ns', px.mean))
px.display(df, 'out')
"""
COUNT = """import px
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(n=('resp_status', px.count))
px.display(df, 'o')
"""


class TestClusterQuery:
    def test_groupby_mean_across_agents(self, clusters):
        got, ref = _run(clusters, GROUPBY_MEAN)
        a = _sorted(got["tables"]["out"], "service")
        b = _sorted(ref["tables"]["out"], "service")
        np.testing.assert_array_equal(a["service"], b["service"])
        np.testing.assert_array_equal(a["n"], b["n"])
        np.testing.assert_allclose(a["avg"], b["avg"], rtol=1e-5)
        t = _truth(clusters[0].pems)
        for s, n, avg in zip(a["service"], a["n"], a["avg"]):
            mask = t["service"] == s
            assert n == int(mask.sum())
            # The true global mean (a mean of means would be off).
            np.testing.assert_allclose(avg, t["latency_ns"][mask].mean(),
                                       rtol=1e-5)

    def test_quantile_digest_merge_across_agents(self, clusters):
        q = ("import px\ndf = px.DataFrame(table='http_events')\n"
             "df = df.agg(p=('latency_ns', px.quantiles))\n"
             "px.display(df, 'out')\n")
        got, ref = _run(clusters, q, timeout_s=60.0)
        pg = json.loads(got["tables"]["out"].to_pydict()["p"][0])
        pr = json.loads(ref["tables"]["out"].to_pydict()["p"][0])
        lat = _truth(clusters[0].pems)["latency_ns"]
        for f, qq in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
            np.testing.assert_allclose(pg[f], pr[f], rtol=0.05)
            np.testing.assert_allclose(pg[f], np.quantile(lat, qq), rtol=0.05)

    def test_filter_rows_gather(self, clusters):
        q = ("import px\ndf = px.DataFrame(table='http_events')\n"
             "df = df[df.resp_status == 500]\npx.display(df, 'errs')\n")
        got, ref = _run(clusters, q, max_output_rows=100_000)
        a = _sorted(got["tables"]["errs"], "time_")
        b = _sorted(ref["tables"]["errs"], "time_")
        assert a.keys() == b.keys()
        for c in a:
            np.testing.assert_array_equal(np.sort(a[c].astype(str)),
                                          np.sort(b[c].astype(str)), c)
        truth = int((_truth(clusters[0].pems)["resp_status"] == 500).sum())
        assert len(a["resp_status"]) == truth
        assert got["distributed_plan"].n_data_shards == 3
        assert ref["distributed_plan"].n_data_shards == 3

    def test_agent_stats_reported(self, clusters):
        got, ref = _run(clusters, COUNT)
        assert set(got["agent_stats"]) == set(ref["agent_stats"]) == {
            "pem-0", "pem-1", "pem-2"}
        # The merge's own record races the end of the stream: when it
        # lands in time it is the Kelvin's.
        assert set(got["merge_stats"]) <= {"kelvin-0"}
        assert set(ref["merge_stats"]) <= {"kelvin-0"}
        for aid, st in got["agent_stats"].items():
            u, ju = st["usage"], ref["agent_stats"][aid]["usage"]
            assert u.keys() == ju.keys()
            assert u["rows_in"] == ju["rows_in"] == \
                clusters[0].pems[int(aid[-1])].engine.tables[
                    "http_events"].num_rows
            assert u["wire_bytes"] > 0


class TestElasticity:
    def test_dead_agent_expires_and_query_replans(self, clusters):
        answers = []
        for c in clusters:
            c.pems[2].stop()  # dies silently
            c.tracker.expiry_s = 0.1
            expired = []
            assert _wait_for(
                lambda: expired.extend(c.tracker.expire_silent())
                or "pem-2" in expired
            )
            assert "pem-0" not in expired  # still heartbeating
            res = c.broker.execute_script(COUNT)
            assert res["distributed_plan"].n_data_shards == 2
            answers.append(_sorted(res["tables"]["o"], "service"))
        truth = sum(clusters[0].pems[i].engine.tables["http_events"].num_rows
                    for i in range(2))
        assert int(answers[0]["n"].sum()) == truth
        np.testing.assert_array_equal(answers[0]["n"], answers[1]["n"])
        np.testing.assert_array_equal(answers[0]["service"],
                                      answers[1]["service"])

    def test_forced_expiry_replans_onto_survivors(self, clusters):
        got = []
        for c in clusters:
            c.pems[1].stop()  # a live agent would re-register at once
            assert c.tracker.force_expire("pem-1")
            res = c.broker.execute_script(COUNT)
            assert res["distributed_plan"].n_data_shards == 2
            assert set(res["agent_stats"]) == {"pem-0", "pem-2"}
            got.append(_sorted(res["tables"]["o"], "service"))
        np.testing.assert_array_equal(got[0]["n"], got[1]["n"])

    def test_reregister_after_expiry(self, clusters):
        for c in clusters:
            with c.tracker._lock:
                del c.tracker._agents["pem-0"]  # simulate expiry
            # The next heartbeat gets a reregister nudge.
            assert _wait_for(lambda: "pem-0" in c.tracker.agent_ids())

    def test_no_table_anywhere_fails(self, clusters):
        for c in clusters:
            with pytest.raises(c.pkg.PxLError):
                c.broker.execute_script(
                    "import px\ndf = px.DataFrame(table='nonexistent')\n"
                    "px.display(df, 'o')\n"
                )
            rel_mod = __import__(c.pkg.relation_mod, fromlist=["Relation"])
            dt_mod = __import__(c.pkg.dtypes_mod, fromlist=["DataType"])
            with c.tracker._lock:
                for rec in c.tracker._agents.values():
                    rec.schemas.setdefault("ghost_table", rel_mod.Relation(
                        [("time_", dt_mod.DataType.TIME64NS)]))
            # Schemas known, but no live agent holds the table.
            with pytest.raises(c.pkg.QueryError):
                c.broker.execute_script(
                    "import px\ndf = px.DataFrame(table='ghost_table')\n"
                    "px.display(df, 'o')\n"
                )


class TestForwarder:
    def test_error_propagates_in_band(self, clusters):
        msgs = []
        for c in clusters:
            # Sabotage one PEM so its fragment fails at execution time.
            c.pems[1].engine.registry = None
            with pytest.raises(c.pkg.QueryError) as ei:
                c.broker.execute_script(COUNT)
            assert "pem-1" in str(ei.value)
            msgs.append(str(ei.value).split(":")[0])
        assert msgs[0] == msgs[1] == "pem-1"

    def test_watchdog_timeout_cancels(self, clusters):
        for c in clusters:
            c.kelvin.stop()  # merge tier dead -> no results ever
            t0 = time.monotonic()
            with pytest.raises(c.pkg.services.QueryTimeout):
                c.broker.execute_script(COUNT, timeout_s=0.5)
            assert time.monotonic() - t0 < 5.0


def test_distributed_live_query_matches_jax(clusters):
    """A live ``px/service_stats``-shaped aggregate: its first update and,
    after one more append on every PEM, its last update equal the JAX
    broker's and the one-shot answer. One-shot queries run on the same
    engines meanwhile (each PEM's fragment beside its live poll)."""
    ups = {"port": [], "jax": []}
    handles = []
    try:
        for name, c in zip(("port", "jax"), clusters):
            handles.append(c.broker.execute_script_streaming(
                GROUPBY_MEAN, ups[name].append, poll_interval_s=0.05))
        total0 = sum(2000 + 500 * i for i in range(N_PEMS))

        def last_n(name):
            batches = [u for u in ups[name] if "batch" in u]
            return int(np.sum(batches[-1]["batch"].to_pydict()["n"])) \
                if batches else -1

        for name in ups:
            assert _wait_for(lambda: last_n(name) == total0), ups[name][-1:]
        for c in clusters:
            for i, pem in enumerate(c.pems):
                pem.append_data("http_events", _rows(i, n=700, off=50_000))
        # One-shot queries beside the live polls.
        one_shot = [c.broker.execute_script(GROUPBY_MEAN) for c in clusters]
        total1 = total0 + 700 * N_PEMS
        for name in ups:
            assert _wait_for(lambda: last_n(name) == total1), ups[name][-1:]
        finals = []
        for name, res in zip(("port", "jax"), one_shot):
            last = [u for u in ups[name] if "batch" in u][-1]
            assert last["mode"] == "replace"
            assert not [u for u in ups[name] if "error" in u]
            finals.append(_sorted(last["batch"], "service"))
        c2 = [c.broker.execute_script(GROUPBY_MEAN) for c in clusters]
        for res in c2:
            ref = _sorted(res["tables"]["out"], "service")
            np.testing.assert_array_equal(finals[0]["n"], ref["n"])
            np.testing.assert_allclose(finals[0]["avg"], ref["avg"], rtol=1e-5)
        np.testing.assert_array_equal(finals[0]["n"], finals[1]["n"])
        np.testing.assert_allclose(finals[0]["avg"], finals[1]["avg"],
                                   rtol=1e-5)
        assert int(np.sum(_sorted(one_shot[0]["tables"]["out"],
                                  "service")["n"])) in (total0, total1)
    finally:
        for h in handles:
            h.cancel()


def test_distributed_trace_is_one_trace():
    with _cluster("port") as c:
        res = c.broker.execute_script(COUNT)
        tr = c.broker.tracer.last()
        assert tr.qid == res["qid"] and tr.kind == "distributed"
        names = {s.name for s in tr.spans}
        assert {"query", "compile", "dispatch"} <= names
        dispatch = next(s for s in tr.spans if s.name == "dispatch")
        for pem in c.pems:
            ft = pem.engine.tracer.last()
            assert ft.kind == "fragment" and ft.qid == res["qid"]
            assert ft.trace_id == tr.trace_id
            assert ft.root.parent_id == dispatch.span_id
        mt = c.kelvin.engine.tracer.last()
        assert mt.kind == "merge" and mt.trace_id == tr.trace_id
        rows = sum(p.engine.tables["http_events"].num_rows for p in c.pems)
        assert rows <= tr.usage.rows_in == sum(
            u["rows_in"] for u in tr.agent_usage.values())
        assert {"pem-0", "pem-1", "pem-2"} <= set(tr.agent_usage) <= {
            "pem-0", "pem-1", "pem-2", "kelvin-0"}
        assert tr.usage.wire_bytes == sum(
            u["wire_bytes"] for u in tr.agent_usage.values()) > 0


def test_agent_status_matches_jax(clusters):
    pxl = load_script("px/agent_status").pxl
    got, ref = _run(clusters, pxl)
    (gt,) = got["tables"].values()
    (rt,) = ref["tables"].values()
    a, b = _sorted(gt, "agent_id"), _sorted(rt, "agent_id")
    for c in ("agent_id", "kind"):
        np.testing.assert_array_equal(a[c], b[c], c)
    assert list(a["agent_id"]) == ["kelvin-0", "pem-0", "pem-1", "pem-2"]
    # Both packages' agents hold their self-telemetry tables.
    np.testing.assert_array_equal(a["num_tables"], b["num_tables"])
    assert (a["last_heartbeat_s"] < 3 * FAST["heartbeat_interval_s"] + 1.0).all()


def test_served_bus_api_matches_execute_script():
    with _cluster("port") as c:
        c.broker.serve()
        reply = c.bus.request("broker.execute", {"query": COUNT},
                              timeout_s=5.0)
        assert reply["ok"], reply
        direct = c.broker.execute_script(COUNT)
        a = _sorted(reply["tables"]["o"], "service")
        b = _sorted(direct["tables"]["o"], "service")
        np.testing.assert_array_equal(a["n"], b["n"])
        agents = c.bus.request("broker.agents", {}, timeout_s=5.0)["agents"]
        assert len(agents) == N_PEMS + 1
        assert "http_events" in c.bus.request(
            "broker.schemas", {}, timeout_s=5.0)["schemas"]
        bad = c.bus.request("broker.execute", {"query": "import nope"},
                            timeout_s=5.0)
        assert not bad["ok"] and "Error" in bad["error"]


def test_tracepoint_answered_not_in_this_slice():
    """A deployment on a symbol no PEM registered is answered FAILED by
    both packages' agents, with the same error text."""
    import pixie_tpu.trace.spec as jax_spec
    import pixie_tpu_torch.trace.spec as port_spec

    answers = {}
    for name, spec in (("jax", jax_spec), ("port", port_spec)):
        with _cluster(name, n_pems=1) as c:
            got = []
            c.bus.subscribe("tracepoint.status", got.append)
            dep = spec.TracepointDeployment(
                name="tp", table_name="calls", probe=spec.ProbeDef(
                    target="no.such.symbol",
                    outputs=(("x", spec.TraceExpr("arg", "x")),)))
            c.bus.publish("agent.pem-0.tracepoint", {"deployment": dep})
            assert _wait_for(lambda: got)
            answers[name] = got[0]
            assert "calls" not in c.tracker.schemas()
    assert answers["port"] == answers["jax"]
    assert answers["port"]["state"] == "FAILED"
    assert answers["port"]["name"] == "tp"
    assert "no traceable target registered for symbol 'no.such.symbol'" in (
        answers["port"]["error"])


def test_cancel_query_of_an_unknown_qid():
    with _cluster("port", n_pems=1) as c:
        assert c.broker.cancel_query("nope") is False
        res = c.broker.execute_script(COUNT)
        assert not res["partial"]


def test_concurrent_queries_on_one_engine():
    """One engine serves queries from many threads at once (an agent's
    one-shot fragment beside its live query's poll): each answer equals
    the serial one, each query gets its own trace and stats, and no
    trace is left in flight. A shortened switch interval interleaves the
    threads often."""
    import sys
    import threading

    eng = Engine(window_rows=W, device="cpu")
    for i in range(N_PEMS):
        eng.append_data("http_events", _rows(i))
    join_q = (
        "import px\ndf = px.DataFrame(table='http_events')\n"
        "agg = df.groupby('service').agg(n=('resp_status', px.count))\n"
        "j = df.merge(agg, how='inner', left_on=['service'],"
        " right_on=['service'], suffixes=['', '_a'])\n"
        "px.display(j.groupby('service').agg(m=('n', px.max)), 'o')\n"
    )
    queries = {"count": COUNT, "join": join_q}
    want = {k: _sorted(eng.execute_query(q)["o"], "service")
            for k, q in queries.items()}
    errors, stats = [], []

    def worker(k):
        try:
            for _ in range(3):
                got = _sorted(eng.execute_query(queries[k])["o"], "service")
                for c in want[k]:
                    np.testing.assert_array_equal(got[c], want[k][c])
                stats.append(eng.last_stats)
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in ("count", "join") * 6]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert len(stats) == 36
    assert not eng.tracer.in_flight()
    assert all(t["status"] == "ok" for t in eng.tracer.recent())
