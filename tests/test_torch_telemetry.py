"""The port's self-telemetry (``pixie_tpu_torch/services/telemetry.py``)
against the JAX package's.

The same seeded table and scripts run on a CPU port engine and on the
JAX engine, each with ``enable_self_telemetry``; their ``__queries__``,
``__spans__`` and ``__agents__`` rows are held to each other field by
field, leaving out only what cannot agree (named at each comparison);
the cases of ``tests/test_telemetry.py`` (the fold, the bundled
self-monitoring scripts, the planner feedback) hold on the port; the
fold reads no tensor; and the heartbeat with its profile summary and the
``telemetry.spans`` message cross the wire codec with the JAX codec's
bytes.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import pytest
import torch

from pixie_tpu import config as jax_config
from pixie_tpu.exec import Engine as JaxEngine
from pixie_tpu.services import wire as jax_wire
from pixie_tpu.services.telemetry import (
    enable_self_telemetry as jax_enable_self_telemetry,
)
from pixie_tpu_torch import config
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.ingest.schemas import TELEMETRY_SCHEMAS
from pixie_tpu_torch.scripts import load_script
from pixie_tpu_torch.services import wire
from pixie_tpu_torch.services.telemetry import (
    TOPIC_SPANS,
    TelemetryCollector,
    _span_summaries,
    enable_self_telemetry,
)

W = 1 << 10

AGG_Q = (
    "import px\n"
    "df = px.DataFrame(table='t')\n"
    "df = df.groupby('k').agg(n=('v', px.count), s=('v', px.sum))\n"
    "px.display(df)\n"
)
FILTER_Q = AGG_Q.replace("df = df.groupby", "df = df[df.v > 500]\n"
                         "df = df.groupby")
BAD_Q = "import px\npx.display(px.DataFrame(table='nope'))\n"


def _rows(n: int = 3 * W + 7) -> dict:
    rng = np.random.default_rng(3)
    return {
        "time_": np.arange(n, dtype=np.int64),
        "k": rng.integers(0, 11, n),
        "v": rng.integers(0, 1000, n),
    }


def _mk_engine(telemetry: bool = True) -> Engine:
    eng = Engine(window_rows=W, device="cpu")
    eng.append_data("t", _rows())
    if telemetry:
        enable_self_telemetry(eng, agent_id="eng0")
    return eng


def _mk_jax_engine() -> JaxEngine:
    eng = JaxEngine(window_rows=W)
    eng.append_data("t", _rows())
    jax_enable_self_telemetry(eng, agent_id="eng0")
    return eng


def _table(eng, name: str) -> dict:
    """Every row of a table, read off its tablets (no query: reading
    through a query would fold one more trace)."""
    out: dict = {}
    for tb in eng.table_store.tablets(name):
        for k, v in tb.read_all().to_pydict().items():
            out.setdefault(k, []).extend(
                x.item() if isinstance(x, np.generic) else x for x in v)
    return out


def _pydict(eng, table, max_rows=10_000):
    out = eng.execute_query(
        f"import px\npx.display(px.DataFrame(table='{table}'))\n",
        max_output_rows=max_rows,
    )
    return out["output"].to_pydict()


def _history(eng) -> None:
    """Two scripts and one that fails at compile."""
    eng.execute_query(AGG_Q)
    eng.execute_query(FILTER_Q)
    with pytest.raises(Exception):
        eng.execute_query(BAD_Q)


@pytest.fixture(scope="module")
def histories():
    port, jax = _mk_engine(), _mk_jax_engine()
    _history(port)
    _history(jax)
    return port, jax


class TestRowsAgainstJax:
    def test_tables_have_the_jax_columns(self, histories):
        port, jax = histories
        for name in ("__queries__", "__spans__", "__agents__"):
            p = port.table_store.relation(name)
            j = jax.table_store.relation(name)
            assert [(n, t.name) for n, t in p.items()] == [
                (n, t.name) for n, t in j.items()], name

    def test_queries_rows_equal(self, histories):
        """Left out: ``time_`` and ``trace_id`` (clock and random ids);
        ``duration_ms``, ``device_ms``, ``compile_ms``, ``stall_ms``
        (timings); ``freshness_lag_ms`` (the clock at scan);
        ``bytes_staged`` (the port stages a partial tail window at its
        first query, the JAX engine at append); ``windows`` (the port
        prunes reads at its window size, ROADMAP C). ``device_peak_bytes``
        is compared: a CPU port engine's None folds as the JAX CPU
        engine's 0."""
        port, jax = histories
        skip = {"time_", "trace_id", "duration_ms", "device_ms",
                "compile_ms", "stall_ms", "freshness_lag_ms",
                "bytes_staged", "windows"}
        p, j = _table(port, "__queries__"), _table(jax, "__queries__")
        assert len(p["script_hash"]) == len(j["script_hash"]) == 3
        for col in j:
            if col not in skip:
                assert p[col] == j[col], col
        assert p["status"] == ["ok", "ok", "error"]
        assert p["rows_out"] == [11, 11, 0]

    def test_spans_rows_equal(self, histories):
        """Left out: the sampled ``window.<stage>`` spans (the port's
        stages are read/stage/compute/finalize, the JAX engine's
        stall/compute/finalize/materialize), ids and timings. The query,
        compile and fragment spans agree in name, count, parent
        structure and agent."""
        port, jax = histories

        def shape(eng):
            d = _table(eng, "__spans__")
            ids = {}
            rows = []
            for i, name in enumerate(d["name"]):
                if name.startswith("window."):
                    continue
                ids[d["span_id"][i]] = name
                rows.append((d["trace_id"][i], name, d["parent_id"][i],
                             d["agent_id"][i]))
            by_trace: dict = {}
            for tid, name, parent, agent in rows:
                by_trace.setdefault(tid, []).append(
                    (name, ids.get(parent, ""), agent))
            return list(by_trace.values())

        assert shape(port) == shape(jax)
        assert shape(port)[0] == [("query", "", "eng0"),
                                  ("compile", "query", "eng0"),
                                  ("fragment", "query", "eng0")]

    def test_agents_rows_equal(self, histories):
        """Left out: ``time_``, ``device_ms_total`` (timings) and
        ``bytes_staged_total`` (the staged tail window, as above)."""
        port, jax = histories
        p, j = _table(port, "__agents__"), _table(jax, "__agents__")
        for col in ("agent_id", "kind", "queries_total", "errors_total",
                    "wire_bytes_total"):
            assert p[col] == j[col], col
        assert p["queries_total"] == [1, 2, 3]
        assert p["errors_total"] == [0, 0, 1]

    def test_observed_equal(self, histories):
        port, jax = histories
        assert port.telemetry.observed() == jax.telemetry.observed()
        assert port.telemetry.totals()["queries"] == 3


class TestCollectorFold:
    def test_queries_table_row_per_query(self):
        eng = _mk_engine()
        eng.execute_query(AGG_Q)
        d = _pydict(eng, "__queries__")
        assert len(d["trace_id"]) == 1
        assert d["kind"][0] == "query" and d["status"][0] == "ok"
        assert d["agent_id"][0] == "eng0"
        assert d["rows_in"][0] == 3 * W + 7
        assert d["windows"][0] >= 3
        assert d["duration_ms"][0] > 0
        assert d["device_ms"][0] >= 0 and d["compile_ms"][0] > 0

    def test_spans_table_parents_consistent(self):
        eng = _mk_engine()
        eng.execute_query(AGG_Q)
        d = _pydict(eng, "__spans__")
        assert {"query", "compile", "fragment"} <= set(d["name"])
        ids = set(d["span_id"])
        assert [p for p in d["parent_id"] if p == ""]  # the query root
        assert all(p in ids for p in d["parent_id"] if p)
        assert all(t == d["trace_id"][0] for t in d["trace_id"])

    def test_agents_table_totals_monotonic(self):
        eng = _mk_engine()
        for _ in range(3):
            eng.execute_query(AGG_Q)
        d = _pydict(eng, "__agents__")
        totals = list(d["queries_total"])
        assert totals == sorted(totals) and totals[-1] >= 3
        assert set(d["agent_id"]) == {"eng0"}

    def test_error_queries_folded_and_counted(self):
        eng = _mk_engine()
        with pytest.raises(Exception):
            eng.execute_query(BAD_Q)
        assert "error" in set(_pydict(eng, "__queries__")["status"])
        assert max(_pydict(eng, "__agents__")["errors_total"]) >= 1

    def test_staging_bytes_recorded_without_device_cache(self):
        eng = _mk_engine()
        with config.override_flag("device_residency", False):
            eng.execute_query(AGG_Q)
        assert _pydict(eng, "__queries__")["bytes_staged"][0] > 0

    @pytest.mark.parametrize("mb", [1, 2])
    def test_retention_bounded_by_budget(self, mb):
        with config.override_flag("telemetry_table_mb", mb), \
                jax_config.override_flag("telemetry_table_mb", mb):
            port, jax = _mk_engine(), _mk_jax_engine()
        for name in TELEMETRY_SCHEMAS:
            assert port.tables[name].max_bytes == mb << 20, name
            assert jax.tables[name].max_bytes == mb << 20, name

    def test_install_idempotent_and_listener_single(self):
        eng = _mk_engine()
        c1 = eng.telemetry
        assert enable_self_telemetry(eng, agent_id="other") is c1
        eng.execute_query(AGG_Q)
        assert len(_pydict(eng, "__queries__")["trace_id"]) == 1

    def test_bare_engine_has_no_collector(self):
        eng = _mk_engine(telemetry=False)
        assert eng.telemetry is None
        eng.execute_query(AGG_Q)
        assert "__queries__" not in eng.tables
        assert "__observed__" not in eng._compile_table_stats()

    def test_fold_never_fails_query(self):
        eng = _mk_engine()
        eng.telemetry.engine = None  # sabotage: the fold raises
        eng.execute_query(AGG_Q)  # must not raise
        assert eng.tracer.last().status == "ok"
        assert eng.telemetry.fold_errors == 1


class TestFoldStaysOnHost:
    """The fold runs on the query's thread in ``Tracer.end_query``: any
    tensor it read would be a device sync per query on the card. With
    every tensor-to-Python conversion made to raise, the fold of a
    finished trace still completes."""

    CONVERSIONS = ("item", "tolist", "numpy", "cpu", "__int__",
                   "__float__", "__bool__", "__index__")

    def _forbid(self, monkeypatch):
        def boom(*_a, **_k):
            raise AssertionError("the telemetry fold converted a tensor")

        for name in self.CONVERSIONS:
            monkeypatch.setattr(torch.Tensor, name, boom)

    def test_fold_reads_no_tensor(self, monkeypatch):
        eng = _mk_engine()
        eng.execute_query(AGG_Q)
        tr = eng.tracer.last()
        before = len(_table(eng, "__queries__")["trace_id"])
        with monkeypatch.context() as m:
            self._forbid(m)
            eng.telemetry._fold(tr)
        assert len(_table(eng, "__queries__")["trace_id"]) == before + 1

    def test_detector_catches_a_tensor_field(self, monkeypatch):
        eng = _mk_engine()
        eng.execute_query(AGG_Q)
        tr = eng.tracer.last()
        tr.usage.rows_in = torch.tensor(5)
        with monkeypatch.context() as m:
            self._forbid(m)
            with pytest.raises(AssertionError, match="converted a tensor"):
                eng.telemetry._fold(tr)


class TestBundledScripts:
    @pytest.mark.parametrize("script", ["px/slow_queries", "px/query_cost",
                                        "px/agent_health"])
    def test_script_over_own_history_equals_jax(self, script):
        """Each self-monitoring script over the same history gives the
        JAX engine's groups and columns (timings left out)."""
        got = {}
        for name, eng in (("port", _mk_engine()), ("jax", _mk_jax_engine())):
            for _ in range(2):
                eng.execute_query(AGG_Q)
            got[name] = eng.execute_query(
                load_script(script).pxl)["output"].to_pydict()
        p, j = got["port"], got["jax"]
        assert list(p) == list(j)
        keys = {"px/slow_queries": ("script_hash", "kind", "status", "n",
                                    "rows_out"),
                "px/query_cost": ("script_hash", "agent_id", "queries",
                                  "wire_bytes", "retries"),
                "px/agent_health": ("agent_id", "kind", "queries_total",
                                    "errors_total")}[script]
        order_p = np.lexsort([np.asarray(p[k]).astype(str) for k in keys])
        order_j = np.lexsort([np.asarray(j[k]).astype(str) for k in keys])
        for k in keys:
            assert list(np.asarray(p[k])[order_p]) == list(
                np.asarray(j[k])[order_j]), (script, k)

    def test_slow_queries_max_over_mean(self):
        eng = _mk_engine()
        for _ in range(2):
            eng.execute_query(AGG_Q)
        d = eng.execute_query(
            load_script("px/slow_queries").pxl)["output"].to_pydict()
        assert (d["n"] >= 1).all()
        assert (d["max_ms"] >= d["mean_ms"] - 1e-6).all()


class TestPlannerFeedback:
    def test_observed_cardinalities_recorded(self):
        eng = _mk_engine()
        eng.execute_query(AGG_Q)
        h = hashlib.sha256(AGG_Q.encode()).hexdigest()[:12]
        ent = eng.telemetry.observed()[h]
        assert ent["agg_groups"] == 11 and ent["runs"] == 1

    def test_exposed_through_compile_table_stats(self):
        eng = _mk_engine()
        eng.execute_query(AGG_Q)
        stats = eng._compile_table_stats()
        assert any(e["agg_groups"] == 11
                   for e in stats["__observed__"].values())

    def test_compile_resolves_observed_self(self):
        from pixie_tpu_torch.planner import CompilerState, compile_pxl
        from pixie_tpu_torch.types.dtypes import DataType
        from pixie_tpu_torch.types.relation import Relation
        from pixie_tpu_torch.udf.registry import default_registry

        h = hashlib.sha256(AGG_Q.encode()).hexdigest()[:12]
        state = CompilerState(
            schemas={"t": Relation([
                ("time_", DataType.TIME64NS), ("k", DataType.INT64),
                ("v", DataType.INT64),
            ])},
            registry=default_registry(),
            table_stats={"__observed__": {h: {"agg_groups": 123}}},
        )
        compile_pxl(AGG_Q, state)
        assert state.table_stats["__observed_self__"]["agg_groups"] == 123

    def test_push_agg_through_join_floors_at_observed(self):
        """A drifted (too small) sketch NDV under-sizes the partial
        aggregate; the observed floor from a past run corrects it, as in
        the JAX compiler."""
        from pixie_tpu.exec.plan import AggOp as JaxAggOp
        from pixie_tpu.planner import CompilerState as JaxState
        from pixie_tpu.planner import compile_pxl as jax_compile
        from pixie_tpu.types.dtypes import DataType as JaxDT
        from pixie_tpu.types.relation import Relation as JaxRel
        from pixie_tpu.udf.registry import default_registry as jax_reg
        from pixie_tpu_torch.exec.plan import AggOp
        from pixie_tpu_torch.planner import CompilerState, compile_pxl
        from pixie_tpu_torch.types.dtypes import DataType
        from pixie_tpu_torch.types.relation import Relation
        from pixie_tpu_torch.udf.registry import default_registry

        q = (
            "import px\n"
            "l = px.DataFrame(table='conn_l')\n"
            "r = px.DataFrame(table='conn_r')\n"
            "g = l.merge(r, how='inner', left_on=['k'], right_on=['k'],"
            " suffixes=['', '_r'])\n"
            "out = g.groupby('b').agg(n=('v', px.count))\n"
            "px.display(out)\n"
        )
        h = hashlib.sha256(q.encode()).hexdigest()[:12]

        def partial_groups(pkg, table_stats):
            State, compile_, Rel, DT, Agg, reg = pkg
            T, I = DT.TIME64NS, DT.INT64
            schemas = {
                "conn_l": Rel([("time_", T), ("k", I), ("b", I)]),
                "conn_r": Rel([("time_", T), ("k", I), ("v", I)]),
            }
            plan = compile_(q, State(schemas=schemas, registry=reg(),
                                     table_stats=table_stats)).plan
            paj = [n.op for n in plan.nodes.values()
                   if isinstance(n.op, Agg)
                   and any(a.out_name.startswith("__paj_")
                           for a in n.op.aggs)]
            assert paj, "eager-agg rewrite did not fire"
            return paj[0].max_groups

        sketch = {"conn_r": {"rows": 1000, "ndv": {"k": 100}}}
        floored = {**sketch, "__observed__": {h: {"agg_groups": 100_000}}}
        got = {}
        for name, pkg in (
            ("port", (CompilerState, compile_pxl, Relation, DataType, AggOp,
                      default_registry)),
            ("jax", (JaxState, jax_compile, JaxRel, JaxDT, JaxAggOp,
                     jax_reg)),
        ):
            got[name] = (partial_groups(pkg, dict(sketch)),
                         partial_groups(pkg, dict(floored)))
        assert got["port"] == got["jax"]
        ndv_only, with_observed = got["port"]
        assert with_observed >= 100_000 > ndv_only

    def test_views_count_runs_the_telemetry_saw(self):
        """The materialized-view heuristic counts the executed runs the
        engine's telemetry observed (the JAX views' seeded history)."""
        from pixie_tpu_torch.exec.result_cache import script_sha

        eng = _mk_engine()
        for _ in range(2):
            eng.execute_query(AGG_Q)
        sha = script_sha(AGG_Q)
        assert eng.views._observed_runs(sha) == 2
        with config.override_flag("view_auto_min_runs", 2):
            assert eng.views._should_register(sha)
        bare = _mk_engine(telemetry=False)
        assert bare.views._observed_runs(sha) == 0


def _seeded_profile(seed: int) -> list:
    rng = np.random.default_rng(seed)
    frames = [f"mod{i}.py:fn{i}" for i in range(8)]
    return [
        {
            "stack": ";".join(rng.choice(frames, 1 + i % 4)),
            "count": int(rng.integers(1, 500)),
            "qid": f"q{i % 3}", "script_hash": f"h{i % 2}",
            "tenant": ("", "alpha")[i % 2], "phase": "host",
        }
        for i in range(12)
    ]


def _seeded_spans(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    spans = []
    for i in range(6):
        start = int(rng.integers(1, 10**12))
        d = {"span_id": f"{i:016x}", "parent_id": "" if i == 0 else
             f"{0:016x}", "name": ("query", "compile", "fragment")[i % 3],
             "start_unix_nano": start,
             "end_unix_nano": start + int(rng.integers(1, 10**6))}
        if i == 0:
            d["status"] = "ok"
        spans.append(d)
    return {"trace_id": f"{seed:032x}", "agent": "pem-0", "spans": spans}


class TestWire:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_heartbeat_profile_bytes_equal(self, seed):
        msg = {"agent_id": "pem-0", "schemas": {}, "table_stats": {},
               "profile": _seeded_profile(seed)}
        buf = wire.encode(msg)
        assert buf == jax_wire.encode(msg)
        assert wire.encode(wire.decode(buf)) == buf

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_span_summary_bytes_equal(self, seed):
        msg = _seeded_spans(seed)
        buf = wire.encode(msg)
        assert buf == jax_wire.encode(msg)
        assert wire.decode(buf) == msg

    def test_real_span_summary_decodes_in_jax(self):
        eng = _mk_engine()
        eng.execute_query(AGG_Q)
        msg = {"trace_id": eng.tracer.last().trace_id, "agent": "eng0",
               "spans": _span_summaries(eng.tracer.last())}
        buf = wire.encode(msg)
        assert jax_wire.encode(jax_wire.decode(buf)) == buf

    def test_real_heartbeat_decodes_in_jax(self):
        """A port PEM's heartbeat (its telemetry folds, its profiler's
        summary) crosses the port codec and the JAX decoder."""
        from pixie_tpu_torch.ingest.profiler import PerfProfilerConnector
        from pixie_tpu_torch.services import MessageBus, PEMAgent

        bus = MessageBus()
        pem = PEMAgent(bus, "pem-hb", engine=_mk_engine(telemetry=False),
                       heartbeat_interval_s=60.0).start()
        conn = PerfProfilerConnector(agent_id="pem-hb")
        conn.init()
        try:
            pem.engine.execute_query(AGG_Q)
            for _ in range(3):
                conn.sample()
            hb = pem._heartbeat()
            assert hb["profile"] and "__tables__" in pem.engine.tables
            buf = wire.encode(hb)
            assert wire.encode(wire.decode(buf)) == buf
            assert jax_wire.encode(jax_wire.decode(buf)) == buf
        finally:
            conn.stop()
            pem.stop()
            bus.close()

    def test_span_attribute_tensor_raises(self):
        msg = _seeded_spans(0)
        msg["spans"][0]["status"] = torch.tensor(1)
        with pytest.raises(wire.WireError, match="torch.Tensor"):
            wire.encode(msg)

    def test_spans_published_for_distributed_traces_only(self):
        from pixie_tpu_torch.exec import tracectx
        from pixie_tpu_torch.services import MessageBus

        bus = MessageBus()
        got = []
        sub = bus.subscribe(TOPIC_SPANS, got.append)
        try:
            eng = _mk_engine(telemetry=False)
            TelemetryCollector(eng, "eng0", bus=bus).install()
            eng.execute_query(AGG_Q)  # local: no parent context
            with tracectx.bound(tracectx.make("ab" * 16, "cd" * 8)):
                tr = eng.tracer.begin_query(script="x", kind="fragment",
                                            parent_ctx=tracectx.current())
                eng.tracer.end_query(tr)
            deadline = time.monotonic() + 5
            while not got and time.monotonic() < deadline:
                time.sleep(0.01)
            assert [m["trace_id"] for m in got] == ["ab" * 16]
            wire.encode(got[0])  # host values only
        finally:
            sub.unsubscribe()
            bus.close()
