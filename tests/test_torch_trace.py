"""The port's query-lifecycle tracer (``exec/trace.py``) against the JAX
package's, for the same plans over the same seeded rows: the span names
and their tree, the usage record's fields and counters, the fragment
records, the stats spine behind ``Engine.last_stats``, the usage merge
the broker does, the slow-query log and the refusal of the OTLP export.
"""

from __future__ import annotations

import logging
from dataclasses import fields

import numpy as np
import pytest

from pixie_tpu.config import override_flag as jax_override_flag
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.exec.trace import QueryResourceUsage as JaxUsage
from pixie_tpu.exec.trace import Tracer as JaxTracer
from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch.exec.analyze import QueryStats
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.exec.trace import QueryResourceUsage, Tracer, plan_script

W = 1 << 10
N = 5000

AGG_Q = """import px
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(n=('latency_ns', px.count),
                               s=('latency_ns', px.sum))
px.display(df, 'out')
"""
ROWS_Q = """import px
df = px.DataFrame(table='http_events')
df = df[df.latency_ns >= 900]
px.display(df['time_', 'latency_ns'], 'out')
"""
TWO_AGG_Q = """import px
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(n=('latency_ns', px.count))
df = df.agg(k=('n', px.count))
px.display(df, 'out')
"""


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(5)
    cols = {
        "time_": np.arange(N, dtype=np.int64),
        "latency_ns": rng.integers(0, 1000, N),
        "service": [f"svc-{j}" for j in rng.integers(0, 4, N)],
    }
    eng = Engine(window_rows=W, device="cpu")
    ref = JaxEngine(window_rows=W)
    eng.append_data("http_events", cols)
    ref.append_data("http_events", cols)
    return eng, ref


def _names(trace):
    return sorted({s.name for s in trace.spans if not s.name.startswith("window.")})


@pytest.mark.parametrize("query", [AGG_Q, ROWS_Q, TWO_AGG_Q],
                         ids=["agg", "rows", "two_aggs"])
def test_spans_and_usage_match_jax(engines, query):
    eng, ref = engines
    eng.execute_query(query, max_output_rows=N)
    ref.execute_query(query, max_output_rows=N)
    got, want = eng.tracer.last(), ref.tracer.last()
    assert _names(got) == _names(want) == ["compile", "fragment", "query"]
    assert (sum(s.name == "fragment" for s in got.spans)
            == sum(s.name == "fragment" for s in want.spans))
    # Every span hangs off the root; every window span off a fragment.
    frag_ids = {s.span_id for s in got.spans if s.name == "fragment"}
    for s in got.spans[1:]:
        parent = got.root.span_id if not s.name.startswith("window.") else None
        assert s.parent_id == parent or s.parent_id in frag_ids
    # Window spans name the port's stages (the JAX engine's "stall" is
    # the port's pipeline counter instead).
    assert {s.name for s in got.spans if s.name.startswith("window.")} <= {
        f"window.{st}" for st in ("read", "stage", "compute", "finalize",
                                  "materialize", "decode", "skip")
    }
    gu, wu = got.usage.to_dict(), want.usage.to_dict()
    assert gu.keys() == wu.keys()
    for k in ("rows_in", "rows_out", "windows", "wire_bytes", "retries",
              "skipped_windows"):
        assert gu[k] == wu[k], k
    assert gu["compile_ms"] > 0 and gu["device_ms"] > 0
    assert gu["device_peak_bytes"] is None  # a CPU engine has no card
    assert got.status == want.status == "ok"
    assert got.script_hash == want.script_hash
    assert got.kind == want.kind == "query"
    assert set(got.to_dict()) <= set(want.to_dict()) | {"pipeline"}


def test_fragment_records_match_jax(engines):
    eng, ref = engines
    eng.execute_query(TWO_AGG_Q)
    ref.execute_query(TWO_AGG_Q)
    got = [(f.ops, f.windows, f.rows_in, f.rows_out)
           for f in eng.tracer.last().stats.fragments]
    want = [(f.ops, f.windows, f.rows_in, f.rows_out)
            for f in ref.tracer.last().stats.fragments]
    assert got == want
    # The stats spine is the engine's last_stats, and each fragment reads
    # through to its compiled fragment.
    st = eng.last_stats
    assert st is eng.tracer.last().stats and isinstance(st, QueryStats)
    assert st.fragments[0].is_agg and st.windows == sum(f[1] for f in got)
    assert st.to_dict()["fragments"][0]["ops"] == list(got[0][0])


def test_plan_script_matches_jax(engines):
    from pixie_tpu.exec.trace import plan_script as jax_plan_script
    from pixie_tpu.planner import CompilerState as JaxState
    from pixie_tpu.planner import compile_pxl as jax_compile
    from pixie_tpu_torch.planner import CompilerState, compile_pxl

    eng, ref = engines
    p = compile_pxl(AGG_Q, CompilerState(
        schemas={"http_events": eng.tables["http_events"].relation},
        registry=eng.registry,
    )).plan
    jp = jax_compile(AGG_Q, JaxState(
        schemas={"http_events": ref.tables["http_events"].relation},
        registry=ref.registry,
    )).plan
    assert plan_script(p) == jax_plan_script(jp)
    eng.execute_plan(p)
    assert eng.tracer.last().script == plan_script(p)


def test_usage_fields_and_merge_match_jax():
    assert [f.name for f in fields(QueryResourceUsage)] == [
        f.name for f in fields(JaxUsage)
    ]
    parts = [
        {"rows_in": 10, "windows": 2, "wire_bytes": 100, "device_ms": 1.5,
         "device_peak_bytes": 7, "freshness_lag_ms": 3.0},
        {"rows_in": 5, "windows": 1, "wire_bytes": 50, "device_ms": 0.5,
         "device_peak_bytes": 9, "freshness_lag_ms": 1.0},
    ]
    got, want = QueryResourceUsage(), JaxUsage()
    for d in parts:
        got.merge(d)
        want.merge(d)
    assert got.to_dict() == want.to_dict()
    # A CPU agent reports no peak: it merges as unknown.
    got.merge({"rows_in": 1, "device_peak_bytes": None})
    assert got.rows_in == 16 and got.device_peak_bytes == 9


def test_error_and_cancel_statuses_match_jax(engines):
    eng, ref = engines
    bad = "import px\ndf = px.DataFrame(table='nope')\npx.display(df)\n"
    for e in (eng, ref):
        with pytest.raises(Exception):
            e.execute_query(bad)
    assert eng.tracer.last().status == ref.tracer.last().status == "error"
    assert not eng.tracer.in_flight() and not ref.tracer.in_flight()


def test_slow_query_log(engines, caplog):
    eng, _ = engines
    with override_flag("slow_query_threshold_ms", 1e-6):
        with caplog.at_level(logging.WARNING, "pixie_tpu_torch.slow_query"):
            eng.execute_query(AGG_Q)
    assert any("slow query" in r.message for r in caplog.records)


def test_trace_export_url_is_refused():
    with override_flag("trace_export_url", "http://localhost:4318"):
        with pytest.raises(NotImplementedError, match="not in this slice"):
            Tracer().begin_query(script="x")
    with jax_override_flag("trace_export_url", ""):
        JaxTracer().begin_query(script="x")  # the JAX tracer exports


def test_ring_buffer_and_window_sampling(engines):
    eng, _ = engines
    with override_flag("trace_window_sample", 1):
        eng.execute_query(AGG_Q)
    tr = eng.tracer.last()
    windows = [s for s in tr.spans if s.name == "window.compute"]
    assert len(windows) == tr.usage.windows == -(-N // W)
    with override_flag("trace_window_sample", 0):
        eng.execute_query(AGG_Q)
    assert not [s for s in eng.tracer.last().spans
                if s.name.startswith("window.")]
    t = Tracer(ring_size=2)
    for i in range(3):
        t.end_query(t.begin_query(script=str(i)))
    assert [d["query"] for d in t.recent()] == ["2", "1"]
