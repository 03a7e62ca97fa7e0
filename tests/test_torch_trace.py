"""The port's query-lifecycle tracer (``exec/trace.py``) against the JAX
package's, for the same plans over the same seeded rows: the span names
and their tree, the usage record's fields and counters, the fragment
records, the stats spine behind ``Engine.last_stats``, the usage merge
the broker does, the slow-query log and the OTLP export of traces.
"""

from __future__ import annotations

import http.server
import json
import logging
import threading
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
    # The port's usage also charges garbage-collection pauses (gc_ms),
    # which the JAX package does not count.
    assert gu.keys() == wu.keys() | {"gc_ms"}
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
    # The JAX package's fields, in its order, then the port's gc_ms.
    assert [f.name for f in fields(QueryResourceUsage)] == [
        f.name for f in fields(JaxUsage)
    ] + ["gc_ms"]
    parts = [
        {"rows_in": 10, "windows": 2, "wire_bytes": 100, "device_ms": 1.5,
         "device_peak_bytes": 7, "freshness_lag_ms": 3.0, "gc_ms": 2.0},
        {"rows_in": 5, "windows": 1, "wire_bytes": 50, "device_ms": 0.5,
         "device_peak_bytes": 9, "freshness_lag_ms": 1.0, "gc_ms": 0.5},
    ]
    got, want = QueryResourceUsage(), JaxUsage()
    for d in parts:
        got.merge(d)
        want.merge(d)
    merged = got.to_dict()
    assert merged.pop("gc_ms") == 2.5  # adds up, like stall_ms
    assert merged == want.to_dict()
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


def _otlp_receiver():
    """A stdlib OTLP/HTTP receiver on 127.0.0.1 recording (path, body)."""
    received = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            received.append((self.path, json.loads(body)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t, received


def _otlp_shape(payload):
    """The package-neutral form of a pushed trace: the payload's keys,
    the resource attribute keys, the span names (as ``_names``) and each
    span's fields (ids and times differ from run to run, and so do some
    per-package span attributes)."""
    rs = payload["resourceSpans"][0]
    ss = rs["scopeSpans"][0]
    return (
        list(payload), list(rs), list(ss),
        [kv["key"] for kv in rs["resource"]["attributes"]],
        sorted({s["name"] for s in ss["spans"]
                if not s["name"].startswith("window.")}),
        sorted({(tuple(s), "parentSpanId" in s) for s in ss["spans"]}),
    )


def test_trace_export_url_is_refused(engines):
    """No longer refused: with ``trace_export_url`` set, each finished
    trace is pushed to ``/v1/traces`` in the JAX tracer's OTLP shape
    (tests/test_trace.py's round trip); a collector that is down counts
    in ``pixie_trace_export_errors_total`` and never fails the query."""
    from pixie_tpu.services.observability import MetricsRegistry as JaxReg
    from pixie_tpu_torch.services.observability import MetricsRegistry

    eng, ref = engines
    httpd, thread, received = _otlp_receiver()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with override_flag("trace_export_url", url):
            eng.execute_query(AGG_Q)
        with jax_override_flag("trace_export_url", url):
            ref.execute_query(AGG_Q)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=5)
    assert [p for p, _b in received] == ["/v1/traces", "/v1/traces"]
    got, want = received[0][1], received[1][1]
    assert _otlp_shape(got) == _otlp_shape(want)
    spans = got["resourceSpans"][0]["scopeSpans"][0]["spans"]
    root = spans[0]
    assert root["name"] == "query" and "parentSpanId" not in root
    assert root["traceId"] == eng.tracer.last().trace_id
    assert len(root["traceId"]) == 32 and len(root["spanId"]) == 16
    assert all(s["traceId"] == root["traceId"] for s in spans)
    ids = {s["spanId"] for s in spans}
    assert all(s["parentSpanId"] in ids for s in spans[1:])
    assert eng.tracer.last().exported
    res = {kv["key"]: kv["value"]["stringValue"]
           for kv in got["resourceSpans"][0]["resource"]["attributes"]}
    assert res["service.name"] == "pixie-tpu-engine"
    assert got == eng.tracer.last().to_otlp()

    # The collector is down: the query answers, the failure is counted.
    reg, jreg = MetricsRegistry(), JaxReg()
    t, jt = Tracer(registry=reg), JaxTracer(registry=jreg)
    down = "http://127.0.0.1:9"
    with override_flag("trace_export_url", down):
        t.end_query(t.begin_query(script="x"))
    with jax_override_flag("trace_export_url", down):
        jt.end_query(jt.begin_query(script="x"))
    assert "pixie_trace_export_errors_total 1" in reg.render()
    assert "pixie_trace_export_errors_total 1" in jreg.render()
    assert not t.last().exported


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
