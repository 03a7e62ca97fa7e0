"""The port's OTel export (``px.export`` / ``px.otel``, the engine's
``OTelExportSinkOp`` branch, ``exec/otel.py``) against the JAX package's:
every case of ``tests/test_otel.py`` over the same seeded rows, each
payload equal to the JAX engine's (floats within rtol 1e-6, everything
else exact), the export through a cluster (the sink on the Kelvin), and
``OTLPHttpExporter``'s paths, headers, retries and counts against a
loopback receiver, request for request the JAX exporter's.
"""

from __future__ import annotations

import http.server
import json
import threading
import time

import numpy as np
import pytest

from pixie_tpu.exec import Engine as JaxEngine
from pixie_tpu.exec import otel as jax_otel
from pixie_tpu.exec.otel import OTLPHttpExporter as JaxExporter
from pixie_tpu.exec.otel import batch_to_otlp as jax_batch_to_otlp
from pixie_tpu.planner.objects import PxLError as JaxPxLError
from pixie_tpu.types import HostBatch as JaxHostBatch
from pixie_tpu_torch.exec import otel
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.planner.objects import PxLError
from pixie_tpu_torch.types import HostBatch

#: Float fields of a payload: FLOAT64 is f32 on the device in both
#: packages, and the two fold in different orders, so a value may be an
#: f32 ulp apart (about 6e-8 relative). Every other field is exact.
FLOAT_KEYS = ("asDouble", "value")
RTOL = 1e-6


def _rows(n: int = 1000) -> dict:
    rng = np.random.default_rng(0)
    lat = rng.integers(1000, 1_000_000, n)
    return {
        "time_": np.arange(n, dtype=np.int64),
        "latency_ns": lat,
        "end_time": np.arange(n, dtype=np.int64) + lat,
        "resp_status": rng.choice(np.array([200, 500]), n),
        "service": [f"svc-{i % 3}" for i in range(n)],
    }


@pytest.fixture(scope="module")
def engines():
    # The default window, as tests/test_otel.py's engine: the 1,000 rows
    # fold in one window in both packages.
    eng = Engine(device="cpu")
    ref = JaxEngine()
    for e in (eng, ref):
        e.append_data("http_events", _rows(), time_cols=("time_", "end_time"))
    return eng, ref


def assert_payload_equal(got, want, path="payload"):
    """Equal JSON trees: dict keys and list lengths exact, the float
    fields within ``RTOL``, every other leaf (and its type) exact."""
    assert type(got) is type(want), (path, got, want)
    if isinstance(want, dict):
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            if k in FLOAT_KEYS and isinstance(want[k], float):
                assert isinstance(got[k], float), (path, k)
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           err_msg=f"{path}.{k}")
            else:
                assert_payload_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_payload_equal(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def _export(engines, query):
    eng, ref = engines
    eng.otel_exports.clear()
    ref.otel_exports.clear()
    eng.execute_query(query)
    ref.execute_query(query)
    assert len(eng.otel_exports) == len(ref.otel_exports) == 1
    got, want = eng.otel_exports[0], ref.otel_exports[0]
    assert got["endpoint"].url == want["endpoint"].url
    assert got["endpoint"].headers == want["endpoint"].headers
    assert_payload_equal(got["payload"], want["payload"])
    return got["payload"]


SUMMARY_Q = """
import px
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(
    count=('latency_ns', px.count),
    lat=('latency_ns', px.quantiles),
)
df.p50 = px.pluck_float64(df.lat, 'p50')
df.p99 = px.pluck_float64(df.lat, 'p99')
df = df[['service', 'count', 'p50', 'p99']]
px.export(df, px.otel.Data(
    endpoint=px.otel.Endpoint(url='otel.example.com:4317'),
    resource={'service.name': df.service, 'k8s.cluster.name': 'test'},
    data=[
        px.otel.metric.Summary(
            name='http.latency',
            count=df.count,
            quantile_values={0.5: df.p50, 0.99: df.p99},
        ),
    ],
))
"""

GAUGE_SPAN_Q = (
    "import px\n"
    "df = px.DataFrame(table='http_events')\n"
    "df = df.head(50)\n"
    "px.export(df, px.otel.Data(\n"
    "    resource={'service.name': df.service},\n"
    "    data=[\n"
    "        px.otel.metric.Gauge(name='http.latency', value=df.latency_ns,\n"
    "                             attributes={'status': df.resp_status}),\n"
    "        px.otel.trace.Span(name='http.request', start_time=df.time_,\n"
    "                           end_time=df.end_time),\n"
    "    ],\n"
    "))\n"
)


class TestOTelExport:
    def test_summary_metrics_per_resource(self, engines):
        payload = _export(engines, SUMMARY_Q)
        rms = payload["resourceMetrics"]
        assert len(rms) == 3  # one resource per service
        attrs = {kv["key"]: kv["value"]["stringValue"]
                 for kv in rms[0]["resource"]["attributes"]}
        assert attrs["k8s.cluster.name"] == "test"
        assert attrs["service.name"].startswith("svc-")
        m = rms[0]["scopeMetrics"][0]["metrics"][0]
        assert m["name"] == "http.latency"
        pt = m["summary"]["dataPoints"][0]
        assert pt["count"] > 0
        assert [q["quantile"] for q in pt["quantileValues"]] == [0.5, 0.99]
        assert sum(rm["scopeMetrics"][0]["metrics"][0]["summary"]
                   ["dataPoints"][0]["count"] for rm in rms) == 1000

    def test_gauge_and_span(self, engines):
        payload = _export(engines, GAUGE_SPAN_Q)
        n_pts = sum(len(m["gauge"]["dataPoints"])
                    for rm in payload["resourceMetrics"]
                    for m in rm["scopeMetrics"][0]["metrics"])
        n_spans = sum(len(ss["spans"])
                      for rs in payload["resourceSpans"]
                      for ss in rs["scopeSpans"])
        assert n_pts == 50 and n_spans == 50
        span = payload["resourceSpans"][0]["scopeSpans"][0]["spans"][0]
        assert span["endTimeUnixNano"] > span["startTimeUnixNano"]
        assert isinstance(span["startTimeUnixNano"], int)
        pt = payload["resourceMetrics"][0]["scopeMetrics"][0]["metrics"][0][
            "gauge"]["dataPoints"][0]
        assert isinstance(pt["timeUnixNano"], int)
        assert isinstance(pt["asDouble"], float)

    def test_unknown_column_rejected(self, engines):
        eng, ref = engines
        q = ("import px\n"
             "df = px.DataFrame(table='http_events')\n"
             "px.export(df, px.otel.Data(\n"
             "    data=[px.otel.metric.Gauge(name='x', value=df.nope)],\n"
             "))\n")
        with pytest.raises(PxLError, match="does not exist|not in dataframe"):
            eng.execute_query(q)
        with pytest.raises(JaxPxLError, match="does not exist|not in dataframe"):
            ref.execute_query(q)

    def test_column_span_name_and_literal_attributes(self, engines):
        _export(engines, (
            "import px\n"
            "df = px.DataFrame(table='http_events')\n"
            "df = df[df.resp_status == 500].head(20)\n"
            "px.export(df, px.otel.Data(\n"
            "    endpoint=px.otel.Endpoint(url='http://c:4318',\n"
            "                              headers={'x-k': 'v'}),\n"
            "    resource={'k8s.cluster.name': 'c1'},\n"
            "    data=[px.otel.trace.Span(name=df.service,\n"
            "        start_time=df.time_, end_time=df.end_time,\n"
            "        attributes={'status': df.resp_status})],\n"
            "))\n"))

    def test_export_beside_display_reads_back_once(self, engines,
                                                   monkeypatch):
        """An export and a display of one aggregate, both data specs of
        the export, with ``materialize=False``: the folded result comes
        to the host once and both sinks read that batch."""
        eng, ref = engines
        q = SUMMARY_Q.replace("px.otel.metric.Summary(", (
            "px.otel.metric.Gauge(name='n', value=df.count),\n"
            "        px.otel.metric.Summary(")) + "px.display(df, 'out')\n"
        from pixie_tpu_torch.exec.plan import AggOp

        folds = []
        orig = Engine._run_fragment

        def counting(self, st, *a, **kw):
            if any(isinstance(o, AggOp) for o in st.chain):
                folds.append(kw.get("defer", False))
            return orig(self, st, *a, **kw)

        monkeypatch.setattr(Engine, "_run_fragment", counting)
        eng.otel_exports.clear()
        ref.otel_exports.clear()
        out = eng.execute_query(q, materialize=False)["out"]
        ref.execute_query(q)
        # The aggregate folds once and is read back at once (the export
        # and the display's limit share that batch), not deferred.
        assert folds == [False]
        assert isinstance(out, HostBatch)
        assert_payload_equal(eng.otel_exports[0]["payload"],
                             ref.otel_exports[0]["payload"])
        metrics = eng.otel_exports[0]["payload"]["resourceMetrics"][0][
            "scopeMetrics"][0]["metrics"]
        assert [m["name"] for m in metrics] == ["n", "http.latency"]


def test_batch_to_otlp_decodes_strings_like_jax():
    """The same host rows through both converters: STRING columns
    (dictionary ids in the port's batch) become the same resource and
    point attributes, UINT128 and BOOLEAN columns the same text."""
    cols = {
        "time_": np.arange(6, dtype=np.int64) * 10,
        "v": np.linspace(0.5, 3.0, 6),
        "n": np.arange(6, dtype=np.int64),
        "svc": ["a", "b", "a", "c", "b", "a"],
        "ok": np.array([True, False, True, True, False, True]),
    }
    def spec(mod):
        return mod.OTelDataSpec(
            resource=(("service.name", ("column", "svc")), ("env", "prod")),
            data=(
                mod.OTelMetricGauge(name="g", value_column="v",
                                    attributes=(("ok", "ok"), ("n", "n"))),
                mod.OTelMetricSummary(
                    name="s", count_column="n",
                    quantile_columns=((0.9, "v"), (0.1, "v"))),
                mod.OTelSpan(name="svc", start_time_column="time_",
                             end_time_column="n", name_is_column=True),
            ),
        )

    got = otel.batch_to_otlp(HostBatch.from_pydict(cols), spec(otel))
    want = jax_batch_to_otlp(JaxHostBatch.from_pydict(cols), spec(jax_otel))
    assert_payload_equal(got, want)
    assert [rm["resource"]["attributes"][0]["value"]["stringValue"]
            for rm in got["resourceMetrics"]] == ["a", "b", "c"]
    # No rows: literal resource attributes give one resource with empty
    # points, as in the JAX package; a column attribute gives no payload.
    empty = {k: v[:0] for k, v in cols.items()}

    def literal(mod):
        return mod.OTelDataSpec(resource=(("env", "prod"),),
                                data=spec(mod).data)

    got = otel.batch_to_otlp(HostBatch.from_pydict(empty), literal(otel))
    assert_payload_equal(got, jax_batch_to_otlp(
        JaxHostBatch.from_pydict(empty), literal(jax_otel)))
    assert got["resourceMetrics"][0]["scopeMetrics"][0]["metrics"][0][
        "gauge"]["dataPoints"] == []
    assert otel.batch_to_otlp(HostBatch.from_pydict(empty), spec(otel)) == {}


# -- the exporter against a loopback receiver ---------------------------------


class _Receiver:
    """A stdlib OTLP/HTTP receiver on 127.0.0.1: records (path, headers,
    body) and answers each request with the next queued status (200 when
    the queue is empty)."""

    def __init__(self):
        self.received = []
        self.statuses = []
        rec = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                rec.received.append((self.path, dict(self.headers),
                                     json.loads(body)))
                code = rec.statuses.pop(0) if rec.statuses else 200
                self.send_response(code)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)


@pytest.fixture
def receiver():
    r = _Receiver()
    try:
        yield r
    finally:
        r.close()


PAYLOAD = {
    "resourceMetrics": [{"resource": {"attributes": []},
                         "scopeMetrics": [{"metrics": []}]}],
    "resourceSpans": [{"resource": {"attributes": []},
                       "scopeSpans": [{"spans": []}]}],
}


def _requests(received):
    return [(p, h["Content-Type"], h.get("X-Tenant"), h.get("X-Ep"), b)
            for p, h, b in received]


class TestOTLPHttpExporter:
    def test_paths_bodies_and_headers_like_jax(self, receiver):
        ep = otel.OTelEndpointConfig(url=receiver.url + "/",
                                     headers=(("X-Ep", "e"),))
        runs = []
        for cls in (otel.OTLPHttpExporter, JaxExporter):
            receiver.received.clear()
            exp = cls("http://127.0.0.1:9", headers=(("X-Tenant", "t"),))
            exp(PAYLOAD, ep)  # the endpoint's url wins over the base url
            assert (exp.pushed, exp.errors) == (2, 0)
            runs.append(_requests(receiver.received))
        assert runs[0] == runs[1]
        assert [r[0] for r in runs[0]] == ["/v1/metrics", "/v1/traces"]
        assert runs[0][0][1:4] == ("application/json", "t", "e")
        assert runs[0][0][4] == {"resourceMetrics": PAYLOAD["resourceMetrics"]}

    def test_spans_only_payload_posts_traces_only(self, receiver):
        exp = otel.OTLPHttpExporter(receiver.url)
        exp({"resourceSpans": PAYLOAD["resourceSpans"]})
        exp({})
        assert [p for p, _h, _b in receiver.received] == ["/v1/traces"]
        assert exp.pushed == 1

    @pytest.mark.parametrize("statuses,pushed,errors,posts", [
        ([503], 1, 0, 2),       # a 5xx is retried
        ([429, 429], 1, 0, 3),  # so is 429
        ([503, 503, 503], 0, 1, 3),  # retries run out
        ([400], 0, 1, 1),       # a 4xx is not retried
    ], ids=["5xx_retry", "429_retry", "exhausted", "4xx_no_retry"])
    def test_retries_and_counts_like_jax(self, receiver, statuses, pushed,
                                         errors, posts):
        for cls, err in ((otel.OTLPHttpExporter, otel.ExportError),
                         (JaxExporter, Exception)):
            receiver.received.clear()
            receiver.statuses[:] = statuses
            exp = cls(receiver.url, max_retries=2)
            body = {"resourceSpans": PAYLOAD["resourceSpans"]}
            if errors:
                with pytest.raises(err, match="OTLP push to .* failed"):
                    exp(body)
            else:
                exp(body)
            assert (exp.pushed, exp.errors) == (pushed, errors)
            assert len(receiver.received) == posts

    def test_unreachable_collector_counts_an_error(self):
        exp = otel.OTLPHttpExporter("http://127.0.0.1:9", max_retries=1,
                                    timeout_s=1.0)
        t0 = time.monotonic()
        with pytest.raises(otel.ExportError):
            exp({"resourceSpans": PAYLOAD["resourceSpans"]})
        assert (exp.pushed, exp.errors) == (0, 1)
        assert time.monotonic() - t0 < 10

    def test_bound_as_engine_export_pushes_the_query_payload(self, engines,
                                                             receiver):
        eng, _ref = engines
        pusher = otel.OTLPHttpExporter(receiver.url)
        e2 = Engine(device="cpu")
        e2.append_data("http_events", _rows(), time_cols=("time_", "end_time"))
        e2.export_otel = pusher
        e2.execute_query(GAUGE_SPAN_Q)
        eng.otel_exports.clear()
        eng.execute_query(GAUGE_SPAN_Q)
        mem = eng.otel_exports[0]["payload"]
        assert [p for p, _h, _b in receiver.received] == [
            "/v1/metrics", "/v1/traces"]
        assert receiver.received[0][2] == {
            "resourceMetrics": mem["resourceMetrics"]}
        assert receiver.received[1][2] == {
            "resourceSpans": mem["resourceSpans"]}
        assert e2.otel_exports == []


# -- agent mode ---------------------------------------------------------------


def test_export_through_cluster():
    """The sink runs on the merge tier (the Kelvin), never on a PEM; the
    fixture waits for the PEM's table AND the Kelvin in the tracker."""
    from pixie_tpu_torch.services import (
        AgentTracker,
        KelvinAgent,
        MessageBus,
        PEMAgent,
        QueryBroker,
    )

    bus = MessageBus()
    tracker = AgentTracker(bus, expiry_s=60, check_interval_s=60)
    pem = PEMAgent(bus, "pem-0", engine=Engine(device="cpu"),
                   heartbeat_interval_s=0.05).start()
    kelvin = KelvinAgent(bus, "kelvin-0", engine=Engine(device="cpu"),
                         heartbeat_interval_s=0.05).start()
    broker = None
    try:
        pem.append_data("http_events", {
            "time_": np.arange(100, dtype=np.int64),
            "latency_ns": np.arange(100, dtype=np.int64) * 1000,
            "service": ["a"] * 60 + ["b"] * 40,
        })
        pem._register()
        deadline = time.time() + 10
        while time.time() < deadline:
            st = tracker.distributed_state()
            if (sum(a.has_table("http_events") for a in st.pems) == 1
                    and st.kelvins):
                break
            time.sleep(0.01)
        broker = QueryBroker(bus, tracker)
        res = broker.execute_script(
            "import px\n"
            "df = px.DataFrame(table='http_events')\n"
            "df = df.groupby('service').agg(n=('latency_ns', px.count))\n"
            "px.export(df, px.otel.Data(\n"
            "    resource={'service.name': df.service},\n"
            "    data=[px.otel.metric.Gauge(name='n', value=df.n)],\n"
            "))\n"
            "px.display(df, 'o')\n",
            timeout_s=60,
        )
        assert len(kelvin.engine.otel_exports) == 1
        assert not pem.engine.otel_exports
        payload = kelvin.engine.otel_exports[0]["payload"]
        got = {rm["resource"]["attributes"][0]["value"]["stringValue"]:
               rm["scopeMetrics"][0]["metrics"][0]["gauge"]["dataPoints"][0]
               ["asDouble"] for rm in payload["resourceMetrics"]}
        assert got == {"a": 60.0, "b": 40.0}
        o = res["tables"]["o"].to_pydict()
        assert dict(zip(o["service"], o["n"])) == {"a": 60, "b": 40}
    finally:
        if broker is not None:
            broker.close()
        for a in (pem, kelvin):
            a.stop()
        tracker.close()
        bus.close()
