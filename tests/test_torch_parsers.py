"""The eleven protocol stitchers, the capture tap and the connection
table of the port against the JAX package.

Every stitcher of ``pixie_tpu_torch/ingest/*_parser.py`` is a copy of the
JAX package's. Each parser case of ``tests/test_new_parsers.py``,
``tests/test_sql_parsers.py`` and ``tests/test_ingest.py``
(``TestHTTPParser``, ``TestDNSParser``) runs here as written, with every
stitcher class (and ``parse_dns``, ``HPACKDecoder``) it reaches replaced
by a twin: each call goes to the JAX object and to the port's with the
same arguments, the two results must be equal, and so must the two
objects' plain state after the call (records pending, ``parse_errors``,
every counter), so the case's own assertions hold for both. The cases
that load an engine (the tap integrations) have counterparts here that
feed one capture to both packages' taps and engines and compare the
tables and the answers. Seeded numpy streams (``ingest/capture_gen.py``)
of each protocol, cut at random points and corrupted, give equal records
and ``parse_errors`` in both packages.
"""

import base64
import importlib
import inspect
import struct
import sys
import types
from collections import deque

import numpy as np
import pytest
import torch

import pixie_tpu.ingest.conn_table as jax_conn_table
from pixie_tpu.config import set_flag as jax_set_flag
from pixie_tpu.exec import Engine as JaxEngine
from pixie_tpu.ingest.collector import Collector as JaxCollector
from pixie_tpu.ingest.schemas import init_schemas as jax_init_schemas
from pixie_tpu.ingest.tap import CaptureTapConnector as JaxTap
from chip_smoke import _quantile_columns, check_library_output
from pixie_tpu_torch import Engine
from pixie_tpu_torch.ingest import conn_table
from pixie_tpu_torch.ingest.capture_gen import PROTOCOLS, gen_capture, write_jsonl
from pixie_tpu_torch.ingest.collector import Collector
from pixie_tpu_torch.ingest.schemas import init_schemas
from pixie_tpu_torch.ingest.tap import CaptureTapConnector
from pixie_tpu_torch.planner import CompilerState, compile_pxl
from pixie_tpu_torch.scripts import load_script

import test_ingest
import test_new_parsers
import test_sql_parsers

PARSER_MODULES = ("http_parser", "http2_parser", "dns_parser", "mysql_parser",
                  "pgsql_parser", "redis_parser", "kafka_parser", "cql_parser",
                  "nats_parser", "mux_parser", "amqp_parser")
#: The JAX test classes whose cases this file runs twinned.
JAX_CASE_CLASSES = {
    test_new_parsers: None,  # every class
    test_sql_parsers: None,
    test_ingest: ("TestHTTPParser", "TestDNSParser", "TestCaptureTap"),
}
#: JAX cases that load an engine, with their counterparts below.
ENGINE_CASES = {
    "test_new_parsers::TestTapIntegration::test_capture_to_pxl_query",
    "test_new_parsers::TestHTTP2Stitcher::test_tap_routes_http2_into_http_events",
    "test_sql_parsers::TestTapIntegration::test_sql_capture_to_query",
    "test_ingest::TestHTTPParser::test_records_flow_into_http_events_table",
    "test_ingest::TestCaptureTap::test_jsonl_tap_to_queryable_tables",
}
#: Each protocol's stats script, run on both engines by the tap tests.
STATS_SCRIPTS = {
    "http": ("px/http_stats", "px/service_stats"),
    "dns": ("px/dns_latency",), "mysql": ("px/mysql_stats",),
    "pgsql": ("px/pgsql_stats",), "redis": ("px/redis_stats",),
    "kafka": ("px/kafka_stats",), "cql": ("px/cql_stats",),
    "nats": ("px/nats_stats",), "mux": ("px/mux_stats",),
    "amqp": ("px/amqp_stats",),
}
TAP_TABLES = ("http_events", "dns_events", "mysql_events", "pgsql_events",
              "redis_events", "kafka_events.beta", "cql_events",
              "nats_events.beta", "mux_events", "amqp_events")
WINDOW = 1 << 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the twin ----------------------------------------------------------------
def _plain(x) -> bool:
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return True
    if isinstance(x, (list, tuple)):
        return all(_plain(v) for v in x)
    if isinstance(x, dict):
        return all(_plain(k) and _plain(v) for k, v in x.items())
    return isinstance(x, deque) and all(_plain(v) for v in x)


def _state(obj) -> dict:
    """An object's plain attributes (pending records, counters, buffers);
    the connection tables are compared through what they emit."""
    return {k: v for k, v in vars(obj).items() if _plain(v)}


def _call_both(what: str, fa, fb, args, kwargs):
    try:
        ra = fa(*args, **kwargs)
    except Exception as e:  # the port must raise the same way
        with pytest.raises(type(e)):
            fb(*args, **kwargs)
        raise
    rb = fb(*args, **kwargs)
    assert _plain(ra), f"{what} returned {type(ra).__name__}"
    assert ra == rb, what
    return ra


class _Twin:
    """One JAX object and one port object driven by the same calls."""

    def __init__(self, what: str, jax_obj, port_obj):
        self._what, self._jax, self._port = what, jax_obj, port_obj
        self._check_state()

    def _check_state(self) -> None:
        if hasattr(self._jax, "__dict__"):
            assert _state(self._jax) == _state(self._port), self._what

    def __getattr__(self, name):
        a, b = getattr(self._jax, name), getattr(self._port, name)
        if callable(a):
            def call(*args, **kwargs):
                try:
                    return _call_both(f"{self._what}.{name}", a, b, args,
                                      kwargs)
                finally:
                    self._check_state()
            return call
        assert _plain(a) and a == b, f"{self._what}.{name}"
        return a


class _TwinFactory:
    """Stands in for a class or a function of the JAX module: a call
    builds (or calls) both packages' and compares."""

    def __init__(self, name: str, jax_obj, port_obj):
        self._name, self._jax, self._port = name, jax_obj, port_obj

    def __call__(self, *args, **kwargs):
        if inspect.isclass(self._jax):
            return _Twin(self._name, self._jax(*args, **kwargs),
                         self._port(*args, **kwargs))
        return _call_both(self._name, self._jax, self._port, args, kwargs)

    def __getattr__(self, name):
        a, b = getattr(self._jax, name), getattr(self._port, name)
        assert _plain(a) and a == b, f"{self._name}.{name}"
        return a


def _twin_modules(monkeypatch, test_module) -> int:
    """Make each stitcher class and parse function of the JAX parser
    modules, as the test module reaches them (its imports, and its
    ``from pixie_tpu.ingest... import`` statements through a stand-in
    module in ``sys.modules``), the twin of the port's. The JAX modules
    themselves stay untouched, so their code calls their own."""
    patched = 0
    for m in PARSER_MODULES:
        jm = importlib.import_module(f"pixie_tpu.ingest.{m}")
        pm = importlib.import_module(f"pixie_tpu_torch.ingest.{m}")
        stand_in = types.ModuleType(jm.__name__)
        stand_in.__dict__.update(vars(jm))
        for name, obj in vars(jm).items():
            if name.startswith("_") or getattr(obj, "__module__", "") != jm.__name__:
                continue
            if not (inspect.isclass(obj) or inspect.isfunction(obj)):
                continue
            if inspect.isclass(obj) and issubclass(obj, BaseException):
                continue
            twin = _TwinFactory(f"{m}.{name}", obj, getattr(pm, name))
            setattr(stand_in, name, twin)
            if vars(test_module).get(name) is obj:
                monkeypatch.setattr(test_module, name, twin)
            patched += 1
        monkeypatch.setitem(sys.modules, jm.__name__, stand_in)
    return patched


def _jax_cases():
    cases = []
    for mod, classes in JAX_CASE_CLASSES.items():
        for cname, cls in vars(mod).items():
            if not (cname.startswith("Test") and inspect.isclass(cls)):
                continue
            if classes is not None and cname not in classes:
                continue
            for tname in sorted(vars(cls)):
                if tname.startswith("test_"):
                    cases.append(f"{mod.__name__}::{cname}::{tname}")
    return cases


JAX_CASES = _jax_cases()
TWIN_CASES = [c for c in JAX_CASES if c not in ENGINE_CASES]


def test_every_engine_case_has_a_counterpart():
    engine = {c for c in JAX_CASES if "Engine" in inspect.getsource(_case_fn(c))}
    assert engine == ENGINE_CASES
    here = globals()
    assert all(c.rsplit("::", 1)[1] in here for c in ENGINE_CASES)


def _case_fn(case: str):
    modname, cname, tname = case.split("::")
    return getattr(getattr(importlib.import_module(modname), cname), tname)


@pytest.mark.parametrize("case", TWIN_CASES)
def test_jax_parser_case_equal_in_port(case, monkeypatch):
    modname, cname, tname = case.split("::")
    mod = importlib.import_module(modname)
    assert _twin_modules(monkeypatch, mod) >= len(PARSER_MODULES)
    getattr(getattr(mod, cname)(), tname)()


# -- engine counterparts -------------------------------------------------------
def _tap_both(feed=None, path="", **tap_kw):
    """(JAX engine, port engine), each fed by its own package's tap and
    collector over the same capture until the capture is spent."""
    out = []
    for eng, coll, tap in (
        (JaxEngine(window_rows=WINDOW), JaxCollector(),
         JaxTap(feed=None if feed is None else list(feed), path=path, **tap_kw)),
        (Engine(window_rows=WINDOW, device="cpu"), Collector(),
         CaptureTapConnector(feed=None if feed is None else list(feed),
                             path=path, **tap_kw)),
    ):
        coll.wire_to(eng)
        coll.register_source(tap)
        while True:
            before = coll.stats["rows_pushed"]
            tap.transfer_data(coll, coll._data_tables)
            coll.flush()
            if coll.stats["rows_pushed"] == before:
                break
        out.append((eng, tap))
    (je, jt), (pe, pt) = out
    for proto in PROTOCOLS:
        assert getattr(jt, proto).parse_errors == getattr(pt, proto).parse_errors
    return je, pe


def _table_rows(eng, table: str) -> dict:
    out = eng.execute_query(
        f"import px\npx.display(px.DataFrame(table='{table}'))",
        max_output_rows=1 << 20)["output"].to_pydict()
    return {k: np.asarray(v) for k, v in out.items()}


def _tables_equal(je, pe) -> None:
    jt, pt = set(je.tables), set(pe.tables)
    assert jt == pt
    for t in sorted(jt):
        a, b = _table_rows(je, t), _table_rows(pe, t)
        assert sorted(a) == sorted(b), t
        for c in a:
            assert np.array_equal(a[c], b[c]), f"{t}.{c}"


def _answers_equal(je, pe, pxl: str) -> dict:
    """The script on both engines: keys, strings and integers exact,
    FLOAT64 rtol 1e-5, t-digest-derived values rtol 0.05. Returns the
    port's answer as dicts."""
    compiled = compile_pxl(pxl, CompilerState(
        schemas={n: t.relation for n, t in pe.tables.items()},
        registry=pe.registry, now_ns=0, max_output_rows=10_000))
    loose, ordered = _quantile_columns(compiled.plan)
    jax_set_flag("cpu_fold_threads", 1)
    try:
        ref = je.execute_query(pxl, max_output_rows=10_000)
    finally:
        jax_set_flag("cpu_fold_threads", 0)
    got = pe.execute_query(pxl, max_output_rows=10_000)
    assert sorted(got) == sorted(ref)
    for k in got:
        check_library_output(k, got[k], ref[k], loose[k], ordered)
    return {k: v.to_pydict() for k, v in got.items()}


def _ev(conn, direction, data, ts, proto):
    return {"conn": conn, "dir": direction, "ts": ts, "proto": proto,
            "data_b64": base64.b64encode(data).decode()}


def test_records_flow_into_http_events_table():
    """test_ingest.TestHTTPParser.test_records_flow_into_http_events_table:
    50 stitched exchanges appended to both engines."""
    from pixie_tpu.ingest.http_parser import HTTPStitcher as JaxHTTP
    from pixie_tpu_torch.ingest.http_parser import HTTPStitcher

    engines = []
    for cls, eng in ((JaxHTTP, JaxEngine(window_rows=WINDOW)),
                     (HTTPStitcher, Engine(window_rows=WINDOW, device="cpu"))):
        st = cls(service="svc-z", pod="ns/p")
        for i in range(50):
            st.feed(3, f"GET /e{i % 4} HTTP/1.1\r\n\r\n".encode(), True,
                    ts_ns=i * 1000)
            st.feed(3, b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n",
                    False, ts_ns=i * 1000 + 77)
        recs = st.drain()
        cols = {k: [r[k] for r in recs] for k in
                ("time_", "latency_ns", "resp_status", "req_path", "service")}
        eng.append_data("http_events", cols)
        engines.append(eng)
    out = _answers_equal(*engines, (
        "import px\ndf = px.DataFrame(table='http_events')\n"
        "s = df.groupby('req_path').agg(n=('latency_ns', px.count),"
        " lat=('latency_ns', px.mean))\npx.display(s)"))["output"]
    assert sorted(out["req_path"]) == ["/e0", "/e1", "/e2", "/e3"]
    assert int(out["n"].sum()) == 50
    np.testing.assert_allclose(out["lat"], [77.0] * 4)


def test_jsonl_tap_to_queryable_tables(tmp_path):
    """test_ingest.TestCaptureTap: a JSONL capture of HTTP/1 and DNS."""
    events = []
    for i in range(20):
        events.append(_ev(1, "req", f"GET /t{i % 2} HTTP/1.1\r\n\r\n".encode(),
                          i * 1000, "http"))
        events.append(_ev(1, "resp",
                          b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n",
                          i * 1000 + 50, "http"))
    q = struct.pack(">HHHHHH", 3, 0x0100, 1, 0, 0, 0) + b"\x01a\x02io\x00\x00\x01\x00\x01"
    r = struct.pack(">HHHHHH", 3, 0x8180, 1, 0, 0, 0) + b"\x01a\x02io\x00\x00\x01\x00\x01"
    events.append({"proto": "dns", "ts": 5,
                   "data_b64": base64.b64encode(q).decode()})
    events.append({"proto": "dns", "ts": 95,
                   "data_b64": base64.b64encode(r).decode()})
    path = tmp_path / "tap.jsonl"
    write_jsonl(events, str(path))
    je, pe = _tap_both(path=str(path), service="svc-t", pod="ns/p")
    _tables_equal(je, pe)
    out = _answers_equal(je, pe, (
        "import px\ndf = px.DataFrame(table='http_events')\n"
        "s = df.groupby('req_path').agg(n=('latency_ns', px.count),"
        " lat=('latency_ns', px.mean))\npx.display(s)"))["output"]
    assert sorted(out["req_path"]) == ["/t0", "/t1"]
    np.testing.assert_allclose(out["lat"], [50.0, 50.0])
    dns = _answers_equal(je, pe, (
        "import px\ndf = px.DataFrame(table='dns_events')\n"
        "s = df.groupby('pod').agg(n=('latency_ns', px.count),"
        " lat=('latency_ns', px.max))\npx.display(s)"))["output"]
    assert list(dns["n"]) == [1] and list(dns["lat"]) == [90]


def test_capture_to_pxl_query():
    """test_new_parsers.TestTapIntegration: redis, kafka and cql."""
    from test_new_parsers import cql_frame, cql_query, cql_rows, kafka_req, kafka_resp, resp_array

    from pixie_tpu_torch.ingest.cql_parser import OP_QUERY, OP_RESULT

    feed = []
    for i in range(30):
        cmd = "GET" if i % 3 else "SET"
        feed.append(_ev(1, "req", resp_array(cmd, f"k{i}"), 1000 + i * 10,
                        "redis"))
        feed.append(_ev(1, "resp", b"+OK\r\n", 1004 + i * 10, "redis"))
    for i in range(20):
        feed.append(_ev(2, "req", kafka_req(i % 2, 9, i), 2000 + i * 10, "kafka"))
        feed.append(_ev(2, "resp", kafka_resp(i), 2007 + i * 10, "kafka"))
    for i in range(10):
        feed.append(_ev(3, "req", cql_frame(OP_QUERY, i, cql_query("SELECT 1")),
                        3000 + i * 10, "cql"))
        feed.append(_ev(3, "resp",
                        cql_frame(OP_RESULT, i, cql_rows(1), response=True),
                        3002 + i * 10, "cql"))
    je, pe = _tap_both(feed=feed, service="svc-a")
    _tables_equal(je, pe)
    got = _answers_equal(je, pe, """
import px
df = px.DataFrame(table='redis_events')
out = df.groupby('req_cmd').agg(n=('latency_ns', px.count),
                                mean_ns=('latency_ns', px.mean))
px.display(out)
""")["output"]
    assert dict(zip(got["req_cmd"], got["n"].tolist())) == {"GET": 20, "SET": 10}
    assert all(abs(v - 4.0) < 1e-6 for v in got["mean_ns"])
    got2 = _answers_equal(je, pe, """
import px
df = px.DataFrame(table='kafka_events.beta')
out = df.groupby('req_cmd').agg(n=('latency_ns', px.count))
px.display(out)
""")["output"]
    assert dict(zip(got2["req_cmd"].tolist(), got2["n"].tolist())) == {0: 10, 1: 10}
    got3 = _answers_equal(je, pe, """
import px
df = px.DataFrame(table='cql_events')
out = df.groupby('req_op').agg(n=('latency_ns', px.count),
                               p50=('latency_ns', px.quantiles))
px.display(out)
""")["output"]
    assert got3["n"].tolist() == [10]
    assert int(got3["req_op"][0]) == OP_QUERY


def test_tap_routes_http2_into_http_events():
    """test_new_parsers.TestHTTP2Stitcher.test_tap_routes_http2_into_http_events."""
    from test_new_parsers import h2_frame, hpack_literal

    preface = test_new_parsers.TestHTTP2Stitcher.PREFACE
    feed = [_ev(1, "req", preface, 1, "http2")]
    for i in range(20):
        sid = 1 + 2 * i
        blk = b"\x82" + hpack_literal(":path", f"/ep{i % 3}")
        feed.append(_ev(1, "req", h2_frame(1, 0x5, sid, blk), 100 + i, "http2"))
        feed.append(_ev(1, "resp", h2_frame(1, 0x5, sid, b"\x88"), 105 + i,
                        "http2"))
    je, pe = _tap_both(feed=feed, service="h2")
    _tables_equal(je, pe)
    got = _answers_equal(je, pe, (
        "import px\ndf = px.DataFrame(table='http_events')\n"
        "out = df.groupby('req_path').agg(n=('latency_ns', px.count))\n"
        "px.display(out)"))["output"]
    assert dict(zip(got["req_path"], got["n"].tolist())) == {
        "/ep0": 7, "/ep1": 7, "/ep2": 6}


def test_sql_capture_to_query():
    """test_sql_parsers.TestTapIntegration: mysql and pgsql."""
    from test_sql_parsers import my_ok, my_query, pg_msg, pg_startup

    feed = []
    for i in range(40):
        q = f"SELECT * FROM orders WHERE id={i}"
        feed.append(_ev(1, "req", my_query(q), 1000 + i * 10, "mysql"))
        feed.append(_ev(1, "resp", my_ok(), 1005 + i * 10, "mysql"))
    feed.append(_ev(9, "req", pg_startup(), 1, "pgsql"))
    for i in range(25):
        feed.append(_ev(9, "req", pg_msg("Q", f"SELECT {i};\0".encode()),
                        5000 + i * 10, "pgsql"))
        feed.append(_ev(9, "resp", pg_msg("C", b"SELECT 1\0") + pg_msg("Z", b"I"),
                        5003 + i * 10, "pgsql"))
    je, pe = _tap_both(feed=feed, service="checkout")
    _tables_equal(je, pe)
    got = _answers_equal(je, pe, """
import px
df = px.DataFrame(table='mysql_events')
df.q = px.normalize_mysql(df.query_str)
out = df.groupby('q').agg(
    n=('latency_ns', px.count), p50=('latency_ns', px.quantiles))
px.display(out)
""")["output"]
    assert len(got["q"]) == 1
    assert int(got["n"][0]) == 40
    got2 = _answers_equal(je, pe, """
import px
df = px.DataFrame(table='pgsql_events')
out = df.groupby('req_cmd').agg(n=('latency_ns', px.count))
px.display(out)
""")["output"]
    assert list(got2["req_cmd"]) == ["QUERY"]
    assert int(got2["n"][0]) == 25


# -- one capture of all eleven protocols ----------------------------------------
@pytest.fixture(scope="module")
def all_protocols(tmp_path_factory):
    """A JSONL capture of every protocol (256 exchanges each, 512 HTTP/1)
    through both packages' taps into engines holding the canonical
    schemas."""
    cap = gen_capture(11, {p: 256 for p in PROTOCOLS} | {"http": 512},
                      conns=4)
    path = tmp_path_factory.mktemp("tap") / "all.jsonl"
    write_jsonl(cap.events, str(path))
    engines = []
    for eng, coll, tap in (
        (JaxEngine(window_rows=WINDOW), JaxCollector(),
         JaxTap(path=str(path), service="svc-7", pod="ns/pod-7")),
        (Engine(window_rows=WINDOW, device="cpu"), Collector(),
         CaptureTapConnector(path=str(path), service="svc-7", pod="ns/pod-7")),
    ):
        (jax_init_schemas if isinstance(eng, JaxEngine) else init_schemas)(eng)
        coll.wire_to(eng)
        coll.register_source(tap)
        for _ in range(len(cap.events) // 4096 + 2):
            tap.transfer_data(coll, coll._data_tables)
        coll.flush()
        engines.append((eng, tap))
    return cap, engines


def test_all_protocols_parse_clean(all_protocols):
    cap, ((je, jt), (pe, pt)) = all_protocols
    for proto in PROTOCOLS:
        assert getattr(jt, proto).parse_errors == 0, proto
        assert getattr(pt, proto).parse_errors == 0, proto
    for eng in (je, pe):
        assert eng.tables["http_events"].num_rows == (
            cap.exchanges["http"] + cap.exchanges["http2"])
        for t, proto in zip(TAP_TABLES[1:], PROTOCOLS[2:]):
            assert eng.tables[t].num_rows == cap.exchanges[proto], t


@pytest.mark.parametrize("table", TAP_TABLES)
def test_all_protocols_tables_equal(all_protocols, table):
    _, ((je, _), (pe, _)) = all_protocols
    a, b = _table_rows(je, table), _table_rows(pe, table)
    assert sorted(a) == sorted(b)
    assert len(next(iter(a.values()))) > 0
    for c in a:
        assert np.array_equal(a[c], b[c]), c


@pytest.mark.parametrize("script", [s for v in STATS_SCRIPTS.values() for s in v])
def test_all_protocols_stats_scripts_equal(all_protocols, script):
    _, ((je, _), (pe, _)) = all_protocols
    out = _answers_equal(je, pe, load_script(script).pxl)
    assert sum(len(next(iter(v.values()))) for v in out.values()) > 0


def test_http_stats_against_numpy():
    """The stitched latency is the response's timestamp minus the
    request's, exactly: px/http_stats over an HTTP/1 capture against
    numpy over the exchanges it was made from."""
    cap = gen_capture(13, {"http": 3000}, conns=7)
    eng = Engine(window_rows=WINDOW, device="cpu")
    init_schemas(eng)
    coll = Collector()
    coll.wire_to(eng)
    tap = CaptureTapConnector(feed=cap.events, service="svc-3", pod="ns/p")
    coll.register_source(tap)
    tap.transfer_data(coll, coll._data_tables, budget=len(cap.events))
    coll.flush()
    assert tap.http.parse_errors == 0
    h = cap.truth["http"]
    ok = h["status"] < 400
    out = eng.execute_query(load_script("px/http_stats").pxl)["output"].to_pydict()
    assert set(out["service"]) == {"svc-3"}
    assert sorted(out["req_path"]) == sorted(np.unique(h["path"][ok]))
    for p, n, mean, mx in zip(out["req_path"], out["n"], out["lat_mean"],
                              out["lat_max"]):
        lat = h["latency_ns"][ok & (h["path"] == p)]
        assert (int(n), int(mx)) == (len(lat), int(lat.max()))
        np.testing.assert_allclose(mean, lat.mean(), rtol=1e-5)


# -- seeded streams, cut and corrupted -----------------------------------------
def _stitchers(pkg: str, proto: str):
    mod = importlib.import_module(
        f"{pkg}.ingest.{'http' if proto == 'http' else proto}_parser")
    name = {"http": "HTTPStitcher", "http2": "HTTP2Stitcher",
            "dns": "DNSStitcher", "mysql": "MySQLStitcher",
            "pgsql": "PgSQLStitcher", "redis": "RedisStitcher",
            "kafka": "KafkaStitcher", "cql": "CQLStitcher",
            "nats": "NATSStitcher", "mux": "MuxStitcher",
            "amqp": "AMQPStitcher"}[proto]
    return getattr(mod, name)


def _feed_stream(st, proto, chunks):
    for conn, is_req, data, ts in chunks:
        if proto == "dns":
            st.feed(data, ts_ns=ts)
        else:
            st.feed(conn, data, is_request=is_req, ts_ns=ts)
    return st.drain(), st.parse_errors


def _chunks(cap, rng, corrupt: float):
    """Each event's bytes cut at random points into 1-4 feeds (a DNS
    datagram stays whole); with
    probability ``corrupt`` a byte of the event is overwritten."""
    out = []
    for ev in cap.events:
        data = bytearray(base64.b64decode(ev["data_b64"]))
        if corrupt and rng.random() < corrupt:
            data[int(rng.integers(len(data)))] = int(rng.integers(256))
        # A DNS message is one datagram: never cut.
        n_cuts = 0 if ev["proto"] == "dns" else int(rng.integers(0, 4))
        cuts = np.sort(rng.integers(0, len(data) + 1, n_cuts))
        bounds = [0, *cuts.tolist(), len(data)]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if hi > lo:
                out.append((ev.get("conn", 0), ev.get("dir", "req") == "req",
                            bytes(data[lo:hi]), ev["ts"]))
    return out


@pytest.mark.parametrize("corrupt", [0.0, 0.05], ids=["clean", "corrupted"])
@pytest.mark.parametrize("proto", PROTOCOLS)
def test_seeded_stream_equal(proto, corrupt):
    rng = np.random.default_rng([PROTOCOLS.index(proto), int(corrupt * 100)])
    cap = gen_capture(rng, {proto: 600}, conns=5)
    chunks = _chunks(cap, rng, corrupt)
    jr, je = _feed_stream(_stitchers("pixie_tpu", proto)(), proto, chunks)
    pr, pe = _feed_stream(_stitchers("pixie_tpu_torch", proto)(), proto, chunks)
    assert jr == pr
    assert je == pe
    if not corrupt:
        assert je == 0 and len(jr) == 600


@pytest.mark.parametrize("proto", [p for p in PROTOCOLS if p != "dns"])
def test_random_bytes_equal(proto):
    """Noise on two connections, both directions, random chunking."""
    rng = np.random.default_rng(PROTOCOLS.index(proto) + 200)
    chunks = []
    for trial in range(40):
        blob = rng.integers(0, 256, int(rng.integers(1, 400)), dtype=np.uint8)
        off = 0
        while off < len(blob):
            k = int(rng.integers(1, 64))
            chunks.append((trial % 2, bool(rng.integers(2)),
                           blob[off:off + k].tobytes(), trial * 1000))
            off += k
    assert (_feed_stream(_stitchers("pixie_tpu", proto)(), proto, chunks)
            == _feed_stream(_stitchers("pixie_tpu_torch", proto)(), proto, chunks))


# -- the connection table -------------------------------------------------------
class _C:
    last_ts = 0


@pytest.mark.parametrize("n,step", [(100, 10**9), (5000, 1), (80, 200 * 10**9)])
def test_connection_table_sweep_and_cap(n, step):
    """The TTL sweep (above SWEEP_MIN entries) and the LRU cap keep the
    same connections in both packages."""
    tables = [jax_conn_table.ConnectionTable(_C), conn_table.ConnectionTable(_C)]
    rng = np.random.default_rng(n)
    ids = rng.integers(0, n, 4 * n)
    for t, cid in enumerate(ids.tolist()):
        for tab in tables:
            tab.get(cid, t * step)
    ja, pa = tables
    assert len(ja) == len(pa) <= conn_table.ConnectionTable.MAX_CONNS
    assert sorted(ja._conns) == sorted(pa._conns)
    assert ([c.last_ts for _k, c in sorted(ja._conns.items())]
            == [c.last_ts for _k, c in sorted(pa._conns.items())])
    ja.kill(int(ids[0]))
    pa.kill(int(ids[0]))
    assert sorted(ja._conns) == sorted(pa._conns)


def test_connection_table_constants_match():
    for k in ("IDLE_TTL_NS", "MAX_CONNS", "SWEEP_MIN"):
        assert getattr(conn_table.ConnectionTable, k) == getattr(
            jax_conn_table.ConnectionTable, k)
