"""Stream lifecycle traces on the port against the JAX package's.

A live query (``exec/streaming.py``) has one trace of kind ``stream``
from its start to its close, as in the JAX package
(``tests/test_trace.py`` ``TestStreamingTrace``). Each case drives a
port engine (CPU) and a JAX engine over the same seeded rows and holds
the traces to each other:

- the three ``TestStreamingTrace`` cases: in flight as ``stream``; ``ok``
  with ``rows_in == 3 * W`` and ``windows == 3``; a second close does
  nothing; a cancelled run ends ``cancelled``;
- a compile error ends the trace as ``error``; each compile (a rebucket
  too) is a fragment of the trace; each poll's window work and
  freshness lag land on it; the finished trace is a ``__queries__``
  row;
- materialized views (``exec/views.py``): a replaced view and a closed
  registry leave nothing in flight, and a view answer's freshness lag is
  on the query's own trace;
- agent mode: a PEM's stream trace is a child of the trace in whose
  context the broker dispatched it.

Counts are compared exactly. A freshness lag is read against the clock,
so each package's lag is held to the interval of clock readings around
its poll, not to the other package's value.
"""

from __future__ import annotations

import contextlib
import threading
import time
import types

import numpy as np
import pytest

import pixie_tpu.exec.streaming as jax_streaming
import pixie_tpu.services as jax_services
import pixie_tpu_torch.exec.streaming as port_streaming
import pixie_tpu_torch.services as port_services
from pixie_tpu import config as jax_config
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.exec.tracectx import bound as jax_bound
from pixie_tpu.services.telemetry import (
    enable_self_telemetry as jax_enable_self_telemetry,
)
from pixie_tpu_torch import config as port_config
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.exec.tracectx import bound as port_bound
from pixie_tpu_torch.services.telemetry import enable_self_telemetry

W = 1 << 10

AGG_Q = (
    "import px\n"
    "df = px.DataFrame(table='t')\n"
    "df = df.groupby('k').agg(n=('v', px.count), s=('v', px.sum))\n"
    "px.display(df)\n"
)
ROWS_Q = (
    "import px\n"
    "df = px.DataFrame(table='t')\n"
    "df = df[df.v >= 500]\n"
    "px.display(df['time_', 'v'])\n"
)

PKGS = {
    "port": types.SimpleNamespace(
        engine=lambda: Engine(window_rows=W, device="cpu"),
        streaming=port_streaming, config=port_config,
        telemetry=enable_self_telemetry, bound=port_bound,
        services=port_services,
    ),
    "jax": types.SimpleNamespace(
        engine=lambda: JaxEngine(window_rows=W),
        streaming=jax_streaming, config=jax_config,
        telemetry=jax_enable_self_telemetry, bound=jax_bound,
        services=jax_services,
    ),
}


def _rows(off: int, n: int, seed: int, t0: int = 0, keys: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "time_": t0 + np.arange(off, off + n, dtype=np.int64),
        "k": rng.integers(0, keys, n),
        "v": rng.integers(0, 1000, n),
    }


def _mk_engine(pkg, n=5 * W + 13, t0: int = 0):
    eng = PKGS[pkg].engine()
    eng.append_data("t", _rows(0, n, 3, t0))
    return eng


def _both(fn):
    """``fn(pkg_name, pkg)`` on each package; {name: result}."""
    return {name: fn(name, p) for name, p in PKGS.items()}


def _trace_view(tr) -> dict:
    """The parts of a finished trace both packages must agree on."""
    return {
        "kind": tr.kind, "status": tr.status, "script": tr.script,
        "rows_in": tr.rows_in, "rows_out": tr.rows_out,
        "windows": tr.windows,
        "fragments": [(tuple(f.ops), f.windows, f.rows_in, f.rows_out)
                      for f in tr.stats.fragments],
        "usage": (tr.usage.rows_in, tr.usage.rows_out, tr.usage.windows),
    }


class TestStreamingTrace:
    """Counterparts of ``tests/test_trace.py::TestStreamingTrace``."""

    def test_stream_lifecycle_traced(self):
        def run(name, p):
            eng = _mk_engine(name, n=3 * W)
            updates = []
            sq = p.streaming.stream_query(eng, AGG_Q, updates.append)
            in_flight = [t["kind"] for t in eng.tracer.in_flight()]
            assert in_flight == ["stream"]
            sq.run(poll_interval_s=0.01, max_rounds=2)
            assert updates
            assert eng.tracer.in_flight() == []
            tr = eng.tracer.last()
            assert tr.kind == "stream" and tr.status == "ok"
            assert tr.rows_in == 3 * W and tr.windows == 3
            assert tr.script.startswith("import px")
            return {"in_flight": in_flight, "updates": len(updates),
                    **_trace_view(tr)}

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_stream_close_idempotent(self):
        def run(name, p):
            eng = _mk_engine(name, n=W)
            sq = p.streaming.stream_query(eng, AGG_Q, lambda u: None)
            sq.poll()
            sq.close()
            sq.close()  # second close is a no-op
            assert eng.tracer.last().status == "ok"
            assert eng.tracer.in_flight() == []
            return {"traces": len(eng.tracer.recent()),
                    **_trace_view(eng.tracer.last())}

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_stream_cancel_status(self):
        def run(name, p):
            eng = _mk_engine(name, n=W)
            ev = threading.Event()
            sq = p.streaming.stream_query(eng, AGG_Q, lambda u: None, cancel=ev)
            ev.set()
            sq.run(poll_interval_s=0.01)
            tr = eng.tracer.last()
            assert tr.status == "cancelled"
            assert eng.tracer.in_flight() == []
            return {"error": tr.error, **_trace_view(tr)}

        got = _both(run)
        assert got["port"] == got["jax"]


def test_cancel_between_polls_ends_cancelled():
    """A cancel that lands while ``run`` waits between polls ends the
    trace ``cancelled`` after the polls it made."""
    def run(name, p):
        eng = _mk_engine(name, n=2 * W)
        ev = threading.Event()
        polls = []
        sq = p.streaming.stream_query(
            eng, AGG_Q, lambda u: (polls.append(u.seq), ev.set()), cancel=ev)
        sq.run(poll_interval_s=5.0)
        return {"polls": polls, **_trace_view(eng.tracer.last())}

    got = _both(run)
    assert got["port"]["status"] == "cancelled"
    assert got["port"] == got["jax"]


def test_compile_error_ends_the_trace_as_error(monkeypatch):
    """A fragment that fails to compile raises out of the constructor
    and leaves an ``error`` trace, nothing in flight."""
    def boom(*a, **kw):
        raise ValueError("no fragment")

    def run(name, p):
        monkeypatch.setattr(p.streaming, "compile_fragment", boom)
        eng = _mk_engine(name, n=W)
        with pytest.raises(ValueError, match="no fragment"):
            p.streaming.stream_query(eng, AGG_Q, lambda u: None)
        assert eng.tracer.in_flight() == []
        tr = eng.tracer.last()
        return {"error": tr.error, **_trace_view(tr)}

    got = _both(run)
    assert got["port"]["status"] == "error"
    assert got["port"]["error"] == "ValueError: no fragment"
    assert got["port"] == got["jax"]


def test_refused_plan_opens_no_trace():
    """A plan the stream refuses raises before the trace begins."""
    def run(name, p):
        eng = _mk_engine(name, n=W)
        bounded = AGG_Q.replace("table='t')", "table='t', end_time=100)")
        with pytest.raises(Exception, match="time-bounded"):
            p.streaming.stream_query(eng, bounded, lambda u: None)
        return (eng.tracer.in_flight(), eng.tracer.last())

    got = _both(run)
    assert got["port"] == got["jax"] == ([], None)


def test_each_compile_is_a_fragment_of_the_trace():
    """INT64 keys past the stats-derived domain overflow the state: the
    stream rebuckets, and the trace holds one fragment per compile with
    the windows and rows each folded, equal to the JAX trace's."""
    def run(name, p):
        eng = PKGS[name].engine()
        eng.append_data("t", _rows(0, 2000, 5, keys=3))
        sq = p.streaming.stream_query(eng, AGG_Q, lambda u: None)
        sq.poll()
        eng.append_data("t", _rows(2000, 2000, 6, keys=6000))
        sq.poll()
        sq.close()
        tr = eng.tracer.last()
        assert len(tr.stats.fragments) >= 2
        return _trace_view(tr)

    got = _both(run)
    assert got["port"] == got["jax"]
    frags = got["port"]["fragments"]
    assert sum(f[1] for f in frags) == got["port"]["windows"]
    assert sum(f[2] for f in frags) == got["port"]["rows_in"]


@pytest.mark.parametrize("query", [AGG_Q, ROWS_Q], ids=["agg", "rows"])
def test_every_polls_window_work_lands_on_the_trace(query):
    """Three rounds of seeded appends: each poll's ``last_stats`` holds
    only that poll's window, and the finished trace holds all of them,
    as the JAX trace does."""
    def run(name, p):
        eng = PKGS[name].engine()
        eng.append_data("t", _rows(0, 2 * W, 11))
        sq = p.streaming.stream_query(eng, query, lambda u: None)
        sq.poll()
        per_poll = []
        for r in range(3):
            eng.append_data("t", _rows(2 * W + r * W, W, 20 + r))
            sq.poll()
            if name == "port":
                per_poll.append((sq.last_stats.windows, sq.last_stats.rows))
        sq.close()
        tr = eng.tracer.last()
        return {"per_poll": per_poll, **_trace_view(tr)}

    got = _both(run)
    assert got["port"].pop("per_poll") == [(1, W)] * 3
    got["jax"].pop("per_poll")
    assert got["port"] == got["jax"]
    assert got["port"]["rows_in"] == 5 * W and got["port"]["windows"] == 5


def test_poll_writes_its_freshness_lag_onto_the_trace():
    """Each poll writes now less the source's newest event time onto the
    trace: the usage keeps the worst poll, ``freshness`` names the
    table."""
    def run(name, p):
        t0 = time.time_ns() - 5_000_000_000  # events 5 s old
        eng = _mk_engine(name, n=W, t0=t0)
        newest = t0 + W - 1
        sq = p.streaming.stream_query(eng, AGG_Q, lambda u: None)
        before = time.time_ns()
        sq.poll()
        after = time.time_ns()
        sq.close()
        tr = eng.tracer.last()
        lag = tr.usage.freshness_lag_ms
        assert (before - newest) / 1e6 <= lag <= (after - newest) / 1e6
        assert tr.freshness["t"] == lag
        if name == "port":
            assert sq.last_stats.freshness_lag_ms == lag
        return sorted(tr.freshness)

    got = _both(run)
    assert got["port"] == got["jax"] == ["t"]


def test_finished_stream_is_a_queries_row():
    """With self-telemetry on, the closed stream's trace folds into
    ``__queries__`` as a ``stream`` row, as the JAX engine's does."""
    def run(name, p):
        eng = _mk_engine(name, n=2 * W)
        p.telemetry(eng, agent_id="eng0")
        sq = p.streaming.stream_query(eng, AGG_Q, lambda u: None)
        sq.poll()
        sq.close()
        rows = {}
        for tb in eng.table_store.tablets("__queries__"):
            for k, v in tb.read_all().to_pydict().items():
                rows.setdefault(k, []).extend(v)
        i = list(rows["kind"]).index("stream")
        return {k: (rows[k][i].item() if isinstance(rows[k][i], np.generic)
                    else rows[k][i])
                for k in ("kind", "status", "rows_in", "windows", "script",
                          "agent_id", "cache")}

    got = _both(run)
    assert got["port"]["rows_in"] == 2 * W
    assert got["port"] == got["jax"]


# -- materialized views -------------------------------------------------------

def test_view_close_and_replace_leave_nothing_in_flight():
    """A registered view's stream is in flight; registering the script
    again closes the view it replaces; closing the registry closes every
    view. A row chain, which cannot materialize, leaves no trace in
    flight."""
    def run(name, p):
        eng = _mk_engine(name, n=2 * W)
        seen = []
        eng.views.register(AGG_Q)
        seen.append([t["kind"] for t in eng.tracer.in_flight()])
        eng.views.register(AGG_Q)  # replaces the first view
        seen.append([t["kind"] for t in eng.tracer.in_flight()])
        seen.append((eng.tracer.last().kind, eng.tracer.last().status))
        with pytest.raises(Exception, match="only aggregate chains"):
            eng.views.register(ROWS_Q)
        seen.append([t["kind"] for t in eng.tracer.in_flight()])
        eng.views.close()
        seen.append(eng.tracer.in_flight())
        seen.append([(t["kind"], t["status"]) for t in eng.tracer.recent()])
        return seen

    got = _both(run)
    assert got["port"][0] == got["port"][1] == ["stream"]
    assert got["port"][4] == []
    assert got["port"] == got["jax"]


def test_view_answer_freshness_on_the_query_trace():
    """With ``view_auto_min_runs`` 2, the second run registers a view
    and is answered from it: the query's trace is marked ``view`` and
    holds the view's freshness lag, as the JAX engine's does."""
    def run(name, p):
        t0 = time.time_ns() - 3_000_000_000
        eng = _mk_engine(name, n=2 * W, t0=t0)
        newest = t0 + 2 * W - 1
        with p.config.override_flag("view_auto_min_runs", 2):
            first = eng.execute_query(AGG_Q)
            before = time.time_ns()
            second = eng.execute_query(AGG_Q)
            after = time.time_ns()
        tr = eng.tracer.last()
        assert tr.cache == "view" and tr.kind == "query"
        lag = tr.usage.freshness_lag_ms
        assert (before - newest) / 1e6 - 1e-3 <= lag
        assert lag <= (after - newest) / 1e6 + 1e-3
        assert tr.freshness == {"t": lag}
        if name == "port":
            assert eng.last_stats.freshness_lag_ms == lag
        in_flight = [t["kind"] for t in eng.tracer.in_flight()]
        eng.views.close()
        out = {}
        for res in (first, second):
            d = res["output"].to_pydict()
            o = np.argsort(d["k"])
            out.setdefault("answers", []).append(
                [(int(d["k"][i]), int(d["n"][i]), int(d["s"][i])) for i in o])
        return {"in_flight": in_flight, "status": tr.status,
                "rows_in": tr.rows_in, "left": eng.tracer.in_flight(), **out}

    got = _both(run)
    assert got["port"]["answers"][0] == got["port"]["answers"][1]
    assert got["port"]["in_flight"] == ["stream"]
    assert got["port"] == got["jax"]


# -- agent mode ---------------------------------------------------------------

def _wait_for(pred, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)
    return True


@contextlib.contextmanager
def _cluster(name: str, n_pems: int = 2):
    p = PKGS[name]
    s = p.services
    bus = s.MessageBus()
    tracker = s.AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
    agents, broker = [], None
    try:
        pems = []
        for i in range(n_pems):
            pem = s.PEMAgent(bus, f"pem-{i}", engine=p.engine(),
                             heartbeat_interval_s=0.05)
            pem.append_data("t", _rows(0, 1500 + 300 * i, 40 + i))
            pems.append(pem)
            agents.append(pem.start())
        kelvin = s.KelvinAgent(bus, "kelvin-0", engine=p.engine(),
                               heartbeat_interval_s=0.05)
        agents.append(kelvin.start())
        # Every PEM's table, not the union of schemas: a PEM whose
        # registration has not landed would be left out of the plan.
        assert _wait_for(lambda: sum(
            a.has_table("t") for a in tracker.distributed_state().pems
        ) == n_pems)
        broker = s.QueryBroker(bus, tracker)
        yield types.SimpleNamespace(bus=bus, tracker=tracker, pems=pems,
                                    kelvin=kelvin, broker=broker)
    finally:
        if broker is not None:
            broker.close()
        for a in agents:
            a.stop()
        tracker.close()
        bus.close()


def test_agent_stream_trace_is_a_child_of_the_broker_trace():
    """A live query dispatched inside a broker trace's context: each
    PEM's stream trace shares the broker's trace id, its root is a child
    of the broker's root span, and it is in the PEM's ``/debug/queryz``
    while it runs; cancelling ends it ``cancelled``."""
    def run(name, p):
        with _cluster(name) as c:
            btr = c.broker.tracer.begin_query(script=AGG_Q)
            ups = []
            try:
                with p.bound(btr.ctx()):
                    handle = c.broker.execute_script_streaming(
                        AGG_Q, ups.append, poll_interval_s=0.05)

                def streams(pem):
                    return [t for t in pem.engine.tracer.in_flight()
                            if t["kind"] == "stream"]

                assert _wait_for(lambda: all(streams(pem) for pem in c.pems))
                parents = [[t.get("parent") for t in streams(pem)]
                           for pem in c.pems]
                ids = [[t["id"] for t in streams(pem)] for pem in c.pems]
                handle.cancel()
                assert _wait_for(lambda: not any(streams(pem)
                                                 for pem in c.pems))
                ends = []
                for pem in c.pems:
                    tr = next(t for t in pem.engine.tracer.recent()
                              if t["kind"] == "stream")
                    ends.append(tr["status"])
            finally:
                c.broker.tracer.end_query(btr)
            want = {"trace_id": btr.trace_id, "span_id": btr.root.span_id}
            return {"parents": [[pp == want for pp in ps] for ps in parents],
                    "ids": [[i == btr.trace_id for i in row] for row in ids],
                    "ends": ends}

    got = _both(run)
    assert got["port"]["parents"] == [[True], [True]]
    assert got["port"]["ids"] == [[True], [True]]
    assert got["port"] == got["jax"]
