"""The port's engine boundaries as the profilers see them
(``exec/trace.py`` ``region``): ``pixie.*`` ranges in a CPU
``torch.profiler`` trace, nested as the tracer's spans of the same name
on the same clock; no ``record_function`` while no profiler runs; the
threadmap phases of each thread during a query; garbage-collection
pauses charged to the query whose thread collected; and the engine's
self time, which with the parts it leaves out adds up to the query.
"""

from __future__ import annotations

import gc
import threading

import numpy as np
import pytest
import torch
from torch.autograd import profiler as torch_profiler
from torch.profiler import ProfilerActivity, profile

from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch.exec import threadmap
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.exec.trace import Tracer
from pixie_tpu_torch.services.observability import MetricsRegistry

W = 1 << 10
N = 4 * W

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
US = 1_000  # ns: ranges and spans agree to the microsecond


def _engine(depth: int = 2) -> Engine:
    rng = np.random.default_rng(11)
    eng = Engine(window_rows=W, device="cpu", pipeline_depth=depth)
    eng.tracer = Tracer(registry=MetricsRegistry())
    eng.append_data("http_events", {
        "time_": np.arange(N, dtype=np.int64),
        "latency_ns": rng.integers(0, 1000, N),
        "service": [f"svc-{j}" for j in rng.integers(0, 4, N)],
    })
    eng.execute_query(AGG_Q)  # compiles and warms every path once
    return eng


@pytest.fixture(scope="module")
def eng():
    return _engine()


@pytest.fixture(scope="module")
def profiled(eng):
    """One AGG_Q under a CPU profiler, every window interval a span:
    (trace, [(name, start_ns, end_ns)] of the profiler's host events)."""
    with override_flag("trace_window_sample", 1):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng.execute_query(AGG_Q)
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()]
    return eng.tracer.last(), events


def _ranges(events, name):
    return [e for e in events if e[0] == f"pixie.{name}"]


def _inside(inner, outer) -> bool:
    return inner[1] >= outer[1] - US and inner[2] <= outer[2] + US


@pytest.mark.parametrize("name,span", [
    ("query", "query"), ("compile", "compile"),
    ("compute", "window.compute"), ("finalize", "window.finalize"),
])
def test_each_range_falls_inside_the_span_of_its_name(profiled, name, span):
    trace, events = profiled
    ranges = _ranges(events, name)
    spans = [(s.name, s.start_unix_nano, s.end_unix_nano)
             for s in trace.spans if s.name == span]
    assert ranges and spans
    for r in ranges:
        assert any(_inside(r, s) for s in spans), (r, spans)
    if name == "compute":  # one range a window, one span a window
        assert len(ranges) == len(spans) == trace.windows == N // W


def test_the_query_range_holds_compile_and_the_fold_holds_its_aten_ops(profiled):
    trace, events = profiled
    (query,) = _ranges(events, "query")
    (compile_,) = _ranges(events, "compile")
    assert _inside(compile_, query)
    aten = [e for e in events if e[0].startswith("aten::")]
    for r in _ranges(events, "compute"):
        assert _inside(r, query)
        inner = [e for e in aten if r[1] <= e[1] < r[2]]
        assert inner, r  # the fold's own ops
        assert all(e[2] <= r[2] for e in inner)
    assert _ranges(events, "stall")  # the consumer's waits, depth 2


@pytest.mark.parametrize("profiler_on", [False, True])
def test_record_function_only_under_a_profiler(eng, monkeypatch, profiler_on):
    made = []
    real = torch_profiler.record_function

    def counting(name, *a, **kw):
        made.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch_profiler, "record_function", counting)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    if profiler_on:
        with profile(activities=[ProfilerActivity.CPU]):
            eng.execute_query(AGG_Q)
        assert {"pixie.query", "pixie.compile", "pixie.compute"} <= set(made)
    else:
        assert not torch_profiler._is_profiler_enabled
        eng.execute_query(AGG_Q)
        eng.execute_query(ROWS_Q)
        assert made == []


def test_threadmap_phases_of_each_thread_during_a_query(eng, monkeypatch):
    seen = []  # (thread id, phase, trace) after every bind and set_phase

    def recording(fn):
        def wrapper(*a, **kw):
            token = fn(*a, **kw)
            e = threadmap.current_entry() or {}
            seen.append((threading.get_ident(), e.get("phase"), e.get("trace")))
            return token
        return wrapper

    monkeypatch.setattr(threadmap, "bind", recording(threadmap.bind))
    monkeypatch.setattr(threadmap, "set_phase", recording(threadmap.set_phase))
    main = threading.get_ident()
    eng.execute_query(AGG_Q)
    trace = eng.tracer.last()
    assert all(tr is trace for _, _, tr in seen)
    mine = {p for t, p, _ in seen if t == main}
    others = {p for t, p, _ in seen if t != main}
    assert mine == {"host", "device_dispatch", "stall"}
    assert others == {"stage"}  # the prefetch thread, bound to the query
    assert threadmap.current_entry() is None  # unbound once it ended


def _gc_in(eng, monkeypatch, where: str) -> None:
    """Make the next query collect once, on ``where``: the query thread
    (its compile of the fragment) or the prefetch thread (its staging)."""
    if where == "query_thread":
        real = eng._compile

        def compile_and_collect(stream):
            gc.collect()
            return real(stream)

        monkeypatch.setattr(eng, "_compile", compile_and_collect)
    else:
        real = eng._staged_windows

        def staged_and_collect(stream, stats, cancel):
            gc.collect()
            yield from real(stream, stats, cancel)

        monkeypatch.setattr(eng, "_staged_windows", staged_and_collect)


@pytest.mark.parametrize("where", ["query_thread", "prefetch_thread"])
def test_a_collection_inside_a_query_is_charged_to_it(eng, monkeypatch, where):
    hist = eng.tracer.registry.histogram_state
    before = hist("pixie_query_gc_seconds")
    gc.disable()  # only the forced collection runs
    try:
        _gc_in(eng, monkeypatch, where)
        eng.execute_query(AGG_Q)
    finally:
        gc.enable()
    trace = eng.tracer.last()
    assert trace.usage.gc_ms > 0
    assert trace.usage.to_dict()["gc_ms"] == round(trace.usage.gc_ms, 3)
    after = hist("pixie_query_gc_seconds")
    assert after[2] == before[2] + 1
    assert after[3] - before[3] == pytest.approx(trace.usage.gc_ms / 1e3)


def test_a_collection_outside_any_query_charges_nothing(eng):
    gc.disable()
    try:
        eng.execute_query(AGG_Q)
        trace = eng.tracer.last()
        assert trace.usage.gc_ms == 0.0
        gc.collect()
    finally:
        gc.enable()
    assert trace.usage.gc_ms == 0.0
    assert threadmap.current_entry() is None


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("query", [AGG_Q, ROWS_Q], ids=["agg", "rows"])
def test_engine_self_time_and_its_parts_add_up_to_the_query(query, depth):
    eng = _engine(depth)
    eng.execute_query(query, max_output_rows=N)
    trace = eng.tracer.last()
    (compile_,) = [s for s in trace.spans if s.name == "compile"]
    parts_s = (compile_.end_unix_nano - compile_.start_unix_nano) / 1e9
    for f in trace.stats.fragments:
        stages = f.stage_snapshot()
        parts_s += sum(stages.get(k, (0.0,))[0]
                       for k in ("compute", "finalize", "materialize"))
    parts_s += trace.pipeline["stall_secs"]
    self_s = trace.engine_self_ms / 1e3
    assert self_s > 0
    assert self_s + parts_s == pytest.approx(trace.duration_s, rel=0.01)
    assert trace.root.attributes["engine_self_ms"] == round(trace.engine_self_ms, 3)
    state = eng.tracer.registry.histogram_state("pixie_query_engine_self_seconds")
    assert state[2] == 2  # the warm-up query and this one


def test_window_spans_take_both_ends_from_the_timer(profiled):
    trace, _ = profiled
    for f in trace.stats.fragments:
        windows = [s for s in trace.spans
                   if s.name == "window.compute" and s.parent_id == f.span.span_id]
        total_ns = sum(s.end_unix_nano - s.start_unix_nano for s in windows)
        assert total_ns == pytest.approx(f.stage_snapshot()["compute"][0] * 1e9,
                                         abs=len(windows))
        # Each ends where the next window's fold could start: none overlap.
        ends = sorted((s.start_unix_nano, s.end_unix_nano) for s in windows)
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
