"""The trace arithmetic and the metric readers, on records made by hand."""

import pytest

from portbench import run, trace
from portbench.work import scan_bytes


def test_busy_time_is_the_union_of_device_intervals():
    dev = [("k", 0, 10), ("k", 5, 15), ("copy", 20, 30), ("k", 30, 31)]
    assert trace.merged(dev) == [[0, 15], [20, 31]]
    assert trace.busy_s(dev) == pytest.approx(26e-9)


def test_queries_cut_by_the_stretch_count_by_their_share():
    spans = [(0.0, 1.0), (1.0, 2.0), (2.0, 4.0)]
    assert trace.queries_within(spans, 0.5, 3.0) == pytest.approx(0.5 + 1.0 + 0.5)


def test_idle_gaps_go_to_the_innermost_host_op():
    dev = [("k", 0, 10), ("k", 20, 30), ("k", 40, 50), ("k", 51, 60)]
    host = [("aten::zeros", 5, 34), ("cudaMemcpyAsync", 12, 18), ("outer", 0, 100)]
    gaps = dict(map(tuple, trace.idle_gaps(dev, host)))
    assert gaps == pytest.approx({"cudaMemcpyAsync": 10e-9, "outer": 11e-9})


def test_top_sums_by_name_and_cuts_long_names():
    long = "void at::native::" + "x" * 300
    got = trace.top([("a", 1.0), (long, 2.0), ("a", 2.5)], k=1)
    assert got == [["a", 3.5]]
    assert trace.top([(long, 2.0)])[0][0] == long[:trace.NAME_CHARS]


def _view(cell, stretch, rows=1000, compile_ms=(), peak=3.35e12):
    return run.RunView(cell, rows, 15, [0.1, 0.3], 0.4, 9.0, stretch, list(compile_ms), peak)


@pytest.fixture(scope="module")
def listed():
    return run.find_cell("pem_default.http_stats")


def test_the_readers_on_a_stretch(listed):
    st = trace.Stretch(0.0, 2.0, 4.0, 0.5, [
        ("void at::native::indexFuncLargeIndex<long>", 0.3),
        ("void at::native::_scatter_gather_elementwise_kernel", 0.01),
        ("Memcpy DtoH (Device -> Pinned)", 0.02),
    ])
    got = run.read_metrics(_view(listed, st, compile_ms=[1.0, 3.0]), listed.per_layer)
    assert got["device.idle_pct"]["value"] == pytest.approx(75.0)
    assert got["fold.device_ops_per_query"]["value"] == pytest.approx(0.5)
    need = scan_bytes(listed.config, listed.traffic, 1000, 15)
    assert need == 1000 * (8 + 4 + 4 + 8) + 15 * 32
    assert got["fold.roofline_pct"]["value"] == pytest.approx(100 * need / 3.35e12 / (0.5 / 4))
    assert got["planner.compile_ms"]["value"] == 2.0
    for m in got:
        assert got[m]["unit"] == next(e["unit"] for e in listed.per_layer if e["name"] == m)


def test_the_end_to_end_readers(listed):
    got = run.read_metrics(_view(listed, None), listed.end_to_end)
    assert got["rows_per_s"]["value"] == pytest.approx(1000 * 2 / 0.4)
    assert got["query_p95_s"]["value"] == pytest.approx(0.29)
    assert got["setup_s"]["value"] == 9.0


def test_a_reader_that_finds_nothing_returns_nothing(listed):
    empty = trace.Stretch(0.0, 1.0, 2.0, 0.0, [])
    assert run.read_metrics(_view(listed, empty), listed.per_layer) == {}
    assert run.read_metrics(_view(listed, None), listed.per_layer) == {}
    # An unknown card has no published peak: no roofline share, never 0.
    st = trace.Stretch(0.0, 1.0, 2.0, 0.5, [("void at::native::k", 0.1)])
    got = run.read_metrics(_view(listed, st, peak=None), listed.per_layer)
    assert "fold.roofline_pct" not in got and "device.idle_pct" in got
