"""The port's window path against the JAX package's: device-resident
windows (``table_store/device_cache.py``), the prefetch pipeline
(``exec/pipeline.py``), zone-map window skipping (``exec/zoneskip.py``)
and the ingest sketches' HLL registers, on the CPU.

The replay: 5 x 1024 + 357 rows of http_events with every column the six
scripts read, appended in four uneven batches, read in 1024-row windows
(five full windows and a ragged tail). The JAX side runs its Pallas
kernels in interpret mode and folds with XLA (``cpu_fold_threads=1``).
Tolerances are those of ``tests/test_torch_engine.py``: keys, counts and
INT64 aggregates exact; the FLOAT64 mean rtol 1e-5 and max within one
f32 ulp; error rate rtol 1e-12; p50/p99 rtol 0.05. Row chains are exact,
in row order. Every wait in the pipeline tests has a timeout.
"""

import sys
import threading
import time
import traceback

import numpy as np
import pytest
import torch

from pixie_tpu.config import override_flag as jax_override_flag
from pixie_tpu.exec import plan as jax_plan
from pixie_tpu.exec import zoneskip as jax_zoneskip
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.ops.hll import hll_init_np as jax_hll_init_np
from pixie_tpu.ops.hll import hll_update_np as jax_hll_update_np
from pixie_tpu.table_store.table import Table as JaxTable
from pixie_tpu.types.batch import HostBatch as JaxHostBatch
from pixie_tpu.types.dtypes import DataType as JaxDataType
from pixie_tpu.types.relation import Relation as JaxRelation
from pixie_tpu.types.strings import StringDictionary as JaxDictionary
from pixie_tpu_torch import Engine, QueryCancelled
from pixie_tpu_torch.config import clear_flag, set_flag
from pixie_tpu_torch.exec import plan
from pixie_tpu_torch.exec import zoneskip
from pixie_tpu_torch.exec.pipeline import DeadlineEvent, WindowPipeline
from pixie_tpu_torch.scripts import load_script
from pixie_tpu_torch.table_store import Table
from pixie_tpu_torch.table_store import device_cache as dc
from pixie_tpu_torch.table_store import table as table_mod
from pixie_tpu_torch.types import DataType, Relation, StringDictionary
from pixie_tpu_torch.types import host_batch_from_numpy
from pixie_tpu_torch.types.batch import stage_planes

from test_torch_engine import _by_key, _run_jax
from test_torch_planner import HTTP_STATS_F64

W = 1 << 10
N = 5 * W + 357
APPENDS = (700, 1500, 2048, N - 700 - 1500 - 2048)
CPU = torch.device("cpu")

SERVICES = [f"svc-{i}" for i in range(32)]
PATHS = [f"/api/v1/ep{i}" for i in range(8)]
METHODS = ["GET", "POST", "PUT", "DELETE"]
RELATION = [
    ("time_", "TIME64NS"), ("latency_ns", "INT64"), ("resp_status", "INT64"),
    ("service", "STRING"), ("req_path", "STRING"), ("req_method", "STRING"),
    ("resp_body_size", "INT64"),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prefetch_threads():
    return [
        t for t in threading.enumerate()
        if t.name.startswith("pixie-window-prefetch") and t.is_alive()
    ]


def _assert_no_prefetch_threads(timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline and _prefetch_threads():
        time.sleep(0.01)
    assert _prefetch_threads() == []


# -- the replay -----------------------------------------------------------------
def _replay():
    rng = np.random.default_rng(11)
    statuses = np.array([200, 200, 200, 200, 404, 500])
    return {
        "time_": np.arange(N, dtype=np.int64),
        "latency_ns": rng.integers(1_000, 100_000_000, N),
        "resp_status": statuses[rng.integers(0, len(statuses), N)].astype(np.int64),
        "service": rng.integers(0, len(SERVICES), N).astype(np.int32),
        "req_path": rng.integers(0, len(PATHS), N).astype(np.int32),
        "req_method": rng.integers(0, len(METHODS), N).astype(np.int32),
        "resp_body_size": rng.integers(0, 1 << 16, N),
    }


def _batches():
    """(JAX HostBatch, port HostBatch) per append, over shared strings."""
    cols = _replay()
    strings = {"service": SERVICES, "req_path": PATHS, "req_method": METHODS}
    dicts = {c: JaxDictionary(s) for c, s in strings.items()}
    rel = JaxRelation([(n, getattr(JaxDataType, t)) for n, t in RELATION])
    off = 0
    for m in APPENDS:
        part = {n: (cols[n][off:off + m],) for n, _t in RELATION}
        off += m
        yield (
            JaxHostBatch(relation=rel, cols=part, length=m, dicts=dicts),
            host_batch_from_numpy(RELATION, part, strings),
        )


def _port_engine(depth, **kw):
    eng = Engine(window_rows=W, device="cpu", pipeline_depth=depth, **kw)
    for _jb, pb in _batches():
        eng.append_data("http_events", pb)
    return eng


@pytest.fixture
def residency(request):
    set_flag("device_residency", request.param)
    try:
        yield request.param
    finally:
        clear_flag("device_residency")


AGG_SCRIPTS = {
    "http_stats": (lambda: load_script("px/http_stats").pxl,
                   ["service", "req_path"], {}),
    "http_stats_float64": (lambda: HTTP_STATS_F64, ["service", "req_path"],
                           {"pallas_dense_fold": "interpret"}),
    "service_stats": (lambda: load_script("px/service_stats").pxl, ["service"],
                      {"pallas_tdigest": "interpret"}),
}
ROW_SCRIPTS = ("http_data", "http_errors", "http_data_filtered")


@pytest.fixture(scope="module")
def jax_answers():
    """The JAX engine's answer to each of the six scripts, once."""
    eng = JaxEngine(window_rows=W)
    for jb, _pb in _batches():
        eng.append_data("http_events", jb)
    out = {}
    for name, (query, _keys, flags) in AGG_SCRIPTS.items():
        out[name] = _run_jax(eng, query(), **flags)
    for name in ROW_SCRIPTS:
        out[name] = _run_jax(eng, load_script(f"px/{name}").pxl)
    return out


def _check_agg(name, got_hb, ref_hb):
    _query, keys, _flags = AGG_SCRIPTS[name]
    got, ref = _by_key(got_hb, keys), _by_key(ref_hb, keys)
    for k in keys:
        assert list(got[k]) == list(ref[k])
        assert got[k + "_name"] == ref[k + "_name"]
    if name == "http_stats":
        for c in ("n", "lat_mean", "lat_max"):
            np.testing.assert_array_equal(got[c], ref[c])
    elif name == "http_stats_float64":
        np.testing.assert_array_equal(got["n"], ref["n"])
        np.testing.assert_allclose(got["lat_mean"], ref["lat_mean"], rtol=1e-5)
        np.testing.assert_allclose(got["lat_max"], ref["lat_max"],
                                   rtol=np.finfo(np.float32).eps, atol=0)
    else:
        np.testing.assert_array_equal(got["throughput"], ref["throughput"])
        np.testing.assert_allclose(got["error_rate"], ref["error_rate"],
                                   rtol=1e-12)
        np.testing.assert_allclose(got["p50"], ref["p50"], rtol=0.05)
        np.testing.assert_allclose(got["p99"], ref["p99"], rtol=0.05)


def _check_rows(got_hb, ref_hb):
    assert got_hb.relation.column_names == ref_hb.relation.column_names
    got, ref = got_hb.to_pydict(decode_strings=False), ref_hb.to_pydict(decode_strings=False)
    assert got_hb.length == ref_hb.length > 0
    for c in ref:
        np.testing.assert_array_equal(got[c], ref[c], err_msg=c)
    got_s, ref_s = got_hb.to_pydict(), ref_hb.to_pydict()
    for c in ("service", "req_path", "req_method"):
        if c in ref_s:
            assert list(got_s[c]) == list(ref_s[c])


# -- engine level ---------------------------------------------------------------
@pytest.mark.parametrize("depth", [1, 2], ids=["depth1", "depth2"])
@pytest.mark.parametrize("residency", [True, False], indirect=True,
                         ids=["resident", "host_staged"])
@pytest.mark.parametrize("script", list(AGG_SCRIPTS) + list(ROW_SCRIPTS))
def test_scripts_match_jax_engine(script, residency, depth, jax_answers):
    """Each of the six scripts answers as the JAX engine does, from
    resident windows or host-staged ones, serial or pipelined."""
    eng = _port_engine(depth)
    query = (AGG_SCRIPTS[script][0]() if script in AGG_SCRIPTS
             else load_script(f"px/{script}").pxl)
    out = eng.execute_query(query)["output"]
    st = eng.last_stats
    assert st.pipeline["depth"] == depth
    if script in AGG_SCRIPTS:
        _check_agg(script, out, jax_answers[script])
        assert st.windows == -(-N // W) and st.rows == N
        # The five full windows were staged at append time; only the
        # ragged tail is staged by the query.
        want = (5, 1) if residency else (0, 6)
        assert (st.resident_windows, st.staged_windows) == want
    else:
        _check_rows(out, jax_answers[script])
        assert st.skipped_windows == 0
    _assert_no_prefetch_threads()


def test_attribution_run_matches_default_run(jax_answers):
    """analyze=True runs serially with the stage times filled in, and
    answers as the default run does."""
    eng = _port_engine(2)
    out = eng.execute_query(load_script("px/http_stats").pxl, analyze=True)["output"]
    st = eng.last_stats
    assert st.sync and st.pipeline["depth"] == 1
    assert st.fold_s > 0 and st.finalize_s > 0 and st.wall_s >= st.fold_s
    _check_agg("http_stats", out, jax_answers["http_stats"])


# -- device cache (the scenarios of tests/test_device_cache.py) -----------------
QUERY = """
import px
df = px.DataFrame(table='events')
df = df[df.v >= 0]
out = df.groupby('svc').agg(n=('v', px.count), s=('v', px.sum))
px.display(out)
"""

EVENTS = Relation([
    ("time_", DataType.TIME64NS), ("v", DataType.INT64), ("svc", DataType.STRING),
])


def _events(n, start=0):
    rng = np.random.default_rng(3 + start)
    return {
        "time_": np.arange(start, start + n, dtype=np.int64),
        "v": rng.integers(0, 100, n).astype(np.int64),
        "svc": [f"s{i % 5}" for i in range(n)],
    }


def _mk_table(n, name="events"):
    t = Table(name, EVENTS)
    t.device = CPU
    t.device_window_rows = W
    t.append(_events(n))
    return t


@pytest.fixture
def count_stagings(monkeypatch):
    calls = []
    orig = table_mod.stage_window

    def counting(table, k, w):
        calls.append(k)
        return orig(table, k, w)

    monkeypatch.setattr(table_mod, "stage_window", counting)
    return calls


class TestDeviceCache:
    def test_append_stages_complete_windows(self):
        t = _mk_table(3 * W + 17)
        assert len(t._device_cache) == 3  # the tail is not staged yet
        wins = list(t.device_scan(window_rows=W))
        assert len(wins) == 4  # the tail, staged on demand
        assert sum(hi - lo for _, lo, hi in wins) == 3 * W + 17
        win0 = wins[0][0]
        assert win0.capacity == W and win0.event is None
        assert win0.cols["v"][0].dtype == torch.int64
        assert win0.cols["svc"][0].dtype == torch.int32
        assert win0.nbytes == W * (8 + 8 + 4) == t.resident_bytes // 4
        tail = wins[-1][0]
        # Pad values past the live rows: 0 for INT64, NULL_ID for STRING.
        assert int(tail.cols["v"][0][17:].abs().sum()) == 0
        assert bool((tail.cols["svc"][0][17:] == -1).all())

    def test_second_scan_hits(self, count_stagings):
        t = _mk_table(2 * W)
        assert count_stagings == [0, 1]  # at append
        count_stagings.clear()
        list(t.device_scan(window_rows=W))
        list(t.device_scan(window_rows=W))
        assert count_stagings == []  # both served from append-time stagings

    def test_grown_tail_supersedes(self):
        t = _mk_table(W + 10)
        list(t.device_scan(window_rows=W))
        n_entries = len(t._device_cache)
        t.append(_events(10, start=W + 10))
        wins = list(t.device_scan(window_rows=W))
        assert sum(hi - lo for _, lo, hi in wins) == W + 20
        assert len(t._device_cache) == n_entries  # the stale tail was evicted
        assert (W, 1, W, 20) in t._device_cache.keys()

    def test_time_bounds(self):
        t = _mk_table(2 * W)
        wins = list(t.device_scan(start_time=100, stop_time=W + 50,
                                  window_rows=W))
        assert sum(hi - lo for _, lo, hi in wins) == W + 50 - 100

    def test_byte_budget_lru_across_two_tables(self, monkeypatch):
        """One budget over every table's cache: the globally least
        recently used window goes first."""
        win_bytes = W * (8 + 8 + 4)
        monkeypatch.setenv("PIXIE_TPU_DEVICE_CACHE_BYTES", str(3 * win_bytes))
        a = _mk_table(2 * W, name="a")
        b = _mk_table(2 * W, name="b")
        assert dc.total_resident_bytes() <= 3 * win_bytes
        assert a._device_cache.keys() == [(W, 1, W, W)]
        assert len(b._device_cache) == 2
        # Touching a's window makes b's first window the LRU victim.
        assert a._device_cache.get((W, 1, W, W)) is not None
        c = _mk_table(W, name="c")
        assert len(c._device_cache) == 1
        assert b._device_cache.keys() == [(W, 1, W, W)]
        assert dc.total_resident_bytes() <= 3 * win_bytes

    def test_expiry_evicts(self):
        rel = Relation([("time_", DataType.TIME64NS), ("v", DataType.INT64)])
        t = Table("ring", rel, max_bytes=2 * W * 16)
        t.device = CPU
        t.device_window_rows = W
        for i in range(4):
            t.append({
                "time_": np.arange(W, dtype=np.int64) + i * W,
                "v": np.arange(W, dtype=np.int64),
            })
        first = t.first_row_id()
        assert first > 0  # the ring expired early batches
        assert all(w.row0 + w.n > first
                   for w in (t._device_cache.get(k) for k in t._device_cache.keys()))
        wins = list(t.device_scan(window_rows=W))
        assert all(lo >= first for _, lo, _hi in wins)

    @pytest.mark.stress
    def test_global_budget_under_concurrent_appends(self, monkeypatch):
        """Tables on several threads stage and evict through the one
        global LRU at once: no thread fails, each cache's byte count
        matches its windows, and the sum stays inside the budget."""
        win_bytes = W * (8 + 8 + 4)
        budget = 5 * win_bytes
        monkeypatch.setenv("PIXIE_TPU_DEVICE_CACHE_BYTES", str(budget))
        tables = [_mk_table(W, name=f"c{i}") for i in range(8)]
        errors = []

        def work(t):
            try:
                for k in range(1, 6):
                    t.append(_events(W, start=k * W))
                    list(t.device_scan(window_rows=W))
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(exc)

        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=work, args=(t,)) for t in tables]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
                assert not th.is_alive(), "staging worker hung"
        finally:
            sys.setswitchinterval(switch)
        assert not errors, errors
        for t in tables:
            c = t._device_cache
            assert c.nbytes == sum(c.get(k).nbytes for k in c.keys())
        assert dc.total_resident_bytes() <= budget

    def test_table_without_device_stages_nothing(self):
        t = Table("nodev", EVENTS)
        t.device_window_rows = W
        t.append(_events(2 * W))
        assert len(t._device_cache) == 0
        with pytest.raises(ValueError, match="no device"):
            list(t.device_scan(window_rows=W))

    def test_steady_state_no_restaging(self, count_stagings):
        e = Engine(window_rows=W, device="cpu")
        e.append_data("events", _events(3 * W))  # no tail
        assert count_stagings == [0, 1, 2]  # at append
        count_stagings.clear()
        e.execute_query(QUERY)
        assert count_stagings == []
        e.execute_query(QUERY)
        assert count_stagings == []
        st = e.last_stats
        assert (st.resident_windows, st.staged_windows) == (3, 0)

    def test_engine_window_size_reaches_appends(self, count_stagings):
        """Tables made through an engine stage at the engine's window
        size from the first append, not at the window_rows flag's."""
        e = Engine(window_rows=2 * W, device="cpu")
        e.create_table("events", EVENTS)
        e.append_data("events", _events(4 * W))
        t = e.tables["events"]
        assert t.device == CPU and t.device_window_rows == 2 * W
        assert sorted(t._device_cache.keys()) == [
            (2 * W, 0, 0, 2 * W), (2 * W, 1, 2 * W, 2 * W)]
        assert count_stagings == [0, 1]  # at append
        count_stagings.clear()
        e.execute_query(QUERY)
        assert count_stagings == []
        assert e.last_stats.staged_windows == 0

    def test_residency_off_stages_nothing_at_append(self):
        set_flag("device_residency", False)
        try:
            e = Engine(window_rows=W, device="cpu")
            e.append_data("events", _events(2 * W))
            assert len(e.tables["events"]._device_cache) == 0
            e.execute_query(QUERY)
            assert e.last_stats.staged_windows == 2
            assert len(e.tables["events"]._device_cache) == 0
        finally:
            clear_flag("device_residency")


# -- pipeline (the scenarios of tests/test_pipeline.py without joins or
# streaming) ------------------------------------------------------------------
def _mk_engine(n=10 * W + 57, depth=2, cls=Engine, **kw):
    eng = cls(window_rows=W, pipeline_depth=depth, device="cpu", **kw)
    rng = np.random.default_rng(5)
    eng.append_data("t", {
        "time_": np.arange(n, dtype=np.int64),
        "k": rng.integers(0, 41, n),
        "v": rng.integers(0, 1000, n),
    })
    return eng


AGG_Q = (
    "import px\ndf = px.DataFrame(table='t')\n"
    "df = df[df.v > 100]\n"
    "df = df.groupby('k').agg(n=('v', px.count), s=('v', px.sum),"
    " m=('v', px.mean))\npx.display(df)"
)
ROWS_Q = (
    "import px\ndf = px.DataFrame(table='t')\n"
    "df.w = df.v * 2\ndf = df[df.w > 900]\npx.display(df)"
)


class _TripAfter:
    """Cancel handle that fires after N is_set() polls: a deterministic
    way to cancel mid-pipeline."""

    def __init__(self, n):
        self.n = n
        self.calls = 0

    def is_set(self):
        self.calls += 1
        return self.calls > self.n


class _BoomEngine(Engine):
    """Engine whose host -> device staging fails after a few windows."""

    device_residency = False  # every window goes through _stage

    def __init__(self, *a, boom_after=2, **kw):
        super().__init__(*a, **kw)
        self._boom_after = boom_after
        self._n_staged = 0

    def _stage(self, hb, capacity):
        self._n_staged += 1
        if self._n_staged > self._boom_after:
            raise RuntimeError("boom: staging failed")
        return super()._stage(hb, capacity)


class TestPipeline:
    @pytest.mark.parametrize("query", [AGG_Q, ROWS_Q], ids=["agg", "rows"])
    @pytest.mark.parametrize("residency", [True, False], indirect=True,
                             ids=["resident", "host_staged"])
    def test_depths_identical(self, query, residency):
        outs = []
        for depth in (1, 2, 4):
            eng = _mk_engine(depth=depth)
            out = eng.execute_query(query, max_output_rows=1 << 20)
            assert eng.last_stats.pipeline["windows"] == 11
            outs.append(out["output"].to_pydict(decode_strings=False))
        for other in outs[1:]:
            assert set(other) == set(outs[0])
            for c in outs[0]:
                np.testing.assert_array_equal(outs[0][c], other[c])
        _assert_no_prefetch_threads()

    def test_mid_pipeline_cancel_joins_thread(self):
        eng = _mk_engine(n=30 * W, depth=3)
        with pytest.raises(QueryCancelled):
            eng.execute_query(AGG_Q, cancel=_TripAfter(5))
        _assert_no_prefetch_threads()
        assert eng.execute_query(AGG_Q)["output"].length == 41

    def test_deadline_cancels(self):
        eng = _mk_engine(n=4 * W, depth=2)
        expired = DeadlineEvent(threading.Event(), time.time() - 1.0)
        with pytest.raises(QueryCancelled):
            eng.execute_query(AGG_Q, cancel=expired)
        _assert_no_prefetch_threads()

    def test_staging_error_surfaces_with_traceback(self):
        eng = _mk_engine(n=10 * W, depth=2, cls=_BoomEngine, boom_after=3)
        with pytest.raises(RuntimeError, match="boom") as ei:
            eng.execute_query(AGG_Q)
        funcs = [f.name for f in traceback.extract_tb(ei.value.__traceback__)]
        assert "_stage" in funcs and "_produce" in funcs
        _assert_no_prefetch_threads()
        eng._n_staged = -(10 ** 9)  # the engine still works afterwards
        assert eng.execute_query(AGG_Q)["output"].length == 41

    def test_close_twice_drops_unconsumed_windows(self):
        staged = []

        def gen():
            for i in range(10):
                staged.append(i)
                yield i

        pipe = WindowPipeline(gen(), depth=3)
        it = iter(pipe)
        assert next(it) == 0
        pipe.close()
        pipe.close()
        assert pipe._q.empty() and pipe._thread is None
        assert len(staged) <= 4  # at most depth + 1 windows were staged
        _assert_no_prefetch_threads()

    def test_close_wakes_a_blocked_producer(self, monkeypatch):
        """A consumer that stops early (a limit) closes a pipeline whose
        producer waits for a free slot: close() wakes it at once instead
        of at its next poll (made 30 s long here)."""
        from pixie_tpu_torch.exec import pipeline as pipeline_mod

        monkeypatch.setattr(pipeline_mod, "_POLL_S", 30.0)
        staged = []

        def gen():
            for i in range(10):
                staged.append(i)
                yield i

        pipe = WindowPipeline(gen(), depth=2)
        it = iter(pipe)
        assert next(it) == 0
        deadline = time.time() + 10
        while len(staged) < 2 and time.time() < deadline:
            time.sleep(0.01)
        t0 = time.perf_counter()
        pipe.close()
        assert time.perf_counter() - t0 < 10.0
        assert staged == [0, 1]  # nothing staged after close
        _assert_no_prefetch_threads()

    @pytest.mark.stress
    def test_concurrent_queries_no_thread_leak(self):
        """Complete, cancelled and failing pipelined queries on engines
        in threads: no prefetch thread survives, every worker ends."""
        _assert_no_prefetch_threads()
        base = threading.active_count()
        engines = [_mk_engine(n=8 * W, depth=3) for _ in range(3)]
        boom = _mk_engine(n=8 * W, depth=3, cls=_BoomEngine, boom_after=2)
        errors = []

        def ok(e):
            try:
                for _ in range(4):
                    assert e.execute_query(AGG_Q)["output"].length == 41
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(exc)

        def cancelled(e):
            try:
                for _ in range(4):
                    with pytest.raises(QueryCancelled):
                        e.execute_query(AGG_Q, cancel=_TripAfter(2))
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        def failing():
            try:
                for _ in range(4):
                    boom._n_staged = 0
                    with pytest.raises(RuntimeError, match="boom"):
                        boom.execute_query(AGG_Q)
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [
                threading.Thread(target=ok, args=(engines[0],)),
                threading.Thread(target=ok, args=(engines[1],)),
                threading.Thread(target=cancelled, args=(engines[2],)),
                threading.Thread(target=failing),
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive(), "stress worker hung"
        finally:
            sys.setswitchinterval(switch)
        assert not errors, errors
        _assert_no_prefetch_threads()
        deadline = time.time() + 5
        while time.time() < deadline and threading.active_count() > base:
            time.sleep(0.01)
        assert threading.active_count() <= base

    def test_serial_depth_records_windows_only(self):
        eng = _mk_engine(n=3 * W, depth=1)
        eng.execute_query(AGG_Q)
        lp = eng.last_stats.pipeline
        assert lp["depth"] == 1
        assert lp["windows"] == 3
        assert lp["stall_secs"] == 0.0 and lp["stage_secs"] == 0.0


# -- zone skipping ----------------------------------------------------------------
def _chains(pl, DT, dicts):
    """The same op chains built from either package's plan module."""
    C, L, F = pl.ColumnRef, pl.Literal, pl.FuncCall
    seq, svc = C("seq"), C("svc")

    def i(v):
        return L(v, DT.INT64)

    def f(name, *args):
        return F(name, tuple(args))

    return {
        "ge": [pl.FilterOp(f("greaterThanEqual", seq, i(5000)))],
        "rename": [pl.MapOp((("s", seq), ("v", C("v")))),
                   pl.FilterOp(f("lessThan", C("s"), i(100)))],
        "and": [pl.FilterOp(f("logicalAnd", f("greaterThan", seq, i(10)),
                              f("lessThanEqual", seq, i(20))))],
        "flipped": [pl.FilterOp(f("greaterThanEqual", i(7), seq))],
        "string_eq": [pl.FilterOp(f("equal", svc, L("s3", DT.STRING)))],
        "unknown_string": [pl.FilterOp(f("equal", svc, L("nope", DT.STRING)))],
        "computed": [pl.MapOp((("w", f("multiply", seq, i(2))),)),
                     pl.FilterOp(f("greaterThan", C("w"), i(5)))],
        "contradiction": [pl.FilterOp(f("logicalAnd", f("lessThan", seq, i(5)),
                                        f("greaterThan", seq, i(10))))],
        "then_limit": [pl.FilterOp(f("greaterThanEqual", seq, i(3))),
                       pl.LimitOp(10)],
        "float_literal": [pl.FilterOp(f("greaterThan", seq, L(2.5, DT.FLOAT64)))],
        "or": [pl.FilterOp(f("logicalOr", f("lessThan", seq, i(5)),
                             f("greaterThan", seq, i(10))))],
    }


def test_predicate_ranges_match_jax():
    names = [f"s{i}" for i in range(5)]
    mine = _chains(plan, DataType, {})
    ref = _chains(jax_plan, JaxDataType, {})
    my_dicts = {"svc": StringDictionary(names)}
    ref_dicts = {"svc": JaxDictionary(names)}
    for name in ref:
        got = zoneskip.predicate_ranges(mine[name], my_dicts)
        want = jax_zoneskip.predicate_ranges(ref[name], ref_dicts)
        assert got == want, name
    assert zoneskip.predicate_ranges(mine["ge"], my_dicts) == {"seq": (5000, None)}


SEQ_QUERIES = {
    "agg_ge": ("import px\ndf = px.DataFrame(table='z')\n"
               "df = df[df.seq >= 5000]\n"
               "px.display(df.groupby('k').agg(n=('seq', px.count), "
               "s=('seq', px.sum)))"),
    "rows_lt": ("import px\ndf = px.DataFrame(table='z')\n"
                "df = df[df.seq < 1500]\npx.display(df)"),
    "agg_range": ("import px\ndf = px.DataFrame(table='z')\n"
                  "df = df[df.seq > 2100]\ndf = df[df.seq <= 3000]\n"
                  "px.display(df.groupby('k').agg(n=('seq', px.count)))"),
}


@pytest.fixture(scope="module")
def sorted_tables():
    """A sorted INT64 column in both engines, appended one window at a
    time so each window has its own zone entry."""
    jax_eng = JaxEngine(window_rows=W)
    cols = {
        "time_": np.arange(8 * W, dtype=np.int64),
        "seq": np.arange(8 * W, dtype=np.int64),
        "k": np.arange(8 * W, dtype=np.int64) % 7,
    }
    parts = [{c: v[i * W:(i + 1) * W] for c, v in cols.items()}
             for i in range(8)]
    for p in parts:
        jax_eng.append_data("z", p)
    return jax_eng, parts


@pytest.mark.parametrize("residency", [True, False], indirect=True,
                         ids=["resident", "host_staged"])
@pytest.mark.parametrize("query", list(SEQ_QUERIES))
def test_zone_skip_counts_match_jax(query, residency, sorted_tables):
    """The windows the JAX engine skips on its resident path. With
    residency off the JAX engine prunes host reads at ``Table.scan``'s
    default 2^17-row grain (one zone here, so nothing skips); the port
    prunes at its window size, so it skips the same windows on both
    paths."""
    jax_eng, parts = sorted_tables
    eng = Engine(window_rows=W, device="cpu")
    for p in parts:
        eng.append_data("z", p)
    q = SEQ_QUERIES[query]
    with jax_override_flag("device_residency", True):
        _run_jax(jax_eng, q)
    want_skips = jax_eng.tracer.last().usage.skipped_windows
    with jax_override_flag("device_residency", residency):
        ref = _run_jax(jax_eng, q)
    got = eng.execute_query(q)["output"]
    st = eng.last_stats
    assert st.skipped_windows == want_skips > 0
    assert st.windows == 8 - want_skips
    a, b = got.to_pydict(), ref.to_pydict()
    order_a = np.argsort(a[list(a)[0]], kind="stable")
    order_b = np.argsort(b[list(b)[0]], kind="stable")
    for c in b:
        np.testing.assert_array_equal(np.asarray(a[c])[order_a],
                                      np.asarray(b[c])[order_b], err_msg=c)


def test_zone_skip_flag_off_skips_nothing(sorted_tables):
    _jax_eng, parts = sorted_tables
    eng = Engine(window_rows=W, device="cpu")
    for p in parts:
        eng.append_data("z", p)
    set_flag("scan_zone_skip", False)
    try:
        eng.execute_query(SEQ_QUERIES["agg_ge"])
    finally:
        clear_flag("scan_zone_skip")
    assert eng.last_stats.skipped_windows == 0
    assert eng.last_stats.windows == 8


# -- ingest sketches ----------------------------------------------------------------
def test_sketch_registers_match_jax():
    """The sketches' HLL registers and zone maps equal the JAX
    package's, column by column, over the same appends."""
    rel = [("time_", "TIME64NS"), ("v", "INT64"), ("svc", "STRING")]
    mine = Table("sk", Relation([(n, getattr(DataType, t)) for n, t in rel]))
    ref = JaxTable("sk", JaxRelation([(n, getattr(JaxDataType, t)) for n, t in rel]))
    rng = np.random.default_rng(17)
    allv = []
    for n in (1000, 3000, 77):
        v = rng.integers(-(1 << 40), 1 << 40, n)
        svc = [f"s{int(x)}" for x in rng.integers(0, 300, n)]
        t = np.arange(n, dtype=np.int64)
        mine.append({"time_": t, "v": v, "svc": svc})
        ref.append({"time_": t, "v": v, "svc": svc})
        allv.append(v)
    assert set(mine.sketches.cols) == set(ref.sketches.cols) == {"v", "svc"}
    assert mine.sketches.rows == ref.sketches.rows == 4077
    for c in ("v", "svc"):
        a, b = mine.sketches.cols[c], ref.sketches.cols[c]
        np.testing.assert_array_equal(a.registers, b.registers)
        assert a.ndv == b.ndv
        assert [(z.row0, z.n, z.lo, z.hi) for z in a.zones] == \
            [(z.row0, z.n, z.lo, z.hi) for z in b.zones]
    want = jax_hll_update_np(jax_hll_init_np(), np.concatenate(allv))
    np.testing.assert_array_equal(mine.sketches.cols["v"].registers, want)


# -- on the card ----------------------------------------------------------------------
@pytest.mark.cuda
def test_pinned_buffers_reused_back_to_back():
    """More windows staged back to back than the stager has pinned
    slots, with no wait between them: each slot is refilled only after
    its copy's event completed, so every window arrives intact."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: pinned staging runs only on CUDA")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(23)
    cap = 1 << 21
    wins = []
    for k in range(6):
        n = cap - 3 * k
        planes = [rng.integers(0, 1 << 40, n), rng.integers(0, 99, n).astype(np.int32),
                  rng.random(n)]
        staged, event = stage_planes(planes, [0, -1, 0.0],
                                     [torch.int64, torch.int32, torch.float32],
                                     cap, dev)
        wins.append((planes, staged, event))
    torch.cuda.current_stream(dev).wait_event(wins[-1][2])
    torch.cuda.synchronize(dev)
    for planes, staged, _event in wins:
        for p, t, pad in zip(planes, staged, (0, -1, 0.0)):
            got = t.cpu().numpy()
            np.testing.assert_array_equal(got[:len(p)], p.astype(got.dtype))
            assert (got[len(p):] == pad).all()
