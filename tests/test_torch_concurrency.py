"""Concurrent queries on one engine: the port against the JAX package.

Each case of ``tests/test_concurrency.py`` runs here on both packages
over the same seeded tables (600,000 and 300,000 rows, 2^17-row
windows):

- two concurrent queries overlap: with a simulated staging latency on
  every window (a wrap of ``Engine._staged_windows``, whose signature is
  ``(stream, stats=None)`` in the JAX engine and ``(stream, stats,
  cancel)`` in the port), the wall of two concurrent queries stays under
  1.7x one solo query, ``max_inflight`` reaches 2, and both answers equal
  the serial one bit for bit;
- mixed queries over three repeats equal the engine's own serial answers
  bit for bit, and the port's equal the JAX package's (keys and integer
  columns exact, FLOAT64 within rtol 1e-5);
- per-query state: each overlapping query's trace counts its own rows,
  a cancel reaches only its own query, and ``px.to_table`` sinks store
  each query's rows;
- the JAX fragment cache's race has, in the port, the counterpart of
  concurrent first compiles of one script on fresh engines;
- the load tester's concurrency sweep reports every query in its
  serving-histogram delta and sees two queries in flight.

A windowed join with zone skipping run beside another query gives the
same trace usage on both packages (fault C9: the port's join had no
trace fragment and its zone-skipped probe windows were not counted).
"""

from __future__ import annotations

import contextlib
import threading
import time
import types

import numpy as np
import pytest

import pixie_tpu.exec.joins as jax_joins
from pixie_tpu.config import override_flag as jax_override_flag
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.exec.stream import QueryCancelled as JaxQueryCancelled
from pixie_tpu.planner import CompilerState as JaxCompilerState
from pixie_tpu.planner import compile_pxl as jax_compile_pxl
from pixie_tpu.services import load_tester as jax_load_tester
from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.exec.stream import QueryCancelled
from pixie_tpu_torch.planner import CompilerState, compile_pxl
from pixie_tpu_torch.services import load_tester

ROWS = 600_000

AGG_Q = (
    "import px\n"
    "df = px.DataFrame(table='t')\n"
    "df = df.groupby('k').agg(n=('v', px.count), m=('v', px.mean))\n"
    "px.display(df, 'o')\n"
)
AGG_Q2 = (
    "import px\n"
    "df = px.DataFrame(table='t2')\n"
    "df = df.groupby('g').agg(lo=('w', px.min), hi=('w', px.max))\n"
    "px.display(df, 'o2')\n"
)

PKGS = {
    "jax": types.SimpleNamespace(
        engine=lambda window_rows: JaxEngine(window_rows=window_rows),
        QueryCancelled=JaxQueryCancelled, CompilerState=JaxCompilerState,
        compile_pxl=jax_compile_pxl, load_tester=jax_load_tester,
        executor_kw={}),
    "port": types.SimpleNamespace(
        engine=lambda window_rows: Engine(window_rows=window_rows,
                                          device="cpu"),
        QueryCancelled=QueryCancelled, CompilerState=CompilerState,
        compile_pxl=compile_pxl, load_tester=load_tester,
        executor_kw={"device": "cpu"}),
}
BOTH = pytest.mark.parametrize("pkg", list(PKGS))


def _mk_engine(pkg: str, window_rows: int = 1 << 17):
    rng = np.random.default_rng(7)
    eng = PKGS[pkg].engine(window_rows)
    eng.append_data("t", {
        "time_": np.arange(ROWS, dtype=np.int64),
        "v": rng.integers(0, 1_000_000, ROWS),
        "k": rng.integers(0, 512, ROWS),
    })
    eng.append_data("t2", {
        "time_": np.arange(ROWS // 2, dtype=np.int64),
        "w": rng.integers(0, 1_000_000, ROWS // 2),
        "g": rng.integers(0, 64, ROWS // 2),
    })
    return eng


def _batches_equal(a, b) -> bool:
    da, db = a.to_pydict(), b.to_pydict()
    if list(da) != list(db):
        return False
    return all(np.array_equal(da[c], db[c]) for c in da)


def _same_as_jax(port_hb, jax_hb, keys) -> None:
    """Rows matched by their keys: keys and integers exact, FLOAT64
    within rtol 1e-5."""
    p, j = port_hb.to_pydict(), jax_hb.to_pydict()
    assert list(p) == list(j)
    po = np.lexsort([np.asarray(p[k]) for k in reversed(keys)])
    jo = np.lexsort([np.asarray(j[k]) for k in reversed(keys)])
    for c in p:
        a, b = np.asarray(p[c])[po], np.asarray(j[c])[jo]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=c)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)


def _wrap_windows(pkg: str, eng, fn):
    """Route every window of ``eng`` through ``fn(windows)`` (a generator
    over the original ``_staged_windows``); returns the original."""
    orig = eng._staged_windows
    if pkg == "jax":
        def wrapped(stream, stats=None):
            yield from fn(orig(stream, stats))
    else:
        def wrapped(stream, stats, cancel):
            yield from fn(orig(stream, stats, cancel))
    eng._staged_windows = wrapped
    return orig


@pytest.fixture(scope="module")
def engines():
    """One engine per package over the seeded tables, shared by the
    module's cases as the JAX file's module fixture is."""
    return {pkg: _mk_engine(pkg) for pkg in PKGS}


def _serial(eng) -> dict:
    return {"a": eng.execute_query(AGG_Q)["o"],
            "b": eng.execute_query(AGG_Q2)["o2"]}


class TestOverlap:
    @BOTH
    def test_two_queries_overlap_wall_under_1_7x_solo(self, engines, pkg):
        """Two concurrent queries overlap on one engine: each window pays
        a simulated staging latency (a sleep, no lock held), so queries
        run one after the other would take about 2x solo. Both answers
        equal the serial one bit for bit."""
        eng = engines[pkg]

        def slow(windows):
            for w in windows:
                time.sleep(0.02)
                yield w

        orig = _wrap_windows(pkg, eng, slow)
        results = {}

        def run(key):
            t0 = time.perf_counter()
            res = eng.execute_query(AGG_Q)
            results[key] = (time.perf_counter() - t0, res)

        try:
            run("warm")
            solos = []
            for i in range(3):
                run(f"solo{i}")
                solos.append(results[f"solo{i}"][0])
            solo = sorted(solos)[1]  # median
            eng.max_inflight = 0
            t0 = time.perf_counter()
            threads = [
                threading.Thread(target=run, args=(f"conc{i}",))
                for i in range(2)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
        finally:
            eng._staged_windows = orig
        assert eng.max_inflight == 2, "queries never overlapped"
        assert wall < 1.7 * solo, (
            f"no overlap: two concurrent queries took {wall * 1e3:.0f}ms "
            f"vs solo {solo * 1e3:.0f}ms (>= 1.7x)"
        )
        for key in ("conc0", "conc1"):
            assert _batches_equal(
                results[key][1]["o"], results["solo0"][1]["o"]
            ), f"{key} diverged from serial execution"

    @BOTH
    def test_concurrent_mixed_queries_bit_identical(self, engines, pkg):
        """Different queries overlapping on one engine (no simulated
        latency) return exactly what serial execution returns, across
        three repeats; the port's answers equal the JAX package's."""
        eng = engines[pkg]
        serial = _serial(eng)
        out: dict = {}
        errs: list = []

        def run(key, q, name):
            try:
                out[key] = eng.execute_query(q)[name]
            except Exception as e:  # noqa: BLE001 - recorded for assert
                errs.append((key, e))

        threads = []
        for rep in range(3):
            threads.extend([
                threading.Thread(target=run, args=(f"a{rep}", AGG_Q, "o")),
                threading.Thread(target=run, args=(f"b{rep}", AGG_Q2, "o2")),
            ])
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        for rep in range(3):
            assert _batches_equal(out[f"a{rep}"], serial["a"])
            assert _batches_equal(out[f"b{rep}"], serial["b"])
        if pkg == "port":
            ref = _serial(engines["jax"])
            _same_as_jax(out["a0"], ref["a"], ["k"])
            _same_as_jax(out["b0"], ref["b"], ["g"])


def _rendezvous(n: int = 2):
    """A window wrap that holds the first window of the first ``n``
    scans until all ``n`` have reached it: the queries that own them are
    then inside execution at once."""
    barrier = threading.Barrier(n, timeout=10.0)
    lock = threading.Lock()
    calls = [0]

    def synced(windows):
        with lock:
            calls[0] += 1
            first = calls[0] <= n
        if first:
            try:
                barrier.wait()
            except threading.BrokenBarrierError:
                pass
        yield from windows

    return synced


class TestScratchIsolation:
    @BOTH
    def test_per_query_stats_do_not_cross(self, engines, pkg):
        """Each overlapping query's trace counts its own rows_in."""
        eng = engines[pkg]
        orig = _wrap_windows(pkg, eng, _rendezvous())
        try:
            threads = [
                threading.Thread(target=eng.execute_query, args=(AGG_Q,)),
                threading.Thread(target=eng.execute_query, args=(AGG_Q2,)),
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            eng._staged_windows = orig
        by_rows = sorted(
            t["usage"]["rows_in"] for t in eng.tracer.recent()[:2]
        )
        assert by_rows == [ROWS // 2, ROWS], (
            f"overlapping queries cross-contaminated their stats: "
            f"{by_rows}"
        )
        assert not eng.tracer.in_flight()

    @BOTH
    def test_cancel_is_per_query(self, engines, pkg):
        """Cancelling one in-flight query does not touch its concurrent
        neighbour: the cancelled one raises QueryCancelled, the other's
        answer equals its serial one."""
        p = PKGS[pkg]
        eng = engines[pkg]
        cancel = threading.Event()
        started = threading.Event()

        def slow(windows):
            for w in windows:
                started.set()
                time.sleep(0.01)
                yield w

        orig = _wrap_windows(pkg, eng, slow)
        out: dict = {}

        def run_cancelled():
            state = p.CompilerState(
                schemas={n: t.relation for n, t in eng.tables.items()},
                registry=eng.registry,
            )
            plan = p.compile_pxl(AGG_Q, state).plan
            try:
                eng.execute_plan(plan, cancel=cancel)
                out["cancelled"] = "completed"
            except p.QueryCancelled:
                out["cancelled"] = "cancelled"

        def run_free():
            try:
                out["free"] = eng.execute_query(AGG_Q2)["o2"]
            except Exception as e:  # noqa: BLE001 - recorded for assert
                out["free"] = e

        try:
            t1 = threading.Thread(target=run_cancelled)
            t2 = threading.Thread(target=run_free)
            t1.start()
            assert started.wait(10.0)
            t2.start()
            cancel.set()
            t1.join(15.0)
            t2.join(15.0)
        finally:
            eng._staged_windows = orig
        assert out["cancelled"] == "cancelled"
        assert not isinstance(out["free"], Exception), out["free"]
        assert _batches_equal(out["free"], eng.execute_query(AGG_Q2)["o2"])
        assert not eng.tracer.in_flight()

    @BOTH
    def test_table_sinks_are_per_query(self, pkg):
        """Two concurrent ``px.to_table`` queries each store their own
        rows."""
        eng = _mk_engine(pkg, window_rows=1 << 16)
        orig = _wrap_windows(pkg, eng, _rendezvous())
        qa = (
            "import px\n"
            "df = px.DataFrame(table='t')\n"
            "df = df.groupby('k').agg(n=('v', px.count))\n"
            "px.display(df, 'oa')\n"
            "px.to_table(df, 'sink_a')\n"
        )
        qb = (
            "import px\n"
            "df = px.DataFrame(table='t2')\n"
            "df = df.groupby('g').agg(n=('w', px.count))\n"
            "px.display(df, 'ob')\n"
            "px.to_table(df, 'sink_b')\n"
        )
        try:
            threads = [
                threading.Thread(target=eng.execute_query, args=(q,))
                for q in (qa, qb)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            eng._staged_windows = orig
        assert eng.tables["sink_a"].num_rows == 512
        assert eng.tables["sink_b"].num_rows == 64


class TestFragmentCacheRace:
    @BOTH
    def test_concurrent_first_compiles_agree(self, pkg):
        """The port keeps no jitted fragments: an eager PyTorch fragment
        holds no compiled program (ROADMAP.md, "Not ported, by
        decision"). Its counterpart of the JAX race is four threads
        compiling six variants of one script for the first time on fresh
        engines, which share the planner's and the analysis passes'
        memos and the program registry's binds; every answer is exact
        and equal across packages."""
        n = 2000
        rng = np.random.default_rng(11)
        cols = {
            "time_": np.arange(n, dtype=np.int64),
            "v": rng.integers(0, 1000, n),
            "k": rng.integers(0, 6, n),
        }
        engines = []
        for _ in range(4):
            e = PKGS[pkg].engine(1 << 10)
            e.append_data("t", cols)
            engines.append(e)
        want = np.bincount(cols["k"], minlength=6)
        errs: list = []
        got: dict = {}

        def worker(wid, e):
            try:
                for i in range(12):
                    q = (
                        "import px\ndf = px.DataFrame(table='t')\n"
                        f"df = df[df.k == {i % 6}]\n"
                        "df = df.groupby('k').agg(n=('v', px.count))\n"
                        "px.display(df)\n"
                    )
                    out = e.execute_query(q)["output"].to_pydict()
                    got[(wid, i)] = (list(out["k"]), list(out["n"]))
            except Exception as ex:  # noqa: BLE001 - recorded for assert
                errs.append(ex)

        threads = [threading.Thread(target=worker, args=(w, e))
                   for w, e in enumerate(engines)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        for (wid, i), (keys, counts) in got.items():
            assert keys == [i % 6] and counts == [int(want[i % 6])]


class TestLoadTesterConcurrency:
    @BOTH
    def test_concurrency_sweep_reports_qps_p99(self, pkg):
        p = PKGS[pkg]
        execute = p.load_tester.local_executor(
            rows=50_000, window_rows=1 << 14, **p.executor_kw)
        reports = p.load_tester.run_concurrency_sweep(
            execute, AGG_Q.replace("table='t'", "table='http_events'")
            .replace("'k'", "'service'").replace("'v'", "'latency_ns'"),
            concurrencies=(1, 2), per_worker=3,
        )
        assert sorted(reports) == [1, 2]
        for n, rep in reports.items():
            d = rep.to_dict()
            assert rep.errors == 0, d
            assert d["qps"] > 0
            for k in ("p50_ms", "p95_ms", "p99_ms"):
                assert d[k] > 0
            # The serving histogram's delta holds exactly this run's
            # n * per_worker observations.
            assert d.get("hist_count", 0) == n * 3
        assert execute.engine.max_inflight >= 2


JOIN_Q = (
    "import px\n"
    "l = px.DataFrame(table='l')\n"
    "r = px.DataFrame(table='r')\n"
    "j = l.merge(r, how='left', left_on=['k'], right_on=['k'],"
    " suffixes=['', '_r'])\n"
    "px.display(j, 'j')\n"
)
USAGE_KEYS = ("rows_in", "rows_out", "windows", "retries", "skipped_windows")


def test_windowed_join_usage_under_concurrency(monkeypatch):
    """A windowed left join whose ascending probe keys meet a narrow
    build range (14 of 16 probe windows zone-skipped), run beside a
    group-by on the same engine, leaves the same trace usage on both
    packages: rows in and out, windows, retries and skipped windows.
    ``bytes_staged`` is left out: the port counts a staged tail window's
    bytes (ROADMAP.md §C, C3), and ``device_peak_bytes`` is None on the
    port's CPU."""
    monkeypatch.setattr(jax_joins, "DEVICE_JOIN_MIN_ROWS", 0)
    flags = {"join_strategy": "sorted", "join_probe_window_rows": 64,
             "device_join_min_rows": 0}
    usage = {}
    for pkg in PKGS:
        eng = PKGS[pkg].engine(1 << 12)
        eng.append_data("l", {"time_": np.arange(1000, dtype=np.int64),
                              "k": np.arange(1000, dtype=np.int64)})
        eng.append_data("r", {"time_": np.arange(30, dtype=np.int64),
                              "k": np.arange(950, 980, dtype=np.int64),
                              "rv": np.arange(30, dtype=np.int64)})
        eng.append_data("t", {"time_": np.arange(5000, dtype=np.int64),
                              "k": np.arange(5000) % 9,
                              "v": np.arange(5000)})
        orig = _wrap_windows(pkg, eng, _rendezvous())
        agg = AGG_Q.replace(", m=('v', px.mean)", "")
        out = {}
        try:
            with contextlib.ExitStack() as stack:
                over = jax_override_flag if pkg == "jax" else override_flag
                for k, v in flags.items():
                    if pkg == "port" or k != "device_join_min_rows":
                        stack.enter_context(over(k, v))
                threads = [
                    threading.Thread(target=lambda q=q, s=s: out.update(
                        {s: eng.execute_query(q)[s]}))
                    for q, s in ((JOIN_Q, "j"), (agg, "o"))
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
        finally:
            eng._staged_windows = orig
        assert out["j"].length == 1000 and out["o"].length == 9
        assert eng.max_inflight == 2
        assert not eng.tracer.in_flight()
        (join_trace,) = [t for t in eng.tracer.recent()
                         if t["query"].startswith(JOIN_Q[:40])]
        usage[pkg] = {k: join_trace["usage"][k] for k in USAGE_KEYS}
    assert usage["jax"]["skipped_windows"] == 14
    assert usage["port"] == usage["jax"]

