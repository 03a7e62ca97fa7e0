"""Device-resident results (``execute_query(materialize=False)``) on the
port against the JAX engine's ``DeviceResult``, on the CPU.

- the query of ``tests/test_exec.py::test_deferred_device_result`` gives
  21 rows on both engines, equal to each other, and a second
  ``to_host()`` returns the same object;
- a deferred run equals a materialized one for ``px/http_stats`` and
  ``px/service_stats`` over bench.py's seeded http_events replay (both
  exact on the port's CPU path; against the JAX engine with the
  tolerances of ``tests/test_torch_engine.py``: counts exact, INT64
  means and maxes exact, error rate rtol 1e-12, p50/p99 rtol 0.05);
- a row chain and a fan-out output come back as HostBatches on both;
- a group-by overflow rebuckets inside ``to_host()`` with the JAX
  engine's answer, and after a later append it folds the table as it is
  then, on both engines (the snapshot caveat);
- the result cache neither serves nor stores a deferred run;
- a live result's bytes are held on the device-memory monitor until it
  is read back or dropped.
"""

import gc
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pixie_tpu.config import override_flag as jax_override_flag
from pixie_tpu.exec.engine import DeviceResult as JaxDeviceResult
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.types.batch import HostBatch as JaxHostBatch
from pixie_tpu_torch import Engine
from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch.exec.engine import DeviceResult
from pixie_tpu_torch.scripts import load_script
from pixie_tpu_torch.types.batch import HostBatch

REPO = Path(__file__).resolve().parent.parent

# tests/test_exec.py's TestDenseGroupBy.QUERY.
QUERY = """
import px
df = px.DataFrame(table='http_events')
df = df[df.resp_status < 400]
df = df.groupby(['service', 'req_path']).agg(
    n=('latency_ns', px.count),
    lat_mean=('latency_ns', px.mean),
    lat_max=('latency_ns', px.max),
)
px.display(df)
"""

ROWS_Q = """
import px
df = px.DataFrame(table='http_events')
df = df[df.resp_status >= 400]
px.display(df[['time_', 'service', 'latency_ns']])
"""

FANOUT_Q = """
import px
df = px.DataFrame(table='http_events')
agg = df.groupby('service').agg(n=('latency_ns', px.count))
px.display(agg, 'a')
px.display(agg, 'b')
"""

N_KEYS, N_ROWS, KEY_WINDOW = 5000, 24_000, 4096
KEY_AGG = """import px
df = px.DataFrame(table='k')
px.display(df.groupby('key').agg(n=('value', px.count), mx=('value', px.max)))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exec_data():
    """tests/test_exec.py's ``engine`` fixture rows."""
    rng = np.random.default_rng(0)
    n = 10_000
    return {
        "time_": np.arange(n, dtype=np.int64) * 1_000_000,
        "latency_ns": rng.integers(10**5, 10**9, n).astype(np.int64),
        "resp_status": rng.choice([200, 200, 200, 404, 500], n).astype(
            np.int64),
        "service": [f"svc-{i % 7}" for i in range(n)],
        "req_path": [f"/api/v{i % 3}/x" for i in range(n)],
    }


@pytest.fixture(scope="module")
def exec_engines():
    data = _exec_data()
    jax_eng = JaxEngine(window_rows=1 << 12)
    jax_eng.append_data("http_events", data)
    eng = Engine(window_rows=1 << 12, device="cpu")
    eng.append_data("http_events", data)
    return jax_eng, eng


def _replay(n=8192):
    """bench.py's http_events recipe (seed 7) at a small size."""
    rng = np.random.default_rng(7)
    svc = rng.integers(0, 32, n).astype(np.int32)
    path = rng.integers(0, 8, n).astype(np.int32)
    lat = rng.integers(1_000, 100_000_000, n)
    statuses = np.array([200, 200, 200, 200, 404, 500])
    status = statuses[rng.integers(0, len(statuses), n)].astype(np.int64)
    return {
        "time_": np.arange(n, dtype=np.int64),
        "latency_ns": lat,
        "resp_status": status,
        "service": [f"svc-{i}" for i in svc],
        "req_path": [f"/api/v1/ep{i}" for i in path],
    }


@pytest.fixture(scope="module")
def replay_engines():
    data = _replay()
    jax_eng = JaxEngine(window_rows=4096)
    jax_eng.append_data("http_events", data)
    eng = Engine(window_rows=4096, device="cpu")
    eng.append_data("http_events", data)
    return jax_eng, eng


def _key_table(seed=5, rows=N_ROWS):
    rng = np.random.default_rng(seed)
    keys = rng.choice(rng.integers(0, 1 << 40, N_KEYS), rows)
    return {"time_": np.arange(rows, dtype=np.int64),
            "key": keys.astype(np.int64),
            "value": rng.integers(0, 1 << 30, rows).astype(np.int64)}


def _sorted(d: dict, keys) -> dict:
    d = {k: np.asarray(v) for k, v in d.items()}
    order = np.lexsort([d[k] for k in reversed(keys)])
    return {k: v[order] for k, v in d.items()}


def _jax_query(eng, query, **kw):
    with jax_override_flag("cpu_fold_threads", 1):
        return eng.execute_query(query, **kw)


def test_deferred_device_result(exec_engines):
    jax_eng, eng = exec_engines
    jr = _jax_query(jax_eng, QUERY, materialize=False)["output"]
    assert isinstance(jr, JaxDeviceResult)
    out = eng.execute_query(QUERY, materialize=False)
    r = out["output"]
    assert isinstance(r, DeviceResult)
    assert r.relation == eng.execute_query(QUERY)["output"].relation
    assert r.block_until_ready() is r
    got = r.to_host().to_pydict()
    ref = jr.to_host().to_pydict()
    assert len(got["n"]) == len(ref["n"]) == 21  # 7 services x 3 paths
    got, ref = (_sorted(d, ["service", "req_path"]) for d in (got, ref))
    for c in ("service", "req_path", "n", "lat_mean", "lat_max"):
        np.testing.assert_array_equal(got[c], ref[c])
    # The readback is cached, and its device tensors are gone.
    assert r.to_host() is r.to_host()
    assert r._cols is None and r._valid is None and r._overflow is None
    assert r.to_pydict()["n"].sum() == got["n"].sum()


def test_rows_out_is_set_at_readback(exec_engines):
    """As in the JAX engine: the trace ends in execute_plan, and the
    deferred fragment's rows_out is written by to_host."""
    jax_eng, eng = exec_engines
    r = eng.execute_query(QUERY, materialize=False)["output"]
    jr = _jax_query(jax_eng, QUERY, materialize=False)["output"]
    trace = eng.tracer.last()
    assert trace.status == "ok"
    assert trace.rows_out == jax_eng.tracer.last().rows_out == 0
    r.to_host()
    jr.to_host()
    assert trace.rows_out == jax_eng.tracer.last().rows_out == 21


@pytest.mark.parametrize("script", ["px/http_stats", "px/service_stats"])
def test_deferred_equals_materialized(replay_engines, script):
    jax_eng, eng = replay_engines
    query = load_script(script).pxl
    keys = ["service", "req_path"] if script == "px/http_stats" else [
        "service"]
    deferred = eng.execute_query(query, materialize=False)["output"]
    assert isinstance(deferred, DeviceResult)
    got = _sorted(deferred.to_host().to_pydict(), keys)
    mat = _sorted(eng.execute_query(query)["output"].to_pydict(), keys)
    assert set(got) == set(mat)
    for c in got:  # the same fold on the same rows: bit-identical
        np.testing.assert_array_equal(got[c], mat[c])
    with jax_override_flag("pallas_tdigest", "interpret"):
        ref = _jax_query(jax_eng, query, materialize=False)["output"]
        ref = _sorted(ref.to_host().to_pydict(), keys)
    for k in keys:
        np.testing.assert_array_equal(got[k], ref[k])
    if script == "px/http_stats":
        for c in ("n", "lat_mean", "lat_max"):
            np.testing.assert_array_equal(got[c], ref[c])
    else:
        np.testing.assert_array_equal(got["throughput"], ref["throughput"])
        np.testing.assert_allclose(got["error_rate"], ref["error_rate"],
                                   rtol=1e-12)
        np.testing.assert_allclose(got["p50"], ref["p50"], rtol=0.05)
        np.testing.assert_allclose(got["p99"], ref["p99"], rtol=0.05)


@pytest.mark.parametrize("query,names", [(ROWS_Q, ["output"]),
                                         (FANOUT_Q, ["a", "b"])],
                         ids=["row_chain", "fan_out"])
def test_rows_and_fan_out_stay_host_batches(replay_engines, query, names):
    jax_eng, eng = replay_engines
    out = eng.execute_query(query, materialize=False)
    jout = _jax_query(jax_eng, query, materialize=False)
    assert sorted(out) == sorted(jout) == sorted(names)
    for name in names:
        assert isinstance(out[name], HostBatch)
        assert isinstance(jout[name], JaxHostBatch)
        assert out[name].length == jout[name].length > 0


@pytest.fixture()
def key_engines():
    data = _key_table()
    jax_eng = JaxEngine(window_rows=KEY_WINDOW)
    jax_eng.append_data("k", data)
    eng = Engine(window_rows=KEY_WINDOW, device="cpu")
    eng.append_data("k", data)
    return jax_eng, eng


def _rebucket_marks(stats) -> int:
    return sum("rebucket" in f.ops for f in stats.fragments)


def test_rebucket_resolves_in_to_host(key_engines):
    """5000 INT64 keys in [0, 2^40) with presizing off start at 4096
    groups: the fold overflows, and the deferred result's to_host
    rebuckets, with the JAX engine's answer and its marked attempts."""
    jax_eng, eng = key_engines
    with override_flag("bounds_presize", False), \
            jax_override_flag("bounds_presize", False):
        r = eng.execute_query(KEY_AGG, materialize=False)["output"]
        stats = eng.last_stats
        assert stats.rebuckets == 0  # nothing read back yet
        n_frags = len(stats.fragments)
        got = _sorted(r.to_host().to_pydict(), ["key"])
        jr = _jax_query(jax_eng, KEY_AGG, materialize=False,
                        analyze=True)["output"]
        ref = _sorted(jr.to_host().to_pydict(), ["key"])
        mat = _sorted(eng.execute_query(KEY_AGG)["output"].to_pydict(),
                      ["key"])
    assert stats.rebuckets == 1
    assert len(stats.fragments) == n_frags + 1
    assert _rebucket_marks(stats) == _rebucket_marks(jax_eng.last_stats) == 1
    assert stats.fragments[-1].rows_out == len(got["key"]) == len(
        np.unique(_key_table()["key"])) > 4096
    for c in ("key", "n", "mx"):
        np.testing.assert_array_equal(got[c], ref[c])
        np.testing.assert_array_equal(got[c], mat[c])


def test_rebucket_after_append_folds_the_table_as_it_is(key_engines):
    """The snapshot caveat, as the JAX engine documents it: a rebucket
    inside to_host refolds the source table as it is at the readback, so
    rows appended after the query ran are in the answer."""
    jax_eng, eng = key_engines
    extra = _key_table(seed=6, rows=4096)
    with override_flag("bounds_presize", False), \
            jax_override_flag("bounds_presize", False):
        r = eng.execute_query(KEY_AGG, materialize=False)["output"]
        jr = _jax_query(jax_eng, KEY_AGG, materialize=False)["output"]
        eng.append_data("k", extra)
        jax_eng.append_data("k", extra)
        got = _sorted(r.to_host().to_pydict(), ["key"])
        ref = _sorted(jr.to_host().to_pydict(), ["key"])
    assert got["n"].sum() == ref["n"].sum() == N_ROWS + 4096
    for c in ("key", "n", "mx"):
        np.testing.assert_array_equal(got[c], ref[c])


def test_result_cache_neither_serves_nor_stores_a_deferred_run(
        replay_engines):
    """px/service_stats: cached by its manifest's staleness budget (no
    view answers it)."""
    jax_eng, eng = replay_engines
    query = load_script("px/service_stats").pxl
    with override_flag("result_cache_mb", 32), \
            jax_override_flag("result_cache_mb", 32):
        for e, run in ((eng, eng.execute_query),
                       (jax_eng, lambda q, **k: _jax_query(jax_eng, q, **k))):
            e.result_cache.clear()
            for _ in range(2):
                out = run(query, materialize=False)
                assert type(out["output"]).__name__ == "DeviceResult"
                assert e.tracer.last().cache == ""
            run(query)  # nothing was stored: a miss, then a hit
            assert e.tracer.last().cache == "miss"
            run(query)
            assert e.tracer.last().cache == "hit"
            # A cached answer never comes back device-resident.
            out = run(query, materialize=False)
            assert type(out["output"]).__name__ == "DeviceResult"
            assert e.tracer.last().cache == ""
            out["output"].to_host()
            e.result_cache.clear()


def test_device_memory_is_held_until_readback_or_drop(exec_engines):
    _jax_eng, eng = exec_engines
    mon, dev = eng.device_memory, eng.device
    gc.collect()  # results earlier tests left for the collector
    base = mon.held_bytes(dev)
    r = eng.execute_query(QUERY, materialize=False)["output"]
    held = mon.held_bytes(dev) - base
    planes = [r._valid, r._overflow] + [p for ps in r._cols.values()
                                        for p in ps]
    storages = {p.untyped_storage().data_ptr(): p.untyped_storage().nbytes()
                for p in planes}
    assert held == sum(storages.values()) > 0
    r.to_host()
    assert mon.held_bytes(dev) == base
    r2 = eng.execute_query(QUERY, materialize=False)["output"]
    assert mon.held_bytes(dev) == base + held
    del r2
    gc.collect()
    assert mon.held_bytes(dev) == base


def test_no_refusal_of_device_resident_results_is_left():
    """``grep "not in this slice"`` finds nothing in the port: no refusal
    of materialize=False, or of anything else, is left (the engine's and
    the fragment's guards for an operator no plan carries raise the JAX
    package's errors)."""
    hits = []
    for path in (REPO / "pixie_tpu_torch").rglob("*.py"):
        # Adjacent string literals joined, so a message split over
        # lines reads whole.
        text = re.sub(r'"\s*\n\s*"', "", path.read_text())
        for m in re.finditer(r"not in\s+this slice", text):
            hits.append((path, text[max(0, m.start() - 160):m.end()]))
    assert hits == []


@pytest.mark.cuda
def test_an_earlier_result_is_not_in_the_next_query_peak():
    """On the card: a DeviceResult left alive by one query is not part of
    the next query's device peak."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng = Engine(window_rows=1 << 12)
    eng.append_data("http_events", _exec_data())
    eng.execute_query(QUERY)  # stages the tail window once
    eng.execute_query(QUERY)
    alone = eng.tracer.last().usage.device_peak_bytes
    kept = eng.execute_query(QUERY, materialize=False)["output"]
    eng.execute_query(QUERY)
    after = eng.tracer.last().usage.device_peak_bytes
    assert after == alone
    kept.to_host()
