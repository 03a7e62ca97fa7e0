"""The three scripts of the port's first slice, end to end, against the
JAX package's engine over one seeded replay (8192 rows in 4096-row
windows; the recipe of bench.py's http_events replay at a small size).

The JAX side folds with XLA (``cpu_fold_threads=1`` keeps it off the
native CPU fold) and, for the FLOAT64 query, through its Pallas dense
fold in interpret mode; the port runs on the CPU with its kernels' plain
versions. Tolerances: keys, counts and throughput are exact; the INT64
http_stats mean and max are exact (both keep exact i64 sums); the
FLOAT64 mean is rtol 1e-5 (f32 window sums in another order). The
FLOAT64 max is exact against numpy's f32 quotient latency_ns / 1e6 and
within one f32 ulp of the JAX package's, because XLA:CPU rewrites the
division by a constant into a multiplication by its reciprocal, which
rounds differently in about 3% of rows; the port divides. The error
rate rtol 1e-12 (exact integer carries, one f64 division); p50/p99
rtol 0.05, the JAX package's own Pallas-vs-XLA tolerance
(tests/test_pallas.py), because f32 histogram sums come out in another
order.
"""

import numpy as np
import pytest
import torch

from pixie_tpu.config import set_flag
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.types.batch import HostBatch as JaxHostBatch
from pixie_tpu.types.dtypes import DataType as JaxDataType
from pixie_tpu.types.relation import Relation as JaxRelation
from pixie_tpu.types.strings import StringDictionary as JaxDictionary
from pixie_tpu_torch import Engine
from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch.scripts import load_script
from pixie_tpu_torch.types import host_batch_from_numpy

from test_torch_planner import HTTP_STATS_F64

N, WINDOW = 8192, 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs several workers
    at once, and timing-based tests in other files share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replay_arrays():
    """bench.py's http_events recipe: seed 7, 32 services, 8 paths,
    statuses [200,200,200,200,404,500], latency in [1e3, 1e8)."""
    rng = np.random.default_rng(7)
    svc = rng.integers(0, 32, N).astype(np.int32)
    path = rng.integers(0, 8, N).astype(np.int32)
    lat = rng.integers(1_000, 100_000_000, N)
    statuses = np.array([200, 200, 200, 200, 404, 500])
    status = statuses[rng.integers(0, len(statuses), N)].astype(np.int64)
    return svc, path, lat, status


def _replay_batches():
    dicts = {
        "service": JaxDictionary([f"svc-{i}" for i in range(32)]),
        "req_path": JaxDictionary([f"/api/v1/ep{i}" for i in range(8)]),
    }
    rel = JaxRelation([
        ("time_", JaxDataType.TIME64NS),
        ("latency_ns", JaxDataType.INT64),
        ("resp_status", JaxDataType.INT64),
        ("service", JaxDataType.STRING),
        ("req_path", JaxDataType.STRING),
    ])
    svc, path, lat, status = _replay_arrays()
    for off in range(0, N, WINDOW):
        s = slice(off, off + WINDOW)
        yield JaxHostBatch(relation=rel, cols={
            "time_": (np.arange(off, off + WINDOW, dtype=np.int64),),
            "latency_ns": (lat[s],),
            "resp_status": (status[s],),
            "service": (svc[s],),
            "req_path": (path[s],),
        }, length=WINDOW, dicts=dicts)


@pytest.fixture(scope="module")
def engines():
    jax_eng = JaxEngine(window_rows=WINDOW)
    eng = Engine(window_rows=WINDOW, device="cpu")
    for hb in _replay_batches():
        jax_eng.append_data("http_events", hb)
        eng.append_data("http_events", host_batch_from_numpy(
            [(n, t.name) for n, t in hb.relation.items()],
            hb.cols,
            {c: list(d.strings) for c, d in hb.dicts.items()},
        ))
    return jax_eng, eng


def _run_jax(eng, query, **flags):
    flags = {"cpu_fold_threads": 1, **flags}
    for k, v in flags.items():
        set_flag(k, v)
    try:
        return eng.execute_query(query)["output"]
    finally:
        set_flag("cpu_fold_threads", 0)
        for k in flags:
            if k != "cpu_fold_threads":
                set_flag(k, "auto")


def _by_key(hb, keys):
    """Columns sorted by the group keys' dictionary ids (both packages
    share the replay's dictionaries), plus the decoded key strings."""
    d = hb.to_pydict(decode_strings=False)
    order = np.lexsort([d[k] for k in reversed(keys)])
    out = {k: np.asarray(v)[order] for k, v in d.items()}
    names = hb.to_pydict()
    for k in keys:
        out[k + "_name"] = list(np.asarray(names[k])[order])
    return out


def _run_both(engines, query, keys, **jax_flags):
    jax_eng, eng = engines
    ref = _by_key(_run_jax(jax_eng, query, **jax_flags), keys)
    got = _by_key(eng.execute_query(query)["output"], keys)
    assert eng.last_stats.windows == N // WINDOW
    for k in keys:
        assert list(got[k]) == list(ref[k])
        assert got[k + "_name"] == ref[k + "_name"]
    return got, ref, eng.last_stats.fragments[0]


def test_http_stats(engines):
    got, ref, frag = _run_both(
        engines, load_script("px/http_stats").pxl, ["service", "req_path"]
    )
    assert not frag.uses_dense_fold  # INT64 aggregates: exact i64 folds
    assert frag.uses_int_fold  # count, mean and max in one int64 pass
    assert len(got["n"]) == 32 * 8
    np.testing.assert_array_equal(got["n"], ref["n"])
    np.testing.assert_array_equal(got["lat_mean"], ref["lat_mean"])
    np.testing.assert_array_equal(got["lat_max"], ref["lat_max"])


def test_http_stats_float64(engines):
    got, ref, frag = _run_both(
        engines, HTTP_STATS_F64, ["service", "req_path"],
        pallas_dense_fold="interpret",
    )
    assert frag.uses_dense_fold  # the route the JAX package's Pallas fold takes
    assert not frag.uses_int_fold
    np.testing.assert_array_equal(got["n"], ref["n"])
    np.testing.assert_allclose(got["lat_mean"], ref["lat_mean"], rtol=1e-5)
    np.testing.assert_allclose(got["lat_max"], ref["lat_max"],
                               rtol=np.finfo(np.float32).eps, atol=0)
    svc, path, lat, status = _replay_arrays()
    ok = status < 400
    ms = lat[ok].astype(np.float32) / np.float32(1e6)
    key = svc[ok].astype(np.int64) * 8 + path[ok]
    want = np.full(32 * 8, -np.inf, dtype=np.float32)
    np.maximum.at(want, key, ms)
    np.testing.assert_array_equal(
        got["lat_max"],
        want[got["service"].astype(np.int64) * 8 + got["req_path"]],
    )


def test_service_stats(engines):
    got, ref, frag = _run_both(
        engines, load_script("px/service_stats").pxl, ["service"],
        pallas_tdigest="interpret",
    )
    assert not frag.uses_dense_fold
    assert not frag.uses_int_fold  # t-digest and boolean aggregates
    assert len(got["throughput"]) == 32
    np.testing.assert_array_equal(got["throughput"], ref["throughput"])
    np.testing.assert_allclose(got["error_rate"], ref["error_rate"], rtol=1e-12)
    np.testing.assert_allclose(got["p50"], ref["p50"], rtol=0.05)
    np.testing.assert_allclose(got["p99"], ref["p99"], rtol=0.05)


def test_time_bounded_scan(engines):
    """start_time/end_time bound the rows a query reads (the table's
    time index), across a window boundary."""
    query = (
        "import px\n"
        "df = px.DataFrame(table='http_events', start_time=1000, "
        "end_time=6000)\n"
        "df = df.groupby('service').agg(n=('latency_ns', px.count), "
        "lo=('latency_ns', px.min))\n"
        "px.display(df)\n"
    )
    got, ref, frag = _run_both(engines, query, ["service"])
    assert frag.uses_int_fold  # count and an INT64 min
    assert got["n"].sum() == 5000
    np.testing.assert_array_equal(got["n"], ref["n"])
    np.testing.assert_array_equal(got["lo"], ref["lo"])


def test_integer_key_group_by(engines):
    """An INT64 key takes a dense domain from the table's append-time
    min/max stats (offset to zero base), as in the JAX package."""
    query = (
        "import px\n"
        "df = px.DataFrame(table='http_events')\n"
        "df.code = df.resp_status + 1\n"
        "df = df.groupby('code').agg(n=('latency_ns', px.count), "
        "hi=('latency_ns', px.max), s=('latency_ns', px.sum))\n"
        "px.display(df)\n"
    )
    got, ref, frag = _run_both(engines, query, ["code"])
    # Stats bounds round out to a 4096-value grain: a domain above the
    # int fold kernel's 2048 slots keeps the UDAs' own updates.
    assert frag.dense_domains == (4096,) and not frag.uses_int_fold
    assert list(got["code"]) == [201, 405, 501]
    for col in ("n", "hi", "s"):
        np.testing.assert_array_equal(got[col], ref[col])


MIXED_STATS = """import px
df = px.DataFrame(table='http_events')
df = df[df.resp_status < 400]
df.latency_ms = df.latency_ns / 1000000.0
df = df.groupby(['service', 'req_path']).agg(
    n=('latency_ns', px.count), total=('latency_ns', px.sum),
    lat_max=('latency_ms', px.max))
px.display(df)
"""


def test_mixed_float64_and_int64_aggregates_take_neither_kernel(engines):
    """A FLOAT64 max beside an INT64 sum: neither fold kernel takes the
    group-by, and it stays on the UDAs' own updates."""
    got, ref, frag = _run_both(engines, MIXED_STATS, ["service", "req_path"])
    assert not frag.uses_dense_fold and not frag.uses_int_fold
    np.testing.assert_array_equal(got["n"], ref["n"])
    np.testing.assert_array_equal(got["total"], ref["total"])
    np.testing.assert_allclose(got["lat_max"], ref["lat_max"],
                               rtol=np.finfo(np.float32).eps, atol=0)


def test_keys_without_dense_domain_take_neither_kernel(engines):
    """With no dense domain for the keys (the port's domain limits at 0),
    px/http_stats groups through the sort/hash form, off both kernels,
    and still equals the JAX package's dense answer."""
    with override_flag("dense_domain_limit", 0), \
            override_flag("int_dense_domain_limit", 0):
        got, ref, frag = _run_both(
            engines, load_script("px/http_stats").pxl, ["service", "req_path"]
        )
    assert not frag.uses_dense_fold and not frag.uses_int_fold
    assert not frag.dense_domains
    for col in ("n", "lat_mean", "lat_max"):
        np.testing.assert_array_equal(got[col], ref[col])
