"""Public names of the JAX package that the port lacked, held to the
JAX package's on the same seeded inputs.

A comparison of the two trees' public module, class and method names
found these without a counterpart in the port: the dtype helpers
``n_planes`` and ``is_numeric``, ``HostBatch.nbytes``, the
``DeviceBatch`` helpers (``capacity``, ``n_valid``, ``plane``,
``with_cols``, ``with_valid``, ``select``, ``to_host``),
``FragmentStats.timed``, ``ProgramRegistry.clear``,
``Engine.last_pipeline``, the result cache's metrics (``ResultCache``'s
``registry``) and ``digest_update(num_groups=)``. Values are compared
exactly, t-digest means at rtol 1e-5 (f32 sums in another order).
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import pixie_tpu.ops.tdigest as jax_tdigest
import pixie_tpu_torch.ops.tdigest as port_tdigest
from pixie_tpu import config as jax_config
from pixie_tpu.exec.analyze import FragmentStats as JaxFragmentStats
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.exec.result_cache import ResultCache as JaxResultCache
from pixie_tpu.services.observability import MetricsRegistry as JaxMetrics
from pixie_tpu.types import dtypes as jax_dtypes
from pixie_tpu.types.batch import HostBatch as JaxHostBatch
from pixie_tpu_torch import config as port_config
from pixie_tpu_torch.exec.analyze import FragmentStats
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.exec.programs import ProgramRegistry
from pixie_tpu_torch.exec.result_cache import ResultCache
from pixie_tpu_torch.services.observability import MetricsRegistry
from pixie_tpu_torch.types import dtypes
from pixie_tpu_torch.types.batch import HostBatch

W = 1 << 10

AGG_Q = (
    "import px\n"
    "df = px.DataFrame(table='t')\n"
    "df = df.groupby('k').agg(n=('v', px.count), s=('v', px.sum))\n"
    "px.display(df)\n"
)


def _data(n=300, seed=5):
    rng = np.random.default_rng(seed)
    return {
        "time_": np.arange(n, dtype=np.int64),
        "v": rng.integers(-1000, 1000, n),
        "f": rng.standard_normal(n),
        "s": [f"s{j}" for j in rng.integers(0, 7, n)],
        "b": rng.random(n) < 0.5,
    }


@pytest.mark.parametrize("name", [dt.name for dt in jax_dtypes.DataType])
def test_dtype_helpers_match_jax(name):
    jdt, pdt = jax_dtypes.DataType[name], dtypes.DataType[name]
    assert dtypes.n_planes(pdt) == jax_dtypes.n_planes(jdt)
    assert dtypes.is_numeric(pdt) == jax_dtypes.is_numeric(jdt)


def test_host_batch_nbytes_matches_jax():
    d = _data()
    assert HostBatch.from_pydict(d).nbytes == JaxHostBatch.from_pydict(d).nbytes
    assert HostBatch.from_pydict(d).nbytes > 0


def test_device_batch_helpers_match_jax():
    """The same rows staged by both packages (port: CPU tensors), then
    masked, narrowed and read back."""
    d = _data()
    hb, jhb = HostBatch.from_pydict(d), JaxHostBatch.from_pydict(d)
    db = hb.to_device(512, torch.device("cpu"))
    jdb = jhb.to_device(512)
    assert db.capacity == jdb.capacity == 512
    assert int(db.n_valid()) == int(jdb.n_valid()) == 300
    np.testing.assert_array_equal(db.plane("v").numpy(),
                                  np.asarray(jdb.plane("v")))
    keep = np.random.default_rng(9).random(512) < 0.4
    db2 = db.with_valid(db.valid & torch.from_numpy(keep))
    jdb2 = jdb.with_valid(jdb.valid & keep)
    sel, jsel = db2.select(["v", "s"]), jdb2.select(["v", "s"])
    assert list(sel.relation.column_names) == list(jsel.relation.column_names)
    got = sel.to_host(dicts=hb.dicts, eow=True).to_pydict()
    want = jsel.to_host(dicts=jhb.dicts, eow=True).to_pydict()
    assert got.keys() == want.keys()
    for c in got:
        np.testing.assert_array_equal(got[c], want[c])
    assert sel.to_host(eow=True).eow and not sel.to_host().eos
    swapped = db.with_cols({"w": db.cols["v"]}, db.relation.select(["v"]))
    jswapped = jdb.with_cols({"w": jdb.cols["v"]}, jdb.relation.select(["v"]))
    assert set(swapped.cols) == set(jswapped.cols) == {"w"}
    assert swapped.valid is db.valid


def test_fragment_stats_timed_matches_jax():
    out = {}
    for name, fs in (("port", FragmentStats(ops=("AggOp",))),
                     ("jax", JaxFragmentStats(ops=("AggOp",)))):
        with fs.timed("compute", rows=7, nbytes=64):
            time.sleep(0.002)
        with fs.timed("compute", rows=3):
            pass
        st = fs.stages["compute"]
        assert st.seconds >= 0.002
        out[name] = (st.rows, st.count, st.nbytes)
    assert out["port"] == out["jax"] == (10, 2, 64)


def test_program_registry_clear():
    reg = ProgramRegistry(metrics_registry=MetricsRegistry(), size=8)
    reg.observe("fragment", ("k", 1), label="agg")
    reg.observe("fragment", ("k", 2), label="agg")
    assert reg.stats()["programs"] == 2
    reg.clear()
    assert reg.stats() == {"programs": 0, "hits": 0, "compiles": 0}


def test_last_pipeline_matches_jax():
    rng = np.random.default_rng(3)
    n = 3 * W + 7
    cols = {"time_": np.arange(n, dtype=np.int64),
            "k": rng.integers(0, 11, n), "v": rng.integers(0, 1000, n)}
    eng, ref = Engine(window_rows=W, device="cpu"), JaxEngine(window_rows=W)
    assert eng.last_pipeline is None and ref.last_pipeline is None
    for e in (eng, ref):
        e.append_data("t", cols)
        e.execute_query(AGG_Q)
    got, want = eng.last_pipeline, ref.last_pipeline
    assert set(got) == set(want)
    assert (got["depth"], got["windows"]) == (want["depth"], want["windows"])


def test_result_cache_metrics_match_jax():
    """A miss, a stored answer, a hit, then a stale lookup: both caches
    count the same dispositions on their metrics registries and report
    the same held bytes."""
    q = AGG_Q
    out = {}
    for name, cache, reg, cfg, eng in (
        ("port", ResultCache, MetricsRegistry(), port_config,
         lambda: Engine(window_rows=W, device="cpu")),
        ("jax", JaxResultCache, JaxMetrics(), jax_config,
         lambda: JaxEngine(window_rows=W)),
    ):
        c = cache(registry=reg)
        e = eng()
        e.append_data("t", {"time_": np.arange(50, dtype=np.int64),
                            "k": np.arange(50) % 3, "v": np.arange(50)})
        wm = e._table_watermark_ns
        with cfg.override_flag("result_cache_mb", 4), \
                cfg.override_flag("result_cache_staleness_ms", 10_000):
            seen = [c.lookup(q, 0, 100, wm)[0]]
            plan = _plan(name, e, q)
            res = e.execute_query(q, max_output_rows=100)
            c.store(q, 0, 100, plan, res, wm)
            seen.append(c.lookup(q, 0, 100, wm)[0])
            e.append_data("t", {"time_": np.array([10**12], dtype=np.int64),
                                "k": np.array([1]), "v": np.array([1])})
            seen.append(c.lookup(q, 0, 100, wm)[0])
        vals = {m: reg.values(m) for m in (
            "pixie_result_cache_hits_total", "pixie_result_cache_misses_total",
            "pixie_result_cache_stale_total", "pixie_result_cache_bytes")}
        out[name] = (seen, vals)
    assert out["port"][0] == out["jax"][0] == ["miss", "hit", "stale"]
    assert out["port"][1] == out["jax"][1]


def _plan(pkg, eng, q):
    if pkg == "port":
        from pixie_tpu_torch.planner import CompilerState, compile_pxl
    else:
        from pixie_tpu.planner import CompilerState, compile_pxl
    state = CompilerState(
        schemas={n: t.relation for n, t in eng.tables.items()},
        registry=eng.registry, max_output_rows=100,
    )
    return compile_pxl(q, state).plan


@pytest.mark.parametrize("num_groups", [None, 4])
def test_digest_update_num_groups_matches_jax(num_groups):
    import jax.numpy as jnp

    rng = np.random.default_rng(21)
    n, g = 2000, 4
    vals = rng.standard_normal(n).astype(np.float32)
    gids = rng.integers(0, g, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    carry = port_tdigest.digest_init(g, torch.device("cpu"))
    jcarry = jax_tdigest.digest_init(g)
    tm, tw = port_tdigest.digest_update(
        carry, torch.from_numpy(gids), torch.from_numpy(mask),
        torch.from_numpy(vals), num_groups=num_groups)
    jm, jw = jax_tdigest.digest_update(
        jcarry, jnp.asarray(gids), jnp.asarray(mask), jnp.asarray(vals),
        num_groups=num_groups)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5)
