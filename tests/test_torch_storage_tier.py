"""The port's cold storage tier (``table_store/coldstore.py``,
``table_store/tier.py``) and tiered ``Table`` against the JAX package's.

The cases of ``tests/test_storage_tier.py`` that need no cluster, on the
same seeded rows in both packages: every encoding picks the JAX
package's encoding and decodes bit for bit; a tiered table on either
ring reads back exactly what an untiered JAX table holds (every dtype,
string ids included); demotion moves no expiry counter; demote-then-
evict keeps the counters and the watermark monotone and equal to the
JAX package's; a time scan crosses the tier boundary; rows demoted under
an open cursor are still delivered once; staged device windows of
demoted rows stay in the device cache; and the engine skips cold windows
by their zone maps as often as the JAX engine does. Everything here is
exact: the tier moves bytes and computes nothing.
"""

import numpy as np
import pytest
import torch

from pixie_tpu.config import override_flag as jax_override_flag
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.table_store import Table as JaxTable
from pixie_tpu.table_store.coldstore import encode_plane as jax_encode_plane
from pixie_tpu.types.dtypes import DataType as JaxDataType
from pixie_tpu.types.relation import Relation as JaxRelation
from pixie_tpu_torch import Engine
from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch.table_store import StartSpec, StopSpec, Table
from pixie_tpu_torch.table_store import table as table_mod
from pixie_tpu_torch.table_store.coldstore import (
    ColdStore,
    ColdStoreError,
    EncodedPlane,
    encode_plane,
)
from pixie_tpu_torch.types import DataType, Relation

REL_ITEMS = [("time_", "TIME64NS"), ("latency", "INT64"), ("service", "STRING")]
ROW_BYTES = 20  # 8 time + 8 latency + 4 string ids
ALL_ITEMS = [("time_", "TIME64NS"), ("flag", "BOOLEAN"), ("i", "INT64"),
             ("u", "UINT128"), ("f", "FLOAT64"), ("s", "STRING")]


def _rel(items):
    return Relation([(n, DataType[t]) for n, t in items])


def _jax_rel(items):
    return JaxRelation([(n, JaxDataType[t]) for n, t in items])


def _batch(t0, n, svc="a"):
    return {
        "time_": np.arange(t0, t0 + n, dtype=np.int64),
        "latency": np.arange(n, dtype=np.int64),
        "service": [svc] * n,
    }


def _tiered(max_bytes, cold_mb=64, items=REL_ITEMS):
    with override_flag("cold_tier_mb", cold_mb):
        return Table("t", _rel(items), max_bytes=max_bytes)


def _jax_tiered(max_bytes, cold_mb=64, items=REL_ITEMS):
    with jax_override_flag("cold_tier_mb", cold_mb):
        return JaxTable("t", _jax_rel(items), max_bytes=max_bytes)


def _same_rows(a, b):
    da, db = a.read_all().to_pydict(), b.read_all().to_pydict()
    assert da.keys() == db.keys()
    for c in da:
        assert np.array_equal(np.asarray(da[c]), np.asarray(db[c])), c


@pytest.fixture(params=["native", "numpy"])
def ring(request, monkeypatch):
    """Run the case on both of the port's rings."""
    if request.param == "numpy":
        monkeypatch.setattr(table_mod, "load_native", lambda name: None)
    return request.param


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the plane encodings --------------------------------------------------------------
def _codec_planes():
    rng = np.random.default_rng(0)
    p = rng.integers(10**12, 10**12 + 200, 4096).astype(np.int64)
    rng.shuffle(p)
    return {
        "delta_monotonic_int64": np.cumsum(rng.integers(0, 200, 4096)).astype(np.int64),
        "delta_rejects_wrapped_diffs": np.array([0, 2**63 + 17, 2**64 - 1],
                                                dtype=np.uint64),
        "delta_uint64_wrapped_domain": (np.uint64(2**63)
                                        + np.arange(1000, dtype=np.uint64) * 3),
        "rle_low_ndv": np.repeat(np.array([5, 900, 5, 7], dtype=np.int64),
                                 [4000, 100, 3000, 900]),
        "dict_rebase_narrow_range": p,
        "raw_random_floats": rng.random(1024),
        "uint64_rebase_overflow_guard": np.array([2**64 - 2, 5, 2**64 - 1],
                                                 dtype=np.uint64),
        "string_ids": rng.integers(-1, 40, 5000).astype(np.int32),
        "booleans": rng.integers(0, 2, 3000).astype(bool),
        "single_row": np.array([42], dtype=np.int64),
    }


CODEC_KINDS = {
    "delta_monotonic_int64": "delta", "delta_uint64_wrapped_domain": "delta",
    "rle_low_ndv": "rle", "dict_rebase_narrow_range": "dict",
    "raw_random_floats": "raw", "uint64_rebase_overflow_guard": "raw",
}


@pytest.mark.parametrize("case", sorted(_codec_planes()))
def test_encoding_matches_jax(case):
    p = _codec_planes()[case]
    got, ref = encode_plane(p), jax_encode_plane(p)
    assert got.kind == ref.kind
    assert got.kind == CODEC_KINDS.get(case, got.kind)
    assert got.nbytes == ref.nbytes and got.nbytes <= p.nbytes  # never worse than raw
    dec = got.decode()
    assert dec.dtype == p.dtype and dec.tobytes() == p.tobytes()
    assert dec.tobytes() == ref.decode().tobytes()


def test_decode_error_wraps():
    store = ColdStore(has_time=True)
    store.append_window(0, [np.arange(64, dtype=np.int64)], 0, 63, [True])
    bad = EncodedPlane("rle", np.dtype(np.int64), 64,
                       (np.array([1]), np.array([63])))  # one row short
    object.__setattr__(store.windows[0], "planes", (bad,))
    with pytest.raises(ColdStoreError, match="decoded to"):
        store.read(0, 64)


def test_non_contiguous_demotion_rejected():
    store = ColdStore(has_time=True)
    store.append_window(0, [np.arange(8, dtype=np.int64)], 0, 7, [True])
    with pytest.raises(ColdStoreError, match="non-contiguous"):
        store.append_window(16, [np.arange(8, dtype=np.int64)], 16, 23, [True])


# -- the tiered table -------------------------------------------------------------------
def test_bit_identity_all_dtypes(ring):
    """Demoted rows read back bit for bit what an untiered JAX table
    holds after the same appends, every dtype and string ids included."""
    rng = np.random.default_rng(3)
    n, rounds = 512, 12
    svcs = [f"s{i}" for i in range(5)]
    hot = JaxTable("t", _jax_rel(ALL_ITEMS), max_bytes=-1)
    cold = _tiered(4 * 1024, items=ALL_ITEMS)
    jax_cold = _jax_tiered(4 * 1024, items=ALL_ITEMS)
    for r in range(rounds):
        hi = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64)
        lo = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64)
        b = {
            "time_": np.arange(r * n, (r + 1) * n, dtype=np.int64),
            "flag": rng.integers(0, 2, n).astype(bool),
            "i": rng.integers(-(2**62), 2**62, n),
            "u": np.stack([hi, lo], axis=1),
            "f": rng.random(n),
            "s": [svcs[j % len(svcs)] for j in range(n)],
        }
        for t in (hot, cold, jax_cold):
            t.append(b)
    st, jst = cold.stats(), jax_cold.stats()
    assert st.cold_rows > 0 and st.demotions > 0 and st.evictions == 0
    for f in ("cold_rows", "hot_rows", "cold_bytes", "cold_raw_bytes",
              "demotions", "num_rows"):
        assert getattr(st, f) == getattr(jst, f), f
    _same_rows(cold, hot)


def test_demotion_is_not_expiry(ring):
    t = _tiered(40 * ROW_BYTES)
    for i in range(10):
        t.append(_batch(i * 40, 40))
    st = t.stats()
    assert st.demotions > 0
    assert st.rows_expired == 0 and st.bytes_expired == 0
    assert st.num_rows == st.rows_added == 400
    assert t.read_all().length == 400


def test_demote_then_evict_matches_jax(ring):
    """A 1 MiB cold budget: demotion flows into true eviction. The
    counters and the watermark move monotonically, live rows reconcile
    with the row-id ledger at every append, and every counter equals the
    JAX package's."""
    t, ref = _tiered(64 * ROW_BYTES, cold_mb=1), _jax_tiered(64 * ROW_BYTES, cold_mb=1)
    rng = np.random.default_rng(4)
    prev = (0, 0, -1, 0)
    n = 1024
    for i in range(180):
        b = {
            "time_": np.arange(i * n, (i + 1) * n, dtype=np.int64),
            "latency": rng.integers(0, 2**62, n),  # incompressible
            "service": ["x"] * n,
        }
        t.append(b)
        ref.append(b)
        st = t.stats()
        cur = (st.rows_expired, st.bytes_expired, t.watermark_ns, st.rows_added)
        assert all(c >= p for c, p in zip(cur, prev))
        assert st.num_rows == st.rows_added - st.rows_expired
        assert t.first_row_id() == st.rows_expired
        prev = cur
    st, jst = t.stats(), ref.stats()
    assert st.evictions > 0 and st.rows_expired > 0
    assert st.cold_bytes <= 1 << 20
    for f in ("num_rows", "rows_added", "rows_expired", "bytes_expired",
              "cold_rows", "cold_bytes", "demotions", "evictions",
              "watermark", "min_time"):
        assert getattr(st, f) == getattr(jst, f), f
    _same_rows(t, ref)


def test_time_scan_across_tier_boundary(ring):
    t = _tiered(50 * ROW_BYTES)
    for i in range(8):
        t.append(_batch(i * 50, 50))
    st = t.stats()
    assert st.cold_rows > 0 and st.hot_rows > 0
    lo = st.cold_rows - 20  # starts cold, ends hot
    got = list(t.scan(start_time=lo, stop_time=lo + 60, window_rows=32))
    times = np.concatenate([b.cols["time_"][0] for b in got])
    assert np.array_equal(times, np.arange(lo, lo + 60))
    assert t.row_id_for_time(lo, False) == lo


def test_cold_read_copies_no_ring_rows(ring):
    """A read that lies in the cold tier never reads the ring; one that
    crosses the boundary reads the ring only from its first row, for
    the rows it returns; both bit for bit."""
    t = _tiered(50 * ROW_BYTES)
    for i in range(8):
        t.append(_batch(i * 50, 50))
    ring_first = t._backend.first_row_id()
    assert ring_first > 64
    reads = []
    real = t._backend.read

    def counted(start, n):
        reads.append((start, n))
        return real(start, n)

    t._backend.read = counted
    planes, first, n = t.read_rows(0, 32)
    assert (first, n, reads) == (0, 32, [])
    np.testing.assert_array_equal(planes[0], np.arange(32))
    planes, first, n = t.read_rows(ring_first - 10, 32)
    assert (first, n) == (ring_first - 10, 32)
    assert reads == [(ring_first, 22)]
    np.testing.assert_array_equal(planes[0],
                                  np.arange(ring_first - 10, ring_first + 22))


def test_mid_scan_demotion_race(ring):
    """Rows the cursor has not read yet demote under it: every live row
    is still delivered exactly once, bit for bit."""
    t = _tiered(1 << 20)  # nothing demotes on append
    for i in range(8):
        t.append(_batch(i * 64, 64))
    cur = t.cursor(StartSpec(), StopSpec.current_end())
    first = cur.next_batch(100)
    assert first.length == 100
    t._tier.demote_rows(512)
    st = t.stats()
    assert st.cold_rows >= 400 and st.rows_expired == 0
    rest = []
    while not cur.done():
        b = cur.next_batch(100)
        if b is None:
            break
        rest.append(b)
    times = np.concatenate(
        [first.cols["time_"][0]] + [b.cols["time_"][0] for b in rest]
    )
    assert np.array_equal(times, np.arange(512))


def test_freshness_exports_tier_split(ring):
    t = _tiered(40 * ROW_BYTES)
    for i in range(10):
        t.append(_batch(i * 40, 40))
    f = t.freshness()
    assert f["cold_rows"] > 0 and f["hot_rows"] > 0
    assert f["rows"] == f["cold_rows"] + f["hot_rows"] == 400
    assert f["cold_demotions_total"] > 0
    assert f["cold_raw_bytes"] >= f["cold_bytes"] > 0
    assert f["cold_evictions_total"] == 0


def test_untiered_unchanged(ring):
    """cold_tier_mb unset: max_bytes keeps its ring-expiry meaning."""
    t = Table("t", _rel(REL_ITEMS), max_bytes=100 * ROW_BYTES)
    t.append(_batch(0, 60))
    t.append(_batch(60, 60))
    st = t.stats()
    assert t._tier is None
    assert st.rows_expired == 60 and st.cold_rows == 0
    assert t.read_all().length == 60


# -- the engine over a tiered table --------------------------------------------------------
AGG_Q = (
    "import px\n"
    "df = px.DataFrame(table='t')\n"
    "out = df.groupby('service').agg(n=('latency', px.count),"
    " s=('latency', px.sum))\n"
    "px.display(out)\n"
)


def _tiered_engines(n=512, wins=12):
    """A CPU port engine and a JAX engine over the same tiered table (4
    windows hot, the rest demoted)."""
    with override_flag("cold_tier_mb", 64):
        eng = Engine(window_rows=n, device="cpu")
        eng.create_table("t", relation=_rel(REL_ITEMS), max_bytes=4 * n * ROW_BYTES)
        for i in range(wins):
            eng.append_data("t", _batch(i * n, n, svc=f"s{i % 3}"))
    with jax_override_flag("cold_tier_mb", 64):
        ref = JaxEngine(window_rows=n)
        ref.create_table("t", relation=_jax_rel(REL_ITEMS), max_bytes=4 * n * ROW_BYTES)
        for i in range(wins):
            ref.append_data("t", _batch(i * n, n, svc=f"s{i % 3}"))
    assert eng.tables["t"].stats().cold_rows == 8 * n
    return eng, ref


def _sorted_out(out, key):
    d = out.to_pydict()
    o = np.argsort(np.asarray(d[key]).astype(str), kind="stable")
    return {k: np.asarray(v)[o] for k, v in d.items()}


def test_device_cache_keeps_demoted_windows():
    """Demotion keeps the staged windows of demoted rows (the cache
    evicts by the first live row across both tiers), so a query over the
    tiered table reads every window resident and decodes nothing."""
    eng, _ref = _tiered_engines()
    t = eng.tables["t"]
    assert t.first_row_id() == 0
    assert len(t._device_cache) == 12
    eng.execute_query(AGG_Q)
    st = eng.last_stats
    assert (st.resident_windows, st.staged_windows, st.decode_s) == (12, 0, 0.0)


@pytest.mark.parametrize("depth", [1, 2])
def test_residency_off_decodes_cold_windows_like_jax(depth):
    """Residency off: the 8 cold windows decode inside the staging (on the
    prefetch thread at depth 2), the decode is charged to the query, and
    the answer equals the JAX engine's over its tiered table."""
    eng, ref = _tiered_engines()
    eng.pipeline_depth = depth
    with override_flag("device_residency", False), \
            jax_override_flag("device_residency", False):
        got = eng.execute_query(AGG_Q)["output"]
        want = ref.execute_query(AGG_Q)["output"]
    st = eng.last_stats
    assert st.decode_s > 0 and st.decode_bytes == 8 * 512 * ROW_BYTES
    assert st.staged_windows == 12 and st.rows == 12 * 512
    g, w = _sorted_out(got, "service"), _sorted_out(want, "service")
    for c in ("service", "n", "s"):
        assert np.array_equal(g[c], w[c]), c
    assert eng.tables["t"].stats().decode_seconds > 0


def test_decode_error_propagates_through_query():
    """A corrupt cold window fails the query through the prefetch
    pipeline's staging, with the store's error."""
    eng, _ref = _tiered_engines()
    t = eng.tables["t"]
    w = t._tier.store.windows[0]
    bad = EncodedPlane("rle", np.dtype(np.int64), w.n,
                       (np.array([1], dtype=np.int64),
                        np.array([w.n - 7], dtype=np.int32)))
    object.__setattr__(w, "planes", (bad,) + w.planes[1:])
    with pytest.raises(ColdStoreError):
        t.read_all()
    t._device_cache.clear()
    eng.pipeline_depth = 2
    with override_flag("device_residency", False):
        with pytest.raises(ColdStoreError, match="cold window"):
            eng.execute_query(AGG_Q)


def test_engine_skips_cold_windows_like_jax():
    """A clustered predicate over a mostly cold table: zone maps prune
    windows before any decode, as many as the JAX engine prunes, and the
    answer equals the unpruned one's."""
    n, wins = 1 << 10, 24
    rel = [("time_", "TIME64NS"), ("shard", "INT64"), ("v", "INT64")]
    with override_flag("cold_tier_mb", 128):
        eng = Engine(window_rows=n, device="cpu")
        eng.create_table("events", relation=_rel(rel), max_bytes=4 * n * 24 // 8)
        for i in range(wins):
            eng.append_data("events", {
                "time_": np.arange(i * n, (i + 1) * n, dtype=np.int64),
                "shard": np.full(n, i, dtype=np.int64),
                "v": np.arange(n, dtype=np.int64),
            })
    with jax_override_flag("cold_tier_mb", 128):
        ref = JaxEngine(window_rows=n)
        ref.create_table("events", relation=_jax_rel(rel), max_bytes=4 * n * 24 // 8)
        for i in range(wins):
            ref.append_data("events", {
                "time_": np.arange(i * n, (i + 1) * n, dtype=np.int64),
                "shard": np.full(n, i, dtype=np.int64),
                "v": np.arange(n, dtype=np.int64),
            })
    assert eng.tables["events"].stats().cold_rows > 0
    q = (
        "import px\n"
        "df = px.DataFrame(table='events')\n"
        "df = df[df.shard == 7]\n"
        "out = df.groupby('shard').agg(n=('v', px.count), s=('v', px.sum))\n"
        "px.display(out)\n"
    )
    got = eng.execute_query(q)["output"].to_pydict()
    skipped = eng.last_stats.skipped_windows
    want = ref.execute_query(q)["output"].to_pydict()
    assert skipped == ref.tracer.recent()[0]["usage"]["skipped_windows"]
    assert skipped >= wins - 2
    with override_flag("scan_zone_skip", False):
        flat = eng.execute_query(q)["output"].to_pydict()
    assert eng.last_stats.skipped_windows == 0
    for d in (got, flat):
        assert d["n"].tolist() == want["n"].tolist() == [n]
        assert d["s"].tolist() == want["s"].tolist()


def test_compile_stats_carry_the_tier_split():
    """A tiered table's sketch snapshot carries the JAX engine's "tier"
    entry (observed bytes per row of each tier), which the bounds pass
    reads."""
    eng, ref = _tiered_engines()
    got = eng._compile_table_stats()["t"]["tier"]
    want = ref._compile_table_stats()["t"]["tier"]
    assert got == want
    assert got["cold_rows"] == 8 * 512 and got["hot_rows"] == 4 * 512


def test_decode_meter_charges_only_the_query():
    """Decodes made on the same thread outside a query (``read_all``
    here) are not charged to the next query: the staging clears the
    thread's meter first. The JAX engine charges them (its decode_ms
    grows with every earlier read_all on the thread)."""
    eng, _ref = _tiered_engines()
    t = eng.tables["t"]
    eng.pipeline_depth = 1  # stage on this thread, where read_all ran
    with override_flag("device_residency", False):
        eng.execute_query(AGG_Q)
        alone = eng.last_stats.decode_bytes
        for _ in range(20):
            t.read_all()
        eng.execute_query(AGG_Q)
    assert alone == eng.last_stats.decode_bytes == 8 * 512 * ROW_BYTES
