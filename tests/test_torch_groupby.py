"""The group-by without a dense key domain, against the JAX package's.

- ``ops/groupby.py``: the hash form's ids, keys, validity and group count
  equal the JAX package's exactly on every key kind (int64; uint64 with
  values at or above 2^63; float32 with NaN, -0.0 and +0.0; bool; a
  UINT128 key as two planes; an all-masked window; no key planes) and
  on overflow (more keys than G; probe exhaustion). So do the sort
  form's: it flips the top bit of a uint64 plane's int64 view, so its
  order is the JAX package's unsigned one. ``regroup_pair`` and
  ``scatter_carry`` equal them exactly on two states with overlapping
  keys, for a scalar carry and a [G, k] carry.
- The engine: the six upid-keyed scripts, a whole-table aggregate,
  quantiles grouped by ``upid``, and ``px/http_stats`` /
  ``px/service_stats`` with the dense domains switched off, against
  the JAX engine over the same seeded tables, under both
  ``groupby_impl`` forms of the port. Answers are compared after
  sorting by key. Counts, sums, maxima and ``any`` are exact; means
  rtol 1e-5 where FLOAT64 and exact where INT64; p50/p99 rtol 0.05:
  the tolerances of ``tests/test_torch_engine.py``.
- The two repairs: a UINT128 column reaches a result (rows and group
  keys) bit for bit; an overflowing group-by rebuckets as the JAX
  engine does and raises only past ``max_groups_limit``.

The JAX side runs on XLA:CPU with ``cpu_fold_threads=1``; its
``groupby_impl`` is its CPU default (hash).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixie_tpu.config import override_flag as jax_override_flag
from pixie_tpu.exec import plan as jax_plan
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.exec.stream import QueryError as JaxQueryError
from pixie_tpu.ingest import schemas as jax_schemas
from pixie_tpu.ops import groupby as jax_groupby
from pixie_tpu.planner import CompilerState as JaxCompilerState
from pixie_tpu.planner import compile_pxl as jax_compile_pxl
from pixie_tpu.types.batch import HostBatch as JaxHostBatch
from pixie_tpu.types.strings import StringDictionary as JaxDictionary
from pixie_tpu_torch import Engine, QueryError
from pixie_tpu_torch.config import clear_flag, set_flag
from pixie_tpu_torch.exec import engine as engine_mod
from pixie_tpu_torch.exec import fragment as fragment_mod
from pixie_tpu_torch.exec import plan
from pixie_tpu_torch.ops import groupby
from pixie_tpu_torch.planner import CompilerState, compile_pxl
from pixie_tpu_torch.scripts import load_script
from pixie_tpu_torch.types import host_batch_from_numpy

from test_torch_engine import N as HTTP_ROWS, _replay_batches

FORMS = ("sort", "hash")
W = 4096
N = 2 * W
N_UPIDS, N_PODS, N_SERVICES = 120, 24, 6
N_LAT = 1000  # rows of the overflow tests' table, one key each
SEED = 11


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=FORMS)
def form(request):
    set_flag("groupby_impl", request.param)
    yield request.param
    clear_flag("groupby_impl")


# -- ops/groupby.py ------------------------------------------------------------
def _key_cases():
    rng = np.random.default_rng(SEED)
    n = 1000
    i64 = rng.integers(-50, 50, n) * (1 << 40)
    u64 = rng.integers(0, 40, n).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    u64[::7] |= np.uint64(1 << 63)
    f32 = rng.choice(
        np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf, 3e38], np.float32), n
    )
    f32[::11] = np.float32(np.nan)
    boolk = rng.integers(0, 2, n).astype(bool)
    hi = rng.integers(0, 6, n).astype(np.uint64) << np.uint64(60)
    lo = rng.integers(0, 5, n).astype(np.uint64) | np.uint64(1 << 63)
    strk = rng.integers(-1, 3, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    return {
        "int64": ([i64], mask),
        "uint64_top_bit": ([u64], mask),
        "float32_nan_zeros": ([f32], mask),
        "bool": ([boolk], mask),
        "uint128": ([hi, lo], mask),
        "uint128_and_string": ([hi, lo, strk], mask),
        "all_masked": ([i64], np.zeros(n, bool)),
        "no_keys": ([], mask),
    }


KEY_CASES = _key_cases()


def _bits(a):
    """Key planes compared by their bits (NaN payloads, -0.0)."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a


def _same(got, ref):
    gids, keys, valid, n_groups = got
    rgids, rkeys, rvalid, rn = ref
    np.testing.assert_array_equal(gids.numpy(), np.asarray(rgids))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    assert int(n_groups) == int(rn)
    assert len(keys) == len(rkeys)
    for k, rk in zip(keys, rkeys):
        assert k.numpy().dtype == np.asarray(rk).dtype
        np.testing.assert_array_equal(_bits(k.numpy()), _bits(rk))


def _both(fn_name, planes, mask, g, **kw):
    ref = getattr(jax_groupby, fn_name)(
        [jnp.asarray(p) for p in planes], jnp.asarray(mask), g, **kw
    )
    got = getattr(groupby, fn_name)(
        [torch.from_numpy(p) for p in planes], torch.from_numpy(mask), g, **kw
    )
    return got, ref


@pytest.mark.parametrize("fn_name", ["dense_group_ids_hash", "dense_group_ids"])
@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_group_ids_match_jax(fn_name, case):
    planes, mask = KEY_CASES[case]
    got, ref = _both(fn_name, planes, mask, 128)
    _same(got, ref)
    if case not in ("all_masked", "no_keys"):
        assert 1 < int(got[3]) <= 128  # real groups, no overflow


@pytest.mark.parametrize("fn_name,kw", [
    ("dense_group_ids_hash", {}),
    ("dense_group_ids", {}),
    ("dense_group_ids_hash", {"max_rounds": 2}),
])
def test_group_id_overflow_matches_jax(fn_name, kw):
    """More distinct keys than G (clamped into the last slot; overflow
    reported), and a hash table that runs out of probe rounds."""
    rng = np.random.default_rng(SEED + 1)
    keys = rng.integers(0, 1 << 62, 3000)
    planes = [keys[rng.integers(0, 200 if not kw else 40, 3000)]]
    mask = rng.random(3000) < 0.95
    g = 64 if not kw else 32
    got, ref = _both(fn_name, planes, mask, g, **kw)
    _same(got, ref)
    assert int(got[3]) > g


def _state(rng, g, universe, n_live):
    """A [g]-slot group state over UINT128 keys: n_live distinct keys of
    ``universe`` in random slots, the rest invalid."""
    pick = rng.choice(len(universe[0]), n_live, replace=False)
    slots = rng.choice(g, n_live, replace=False)
    valid = np.zeros(g, bool)
    valid[slots] = True
    keys = []
    for u in universe:
        k = np.zeros(g, np.uint64)
        k[slots] = u[pick]
        keys.append(k)
    cnt = np.where(valid, rng.integers(1, 100, g), 0).astype(np.int64)
    digest = np.where(valid[:, None], rng.random((g, 5)), 0).astype(np.float32)
    return keys, valid, cnt, digest


def test_regroup_pair_and_scatter_carry_match_jax():
    rng = np.random.default_rng(SEED + 2)
    g = 48
    universe = [
        rng.integers(0, 1 << 63, 40).astype(np.uint64) | np.uint64(1 << 63),
        rng.integers(0, 1 << 63, 40).astype(np.uint64),
    ]
    ka, va, ca, da = _state(rng, g, universe, 25)
    kb, vb, cb, db = _state(rng, g, universe, 30)
    ref = jax_groupby.regroup_pair(
        [jnp.asarray(k) for k in ka], jnp.asarray(va),
        [jnp.asarray(k) for k in kb], jnp.asarray(vb), g,
    )
    got = groupby.regroup_pair(
        [torch.from_numpy(k) for k in ka], torch.from_numpy(va),
        [torch.from_numpy(k) for k in kb], torch.from_numpy(vb), g,
    )
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _same((got[0], got[2], got[3], got[4]), (ref[0], ref[2], ref[3], ref[4]))
    assert int(got[4]) < 55  # the overlap merged
    for side, (ids, rids) in ((0, (got[0], ref[0])), (1, (got[1], ref[1]))):
        valid, cnt, digest = ((va, ca, da), (vb, cb, db))[side]
        carry = (torch.from_numpy(cnt), torch.from_numpy(digest))
        init = (torch.zeros(g, dtype=torch.int64),
                torch.full((g, 5), -1.0, dtype=torch.float32))
        rcarry = (jnp.asarray(cnt), jnp.asarray(digest))
        rinit = (jnp.zeros(g, jnp.int64), jnp.full((g, 5), -1.0, jnp.float32))
        out = groupby.scatter_carry(carry, ids, torch.from_numpy(valid), g, init)
        rout = jax_groupby.scatter_carry(rcarry, rids, jnp.asarray(valid), g,
                                         rinit)
        for a, b in zip(out, rout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        rows = groupby.scatter_rows(carry[0], ids, torch.from_numpy(valid), g, 0)
        rrows = jax_groupby.scatter_rows(rcarry[0], rids, jnp.asarray(valid),
                                         g, 0)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(rrows))


# -- the engine ------------------------------------------------------------------
def _upids(rng):
    """N_UPIDS upids: hi = asid << 32 | pid (some with the top bit set),
    lo = start ticks; each in one pod."""
    asid = rng.integers(0, 40, N_UPIDS).astype(np.uint64)
    pid = rng.integers(1, 1 << 22, N_UPIDS).astype(np.uint64)
    hi = (asid << np.uint64(32)) | pid
    hi[:7] |= np.uint64(1 << 63)
    lo = rng.integers(1 << 30, 1 << 40, N_UPIDS).astype(np.uint64)
    return hi, lo, rng.integers(0, N_PODS, N_UPIDS).astype(np.int32)


def _tables():
    """{table: (relation, cols, dicts)} for process_stats and the three
    protocol event tables, N rows each, from one seed."""
    rng = np.random.default_rng(SEED)
    hi, lo, pod_of = _upids(rng)
    pods = [f"ns-{i % 3}/pod-{i}" for i in range(N_PODS)]
    services = [f"ns-{i % 3}/svc-{i}" for i in range(N_SERVICES)]
    out = {}
    for name, rel in (
        ("process_stats", jax_schemas.PROCESS_STATS_RELATION),
        ("mysql_events", jax_schemas.MYSQL_EVENTS_RELATION),
        ("pgsql_events", jax_schemas.PGSQL_EVENTS_RELATION),
        ("redis_events", jax_schemas.REDIS_EVENTS_RELATION),
    ):
        u = rng.integers(0, N_UPIDS, N)
        cols, dicts = {}, {}
        for c, t in rel.items():
            if c == "time_":
                cols[c] = (np.arange(N, dtype=np.int64),)
            elif c == "upid":
                cols[c] = (hi[u], lo[u])
            elif c == "pod":
                cols[c] = (pod_of[u],)
                dicts[c] = pods
            elif c == "service":
                cols[c] = (rng.integers(0, N_SERVICES, N).astype(np.int32),)
                dicts[c] = services
            elif t.name == "STRING":
                cols[c] = (rng.integers(0, 5, N).astype(np.int32),)
                dicts[c] = [f"{c}-{i}" for i in range(5)]
            else:  # INT64 counters and sizes: a per-upid base plus noise
                base = rng.integers(1 << 20, 1 << 34, N_UPIDS)
                cols[c] = (base[u] + rng.integers(0, 1 << 16, N),)
        out[name] = (rel, cols, dicts)
    return out


@pytest.fixture(scope="module")
def engines():
    jax_eng = JaxEngine(window_rows=W)
    eng = Engine(window_rows=W, device="cpu")
    for name, (rel, cols, dicts) in _tables().items():
        jd = {c: JaxDictionary(v) for c, v in dicts.items()}
        for off in range(0, N, W):
            s = slice(off, off + W)
            hb = JaxHostBatch(
                relation=rel,
                cols={c: tuple(p[s] for p in ps) for c, ps in cols.items()},
                length=W, dicts=jd,
            )
            jax_eng.append_data(name, hb)
            eng.append_data(name, host_batch_from_numpy(
                [(n, t.name) for n, t in rel.items()], hb.cols, dicts,
            ))
    rng = np.random.default_rng(SEED + 3)
    lat = {"time_": np.arange(N_LAT), "latency_ns": rng.permutation(
        np.arange(1_000, 100_000_000, 99_991))[:N_LAT]}
    jax_eng.append_data("lat_events", lat)
    eng.append_data("lat_events", lat)
    for hb in _replay_batches():  # http_events, test_torch_engine's replay
        jax_eng.append_data("http_events", hb)
        eng.append_data("http_events", host_batch_from_numpy(
            [(n, t.name) for n, t in hb.relation.items()], hb.cols,
            {c: list(d.strings) for c, d in hb.dicts.items()},
        ))
    return jax_eng, eng


def _jax_flags(dense: bool):
    flags = {"cpu_fold_threads": 1}
    if not dense:  # no key qualifies for a dense domain
        flags.update(dense_domain_limit=0, int_dense_domain_limit=0)
    return flags


def _run_jax(jax_eng, query, max_groups, dense=True):
    state = JaxCompilerState(
        schemas={n: t.relation for n, t in jax_eng.tables.items()},
        registry=jax_eng.registry, now_ns=1, max_groups=max_groups,
    )
    compiled = jax_compile_pxl(query, state)
    ctx = [jax_override_flag(k, v) for k, v in _jax_flags(dense).items()]
    for c in ctx:
        c.__enter__()
    try:
        return jax_eng.execute_plan(compiled.plan)["output"]
    finally:
        for c in reversed(ctx):
            c.__exit__(None, None, None)


def _run_port(eng, query, max_groups, dense=True):
    """The port's answer; ``dense=False`` has the engine compile every
    fragment with ``compile_fragment(allow_dense=False)``."""
    state = CompilerState(
        schemas={n: t.relation for n, t in eng.tables.items()},
        registry=eng.registry, now_ns=1, max_groups=max_groups,
    )
    compiled = compile_pxl(query, state)
    if dense:
        return eng.execute_plan(compiled.plan)["output"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod, "compile_fragment", functools.partial(
            fragment_mod.compile_fragment, allow_dense=False))
        return eng.execute_plan(compiled.plan)["output"]


def _sorted(hb, keys):
    """Columns sorted by the key columns' ids and bits (a UINT128 key
    sorts by hi, then lo)."""
    d = hb.to_pydict(decode_strings=False)
    sort_cols = []
    for k in keys:
        v = np.asarray(d[k])
        sort_cols += [v[:, 0], v[:, 1]] if v.ndim == 2 else [v]
    order = np.lexsort(sort_cols[::-1])
    return {k: np.asarray(v)[order] for k, v in d.items()}


@functools.lru_cache(maxsize=None)
def _jax_answer(query, keys, max_groups, dense):
    return _sorted(_run_jax(_ENGINES[0], query, max_groups, dense), keys)


_ENGINES = [None]


def _compare(engines, query, keys, exact, close=(), max_groups=128,
             dense=True, rtol=1e-5):
    """The port's answer against the JAX engine's, sorted by key."""
    _ENGINES[0] = engines[0]
    ref = _jax_answer(query, tuple(keys), max_groups, dense)
    eng = engines[1]
    got = _sorted(_run_port(eng, query, max_groups, dense), keys)
    assert list(got) == list(ref)
    assert len(got[keys[0]]) > 0
    for c in list(keys) + list(exact):
        np.testing.assert_array_equal(got[c], ref[c], err_msg=c)
    for c in close:
        np.testing.assert_allclose(got[c], ref[c], rtol=rtol, err_msg=c)
    return got, eng.last_stats


def _no_dense_fragment(stats):
    assert all(f.is_agg is False or not (f.uses_dense_fold or f.uses_int_fold)
               for f in stats.fragments)


@pytest.mark.parametrize("script,keys,exact,close", [
    ("px/upids", ("upid", "pod"), ("samples", "rss", "vsize", "cpu_utime_ns"),
     ()),
    ("px/pid_memory_usage", ("upid",), ("rss", "vsize", "pod"), ()),
    ("px/pods", ("pod",), ("processes", "rss"), ()),
    ("px/mysql_flow_graph", ("upid", "service"), ("queries",), ("lat_mean",)),
    ("px/pgsql_flow_graph", ("upid", "service"), ("queries",), ("lat_mean",)),
    ("px/redis_flow_graph", ("upid", "service"), ("commands",), ("lat_mean",)),
])
def test_upid_scripts_match_jax(engines, form, script, keys, exact, close):
    got, stats = _compare(engines, load_script(script).pxl, keys, exact, close,
                          max_groups=512, rtol=1e-12)
    n_keys = len(got[keys[0]])
    if script == "px/pods":
        assert n_keys == N_PODS
    else:
        assert len(np.unique(got["upid"], axis=0)) > N_UPIDS // 2
    # The 700-odd (upid, service) edges outnumber 512 groups: the sort form
    # climbs exactly ceil(log2(edges / 512)) rungs, the hash form at
    # least as many (one more where the table runs out of probes).
    first = len(stats.fragments[0].init_state()["valid"])
    rungs = int(np.ceil(np.log2(max(n_keys / first, 1))))
    if script != "px/pods":
        assert (stats.rebuckets == rungs) if form == "sort" else (
            stats.rebuckets >= rungs)
    # UINT128 upid keys have no dense domain; px/pods' second group-by,
    # by pod, folds its INT64 aggregates through int_fold.
    assert [f.uses_int_fold for f in stats.fragments if f.is_agg][-1] == (
        script == "px/pods")
    assert not any(f.uses_int_fold for f in stats.fragments[:-1])


WHOLE_TABLE = """import px
df = px.DataFrame(table='process_stats')
out = df.agg(
    samples=('rss_bytes', px.count),
    rss=('rss_bytes', px.max),
    faults=('major_faults', px.sum),
    low=('vsize_bytes', px.min),
    cpu=('cpu_utime_ns', px.mean),
)
px.display(out)
"""

QUANTILES_BY_UPID = """import px
df = px.DataFrame(table='process_stats')
df.rss_mb = df.rss_bytes / 1048576.0
q = df.groupby('upid').agg(rss_q=('rss_mb', px.quantiles),
                           n=('rss_mb', px.count))
q.p50 = px.pluck_float64(q.rss_q, 'p50')
q.p99 = px.pluck_float64(q.rss_q, 'p99')
px.display(q[['upid', 'p50', 'p99', 'n']])
"""


def test_whole_table_aggregate_matches_jax(engines, form):
    _ENGINES[0] = engines[0]
    ref = _run_jax(engines[0], WHOLE_TABLE, 128).to_pydict()
    got = _run_port(engines[1], WHOLE_TABLE, 128).to_pydict()
    assert list(got) == list(ref)
    assert int(got["samples"][0]) == N
    for c in ("samples", "rss", "faults", "low"):
        np.testing.assert_array_equal(got[c], ref[c], err_msg=c)
    np.testing.assert_allclose(got["cpu"], ref["cpu"], rtol=1e-12)


def test_quantiles_by_upid_match_jax(engines, form):
    got, _stats = _compare(engines, QUANTILES_BY_UPID, ("upid",), ("n",),
                           ("p50", "p99"), rtol=0.05)
    assert len(got["upid"]) > N_UPIDS // 2


@pytest.mark.parametrize("script,keys,exact,close,rtol", [
    ("px/http_stats", ("service", "req_path"), ("n", "lat_mean", "lat_max"),
     (), 0),
    ("px/service_stats", ("service",), ("throughput",),
     ("p50", "p99", "error_rate"), 0.05),
])
def test_dense_scripts_without_dense_domains(engines, form, script, keys,
                                              exact, close, rtol):
    got, stats = _compare(engines, load_script(script).pxl, keys, exact, close,
                          max_groups=256, dense=False, rtol=rtol)
    assert len(got[keys[0]]) == (32 * 8 if script == "px/http_stats" else 32)
    _no_dense_fragment(stats)
    assert stats.fragments[0].init_state()["keys"]  # explicit key planes


# -- the repairs -----------------------------------------------------------------
ROWS_WITH_UPID = """import px
df = px.DataFrame(table='process_stats')
df = df[df.rss_bytes > 8000000000]
px.display(df.head(40))
"""


def test_uint128_rows_reach_the_result_bit_for_bit(engines):
    """Before the repair the port's row gather raised for uint64 planes
    (``index_select`` has no UInt64 kernel)."""
    jax_eng, eng = engines
    ref = jax_eng.execute_query(ROWS_WITH_UPID)["output"].to_pydict(
        decode_strings=False)
    got = eng.execute_query(ROWS_WITH_UPID)["output"].to_pydict(
        decode_strings=False)
    assert got["upid"].dtype == np.uint64 and got["upid"].shape == (40, 2)
    for c in ref:
        np.testing.assert_array_equal(got[c], ref[c], err_msg=c)


def test_uint128_group_keys_bit_for_bit(engines, form):
    query = ("import px\ndf = px.DataFrame(table='process_stats')\n"
             "px.display(df.groupby('upid').agg(n=('rss_bytes', px.count)))\n")
    got, _stats = _compare(engines, query, ("upid",), ("n",))
    assert got["upid"].dtype == np.uint64
    assert (got["upid"][:, 0] >= np.uint64(1 << 63)).any()


def _overflow_plans(mod):
    p = mod.Plan()
    src = p.add(mod.MemorySourceOp(table="lat_events"))
    agg = p.add(
        mod.AggOp(
            group_cols=("latency_ns",),  # about one group per row
            aggs=(mod.AggExpr("n", "count", (mod.ColumnRef("latency_ns"),)),),
            max_groups=64,
        ),
        [src],
    )
    p.add(mod.ResultSinkOp("output"), [agg])
    return p


@functools.lru_cache(maxsize=None)
def _jax_overflow_answer():
    """The JAX engine's answer (its CPU default, the hash form) and the
    rebuckets it marked in its analyze stats."""
    jax_eng = _ENGINES[0]
    with jax_override_flag("cpu_fold_threads", 1):
        out = jax_eng.execute_plan(_overflow_plans(jax_plan), analyze=True)
    rebuckets = sum("rebucket" in f.ops for f in jax_eng.last_stats.fragments)
    return _sorted(out["output"], ["latency_ns"]), rebuckets


def test_agg_overflow_rebuckets(engines, form):
    """Port counterpart of tests/test_exec.py::test_agg_overflow_rebuckets:
    the engine doubles max_groups and folds again (it raised before the
    repair), with the JAX engine's answer."""
    _ENGINES[0] = engines[0]
    ref, jax_rebuckets = _jax_overflow_answer()
    eng = engines[1]
    got = _sorted(eng.execute_plan(_overflow_plans(plan))["output"],
                  ["latency_ns"])
    assert len(got["latency_ns"]) == N_LAT
    assert got["n"].sum() == N_LAT
    for c in ref:
        np.testing.assert_array_equal(got[c], ref[c], err_msg=c)
    # 64 -> 1024 holds the 1000 keys: the sort form climbs exactly four
    # rungs; the hash form climbs as many as the JAX engine's (one more
    # wherever a table runs out of probe rounds).
    st = eng.last_stats
    assert st.rebuckets == (4 if form == "sort" else jax_rebuckets)
    assert jax_rebuckets >= 4
    assert len(st.fragments) == st.rebuckets + 1
    assert st.windows == st.rebuckets + 1


def test_agg_overflow_cap_raises(engines, form):
    """Port counterpart of tests/test_exec.py::test_agg_overflow_cap_raises."""
    jax_eng, eng = engines
    if form == "hash":  # the JAX engine's CPU form; it raises alike
        with jax_override_flag("max_groups_limit", 128), \
                jax_override_flag("cpu_fold_threads", 1):
            with pytest.raises(JaxQueryError, match="overflow"):
                jax_eng.execute_plan(_overflow_plans(jax_plan))
    set_flag("max_groups_limit", 128)
    try:
        with pytest.raises(QueryError, match="overflow"):
            eng.execute_plan(_overflow_plans(plan))
    finally:
        clear_flag("max_groups_limit")
    assert eng.last_stats.rebuckets == 1


def test_groupby_impl_flag():
    from pixie_tpu_torch.exec.fragment import window_group_ids_for

    assert window_group_ids_for("cpu") is groupby.dense_group_ids_hash
    assert window_group_ids_for("cuda") is groupby.dense_group_ids
    set_flag("groupby_impl", "SORT")
    try:
        assert window_group_ids_for("cpu") is groupby.dense_group_ids
    finally:
        clear_flag("groupby_impl")
    with pytest.raises(ValueError, match="groupby_impl"):
        set_flag("groupby_impl", "radix")


def _stale_first(real):
    """``_stream_col_stats`` whose first answer is stale: time_ as if the
    table held only its first 101 rows (an append racing the query)."""
    calls = []

    def col_stats(stream):
        stats = real(stream)
        calls.append(stats)
        if len(calls) == 1 and stats and "time_" in stats:
            return {**stats, "time_": (0, 100)}
        return stats

    return col_stats


DENSE_ESCAPE = """import px
df = px.DataFrame(table='http_events')
px.display(df.groupby('time_').agg(n=('latency_ns', px.count),
                                   hi=('latency_ns', px.max)))
"""


def test_dense_domain_escape_rebuckets(engines, monkeypatch):
    """An integer key outside its stats-derived dense domain sets the
    overflow flag: the engine recompiles against fresh stats and folds
    again, as the JAX engine does. Before the repair the port raised
    QueryError ("rows escaped the group keys' dense domain")."""
    import pixie_tpu.exec.engine as jax_engine_mod

    jax_eng, eng = engines
    monkeypatch.setattr(jax_engine_mod, "_stream_col_stats",
                        _stale_first(jax_engine_mod._stream_col_stats))
    monkeypatch.setattr(engine_mod, "_stream_col_stats",
                        _stale_first(engine_mod._stream_col_stats))
    with jax_override_flag("cpu_fold_threads", 1):
        ref = _sorted(jax_eng.execute_query(
            DENSE_ESCAPE, max_output_rows=HTTP_ROWS)["output"], ["time_"])
    got = _sorted(eng.execute_query(
        DENSE_ESCAPE, max_output_rows=HTTP_ROWS)["output"], ["time_"])
    assert len(got["time_"]) == HTTP_ROWS  # one row per time_
    for c in ref:
        np.testing.assert_array_equal(got[c], ref[c], err_msg=c)
    st = eng.last_stats
    assert st.rebuckets == 1
    assert all(f.uses_dense_fold is False and not f.init_state()["keys"]
               for f in st.fragments)  # dense slots both times
