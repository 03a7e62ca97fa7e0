"""Joins and unions of the port against the JAX package's, on the CPU.

- ``ops/join.py``: ``device_join`` for each ``how`` (one- and two-plane
  keys, a masked tail, a capacity that overflows), ``probe_sorted_join``
  and ``radix_probe_join`` for inner and left: the compacted
  (probe_idx, probe_take, build_idx, build_take) sequences and the
  overflow flag equal the JAX package's exactly. ``radix_partition_build``
  gives the same order, partition starts and search depth, and the
  port's device mixer equals the host splitmix64 on edge keys, so a probe
  key lands in the partition its build twin was put in.
- The engine: every strategy the JAX package serves (``host``,
  ``single``, ``sorted``, ``radix`` and the ``host_dict`` N:1 path)
  for each ``how`` it serves, over the JAX suite's cases
  (``tests/test_join.py``, ``tests/test_join_equivalence.py``):
  randomized and duplicate-heavy N:M keys, empty sides, STRING keys
  with divergent dictionaries and null ids, UINT128 keys, the build-side
  swap, the zone-skipped left join, the forced overflow retry and the
  learned capacity. Rows are compared as multisets (a join has no row
  order contract), and ``JoinDecision`` (strategy, swap, retries,
  skipped windows) and the final output capacity equal the JAX
  engine's. A hand-built union plan gives the same rows in order.
- ``px/net_flow_graph``, ``px/http_request_stats`` and
  ``px/service_resource_usage`` end to end at a few thousand rows: keys
  and INT64 values exact, FLOAT64 within rtol 1e-6, the same routing.

The JAX side runs as its own tests run it: XLA:CPU, the strategy and
window forced through ``override_flag``, ``DEVICE_JOIN_MIN_ROWS``
patched in its joins module. The port takes the same settings through
its own flags (``device_join_min_rows`` is the port's threshold).
"""

import collections
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pixie_tpu.exec.joins as jax_joins
from pixie_tpu.config import override_flag as jax_override_flag
from pixie_tpu.config import set_flag as jax_set_flag
from pixie_tpu.exec import plan as jax_plan
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.ops import hashtable as jax_hashtable
from pixie_tpu.ops import join as jax_join
from pixie_tpu.types.batch import HostBatch as JaxHostBatch
from pixie_tpu.types.dtypes import DataType as JaxDataType
from pixie_tpu.types.relation import Relation as JaxRelation
from pixie_tpu.types.strings import StringDictionary as JaxDictionary
import pixie_tpu_torch.exec.joins as joins
from pixie_tpu_torch import Engine
from pixie_tpu_torch.config import clear_flag, set_flag
from pixie_tpu_torch.exec import plan
from pixie_tpu_torch.ops import hashtable, join
from pixie_tpu_torch.scripts import load_script
from pixie_tpu_torch.types import DataType, HostBatch, Relation, StringDictionary

STRATEGIES = ("host", "single", "sorted", "radix")
HOWS = ("inner", "left", "right", "outer")
WINDOW = 64  # small probe windows force the multi-window drivers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- ops/join.py ----------------------------------------------------------------
def _compact(out):
    """The valid output rows of a kernel, as numpy: (probe_idx,
    probe_take, build_idx, build_take), and the overflow flag. An index
    whose take-mask is False is arbitrary by contract (the JAX package's
    hash ids and the port's sort ids pick different in-bounds rows), so
    it reads as -1."""
    p_idx, p_take, b_idx, b_take, valid, overflow = (
        np.asarray(a) for a in out
    )
    sel = np.nonzero(valid)[0]
    p_take, b_take = p_take[sel], b_take[sel]
    return (
        np.where(p_take, p_idx[sel], -1), p_take,
        np.where(b_take, b_idx[sel], -1), b_take,
    ), bool(overflow)


def _same_kernel_output(got, ref):
    (g, g_over), (r, r_over) = _compact(got), _compact(ref)
    assert g_over == r_over
    for a, b in zip(g, r):
        np.testing.assert_array_equal(a, b)


def _keys_case(seed, planes: int, n_b=300, n_p=400):
    rng = np.random.default_rng(seed)
    bk = [rng.integers(0, 40, n_b).astype(np.int64)]
    pk = [rng.integers(10, 60, n_p).astype(np.int64)]
    for _ in range(planes - 1):  # a second plane of few values
        bk.append(rng.integers(0, 2, n_b).astype(np.int64) << 40)
        pk.append(rng.integers(0, 2, n_p).astype(np.int64) << 40)
    bv = np.arange(n_b) < n_b - 7  # a masked tail on both sides
    pv = np.arange(n_p) < n_p - 5
    return bk, bv, pk, pv


@functools.lru_cache(maxsize=None)
def _jax_device_join(capacity, how):
    return jax.jit(lambda bk, bv, pk, pv: jax_join.device_join(
        bk, bv, pk, pv, capacity, how))


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("capacity", [4096, 256])  # 256 overflows
def test_device_join_matches_jax(how, planes, capacity):
    bk, bv, pk, pv = _keys_case(3 + planes, planes)
    ref = _jax_device_join(capacity, how)(
        [jnp.asarray(p) for p in bk], jnp.asarray(bv),
        [jnp.asarray(p) for p in pk], jnp.asarray(pv),
    )
    got = join.device_join(
        [torch.from_numpy(p) for p in bk], torch.from_numpy(bv),
        [torch.from_numpy(p) for p in pk], torch.from_numpy(pv),
        capacity, how,
    )
    _same_kernel_output(got, ref)
    assert bool(got[5]) == (capacity == 256)


def _sorted_build(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 500, 2000).astype(np.int64)
    nb = 4096
    order = np.argsort(keys, kind="stable")
    sbk = np.full(nb, np.iinfo(np.int64).max, dtype=np.int64)
    sbk[:len(keys)] = keys[order]
    probe = rng.integers(-20, 520, 1024).astype(np.int64)
    pv = np.arange(1024) < 1000
    return keys, sbk, probe, pv


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("capacity", [8192, 1024])  # 1024 overflows
def test_probe_sorted_join_matches_jax(how, capacity):
    keys, sbk, probe, pv = _sorted_build(5)
    ref = jax_join.probe_sorted_join(
        jnp.asarray(sbk), np.int32(len(keys)), jnp.asarray(probe),
        jnp.asarray(pv), capacity, how,
    )
    got = join.probe_sorted_join(
        torch.from_numpy(sbk), len(keys), torch.from_numpy(probe),
        torch.from_numpy(pv), capacity, how,
    )
    _same_kernel_output(got, ref)


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("bits", [4, 8])
def test_radix_probe_join_matches_jax(how, bits):
    keys, _sbk, probe, pv = _sorted_build(7)
    keys = keys * 7919 - (1 << 40)  # negative and wide keys
    probe = probe * 7919 - (1 << 40)
    order, starts, steps = join.radix_partition_build(keys, bits)
    sbk = np.full(4096, np.iinfo(np.int64).max, dtype=np.int64)
    sbk[:len(keys)] = keys[order]
    ref = jax_join.radix_probe_join(
        jnp.asarray(sbk), jnp.asarray(starts), jnp.asarray(probe),
        jnp.asarray(pv), 8192, how, bits, steps,
    )
    got = join.radix_probe_join(
        torch.from_numpy(sbk), torch.from_numpy(starts),
        torch.from_numpy(probe), torch.from_numpy(pv), 8192, how, bits,
        steps,
    )
    _same_kernel_output(got, ref)


EDGE_KEYS = np.array([
    0, -1, 1 << 62, -(1 << 62), np.iinfo(np.int64).min,
    np.iinfo(np.int64).max, 1, 0x9E3779B97F4A7C15 - (1 << 64),
], dtype=np.int64)


@pytest.mark.parametrize("bits", [1, 8, 16])
def test_radix_partition_build_matches_jax(bits):
    rng = np.random.default_rng(bits)
    keys = np.concatenate([
        rng.integers(-(1 << 50), 1 << 50, 3000), EDGE_KEYS,
        rng.integers(0, 30, 500),  # duplicates
    ]).astype(np.int64)
    got = join.radix_partition_build(keys, bits)
    ref = jax_join.radix_partition_build(keys, bits)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[1].dtype == ref[1].dtype
    assert got[2] == ref[2]


def test_device_mixer_matches_host_splitmix64():
    """Edge keys and random keys: the torch mixer on int64 lanes has the
    bits of the numpy (and the JAX package's) uint64 mixer, and the top
    bits give the same partition."""
    keys = np.concatenate([
        EDGE_KEYS,
        np.random.default_rng(0).integers(
            np.iinfo(np.int64).min, np.iinfo(np.int64).max, 4096,
            dtype=np.int64),
    ])
    want = jax_hashtable._mix64(keys.view(np.uint64))
    np.testing.assert_array_equal(hashtable._mix64(keys.view(np.uint64)), want)
    got = hashtable.mix64(torch.from_numpy(keys)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    for bits in (1, 8, 63):
        part = hashtable.shr64(
            hashtable.mix64(torch.from_numpy(keys)), 64 - bits).numpy()
        np.testing.assert_array_equal(
            part, (want >> np.uint64(64 - bits)).astype(np.int64))


# -- the engine ---------------------------------------------------------------------
@contextlib.contextmanager
def _join_flags(monkeypatch, strategy="auto", window=WINDOW, min_rows=0):
    """The JAX suite's settings on both packages: a forced strategy, the
    probe window and the host-dict threshold."""
    monkeypatch.setattr(jax_joins, "DEVICE_JOIN_MIN_ROWS", min_rows)
    set_flag("device_join_min_rows", min_rows)
    set_flag("join_strategy", strategy)
    set_flag("join_probe_window_rows", window)
    try:
        with jax_override_flag("join_strategy", strategy), \
                jax_override_flag("join_probe_window_rows", window):
            yield
    finally:
        clear_flag("device_join_min_rows")
        clear_flag("join_strategy")
        clear_flag("join_probe_window_rows")


def _join_plan(mod, how, on=("k",)):
    p = mod.Plan()
    s1 = p.add(mod.MemorySourceOp(table="l"))
    s2 = p.add(mod.MemorySourceOp(table="r"))
    j = p.add(mod.JoinOp(left_on=on, right_on=on, how=how), [s1, s2])
    p.add(mod.ResultSinkOp("output"), [j])
    return p


def _engine_pair(l_cols, r_cols):
    """A JAX engine and a CPU port engine holding tables l and r."""
    jax_eng, eng = JaxEngine(), Engine(device="cpu")
    for e in (jax_eng, eng):
        e.append_data("l", l_cols, time_cols=())
        e.append_data("r", r_cols, time_cols=())
    return jax_eng, eng


def _final_capacity(jax_eng):
    """The JAX engine's learned capacity of its one join (None when the
    join ran on the host)."""
    caps = list(jax_eng._join_capacity_cache.values())
    assert len(caps) <= 1
    return caps[0] if caps else None


def _same_decision(jax_eng, eng):
    ref, got = jax_eng.last_join_decision, eng.last_join_decision
    assert (got.strategy, got.swap, got.retries, got.skipped_windows) == (
        ref.strategy, ref.swap, ref.retries, ref.skipped_windows), (got, ref)
    assert got.capacity == _final_capacity(jax_eng)
    return got


def _rows(out, cols):
    d = out.to_pydict()
    return collections.Counter(zip(*(
        [tuple(r) for r in d[c]] if np.ndim(d[c]) == 2 else d[c].tolist()
        for c in cols
    )))


def _run_pair(monkeypatch, l_cols, r_cols, how, strategy, cols=("lv", "rv"),
              on=("k",), window=WINDOW, min_rows=0, engines=None):
    jax_eng, eng = engines or _engine_pair(l_cols, r_cols)
    with _join_flags(monkeypatch, strategy, window, min_rows):
        ref = jax_eng.execute_plan(_join_plan(jax_plan, how, on))["output"]
        got = eng.execute_plan(_join_plan(plan, how, on))["output"]
    assert _rows(got, cols) == _rows(ref, cols)
    return _same_decision(jax_eng, eng), _rows(got, cols)


def _ref_join(lk, rk, how):
    """The pair multiset of a reference N:M join, as (lv, rv) with
    lv = i + 1, rv = j + 1 and 0 for a null side."""
    by_key = collections.defaultdict(list)
    for j, k in enumerate(rk):
        by_key[k].append(j)
    out, matched = [], set()
    for i, k in enumerate(lk):
        js = by_key.get(k, [])
        for j in js:
            out.append((i + 1, j + 1))
            matched.add(j)
        if not js and how in ("left", "outer"):
            out.append((i + 1, 0))
    if how in ("right", "outer"):
        out += [(0, j + 1) for j in range(len(rk)) if j not in matched]
    return collections.Counter(out)


def _int_tables(lk, rk):
    lk, rk = np.asarray(lk, np.int64), np.asarray(rk, np.int64)
    return (
        {"k": lk, "lv": np.arange(1, len(lk) + 1, dtype=np.int64)},
        {"k": rk, "rv": np.arange(1, len(rk) + 1, dtype=np.int64)},
    )


def _check_int_join(monkeypatch, lk, rk, how, strategy, **kw):
    decision, rows = _run_pair(monkeypatch, *_int_tables(lk, rk), how,
                               strategy, **kw)
    assert rows == _ref_join(list(lk), list(rk), how)
    return decision


def _served(how, strategy):
    """The strategy the JAX package runs for a forced one: ``host`` serves
    inner/left, and right/outer always take the single-shot kernel."""
    if how in ("right", "outer"):
        return "single"
    return "host_hash" if strategy == "host" else strategy


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("how", HOWS)
def test_randomized_nm(monkeypatch, how, strategy):
    rng = np.random.default_rng(11)
    for _trial in range(2):
        lk = rng.integers(0, 60, int(rng.integers(1, 400)))
        rk = rng.integers(20, 80, int(rng.integers(1, 300)))
        d = _check_int_join(monkeypatch, lk, rk, how, strategy)
        assert d.strategy == _served(how, strategy)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("how", ["inner", "left"])
def test_duplicate_heavy_nm(monkeypatch, how, strategy):
    rng = np.random.default_rng(13)
    _check_int_join(monkeypatch, rng.integers(0, 5, 300),
                    rng.integers(0, 5, 200), how, strategy)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("how", HOWS)
def test_empty_sides(monkeypatch, how, strategy):
    for n_l, n_r in ((0, 5), (5, 0), (0, 0)):
        d = _check_int_join(monkeypatch, np.arange(n_l), np.arange(n_r),
                            how, strategy)
        assert d.strategy == "degenerate"


@pytest.mark.parametrize("strategy", ["sorted", "radix"])
def test_build_side_swap(monkeypatch, strategy):
    rng = np.random.default_rng(17)
    d = _check_int_join(monkeypatch, rng.integers(0, 50, 60),
                        rng.integers(0, 50, 1200), "inner", strategy)
    assert d.swap


@pytest.mark.parametrize("strategy,how", [
    ("sorted", "left"), ("radix", "left"), ("sorted", "inner"),
])
def test_zone_skipped_windows(monkeypatch, strategy, how):
    """Ascending probe keys and a narrow build range: most probe windows
    are zone-skipped, and a left join still emits their null rows."""
    d = _check_int_join(monkeypatch, np.arange(1000), np.arange(950, 980),
                        how, strategy)
    assert d.skipped_windows > 0


@pytest.mark.parametrize("strategy,how", [
    ("sorted", "left"), ("radix", "left"), ("sorted", "inner"),
])
def test_zone_skipped_windows_on_the_trace(monkeypatch, strategy, how):
    """The windowed join's trace usage equals the JAX engine's: the join
    is a fragment of the query's trace (its probe windows and rows, its
    output rows) and its zone-skipped probe windows count, as do its
    retries (ROADMAP.md §C, C9)."""
    tables = _int_tables(np.arange(1000), np.arange(950, 980))
    engines = _engine_pair(*tables)
    _run_pair(monkeypatch, *tables, how, strategy, engines=engines)
    keys = ("rows_in", "rows_out", "windows", "retries", "skipped_windows")
    jax_usage, usage = (
        {k: getattr(e.tracer.last().usage, k) for k in keys}
        for e in engines
    )
    assert usage == jax_usage
    assert usage["skipped_windows"] == engines[1].last_join_decision \
        .skipped_windows > 0


@pytest.mark.parametrize("strategy", ["single", "sorted", "radix"])
def test_forced_overflow_retry(monkeypatch, strategy):
    """A capacity estimate far too low retries doubled, as many times as
    the JAX engine does, and still gives the exact join."""
    for mod in (jax_joins, joins):
        monkeypatch.setattr(mod, "estimate_join_capacity",
                            lambda *a, **k: 16)
        monkeypatch.setattr(mod, "learned_capacity", lambda eng, k: None)
    rng = np.random.default_rng(19)
    d = _check_int_join(monkeypatch, rng.integers(0, 10, 400),
                        rng.integers(0, 10, 400), "inner", strategy)
    assert d.retries > 0


@pytest.mark.parametrize("strategy", ["single", "sorted"])
def test_learned_capacity(monkeypatch, strategy):
    """The second run of a plan starts at the rung the first settled on:
    no retries, the same capacity in both packages."""
    rng = np.random.default_rng(23)
    engines = _engine_pair(*_int_tables(rng.integers(0, 10, 400),
                                        rng.integers(0, 10, 400)))
    for mod in (jax_joins, joins):
        monkeypatch.setattr(mod, "estimate_join_capacity",
                            lambda *a, **k: 1024)
    first, _ = _run_pair(monkeypatch, None, None, "inner", strategy,
                         engines=engines)
    assert first.retries > 0
    second, _ = _run_pair(monkeypatch, None, None, "inner", strategy,
                          engines=engines)
    assert second.retries == 0 and second.capacity == first.capacity
    assert engines[1].last_stats.join_retries == 0


@pytest.mark.parametrize("how", ["inner", "left"])
def test_host_dict_on_unique_build(monkeypatch, how):
    rng = np.random.default_rng(29)
    lk = rng.integers(0, 40, 200)
    rk = rng.permutation(40)[:30]
    d = _check_int_join(monkeypatch, lk, rk, how, "auto", min_rows=1 << 15)
    assert d.strategy == "host_dict"


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("how", HOWS)
def test_string_keys_divergent_dicts(monkeypatch, how, strategy):
    """Divergent dictionaries: unseen build strings remap past the probe
    side's ids. Null ids (-1) on both sides take every path the way the
    JAX package takes them (a null probe key meets a null build key)."""
    l_ids = np.array([0, 1, 2, 1, 3, -1], np.int32)  # a, b, c, b, e, null
    r_ids = np.array([0, 1, 0, 2, -1], np.int32)  # b, d, b, e, null
    tables = {
        "l": ({"s": "STRING"}, {"s": l_ids}, {"s": ["a", "b", "c", "e"]}),
        "r": ({"s": "STRING", "v": "INT64"},
              {"s": r_ids, "v": np.arange(1, 6, dtype=np.int64)},
              {"s": ["b", "d", "e"]}),
    }
    _, rows = _run_pair(monkeypatch, None, None, how, strategy,
                        cols=("s", "v"), on=("s",), window=2,
                        engines=_load(tables, window=1024))
    assert rows[("b", 1)] == rows[("b", 3)] == 2


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("how", HOWS)
def test_uint128_keys(monkeypatch, how, strategy):
    rng = np.random.default_rng(31)
    hi = (rng.integers(0, 4, 300).astype(np.uint64) << np.uint64(61))
    lo = rng.integers(0, 6, 300).astype(np.uint64) | np.uint64(1 << 63)
    u = np.stack([hi, lo], axis=1)
    l_cols = {"u": u[:180], "lv": np.arange(1, 181, dtype=np.int64)}
    r_cols = {"u": u[180:], "rv": np.arange(1, 121, dtype=np.int64)}
    _run_pair(monkeypatch, l_cols, r_cols, how, strategy, cols=("u", "lv", "rv"),
              on=("u",))


def _union_plan(mod):
    p = mod.Plan()
    a = p.add(mod.MemorySourceOp(table="a"))
    b = p.add(mod.MemorySourceOp(table="b"))
    u = p.add(mod.UnionOp(), [a, b])
    p.add(mod.ResultSinkOp("output"), [u])
    return p


def test_union_plan():
    """A hand-built union of two tables with divergent string
    dictionaries: re-encoded strings, rows merged in time order."""
    rng = np.random.default_rng(37)
    tables = {
        "a": {"time_": np.sort(rng.integers(0, 1000, 300)),
              "svc": [f"s{i}" for i in rng.integers(0, 5, 300)],
              "v": rng.integers(0, 100, 300)},
        "b": {"time_": np.sort(rng.integers(0, 1000, 200)),
              "svc": [f"s{i}" for i in rng.integers(3, 9, 200)],
              "v": rng.integers(0, 100, 200)},
    }
    jax_eng, eng = JaxEngine(), Engine(device="cpu")
    for e in (jax_eng, eng):
        for name, cols in tables.items():
            e.append_data(name, cols)
    ref = jax_eng.execute_plan(_union_plan(jax_plan))["output"].to_pydict()
    got = eng.execute_plan(_union_plan(plan))["output"].to_pydict()
    for c in ("time_", "svc", "v"):
        assert list(got[c]) == list(ref[c]), c
    assert list(got["time_"]) == sorted(got["time_"])


# -- the scripts ------------------------------------------------------------------
N_SCRIPT = 4096


def _conn_stats():
    """bench.py's conn_stats recipe (seed 11, 48 pods) at N_SCRIPT rows."""
    rng = np.random.default_rng(11)
    n, n_pods = N_SCRIPT, 48
    pods = [f"ns/pod-{i}" for i in range(n_pods)]
    addrs = [f"10.1.{i // 250}.{i % 250}" for i in range(n_pods)]
    src = rng.integers(0, n_pods, n).astype(np.int32)
    dst = rng.integers(0, n_pods, n).astype(np.int32)
    cols = {"time_": np.arange(n, dtype=np.int64), "src_addr": src,
            "src_pod": src, "remote_addr": dst,
            "bytes_sent": rng.integers(64, 1 << 20, n),
            "bytes_recv": rng.integers(64, 1 << 20, n)}
    types = {"time_": "TIME64NS", "src_addr": "STRING", "src_pod": "STRING",
             "remote_addr": "STRING", "bytes_sent": "INT64",
             "bytes_recv": "INT64"}
    dicts = {"src_addr": addrs, "src_pod": pods, "remote_addr": addrs}
    return {"conn_stats": (types, cols, dicts)}


def _http_and_process():
    """http_events (with a pod column and /healthz rows) and
    process_stats over the same 64 pods."""
    rng = np.random.default_rng(41)
    n, n_pods, n_svc = N_SCRIPT, 64, 6
    pods = [f"ns/pod-{i}" for i in range(n_pods)]
    pod = rng.integers(0, n_pods, n).astype(np.int32)
    http = {"time_": np.sort(rng.integers(0, 8_000_000_000, n)),
            "latency_ns": rng.integers(1_000, 10_000_000, n),
            "service": (pod % n_svc).astype(np.int32),
            "req_path": rng.integers(0, 3, n).astype(np.int32),
            "pod": pod}
    http_t = {"time_": "TIME64NS", "latency_ns": "INT64", "service": "STRING",
              "req_path": "STRING", "pod": "STRING"}
    m = n // 2
    procs = {"time_": np.arange(m, dtype=np.int64),
             "pod": rng.integers(0, n_pods, m).astype(np.int32),
             "cpu_utime_ns": rng.integers(0, 1 << 40, m),
             "cpu_ktime_ns": rng.integers(0, 1 << 40, m),
             "rss_bytes": rng.integers(1 << 20, 1 << 32, m)}
    procs_t = {"time_": "TIME64NS", "pod": "STRING", "cpu_utime_ns": "INT64",
               "cpu_ktime_ns": "INT64", "rss_bytes": "INT64"}
    return {
        "http_events": (http_t, http, {
            "service": [f"svc-{i}" for i in range(n_svc)],
            "req_path": ["/healthz", "/api/a", "/api/b"], "pod": pods}),
        "process_stats": (procs_t, procs, {"pod": pods}),
    }


def _load(tables, window):
    jax_eng = JaxEngine(window_rows=window)
    eng = Engine(window_rows=window, device="cpu")
    for name, (types, cols, dicts) in tables.items():
        jrel = JaxRelation([(c, JaxDataType[t]) for c, t in types.items()])
        rel = Relation([(c, DataType[t]) for c, t in types.items()])
        planes = {c: (np.asarray(v),) for c, v in cols.items()}
        n = len(next(iter(cols.values())))
        jax_eng.append_data(name, JaxHostBatch(
            relation=jrel, cols=planes, length=n,
            dicts={c: JaxDictionary(s) for c, s in dicts.items()}))
        eng.append_data(name, HostBatch(
            relation=rel, cols=planes, length=n,
            dicts={c: StringDictionary(s) for c, s in dicts.items()}))
    return jax_eng, eng


SCRIPTS = {
    "px/net_flow_graph": (_conn_stats, ["src_pod", "src_pod_dst"]),
    "px/http_request_stats": (_http_and_process, ["service", "window"]),
    "px/service_resource_usage": (_http_and_process, ["service"]),
}


def _sorted_cols(hb, keys):
    d = hb.to_pydict(decode_strings=False)
    order = np.lexsort([d[k] for k in reversed(keys)])
    return {c: np.asarray(v)[order] for c, v in d.items()}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_script_matches_jax(script):
    make, keys = SCRIPTS[script]
    jax_eng, eng = _load(make(), window=1024)
    q = load_script(script).pxl
    jax_set_flag("cpu_fold_threads", 1)
    try:
        ref = jax_eng.execute_query(q)["output"]
    finally:
        jax_set_flag("cpu_fold_threads", 0)
    got = eng.execute_query(q)["output"]
    assert got.relation.column_names == ref.relation.column_names
    assert got.length == ref.length > 0
    g, r = _sorted_cols(got, keys), _sorted_cols(ref, keys)
    for c in g:
        if g[c].dtype.kind == "f":
            np.testing.assert_allclose(g[c], r[c], rtol=1e-6, err_msg=c)
        else:
            np.testing.assert_array_equal(g[c], r[c], err_msg=c)
    assert eng.last_join_decision.strategy == \
        jax_eng.last_join_decision.strategy


@pytest.mark.cuda
@pytest.mark.parametrize("how", HOWS)
def test_kernels_on_the_card_match_the_cpu(how):
    """On a card: the device mixer, ``device_join`` and both windowed
    probes give the CPU's results exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    keys = torch.from_numpy(EDGE_KEYS)
    assert torch.equal(hashtable.mix64(keys.to(dev)).cpu(),
                       hashtable.mix64(keys))
    bk, bv, pk, pv = _keys_case(9, 2)
    args = ([torch.from_numpy(p) for p in bk], torch.from_numpy(bv),
            [torch.from_numpy(p) for p in pk], torch.from_numpy(pv))
    on_card = ([p.to(dev) for p in args[0]], args[1].to(dev),
               [p.to(dev) for p in args[2]], args[3].to(dev))
    _same_kernel_output(
        [t.cpu() for t in join.device_join(*on_card, 4096, how)],
        join.device_join(*args, 4096, how))
    if how in ("inner", "left"):
        keys, sbk, probe, pv = _sorted_build(5)
        order, starts, steps = join.radix_partition_build(keys, 8)
        rsbk = np.full(4096, np.iinfo(np.int64).max, dtype=np.int64)
        rsbk[:len(keys)] = keys[order]
        for fn, a in (
            (join.probe_sorted_join, (sbk, len(keys), probe, pv, 8192, how)),
            (join.radix_probe_join, (rsbk, starts, probe, pv, 8192, how, 8,
                                     steps)),
        ):
            cpu = [torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                   for x in a]
            card = [x.to(dev) if isinstance(x, torch.Tensor) else x
                    for x in cpu]
            _same_kernel_output([t.cpu() for t in fn(*card)], fn(*cpu))
