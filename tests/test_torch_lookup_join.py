"""The fused lookup join and eager aggregation through joins, port
against the JAX package, on the CPU: the cases of
``tests/test_lookup_join.py`` through both engines, with the same rows
and the same ``fused`` routing.

- the eager-aggregation rewrite (a join then an aggregate of the build
  side's values becomes a partial aggregate below an N:1 join, which
  fuses into the probe stream as a lookup against the dense aggregate's
  device planes) against brute force, and its guards (an already
  grouped build side is not aggregated again);
- a STRING-key join whose build side becomes a dense aggregate over
  the dictionary's codes;
- an INT64 key whose dense domain is negative and offset;
- a build side whose aggregate feeds a post-aggregate map;
- the host table build: a unique-key build side that arrives as rows.

The quantile case of the JAX suite (``test_quantiles_blocks_rewrite``)
is marked slow there and is not repeated. Counts, sums, minima and
maxima are exact.
"""

import collections

import numpy as np
import pytest
import torch

from pixie_tpu.config import set_flag as jax_set_flag
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu.types.batch import HostBatch as JaxHostBatch
from pixie_tpu.types.dtypes import DataType as JaxDataType
from pixie_tpu.types.relation import Relation as JaxRelation
from pixie_tpu.types.strings import StringDictionary as JaxDictionary
import pixie_tpu_torch.exec.joins as joins
from pixie_tpu_torch import Engine
from pixie_tpu_torch.exec.plan import AggOp, JoinOp
from pixie_tpu_torch.planner import CompilerState, compile_pxl
from pixie_tpu_torch.types import DataType, HostBatch, Relation, StringDictionary
from pixie_tpu_torch.udf.registry import default_registry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _append(engines, name, types, cols, dicts=None):
    """Append one table, as typed host planes, to both engines."""
    jax_eng, eng = engines
    n = len(next(iter(cols.values())))
    planes = {c: (np.asarray(v),) for c, v in cols.items()}
    dicts = dicts or {}
    jax_eng.append_data(name, JaxHostBatch(
        relation=JaxRelation([(c, JaxDataType[t]) for c, t in types]),
        cols=planes, length=n,
        dicts={c: JaxDictionary(s) for c, s in dicts.items()}))
    eng.append_data(name, HostBatch(
        relation=Relation([(c, DataType[t]) for c, t in types]),
        cols=planes, length=n,
        dicts={c: StringDictionary(s) for c, s in dicts.items()}))


def _engines(window):
    return JaxEngine(window_rows=window), Engine(window_rows=window,
                                                 device="cpu")


def _two_tables(engines, n=20_000, n_keys=4_000, seed=5):
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, n_keys, n)
    lb = rng.integers(0, 7, n)
    rk = rng.integers(0, n_keys, n)
    rv = rng.integers(-50, 1000, n)
    t = np.arange(n, dtype=np.int64)
    _append(engines, "L", [("time_", "TIME64NS"), ("k", "INT64"),
                           ("b", "INT64")], {"time_": t, "k": lk, "b": lb})
    _append(engines, "R", [("time_", "TIME64NS"), ("k", "INT64"),
                           ("v", "INT64")], {"time_": t, "k": rk, "v": rv})
    return lk, lb, rk, rv, n_keys


def _run(engines, q, key, max_output_rows=10_000):
    """Both engines' answers, sorted by ``key``, and their join routes."""
    jax_eng, eng = engines
    jax_set_flag("cpu_fold_threads", 1)
    try:
        ref = jax_eng.execute_query(q, max_output_rows=max_output_rows)
    finally:
        jax_set_flag("cpu_fold_threads", 0)
    got = eng.execute_query(q, max_output_rows=max_output_rows)
    out = []
    for hb in (got["output"], ref["output"]):
        d = hb.to_pydict(decode_strings=False)
        order = np.argsort(d[key], kind="stable")
        out.append({c: np.asarray(v)[order] for c, v in d.items()})
    g, r = out
    assert list(g) == list(r)
    for c in g:
        np.testing.assert_array_equal(g[c], r[c], err_msg=c)
    strategy = [getattr(e.last_join_decision, "strategy", None)
                for e in (eng, jax_eng)]
    assert strategy[0] == strategy[1]
    return g, eng.last_join_decision


JOIN_AGG = """
import px
l = px.DataFrame(table='L')
r = px.DataFrame(table='R')
g = l.merge(r, how='inner', left_on=['k'], right_on=['k'], suffixes=['', '_r'])
out = g.groupby('b').agg(
    n=('v', px.count), s=('v', px.sum),
    mn=('v', px.min), mx=('v', px.max), bmax=('time_', px.max))
px.display(out)
"""


def _expected(lk, lb, rk, rv, n_keys):
    cnt = np.bincount(rk, minlength=n_keys)
    s = np.bincount(rk, weights=rv.astype(np.float64), minlength=n_keys)
    mn = np.full(n_keys, np.iinfo(np.int64).max)
    mx = np.full(n_keys, np.iinfo(np.int64).min)
    np.minimum.at(mn, rk, rv)
    np.maximum.at(mx, rk, rv)
    out = {}
    for b in np.unique(lb):
        m = (lb == b) & (cnt[lk] > 0)
        if m.any():
            ks = lk[m]
            out[int(b)] = (int(cnt[ks].sum()), float(s[ks].sum()),
                           int(mn[ks].min()), int(mx[ks].max()),
                           int(np.nonzero(m)[0].max()))
    return out


def test_agg_through_join_fuses_and_matches_bruteforce():
    engines = _engines(1 << 13)  # several windows
    lk, lb, rk, rv, n_keys = _two_tables(engines)
    got, decision = _run(engines, JOIN_AGG, "b")
    assert decision.strategy == "fused"
    want = _expected(lk, lb, rk, rv, n_keys)
    assert got["b"].tolist() == sorted(want)
    for i, b in enumerate(got["b"].tolist()):
        assert (got["n"][i], got["s"][i], got["mn"][i], got["mx"][i],
                got["bmax"][i]) == want[b]


def _plan(q, engines):
    eng = engines[1]
    state = CompilerState(
        schemas={n: eng.tables[n].relation for n in ("L", "R")},
        registry=default_registry(),
    )
    return compile_pxl(q, state).plan


def test_rewrite_applied_and_guarded():
    """The port's planner rewrites to a partial aggregate below an N:1
    join; an already grouped build side is left alone."""
    engines = _engines(1 << 12)
    _two_tables(engines, n=100)
    plan = _plan(JOIN_AGG, engines)
    aggs = [n.op for n in plan.nodes.values() if isinstance(n.op, AggOp)]
    assert any(ae.out_name == "__paj_cnt" for a in aggs for ae in a.aggs)
    join = next(n for n in plan.nodes.values() if isinstance(n.op, JoinOp))
    partial = plan.nodes[join.inputs[1]]
    assert isinstance(partial.op, AggOp) and partial.op.group_cols == ("k",)
    plan2 = _plan(PRE_GROUPED, engines)
    aggs2 = [n.op for n in plan2.nodes.values() if isinstance(n.op, AggOp)]
    assert not any(ae.out_name.startswith("__paj_")
                   for a in aggs2 for ae in a.aggs)


PRE_GROUPED = """
import px
r = px.DataFrame(table='R')
ra = r.groupby('k').agg(cnt=('v', px.count))
l = px.DataFrame(table='L')
g = l.merge(ra, how='inner', left_on=['k'], right_on=['k'], suffixes=['', '_r'])
out = g.groupby('b').agg(n=('cnt', px.sum))
px.display(out)
"""


def test_pre_grouped_build_side_fuses():
    engines = _engines(1 << 12)
    lk, lb, rk, _rv, _n = _two_tables(engines, n=8_000, n_keys=500)
    got, decision = _run(engines, PRE_GROUPED, "b")
    assert decision.strategy == "fused"
    cnt = collections.Counter(rk.tolist())
    want = collections.Counter()
    for k, b in zip(lk.tolist(), lb.tolist()):
        want[b] += cnt.get(k, 0)
    assert dict(zip(got["b"].tolist(), got["n"].tolist())) == {
        b: v for b, v in want.items() if v}


def test_string_key_join():
    """A join on a STRING key against a small dimension table: the
    rewrite aggregates the dimension by service, and the probe gathers
    from that aggregate's planes."""
    engines = _engines(1 << 12)
    n = 10_000
    rng = np.random.default_rng(9)
    svc = [f"svc-{i}" for i in range(11)]
    codes = rng.integers(0, 11, n).astype(np.int32)
    _append(engines, "http", [("time_", "TIME64NS"), ("service", "STRING"),
                              ("latency", "INT64")],
            {"time_": np.arange(n, dtype=np.int64), "service": codes,
             "latency": rng.integers(1, 500, n)}, {"service": svc})
    _append(engines, "dim", [("time_", "TIME64NS"), ("service", "STRING"),
                             ("weight", "INT64")],
            {"time_": np.zeros(11, dtype=np.int64),
             "service": np.arange(11, dtype=np.int32),
             "weight": (np.arange(11, dtype=np.int64) + 1) * 10},
            {"service": svc})
    q = """
import px
h = px.DataFrame(table='http')
d = px.DataFrame(table='dim')
g = h.merge(d, how='inner', left_on=['service'], right_on=['service'],
            suffixes=['', '_d'])
out = g.groupby('service').agg(n=('latency', px.count), w=('weight', px.max))
px.display(out)
"""
    got, _decision = _run(engines, q, "service")
    for s, cnt, w in zip(got["service"], got["n"], got["w"]):
        assert cnt == int((codes == s).sum()) and w == (s + 1) * 10


def test_dense_int_groupby_negative_and_offset_domain():
    engines = _engines(1 << 12)
    n = 30_000
    rng = np.random.default_rng(2)
    k = rng.integers(-1000, 9_000, n)
    v = rng.integers(0, 100, n)
    _append(engines, "t", [("time_", "TIME64NS"), ("k", "INT64"),
                           ("v", "INT64")],
            {"time_": np.arange(n, dtype=np.int64), "k": k, "v": v})
    q = """
import px
df = px.DataFrame(table='t')
out = df.groupby('k').agg(n=('v', px.count), s=('v', px.sum))
px.display(out)
"""
    got, _decision = _run(engines, q, "k", max_output_rows=100_000)
    uk, cnt = np.unique(k, return_counts=True)
    np.testing.assert_array_equal(got["k"], uk)
    np.testing.assert_array_equal(got["n"], cnt)


POST_AGG_MAP = """
import px
r = px.DataFrame(table='R')
ra = r.groupby('k').agg(cnt=('v', px.count))
ra.cnt2 = ra.cnt * 2
l = px.DataFrame(table='L')
g = l.merge(ra, how='inner', left_on=['k'], right_on=['k'], suffixes=['', '_r'])
out = g.groupby('b').agg(n=('cnt2', px.sum))
px.display(out)
"""


def test_dense_agg_build_with_post_agg_map():
    engines = _engines(1 << 13)
    lk, lb, rk, _rv, _n = _two_tables(engines, n=8_000, n_keys=500)
    got, decision = _run(engines, POST_AGG_MAP, "b")
    assert decision.strategy == "fused"
    cnt = collections.Counter(rk.tolist())
    want = collections.Counter()
    for k, b in zip(lk.tolist(), lb.tolist()):
        want[b] += 2 * cnt.get(k, 0)
    assert dict(zip(got["b"].tolist(), got["n"].tolist())) == {
        b: v for b, v in want.items() if v}


@pytest.mark.parametrize("how", ["inner", "left"])
def test_host_table_build(monkeypatch, how):
    """A unique-key build side that is already rows (it feeds two
    consumers, so it is materialized once): the lookup tables are built
    on the host and put on the device once; a left join keeps unmatched
    probe rows with zeros."""
    engines = _engines(1 << 12)
    lk, lb, rk, _rv, _n = _two_tables(engines, n=6_000, n_keys=300)
    q = f"""
import px
r = px.DataFrame(table='R')
ra = r[r.k < 250].groupby('k').agg(cnt=('v', px.count))
px.display(ra, 'build')
l = px.DataFrame(table='L')
g = l.merge(ra, how='{how}', left_on=['k'], right_on=['k'], suffixes=['', '_r'])
out = g.groupby('b').agg(n=('cnt', px.sum), m=('k', px.count))
px.display(out)
"""
    built = []
    real = joins._host_table_build
    monkeypatch.setattr(joins, "_host_table_build",
                        lambda *a: built.append(real(*a)) or built[-1])
    got, decision = _run(engines, q, "b")
    assert decision.strategy == "fused" and built[0] is not None
    m = lk < 250 if how == "inner" else np.ones(len(lk), bool)
    np.testing.assert_array_equal(got["m"], np.bincount(lb[m], minlength=7))
