"""The port's resource-bound pass (``pixie_tpu_torch/analysis/bounds.py``)
against the JAX package's.

Both engines hold ``tests/test_scripts.py`` ``_seed_all_tables``' rows
with ingest sketches on. Their sketch snapshots
(``Engine._compile_table_stats``) are equal, and every shipped script
compiled against them gets the same ``PlanResourceReport`` (row, byte
and peak bounds, group and join-capacity bounds, diagnostics) and the
same presized ``AggOp.max_groups`` in both packages. Presizing only
grows, the flag turned off leaves the plan as it was, the compile-time
budgets reject with the JAX package's diagnostic, and the memos hit on
a repeat compile. At the engine level, an aggregate over a sketched key
with several thousand distinct values and no dense domain rebuckets as
the JAX engine does, with presizing on and off, and a join against its
own aggregate takes the JAX engine's planned capacity.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import pixie_tpu.analysis.bounds as jax_bounds
import pixie_tpu.types.dtypes as jax_dtypes
import pixie_tpu.types.relation as jax_relation
import pixie_tpu.udf.registry as jax_registry
from pixie_tpu.analysis import PlanCheckError as JaxPlanCheckError
from pixie_tpu.config import override_flag as jax_override_flag
from pixie_tpu.exec import Engine as JaxEngine
from pixie_tpu.ingest.schemas import init_schemas as jax_init_schemas
from pixie_tpu.planner import CompilerState as JaxCompilerState
from pixie_tpu.planner import compile_pxl as jax_compile_pxl
import pixie_tpu_torch.analysis.bounds as bounds
import pixie_tpu_torch.analysis.verifier as verifier
import pixie_tpu_torch.exec.plan as plan
import pixie_tpu_torch.types.dtypes as dtypes
import pixie_tpu_torch.types.relation as relation
import pixie_tpu_torch.udf.registry as registry
from pixie_tpu_torch import Engine
from pixie_tpu_torch.analysis import PlanCheckError
from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch.ingest.schemas import init_schemas
from pixie_tpu_torch.planner import CompilerState, PxLError, compile_pxl
from pixie_tpu_torch.scripts import list_scripts, load_script

from test_scripts import _seed_all_tables
from test_torch_planner import _plan_shape, _report_shape

WINDOW = 1 << 11
AGENT_STATUS = "px/agent_status"  # needs the service bus (ROADMAP item 18)


def _pkg(dt, rel, reg, compile_, state, override, error):
    return types.SimpleNamespace(
        DataType=dt.DataType, Relation=rel.Relation, reg=reg,
        compile_pxl=compile_, CompilerState=state, override_flag=override,
        PlanCheckError=error,
    )


JAX = _pkg(jax_dtypes, jax_relation, jax_registry, jax_compile_pxl,
           JaxCompilerState, jax_override_flag, JaxPlanCheckError)
PORT = _pkg(dtypes, relation, registry, compile_pxl, CompilerState,
            override_flag, PlanCheckError)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    jax_eng = JaxEngine(window_rows=WINDOW)
    jax_init_schemas(jax_eng)
    _seed_all_tables(jax_eng)
    eng = Engine(window_rows=WINDOW, device="cpu")
    init_schemas(eng)
    _seed_all_tables(eng)
    return jax_eng, eng


def _compile_on(pk, eng, pxl, **kw):
    return pk.compile_pxl(pxl, pk.CompilerState(
        schemas={n: t.relation for n, t in eng.tables.items()},
        registry=eng.registry, now_ns=10**18, max_output_rows=10_000,
        table_stats=eng._compile_table_stats(), **kw))


def test_table_stats_snapshot_matches_jax(engines):
    jax_eng, eng = engines
    got, ref = eng._compile_table_stats(), jax_eng._compile_table_stats()
    assert got == ref
    assert len(got) >= 5 and all(
        set(v) == {"rows", "ndv", "zones"} for v in got.values())
    assert got["http_events"]["rows"] == 3000
    assert got["http_events"]["ndv"]["service"] == 4


SCRIPTS = [n for n in list_scripts() if n != AGENT_STATUS]


@pytest.mark.parametrize("name", SCRIPTS)
def test_shipped_script_report_matches_jax(name, engines):
    jax_eng, eng = engines
    pxl = load_script(name).pxl
    got = _compile_on(PORT, eng, pxl)
    ref = _compile_on(JAX, jax_eng, pxl)
    assert _report_shape(got.plan.resource_report) == _report_shape(
        ref.plan.resource_report)
    # The presized max_groups is part of each AggOp's fields.
    assert _plan_shape(got.plan) == _plan_shape(ref.plan)


@pytest.mark.parametrize("dt", [d.name for d in dtypes.DataType])
def test_bytes_per_row_match_jax(dt):
    got = bounds._row_bytes(relation.Relation([("c", dtypes.DataType[dt])]))
    ref = jax_bounds._row_bytes(
        jax_relation.Relation([("c", jax_dtypes.DataType[dt])]))
    assert got == ref == {"BOOLEAN": 1, "INT64": 8, "UINT128": 16,
                          "FLOAT64": 8, "STRING": 4, "TIME64NS": 8}[dt]


# -- presize, budgets and memos over a small schema with fixed stats ------------

def _schemas(pk):
    D = pk.DataType
    return {
        "t": pk.Relation([("time_", D.TIME64NS), ("k", D.INT64),
                          ("v", D.INT64), ("svc", D.STRING)]),
        "r": pk.Relation([("time_", D.TIME64NS), ("k", D.INT64),
                          ("w", D.INT64)]),
    }


STATS = {
    "t": {"rows": 10_000, "ndv": {"k": 100, "v": 5_000, "svc": 8},
          "zones": {"k": (0, 99), "v": (0, 9_999)}},
    "r": {"rows": 2_000, "ndv": {"k": 100, "w": 1_000},
          "zones": {"k": (0, 99), "w": (0, 999)}},
}
BIG_NDV = {"t": {"rows": 500_000, "ndv": {"v": 100_000, "svc": 8},
                 "zones": {}}}


def _query(col):
    return (f"import px\ndf = px.DataFrame(table='t')\n"
            f"px.display(df.groupby('{col}').agg(n=('k', px.count)))\n")


JOIN_QUERY = """import px
l = px.DataFrame(table='t')
r = px.DataFrame(table='r')
g = l.merge(r, how='inner', left_on=['k'], right_on=['k'],
            suffixes=['', '_r'])
px.display(g.groupby(['svc', 'w']).agg(n=('v', px.count)))
"""


def _compile(pk, query, stats, **kw):
    return pk.compile_pxl(query, pk.CompilerState(
        schemas=_schemas(pk), registry=pk.reg.default_registry(), now_ns=1,
        table_stats=dict(stats), **kw))


def _max_groups(compiled):
    """Each AggOp's max_groups, in either package's plan."""
    return [n.op.max_groups for n in compiled.plan.nodes.values()
            if type(n.op).__name__ == "AggOp"]


PRESIZE = {
    # query, stats, the presized max_groups with the flag on
    "grows_to_ndv": (_query("v"), BIG_NDV, [131072]),
    "never_shrinks": (_query("svc"), STATS, [4096]),
    "sketchless": (_query("v"), {}, [4096]),
    "join_then_agg": (JOIN_QUERY, STATS, [4096]),
}


@pytest.mark.parametrize("presize", [True, False])
@pytest.mark.parametrize("case", sorted(PRESIZE))
def test_presize_matches_jax(case, presize):
    query, stats, want = PRESIZE[case]
    with override_flag("bounds_presize", presize), \
            jax_override_flag("bounds_presize", presize):
        got = _compile(PORT, query, stats)
        ref = _compile(JAX, query, stats)
    assert _plan_shape(got.plan) == _plan_shape(ref.plan)
    assert _report_shape(got.plan.resource_report) == _report_shape(
        ref.plan.resource_report)
    assert _max_groups(got) == (want if presize else [4096] * len(want))


def test_presize_clamps_to_the_limit():
    with override_flag("max_groups_limit", 1 << 15), \
            jax_override_flag("max_groups_limit", 1 << 15):
        got = _compile(PORT, _query("v"), BIG_NDV)
        ref = _compile(JAX, _query("v"), BIG_NDV)
    assert _max_groups(got) == _max_groups(ref) == [1 << 15]


BUDGETS = {
    "query": ("bounds_query_budget_mb", 0.001),
    "device": ("bounds_device_budget_mb", 0.0001),
}


@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_budget_rejects_at_compile_like_jax(budget):
    flag, value = BUDGETS[budget]
    diags = []
    for pk in (PORT, JAX):
        with pk.override_flag(flag, value):
            with pytest.raises(pk.PlanCheckError) as ei:
                _compile(pk, _query("svc"), STATS)
        diags.append([(d.code, d.severity.value, d.node, d.op, d.plan,
                       d.message) for d in ei.value.diagnostics])
    assert diags[0] == diags[1]
    assert {c for c, *_r in diags[0]} == {"resource-bound"}
    assert flag in diags[0][0][5] or budget == "device"


def test_budgets_off_by_default_and_sketchless_never_rejected():
    assert _compile(PORT, _query("svc"), STATS).plan.resource_report \
        .diagnostics == []
    with override_flag("bounds_query_budget_mb", 0.001):
        r = _compile(PORT, _query("svc"), {}).plan.resource_report
    assert r.bytes_staged_hi is None and r.diagnostics == []


def test_memos_hit_on_repeat_compile(monkeypatch):
    q = _query("svc")
    c1 = _compile(PORT, q, STATS)
    calls = []
    real = verifier.check_plan
    monkeypatch.setattr(verifier, "check_plan",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    c2 = _compile(PORT, q, STATS)
    assert calls == []  # the clean verification was memoized
    assert c1.plan.resource_report is c2.plan.resource_report
    # A new stats snapshot misses the bounds memo (new rows, new bounds)
    # but not the verifier's (its key has no stats).
    stats2 = {**STATS, "t": {**STATS["t"], "rows": 20_000}}
    c3 = _compile(PORT, q, stats2)
    assert calls == []
    assert c3.plan.resource_report is not c1.plan.resource_report
    src = next(n.id for n in c3.plan.nodes.values()
               if isinstance(n.op, plan.MemorySourceOp))
    assert c3.plan.resource_report.nodes[src].rows.hi == 20_000
    # max_output_rows shapes the injected limit: a separate entry.
    small = _compile(PORT, "import px\npx.display(px.DataFrame(table='t'))\n",
                     STATS, max_output_rows=5)
    big = _compile(PORT, "import px\npx.display(px.DataFrame(table='t'))\n",
                   STATS, max_output_rows=1 << 62)
    assert small.plan.resource_report is not big.plan.resource_report
    assert small.plan.resource_report.rows_out_hi < \
        big.plan.resource_report.rows_out_hi


# -- the engine ----------------------------------------------------------------------

N_KEYS, N_ROWS, SMALL_WINDOW = 5000, 24_000, 4096
AGG = """import px
df = px.DataFrame(table='k')
px.display(df.groupby('key').agg(n=('value', px.count), mx=('value', px.max)))
"""
# N:1 eager-aggregate shape: the build side is the table's own group-by.
SELF_JOIN = """import px
df = px.DataFrame(table='k')
agg = df.groupby('key').agg(n=('value', px.count))
j = df.merge(agg, how='inner', left_on='key', right_on='key',
             suffixes=['', '_a'])
px.display(j.groupby('key').agg(rows=('value', px.count), n=('n', px.max)))
"""


def _key_table():
    rng = np.random.default_rng(5)
    keys = rng.choice(rng.integers(0, 1 << 40, N_KEYS), N_ROWS)
    return {"time_": np.arange(N_ROWS, dtype=np.int64),
            "key": keys.astype(np.int64),
            "value": rng.integers(0, 1 << 30, N_ROWS).astype(np.int64)}


@pytest.fixture(scope="module")
def key_engines():
    data = _key_table()
    jax_eng = JaxEngine(window_rows=SMALL_WINDOW)
    jax_eng.append_data("k", data)
    eng = Engine(window_rows=SMALL_WINDOW, device="cpu")
    eng.append_data("k", data)
    return jax_eng, eng, data


def _jax_run(jax_eng, query):
    with jax_override_flag("cpu_fold_threads", 1):
        out = jax_eng.execute_query(query, analyze=True)["output"]
    rebuckets = sum("rebucket" in f.ops for f in jax_eng.last_stats.fragments)
    return out.to_pydict(), rebuckets


def _sorted(d, by):
    order = np.lexsort([np.asarray(d[c]) for c in reversed(by)])
    return {c: np.asarray(v)[order] for c, v in d.items()}


@pytest.mark.parametrize("presize", [True, False])
def test_engine_presize_rebuckets_like_jax(key_engines, presize):
    jax_eng, eng, data = key_engines
    with override_flag("bounds_presize", presize), \
            jax_override_flag("bounds_presize", presize):
        ref, jax_rebuckets = _jax_run(jax_eng, AGG)
        got = eng.execute_query(AGG)["output"].to_pydict()
    st = eng.last_stats
    assert st.rebuckets == jax_rebuckets == (0 if presize else 1)
    ref, got = _sorted(ref, ["key"]), _sorted(got, ["key"])
    for c in ref:
        np.testing.assert_array_equal(got[c], ref[c], err_msg=c)
    keys, counts = np.unique(data["key"], return_counts=True)
    np.testing.assert_array_equal(got["key"], keys)
    np.testing.assert_array_equal(got["n"], counts)
    # 5,000 distinct keys (HLL ~3%) x 1.25 -> 8192 slots, or the ladder
    # 4096 -> 8192 from the default.
    rep = eng.last_resource_report
    assert rep is not None and len(rep.agg_groups) == 1
    assert list(rep.agg_groups.values()) == list(
        jax_eng.last_resource_report.agg_groups.values())
    assert st.windows == (N_ROWS // SMALL_WINDOW + 1) * (1 + st.rebuckets)


def test_engine_join_takes_planned_capacity_like_jax(key_engines):
    jax_eng, eng, data = key_engines
    ref, _ = _jax_run(jax_eng, SELF_JOIN)
    got = eng.execute_query(SELF_JOIN)["output"].to_pydict()
    rep, jax_rep = eng.last_resource_report, jax_eng.last_resource_report
    assert rep.join_capacity == jax_rep.join_capacity
    # The N:1 structural bound: each probe row matches at most once.
    assert list(rep.join_capacity.values()) == [N_ROWS]
    ref, got = _sorted(ref, ["key"]), _sorted(got, ["key"])
    for c in ref:
        np.testing.assert_array_equal(got[c], ref[c], err_msg=c)
    keys, counts = np.unique(data["key"], return_counts=True)
    np.testing.assert_array_equal(got["rows"], counts)
    np.testing.assert_array_equal(got["n"], counts)


@pytest.mark.parametrize("body,error", [
    # The frontend binds every column it is given: an unbound column
    # fails there, in both packages, before the verifier runs.
    ("df = df.groupby('key').agg(n=('nope', px.count))", "PxLError"),
    # A host-dict UDF with a column where a literal belongs passes the
    # frontend; the verifier refuses it (udf-signature).
    ("df.x = px.pluck(df.s, df.s)", "PlanCheckError"),
])
def test_bad_script_stages_nothing(body, error):
    eng = Engine(window_rows=SMALL_WINDOW, device="cpu")
    eng.append_data("k", {"time_": np.arange(100), "key": np.arange(100),
                          "s": ['{"a": 1}'] * 100})
    q = f"import px\ndf = px.DataFrame(table='k')\n{body}\npx.display(df)\n"
    with pytest.raises(PxLError) as ei:
        eng.execute_query(q)
    assert type(ei.value).__name__ == error
    assert eng.last_stats is None  # no plan ran: nothing was staged
    # The partial window is staged on demand by the first query to read
    # it; none did.
    assert len(eng.tables["k"]._device_cache) == 0
    eng.execute_query("import px\npx.display(px.DataFrame(table='k'))\n")
    assert len(eng.tables["k"]._device_cache) == 1
