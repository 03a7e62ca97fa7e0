"""The port's distributed planner (``pixie_tpu_torch/planner/distributed``)
against the JAX package's.

The cases of ``tests/test_distributed_planner.py`` that plan without
executing: the same logical plan, split, assigned to the same synthetic
agents and stitched, gives the same data and merge fragments, bridges
(id, kind, mesh axes), agent assignment and data tier in both packages,
and ``distributed_bounds`` the same resource report. Every shipped
script is planned the same way too. The port executes no distributed
plan yet.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

import pixie_tpu.analysis.bounds as jax_bounds
import pixie_tpu.exec.plan as jax_plan
import pixie_tpu.planner.distributed as jax_distributed
import pixie_tpu.planner.distributed.coordinator as jax_coordinator
import pixie_tpu.types.dtypes as jax_dtypes
import pixie_tpu.types.relation as jax_relation
import pixie_tpu.udf.registry as jax_registry
from pixie_tpu.config import override_flag as jax_override_flag
from pixie_tpu.ingest.schemas import CANONICAL_SCHEMAS as JAX_SCHEMAS
from pixie_tpu.planner import CompilerState as JaxCompilerState
from pixie_tpu.planner import compile_pxl as jax_compile_pxl
import pixie_tpu_torch.analysis.bounds as bounds
import pixie_tpu_torch.exec.plan as plan
import pixie_tpu_torch.planner.distributed as distributed
import pixie_tpu_torch.planner.distributed.coordinator as coordinator
import pixie_tpu_torch.types.dtypes as dtypes
import pixie_tpu_torch.types.relation as relation
import pixie_tpu_torch.udf.registry as registry
from pixie_tpu_torch.analysis import PlanCheckError
from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch.ingest.schemas import CANONICAL_SCHEMAS
from pixie_tpu_torch.planner import CompilerState, compile_pxl
from pixie_tpu_torch.scripts import list_scripts, load_script

from test_torch_planner import _plan_shape, _report_shape

AGENT_STATUS = "px/agent_status"  # needs the service bus (ROADMAP item 18)


def _pkg(pl, dist, coord, bnd, dt, rel, reg, compile_, state, schemas,
         override):
    return types.SimpleNamespace(
        plan=pl, distributed=dist, coordinator=coord, bounds=bnd,
        DataType=dt.DataType, Relation=rel.Relation, reg=reg,
        compile_pxl=compile_, CompilerState=state, schemas=schemas,
        override_flag=override,
    )


JAX = _pkg(jax_plan, jax_distributed, jax_coordinator, jax_bounds,
           jax_dtypes, jax_relation, jax_registry, jax_compile_pxl,
           JaxCompilerState, JAX_SCHEMAS, jax_override_flag)
PORT = _pkg(plan, distributed, coordinator, bounds, dtypes, relation,
            registry, compile_pxl, CompilerState, CANONICAL_SCHEMAS,
            override_flag)


# -- logical plans ---------------------------------------------------------------

def _filter_agg(pk):
    P = pk.plan
    p = P.Plan()
    src = p.add(P.MemorySourceOp(table="http_events"))
    flt = p.add(P.FilterOp(P.FuncCall("greaterThanEqual", (
        P.ColumnRef("resp_status"), P.Literal(400, pk.DataType.INT64)))), [src])
    agg = p.add(P.AggOp(
        group_cols=("service",),
        aggs=(P.AggExpr("n", "count", (P.ColumnRef("resp_status"),)),),
    ), [flt])
    p.add(P.ResultSinkOp("out"), [agg])
    return p


def _rows_bridge(pk):
    P = pk.plan
    p = P.Plan()
    src = p.add(P.MemorySourceOp(table="t"))
    flt = p.add(P.FilterOp(P.FuncCall("equal", (
        P.ColumnRef("a"), P.Literal(1, pk.DataType.INT64)))), [src])
    p.add(P.ResultSinkOp("out"), [flt])
    return p


def _limit(pk):
    P = pk.plan
    p = P.Plan()
    src = p.add(P.MemorySourceOp(table="t"))
    lim = p.add(P.LimitOp(10), [src])
    p.add(P.ResultSinkOp("out"), [lim])
    return p


def _count_by_k(pk, out="n"):
    P = pk.plan
    return P.AggOp(("k",), (P.AggExpr(out, "count", (P.ColumnRef("k"),)),))


def _join_of_two_aggs(pk):
    P = pk.plan
    p = P.Plan()
    a1 = p.add(_count_by_k(pk), [p.add(P.MemorySourceOp(table="t"))])
    a2 = p.add(_count_by_k(pk, "m"), [p.add(P.MemorySourceOp(table="t"))])
    j = p.add(P.JoinOp(("k",), ("k",)), [a1, a2])
    p.add(P.ResultSinkOp("out"), [j])
    return p


def _map_after_agg(pk):
    P = pk.plan
    p = P.Plan()
    agg = p.add(_count_by_k(pk), [p.add(P.MemorySourceOp(table="t"))])
    m = p.add(P.MapOp(exprs=(("n2", P.ColumnRef("n")),)), [agg])
    p.add(P.ResultSinkOp("out"), [m])
    return p


def _union_agg(pk):
    """A union of two scans feeding an aggregate: pushed down to the data
    agents (``pushdown_union_agg``)."""
    P = pk.plan
    p = P.Plan()
    u = p.add(P.UnionOp(), [p.add(P.MemorySourceOp(table="t")),
                            p.add(P.MemorySourceOp(table="t"))])
    agg = p.add(_count_by_k(pk), [u])
    p.add(P.ResultSinkOp("out"), [agg])
    return p


def _udtf(name):
    def build(pk):
        P = pk.plan
        p = P.Plan()
        p.add(P.ResultSinkOp("out"), [p.add(P.UDTFSourceOp(name=name))])
        return p
    return build


PLANS = {
    "filter_agg": _filter_agg,
    "rows_bridge": _rows_bridge,
    "limit": _limit,
    "join_of_two_aggs": _join_of_two_aggs,
    "map_after_agg": _map_after_agg,
    "union_agg": _union_agg,
    "udtf_all_agents": _udtf("GetTables"),
    "udtf_one_kelvin": _udtf("GetVersion"),
}


# -- cluster states ----------------------------------------------------------------

def _homogeneous(n_pems, n_kelvins):
    return lambda pk: pk.distributed.DistributedState.homogeneous(
        n_pems, n_kelvins)


def _pruned(pk):
    D = pk.distributed
    return D.DistributedState(agents=[
        D.AgentInfo(f"pem-{i}", tables=frozenset(
            {"http_events", "t"} if i < 4 else {"other"}))
        for i in range(8)
    ] + [D.AgentInfo("kelvin-0", processes_data=False,
                     accepts_remote_sources=True)])


def _kelvinless(pk):
    return pk.distributed.DistributedState(
        agents=[pk.distributed.AgentInfo("pem-0")])


STATES = {
    "8x1": _homogeneous(8, 1),
    "8x2": _homogeneous(8, 2),
    "pruned": _pruned,
    "kelvinless": _kelvinless,
}


class _Mesh:
    """A stand-in for a device mesh: what ``stitch`` reads of one."""

    def __init__(self, agents, kelvin):
        self.axis_names = ("agents", "kelvin")
        self.devices = np.empty((agents, kelvin), dtype=object)


def _dplan_shape(d):
    s = d.split
    return {
        "data": _plan_shape(s.before_blocking),
        "merge": _plan_shape(s.after_blocking),
        "bridges": [(b.bridge_id, b.kind, b.axes) for b in s.bridges],
        "data_tier": s.data_tier,
        "clusters": [(c.agent_ids, _plan_shape(c.plan)) for c in d.clusters],
        "data_agents": d.data_agent_ids,
        "kelvins": d.kelvin_agent_ids,
        "pruned": d.pruned_agent_ids,
        "n_data_shards": d.n_data_shards,
    }


def _planned(pk, plan_name, state_name, mesh=None):
    planner = pk.distributed.DistributedPlanner(pk.reg.default_registry())
    return planner.plan(PLANS[plan_name](pk), STATES[state_name](pk),
                        mesh=mesh)


@pytest.mark.parametrize("state_name", sorted(STATES))
@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_plan_matches_jax(plan_name, state_name):
    got = _dplan_shape(_planned(PORT, plan_name, state_name))
    ref = _dplan_shape(_planned(JAX, plan_name, state_name))
    assert got == ref


def test_splitter_halves_an_aggregate():
    """tests/test_distributed_planner.py's TestSplitter, on the port."""
    d = _planned(PORT, "filter_agg", "8x1")
    s = d.split
    assert [op for _n, _i, (op, *_f) in _plan_shape(s.before_blocking)] == [
        "MemorySourceOp", "FilterOp", "AggOp", "BridgeSinkOp"]
    assert [op for _n, _i, (op, *_f) in _plan_shape(s.after_blocking)] == [
        "BridgeSourceOp", "AggOp", "ResultSinkOp"]
    modes = {n.op.mode for p in (s.before_blocking, s.after_blocking)
             for n in p.nodes.values() if isinstance(n.op, plan.AggOp)}
    assert modes == {"partial", "finalize"}
    assert [b.kind for b in s.bridges] == [distributed.splitter.AGG_STATE_MERGE]
    assert all(b.axes == ("agents",) for b in s.bridges)
    assert d.n_data_shards == 8 and len(d.clusters) == 1
    assert _planned(PORT, "udtf_all_agents", "8x1").split.data_tier == (
        "all_agents")


@pytest.mark.parametrize("flag", [True, False])
def test_union_pushdown_flag_matches_jax(flag):
    with override_flag("pushdown_union_agg", flag), \
            jax_override_flag("pushdown_union_agg", flag):
        got = _dplan_shape(_planned(PORT, "union_agg", "8x1"))
        ref = _dplan_shape(_planned(JAX, "union_agg", "8x1"))
    assert got == ref
    kinds = {b[1] for b in got["bridges"]}
    assert kinds == ({"agg_state_merge"} if flag else {"row_gather"})


def test_coordinator_prunes_agents_without_the_table():
    d = _planned(PORT, "filter_agg", "pruned")
    assert d.data_agent_ids == tuple(f"pem-{i}" for i in range(4))
    assert d.pruned_agent_ids == tuple(f"pem-{i}" for i in range(4, 8))
    assert d.kelvin_agent_ids == ("kelvin-0",)
    assert _planned(PORT, "filter_agg", "kelvinless").kelvin_agent_ids == (
        "pem-0",)
    assert coordinator.prune_unavailable_sources(
        _filter_agg(PORT), distributed.AgentInfo(
            "x", tables=frozenset({"other"}))) == (False, {"http_events"})


def test_no_agent_has_the_table_raises_like_jax():
    msgs = []
    for pk in (PORT, JAX):
        state = pk.distributed.DistributedState(agents=[
            pk.distributed.AgentInfo("pem-0", tables=frozenset({"other"}))])
        with pytest.raises(pk.coordinator.PlanningError) as ei:
            pk.distributed.DistributedPlanner().plan(_filter_agg(pk), state)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] == "no live agent can serve ['http_events']"


@pytest.mark.parametrize("agents,kelvin", [(4, 1), (4, 2), (8, 1)])
def test_stitch_reads_the_mesh_like_jax(agents, kelvin):
    """A known mesh is authoritative: the kelvin axis joins the bridges'
    axes only where the mesh has more than one kelvin."""
    got = _planned(PORT, "join_of_two_aggs", "8x2", mesh=_Mesh(agents, kelvin))
    ref = _planned(JAX, "join_of_two_aggs", "8x2", mesh=_Mesh(agents, kelvin))
    assert _dplan_shape(got) == _dplan_shape(ref)
    want = ("agents", "kelvin") if kelvin > 1 else ("agents",)
    assert all(b.axes == want for b in got.split.bridges)


def test_broken_split_fails_the_always_on_check():
    """DistributedPlanner.plan runs check_distributed_plan: a splitter
    that leaves a full aggregate in the data fragment is refused."""
    class BadSplitter(distributed.Splitter):
        def split(self, p):
            s = super().split(p)
            for n in s.before_blocking.nodes.values():
                if isinstance(n.op, plan.AggOp):
                    n.op = plan.AggOp(n.op.group_cols, n.op.aggs, mode="full")
            return s

    planner = distributed.DistributedPlanner(registry.default_registry())
    planner.splitter = BadSplitter(planner.splitter.registry)
    with pytest.raises(PlanCheckError, match="fragment-invariant"):
        planner.plan(_filter_agg(PORT), STATES["8x1"](PORT))


# -- distributed_bounds --------------------------------------------------------------

def _stats():
    return {
        "http_events": {
            "rows": 40_000,
            "ndv": {"service": 12, "req_path": 300, "resp_status": 5},
            "zones": {"resp_status": (200, 500)},
        },
        "conn_stats": {
            "rows": 9_000,
            "ndv": {"remote_addr": 70, "remote_port": 900},
            "zones": {"remote_port": (1024, 65535)},
        },
        "process_stats": {"rows": 5_000, "ndv": {"pod": 40}, "zones": {}},
    }


def _planned_script(pk, name, n_pems, n_kelvins, stats):
    pxl = load_script(name).pxl
    reg = pk.reg.default_registry()
    schemas = dict(pk.schemas)
    compiled = pk.compile_pxl(pxl, pk.CompilerState(
        schemas=schemas, registry=reg, now_ns=10**18,
        table_stats=dict(stats)))
    dplan = pk.distributed.DistributedPlanner(reg).plan(
        compiled.plan,
        pk.distributed.DistributedState.homogeneous(n_pems, n_kelvins),
        schemas=schemas, table_stats=stats)
    return compiled, dplan


SCRIPTS = [n for n in list_scripts() if n != AGENT_STATUS]


@pytest.mark.parametrize("name", SCRIPTS)
def test_shipped_script_plans_and_bounds_like_jax(name):
    """Each shipped script, compiled with a sketch snapshot, split over 3
    data agents and 1 kelvin: the same fragments, bridges and agents,
    and the same data, merge and wire bounds and merged cost."""
    stats = _stats()
    results = []
    for pk in (PORT, JAX):
        try:
            compiled, d = _planned_script(pk, name, 3, 1, stats)
        except Exception as e:  # noqa: BLE001 - compared across packages
            results.append(("raises", type(e).__name__, str(e)))
            continue
        rep = d.resource_report
        results.append((
            _dplan_shape(d),
            _report_shape(rep["data"]), _report_shape(rep["merge"]),
            rep["wire_bytes_hi"],
            pk.bounds.merged_cost(compiled.plan.resource_report, rep),
        ))
    assert results[0] == results[1]


def test_distributed_bounds_seed_the_merge_fragment():
    """tests/test_bounds.py's bridge case on the port: the wire bound
    covers 3 agents' payloads, and the merge side's bridge source is
    seeded with 3 x the data side's bound."""
    stats = _stats()
    q = ("import px\ndf = px.DataFrame(table='http_events')\n"
         "px.display(df.groupby('service').agg(n=('latency_ns', px.count)))\n")
    got = []
    for pk in (PORT, JAX):
        reg = pk.reg.default_registry()
        compiled = pk.compile_pxl(q, pk.CompilerState(
            schemas=dict(pk.schemas), registry=reg, now_ns=1,
            table_stats=stats))
        d = pk.distributed.DistributedPlanner(reg).plan(
            compiled.plan, pk.distributed.DistributedState.homogeneous(3, 1),
            schemas=dict(pk.schemas), table_stats=stats)
        rep = d.resource_report
        assert set(rep) == {"data", "merge", "wire_bytes_hi"}
        assert rep["wire_bytes_hi"] is not None and rep["wire_bytes_hi"] > 0
        assert rep["merge"].rows_out_hi is not None
        sink = next(n for n in d.split.before_blocking.nodes.values()
                    if isinstance(n.op, pk.plan.BridgeSinkOp))
        src = next(n for n in d.split.after_blocking.nodes.values()
                   if isinstance(n.op, pk.plan.BridgeSourceOp))
        assert rep["merge"].nodes[src.id].rows.hi == 3 * rep[
            "data"].nodes[sink.id].rows.hi
        assert d.split.before_blocking.resource_report is rep["data"]
        cost = pk.bounds.merged_cost(compiled.plan.resource_report, rep)
        assert cost["wire_bytes_hi"] == rep["wire_bytes_hi"]
        got.append((_report_shape(rep["data"]), _report_shape(rep["merge"]),
                    rep["wire_bytes_hi"], cost))
    assert got[0] == got[1]


def test_merged_cost_unknown_wire_stays_none():
    for pk in (PORT, JAX):
        compiled = pk.compile_pxl(
            "import px\npx.display(px.DataFrame(table='http_events'))\n",
            pk.CompilerState(schemas=dict(pk.schemas),
                             registry=pk.reg.default_registry(), now_ns=1,
                             table_stats=_stats()))
        assert compiled.plan.resource_report.wire_bytes_hi == 0
        cost = pk.bounds.merged_cost(
            compiled.plan.resource_report,
            {"data": None, "merge": None, "wire_bytes_hi": None})
        assert cost["wire_bytes_hi"] is None
        assert pk.bounds.merged_cost(None, None) is None
