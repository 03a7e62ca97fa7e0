"""The port's plan verifier (``pixie_tpu_torch/analysis/verifier.py``)
against the JAX package's.

Each golden case of ``tests/test_verifier.py`` builds the same plan in
both packages and must give the same diagnostics: code, severity, node
id, operator, plan name and message. Every shipped script compiles and
verifies clean on the port's registry, and every builtin UDA of the
port passes the segmented-UDA protocol check, whose ``init`` takes
``(num_groups, device)`` in the port (two arguments) where the JAX
package's takes one.
"""

from __future__ import annotations

import types

import pytest

import pixie_tpu.analysis as jax_analysis
import pixie_tpu.exec.plan as jax_plan
import pixie_tpu.planner.distributed as jax_distributed
import pixie_tpu.planner.distributed.splitter as jax_splitter
import pixie_tpu.types.dtypes as jax_dtypes
import pixie_tpu.types.relation as jax_relation
import pixie_tpu.udf.registry as jax_registry
from pixie_tpu.ingest.schemas import CANONICAL_SCHEMAS as JAX_SCHEMAS
from pixie_tpu.planner import CompilerState as JaxCompilerState
from pixie_tpu.planner import compile_pxl as jax_compile_pxl
import pixie_tpu_torch.analysis as analysis
import pixie_tpu_torch.analysis.verifier as verifier
import pixie_tpu_torch.exec.plan as plan
import pixie_tpu_torch.planner.distributed as distributed
import pixie_tpu_torch.planner.distributed.splitter as splitter
import pixie_tpu_torch.types.dtypes as dtypes
import pixie_tpu_torch.types.relation as relation
import pixie_tpu_torch.udf.registry as registry
from pixie_tpu_torch.ingest.schemas import CANONICAL_SCHEMAS
from pixie_tpu_torch.planner import CompilerState, PxLError, compile_pxl
from pixie_tpu_torch.scripts import list_scripts, load_script

AGENT_STATUS = "px/agent_status"  # needs the service bus (ROADMAP item 18)


def _pkg(an, pl, dist, spl, dt, rel, reg):
    return types.SimpleNamespace(
        analysis=an, plan=pl, distributed=dist, splitter=spl,
        DataType=dt.DataType, Relation=rel.Relation, reg=reg,
    )


JAX = _pkg(jax_analysis, jax_plan, jax_distributed, jax_splitter,
           jax_dtypes, jax_relation, jax_registry)
PORT = _pkg(analysis, plan, distributed, splitter, dtypes, relation,
            registry)


def _schemas(pk):
    D = pk.DataType
    return {"t": pk.Relation([
        ("time_", D.TIME64NS), ("a", D.INT64), ("s", D.STRING),
    ])}


def _chain(pk, *ops):
    """Linear plan source -> ops... -> result sink."""
    p = pk.plan.Plan()
    nid = p.add(pk.plan.MemorySourceOp(table="t"))
    for op in ops:
        nid = p.add(op, [nid])
    p.add(pk.plan.ResultSinkOp(name="out"), [nid])
    return p


def _verify(pk, p, reg=None):
    return pk.analysis.verify_plan(p, _schemas(pk),
                                   reg or pk.reg.default_registry())


def _bad_uda_registry(pk):
    """A UDA whose update lacks its (mask, arg) parameters; its init has
    each package's own arity, so only update is flagged."""
    reg = pk.reg.default_registry().clone("test")
    init = (lambda g: None) if pk is JAX else (lambda g, device: None)
    reg.uda(
        "badsum", [pk.DataType.INT64], pk.DataType.INT64,
        init=init,
        update=lambda carry, gids: carry,
        merge=lambda a, b: a,
        finalize=lambda c: c,
    )
    return reg


def _agg_dplan(pk):
    P = pk.plan
    p = _chain(pk, P.AggOp(
        group_cols=("a",),
        aggs=(P.AggExpr("n", "count", (P.ColumnRef("a"),)),),
    ))
    state = pk.distributed.DistributedState.homogeneous(2, 1)
    return pk.distributed.DistributedPlanner(
        pk.reg.default_registry()).plan(p, state)


# -- the golden cases: each returns its diagnostics ----------------------------

def _unbound_column(pk):
    P = pk.plan
    return _verify(pk, _chain(pk, P.MapOp(exprs=(("x", P.ColumnRef("nope")),))))


def _udf_dtype_mismatch(pk):
    P = pk.plan
    return _verify(pk, _chain(pk, P.FilterOp(predicate=P.FuncCall("add", (
        P.ColumnRef("s"), P.Literal(1, pk.DataType.INT64),
    )))))


def _bad_uda_arity(pk):
    P = pk.plan
    p = _chain(pk, P.AggOp(
        group_cols=("a",),
        aggs=(P.AggExpr("x", "badsum", (P.ColumnRef("a"),)),),
    ))
    return _verify(pk, p, _bad_uda_registry(pk))


def _dangling_output(pk):
    P = pk.plan
    p = P.Plan()
    src = p.add(P.MemorySourceOp(table="t"))
    p.add(P.MapOp(exprs=(("a", P.ColumnRef("a")),)), [src])
    return _verify(pk, p)


def _dispatch_set_mismatch(pk):
    dplan = _agg_dplan(pk)
    v = pk.analysis.verify_dispatch_sets
    return (
        v(dplan, merge_expected=["pem-0", "pem-1"], dispatched=["pem-0"],
          merge_agent="kelvin-0")
        + v(dplan, merge_expected=["pem-0"], dispatched=["pem-0", "pem-1"],
            merge_agent="kelvin-0")
        + v(dplan, merge_expected=["pem-0", "pem-1"],
            dispatched=["pem-0", "pem-1"], merge_agent="pem-0")
    )


def _dangling_input(pk):
    P = pk.plan
    p = P.Plan()
    src = p.add(P.MemorySourceOp(table="t"))
    m = p.add(P.MapOp(exprs=(("a", P.ColumnRef("a")),)), [src])
    p.add(P.ResultSinkOp(name="out"), [m])
    p.nodes[m].inputs.append(99)  # a node that does not exist
    return _verify(pk, p)


def _cycle(pk):
    P = pk.plan
    p = P.Plan()
    a = p.add(P.MemorySourceOp(table="t"))
    b = p.add(P.FilterOp(predicate=P.ColumnRef("a")), [a])
    c = p.add(P.MapOp(exprs=(("a", P.ColumnRef("a")),)), [b])
    p.nodes[b].inputs.append(c)  # b <-> c
    p.add(P.ResultSinkOp(name="out"), [c])
    return _verify(pk, p)


def _filter_not_boolean(pk):
    P = pk.plan
    return _verify(pk, _chain(pk, P.FilterOp(predicate=P.ColumnRef("a"))))


def _bad_arity(pk):
    P = pk.plan
    p = P.Plan()
    p.add(P.BridgeSinkOp(bridge_id=0), [])  # a sink with no input
    return _verify(pk, p)


def _unknown_table(pk):
    P = pk.plan
    p = P.Plan()
    src = p.add(P.MemorySourceOp(table="missing"))
    p.add(P.ResultSinkOp(name="out"), [src])
    return _verify(pk, p)


def _unknown_udtf(pk):
    P = pk.plan
    p = P.Plan()
    src = p.add(P.UDTFSourceOp(name="NotAUDTF"))
    p.add(P.ResultSinkOp(name="out"), [src])
    return _verify(pk, p, pk.reg.Registry("empty"))


def _distributed_clean(pk):
    return pk.analysis.verify_distributed_plan(
        _agg_dplan(pk), _schemas(pk), pk.reg.default_registry())


def _distributed_dangling_bridge(pk):
    dplan = _agg_dplan(pk)
    after = dplan.split.after_blocking
    src = next(nid for nid, n in after.nodes.items()
               if isinstance(n.op, pk.plan.BridgeSourceOp))
    del after.nodes[src]  # the bridge sink now ships into the void
    return pk.analysis.verify_distributed_plan(dplan)


def _distributed_blocking_in_data(pk):
    dplan = _agg_dplan(pk)
    before = dplan.split.before_blocking
    nid = next(nid for nid, n in before.nodes.items()
               if isinstance(n.op, pk.plan.AggOp))
    op = before.nodes[nid].op
    before.nodes[nid].op = pk.plan.AggOp(
        group_cols=op.group_cols, aggs=op.aggs, mode="full")
    return pk.analysis.verify_distributed_plan(dplan)


def _distributed_row_bridge_to_finalize(pk):
    dplan = _agg_dplan(pk)
    for b in dplan.split.bridges:
        b.kind = pk.splitter.ROW_GATHER
    return pk.analysis.verify_distributed_plan(dplan)


def _distributed_agg_bridge_to_rows(pk):
    dplan = _agg_dplan(pk)
    after = dplan.split.after_blocking
    for n in after.nodes.values():
        if isinstance(n.op, pk.plan.AggOp):
            n.op = pk.plan.AggOp(group_cols=n.op.group_cols,
                                 aggs=n.op.aggs, mode="full")
    return pk.analysis.verify_distributed_plan(
        dplan, _schemas(pk), pk.reg.default_registry())


# name -> (case, the codes it must find, in order)
GOLDEN = {
    "unbound_column": (_unbound_column, ["unbound-column"]),
    "udf_dtype_mismatch": (_udf_dtype_mismatch, ["udf-signature"]),
    "bad_uda_arity": (_bad_uda_arity, ["uda-arity"]),
    "dangling_output": (_dangling_output, ["dangling-output"]),
    "dispatch_set_mismatch": (_dispatch_set_mismatch,
                              ["dispatch-set-mismatch"] * 4),
    "dangling_input": (_dangling_input, ["dangling-input"]),
    "cycle": (_cycle, None),
    "filter_not_boolean": (_filter_not_boolean, ["dtype-mismatch"]),
    "bad_arity": (_bad_arity, ["bad-arity"]),
    "unknown_table": (_unknown_table, ["unknown-table"]),
    "unknown_udtf": (_unknown_udtf, ["unknown-udtf"]),
    "distributed_clean": (_distributed_clean, []),
    "distributed_dangling_bridge": (_distributed_dangling_bridge, None),
    "distributed_blocking_in_data": (_distributed_blocking_in_data, None),
    "distributed_row_bridge_to_finalize": (
        _distributed_row_bridge_to_finalize, ["bridge-kind"]),
    "distributed_agg_bridge_to_rows": (
        _distributed_agg_bridge_to_rows, None),
}


def _canon(diags):
    return [(d.code, d.severity.value, d.node, d.op, d.plan, d.message,
             d.render()) for d in diags]


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_diagnostics_match_jax(case):
    fn, codes = GOLDEN[case]
    got, ref = fn(PORT), fn(JAX)
    assert _canon(got) == _canon(ref)
    if codes is not None:
        assert [d.code for d in got] == codes
    else:
        assert got, "the malformed plan verified clean"


def test_golden_renders():
    """Two of tests/test_verifier.py's golden strings, on the port."""
    (d,) = _unbound_column(PORT)
    assert d.render() == (
        "unbound-column: column 'nope' is not in the input relation "
        "Relation[time_:TIME64NS, a:INT64, s:STRING] "
        "[node 1: MapOp in logical plan]"
    )
    (d,) = _bad_uda_arity(PORT)
    assert d.render() == (
        "uda-arity: UDA 'badsum' update must accept 4 positional "
        "argument(s) (update of a segmented UDA over 1 arg column(s)) "
        "[node 1: AggOp in logical plan]"
    )


def test_uda_init_arity_is_the_ports():
    """A UDA written to the JAX package's protocol (``init(G)``) is a bad
    UDA in the port, whose init makes its carry on a device."""
    reg = PORT.reg.default_registry().clone("test")
    reg.uda("jaxsum", [PORT.DataType.INT64], PORT.DataType.INT64,
            init=lambda g: None,
            update=lambda carry, gids, mask, x: carry,
            merge=lambda a, b: a, finalize=lambda c: c)
    P = PORT.plan
    p = _chain(PORT, P.AggOp(
        group_cols=("a",),
        aggs=(P.AggExpr("x", "jaxsum", (P.ColumnRef("a"),)),),
    ))
    (d,) = _verify(PORT, p, reg)
    assert d.code == "uda-arity"
    assert d.message == (
        "UDA 'jaxsum' init must accept 2 positional argument(s) (init of "
        "a segmented UDA over 1 arg column(s))"
    )


def test_check_plan_raises_plancheckerror_a_pxlerror():
    P = PORT.plan
    p = _chain(PORT, P.MapOp(exprs=(("x", P.ColumnRef("nope")),)))
    with pytest.raises(analysis.PlanCheckError) as ei:
        analysis.check_plan(p, _schemas(PORT), registry.default_registry())
    assert isinstance(ei.value, PxLError)
    assert ei.value.diagnostics[0].node == 1
    assert "unbound-column" in str(ei.value)


@pytest.mark.parametrize("body", [
    # Caught by the frontend in both packages (PxLError).
    "df = df.groupby('a').agg(n=('a', px.count))\ndf = df[df.nope > 1]",
    # Passes the frontend; the verifier refuses it (PlanCheckError).
    "df.x = px.pluck(df.s, df.s)",
])
def test_bad_script_fails_at_compile_like_jax(body):
    q = f"import px\ndf = px.DataFrame(table='t')\n{body}\npx.display(df)\n"
    with pytest.raises(Exception) as ref:
        jax_compile_pxl(q, JaxCompilerState(
            schemas=_schemas(JAX), registry=jax_registry.default_registry(),
            now_ns=1))
    with pytest.raises(PxLError) as got:
        compile_pxl(q, CompilerState(
            schemas=_schemas(PORT), registry=registry.default_registry(),
            now_ns=1))
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)
    if isinstance(got.value, analysis.PlanCheckError):
        assert _canon(got.value.diagnostics) == _canon(ref.value.diagnostics)


SCRIPTS = [n for n in list_scripts() if n != AGENT_STATUS]


@pytest.mark.parametrize("name", SCRIPTS)
def test_shipped_script_verifies_clean(name):
    pxl = load_script(name).pxl
    reg = registry.default_registry()
    state = CompilerState(schemas=dict(CANONICAL_SCHEMAS), registry=reg,
                          now_ns=10**18)
    compiled = compile_pxl(pxl, state)  # check_script_plan runs inside
    got = analysis.verify_plan(compiled.plan, state.schemas, reg)
    jax_state = JaxCompilerState(
        schemas=dict(JAX_SCHEMAS), registry=jax_registry.default_registry(),
        now_ns=10**18)
    ref = jax_analysis.verify_plan(
        jax_compile_pxl(pxl, jax_state).plan, jax_state.schemas,
        jax_state.registry)
    assert _canon(got) == _canon(ref)
    assert not [d for d in got if d.severity == analysis.Severity.ERROR]


def test_every_shipped_script_is_covered():
    assert len(SCRIPTS) == 80 and AGENT_STATUS in list_scripts()


def _uda_overloads():
    reg = registry.default_registry()
    return [(n, i) for n in reg.uda_names()
            for i in range(len(reg.uda_overloads(n)))]


@pytest.mark.parametrize("name,i", _uda_overloads())
def test_builtin_uda_passes_protocol_check(name, i):
    uda = registry.default_registry().uda_overloads(name)[i]
    assert verifier._uda_protocol_errors(uda) == ()


def test_builtin_udas_are_the_jax_packages():
    assert sorted(registry.default_registry().uda_names()) == sorted(
        jax_registry.default_registry().uda_names())
