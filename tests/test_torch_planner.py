"""The port's PxL frontend against the JAX package's: the same scripts
compile to the same plan (op classes, fields and edges), without table
stats and with a seeded sketch snapshot, which the bounds pass reads:
the presized ``AggOp.max_groups`` is one of the compared fields, and
the attached ``PlanResourceReport`` is compared too."""

import dataclasses
import enum

import numpy as np
import pytest

from pixie_tpu.ingest import schemas as jax_schemas
from pixie_tpu.planner import CompilerState as JaxCompilerState
from pixie_tpu.planner import compile_pxl as jax_compile_pxl
from pixie_tpu.scripts import load_script as jax_load_script
from pixie_tpu.types.dtypes import DataType as JaxDataType
from pixie_tpu.types.relation import Relation as JaxRelation
from pixie_tpu.udf.registry import default_registry as jax_registry
from pixie_tpu_torch.planner import CompilerState, PxLError, compile_pxl
from pixie_tpu_torch.scripts import load_script
from pixie_tpu_torch.types import DataType, Relation
from pixie_tpu_torch.udf.registry import default_registry

HTTP_EVENTS = [
    ("time_", "TIME64NS"), ("latency_ns", "INT64"), ("resp_status", "INT64"),
    ("service", "STRING"), ("req_path", "STRING"),
]

# The FLOAT64 form of px/http_stats: the query that reaches the dense
# fold kernel (its aggregates read a FLOAT64 column).
HTTP_STATS_F64 = """import px
df = px.DataFrame(table='http_events')
df = df[df.resp_status < 400]
df.latency_ms = df.latency_ns / 1000000.0
df = df.groupby(['service', 'req_path']).agg(
    n=('latency_ms', px.count), lat_mean=('latency_ms', px.mean),
    lat_max=('latency_ms', px.max))
px.display(df)
"""

# The upid-keyed scripts (group-bys without a dense key domain) and the
# tables they read.
UPID_SCRIPTS = ("px/upids", "px/pods", "px/pid_memory_usage",
                "px/mysql_flow_graph", "px/pgsql_flow_graph",
                "px/redis_flow_graph")
UPID_TABLES = {
    "process_stats": jax_schemas.PROCESS_STATS_RELATION,
    "mysql_events": jax_schemas.MYSQL_EVENTS_RELATION,
    "pgsql_events": jax_schemas.PGSQL_EVENTS_RELATION,
    "redis_events": jax_schemas.REDIS_EVENTS_RELATION,
}

SCRIPTS = {
    "http_stats": lambda: load_script("px/http_stats").pxl,
    "http_stats_f64": lambda: HTTP_STATS_F64,
    "service_stats": lambda: load_script("px/service_stats").pxl,
    **{name: (lambda _n=name: load_script(_n).pxl) for name in UPID_SCRIPTS},
}


def _canon(x):
    """Package-neutral form of a plan op: class names, field values, and
    enums by name (the two packages have distinct DataType classes)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _canon(getattr(x, f.name))) for f in dataclasses.fields(x)
        )
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, (list, tuple)):
        return tuple(_canon(v) for v in x)
    return x


def _plan_shape(plan):
    return [
        (nid, tuple(plan.nodes[nid].inputs), _canon(plan.nodes[nid].op))
        for nid in plan.topo_order()
    ]


def _report_shape(r):
    """Package-neutral form of a PlanResourceReport."""
    return {
        "rows_in_hi": r.rows_in_hi, "rows_out_hi": r.rows_out_hi,
        "bytes_staged_hi": r.bytes_staged_hi,
        "peak_node_bytes_hi": r.peak_node_bytes_hi,
        "wire_bytes_hi": r.wire_bytes_hi,
        "cold_decode_bytes_hi": r.cold_decode_bytes_hi,
        "agg_groups": dict(r.agg_groups),
        "join_capacity": dict(r.join_capacity),
        "diagnostics": [d.code for d in r.diagnostics],
        "origin": r.origin, "safety": r.safety, "cost": r.cost(),
        "nodes": {nid: (b.rows.lo, b.rows.hi, b.row_bytes, b.groups,
                        b.join_capacity, b.origin)
                  for nid, b in r.nodes.items()},
    }


def seeded_table_stats(tables, seed=3, rows=1 << 22):
    """A sketch snapshot of ``tables`` as ``Engine._compile_table_stats``
    builds one: every INT64 and STRING column but ``time_`` sketched, with
    NDVs drawn from a seeded generator (up to 50,000, so some group-bys
    presize past the default 4096 groups) and integer zone maps."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, rel in sorted(tables.items()):
        cols = [c for c, t in rel.items()
                if t.name in ("INT64", "STRING") and c != "time_"]
        ndv = {c: int(rng.integers(2, 50_000)) for c in cols}
        out[name] = {
            "rows": rows, "ndv": ndv,
            "zones": {c: (0, 10 * ndv[c]) for c in cols
                      if rel.col_type(c).name == "INT64"},
        }
    return out


def _compile_both(q, tables):
    """The script compiled by both packages, without table stats and with
    ``seeded_table_stats``: [(port, jax), (port, jax)]."""
    port_tables = {
        name: Relation([(n, DataType[t.name]) for n, t in rel.items()])
        for name, rel in tables.items()
    }
    out = []
    for stats in ({}, seeded_table_stats(tables)):
        jax_state = JaxCompilerState(
            schemas=tables, registry=jax_registry(), now_ns=1,
            table_stats=dict(stats),
        )
        state = CompilerState(
            schemas=port_tables, registry=default_registry(), now_ns=1,
            table_stats=dict(stats),
        )
        out.append((compile_pxl(q, state), jax_compile_pxl(q, jax_state)))
    return out


def _assert_same_compile(q, tables):
    presized = False
    for got, ref in _compile_both(q, tables):
        assert _plan_shape(got.plan) == _plan_shape(ref.plan)
        assert got.outputs == ref.outputs == ["output"]
        assert _report_shape(got.plan.resource_report) == _report_shape(
            ref.plan.resource_report)
        presized |= any(
            n.op.max_groups > 4096 for n in got.plan.nodes.values()
            if type(n.op).__name__ == "AggOp")
    return presized


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_compile_pxl_matches_jax(script):
    tables = {"http_events": JaxRelation(
        [(n, JaxDataType[t]) for n, t in HTTP_EVENTS]), **UPID_TABLES}
    presized = _assert_same_compile(SCRIPTS[script](), tables)
    # Group-bys over sketched columns presize; upid (UINT128) keys are
    # not sketched and keep the default, and so does px/pods' second
    # group-by (over the first one's output).
    assert presized == (script not in UPID_SCRIPTS)


# The scripts with joins, and the tables they read (http_events with the
# pod column px/service_resource_usage groups by).
JOIN_SCRIPTS = ("px/net_flow_graph", "px/http_request_stats",
                "px/service_resource_usage")
JOIN_TABLES = {
    "conn_stats": jax_schemas.CONN_STATS_RELATION,
    "process_stats": jax_schemas.PROCESS_STATS_RELATION,
    "http_events": JaxRelation(
        [(n, JaxDataType[t]) for n, t in HTTP_EVENTS + [("pod", "STRING")]]),
}


@pytest.mark.parametrize("script", JOIN_SCRIPTS)
def test_join_scripts_compile_like_jax(script):
    _assert_same_compile(load_script(script).pxl, JOIN_TABLES)


@pytest.mark.parametrize(
    "name", ["px/http_stats", "px/service_stats", *UPID_SCRIPTS,
             *JOIN_SCRIPTS]
)
def test_script_copies_match_jax_package(name):
    assert load_script(name).pxl == jax_load_script(name).pxl


def _mutation_fields(m) -> tuple:
    """A pxtrace mutation as plain values, comparable across packages."""
    if not hasattr(m, "probe"):  # TracepointDelete
        return ("delete", m.name)
    return ("deploy", m.name, m.table_name, m.probe.target,
            tuple((col, te.kind, te.expr, te.dtype.name)
                  for col, te in m.probe.outputs), m.ttl_s)


PXTRACE_SCRIPT = """import pxtrace

@pxtrace.probe('app.handle')
def probe_fn():
    return [{'latency_ns': pxtrace.FunctionLatency(),
             'who': pxtrace.ArgExpr('who', type='string')}]

pxtrace.UpsertTracepoint('tp', 'calls', probe_fn, ttl='5m')
"""


@pytest.mark.parametrize("script", [
    pytest.param(PXTRACE_SCRIPT, id="import pxtrace\n"),
    "import px\ndf = px.DataFrame(table='http_events')\n"
    "px.export(df, px.otel.Data())\n",
    "import px\ndf = px.DataFrame(table='http_events')\n"
    "df.svc = df.ctx['service']\npx.display(df)\n",
])
def test_features_outside_the_slice_raise(script):
    """``df.ctx`` without a metadata state raises as in the JAX package;
    ``px.export`` and ``pxtrace`` are in the port now: both packages
    compile the export to the same plan and the pxtrace script to equal
    mutations."""
    if "pxtrace" in script:
        for got, ref in _compile_both(script, {}):
            assert got.outputs == ref.outputs == []
            assert len(got.mutations) == 1
            assert ([_mutation_fields(m) for m in got.mutations]
                    == [_mutation_fields(m) for m in ref.mutations])
        return
    if "px.export" in script:
        tables = {"http_events": JaxRelation(
            [(n, JaxDataType[t]) for n, t in HTTP_EVENTS])}
        for got, ref in _compile_both(script, tables):
            assert _plan_shape(got.plan) == _plan_shape(ref.plan)
            assert got.outputs == ref.outputs == []
            assert got.n_exports == ref.n_exports == 1
            assert [type(n.op).__name__ for n in got.plan.nodes.values()
                    ] == ["MemorySourceOp", "OTelExportSinkOp"]
        return
    state = CompilerState(
        schemas={"http_events": Relation(
            [(n, DataType[t]) for n, t in HTTP_EVENTS])},
        registry=default_registry(), now_ns=1,
    )
    # ``df.ctx`` is in the port now; without a metadata state attached it
    # raises as the JAX package does.
    with pytest.raises(PxLError, match="no metadata state attached"):
        compile_pxl(script, state)
