"""The port's PxL frontend against the JAX package's: the same scripts
compile to the same plan (op classes, fields and edges)."""

import dataclasses
import enum

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


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_compile_pxl_matches_jax(script):
    q = SCRIPTS[script]()
    tables = {"http_events": JaxRelation(
        [(n, JaxDataType[t]) for n, t in HTTP_EVENTS]), **UPID_TABLES}
    jax_state = JaxCompilerState(
        schemas=tables, registry=jax_registry(), now_ns=1,
    )
    state = CompilerState(
        schemas={
            name: Relation([(n, DataType[t.name]) for n, t in rel.items()])
            for name, rel in tables.items()
        },
        registry=default_registry(), now_ns=1,
    )
    ref = jax_compile_pxl(q, jax_state)
    got = compile_pxl(q, state)
    assert _plan_shape(got.plan) == _plan_shape(ref.plan)
    assert got.outputs == ref.outputs == ["output"]


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


def _compile_both(q, tables):
    jax_state = JaxCompilerState(
        schemas=tables, registry=jax_registry(), now_ns=1,
    )
    state = CompilerState(
        schemas={
            name: Relation([(n, DataType[t.name]) for n, t in rel.items()])
            for name, rel in tables.items()
        },
        registry=default_registry(), now_ns=1,
    )
    return compile_pxl(q, state), jax_compile_pxl(q, jax_state)


@pytest.mark.parametrize("script", JOIN_SCRIPTS)
def test_join_scripts_compile_like_jax(script):
    got, ref = _compile_both(load_script(script).pxl, JOIN_TABLES)
    assert _plan_shape(got.plan) == _plan_shape(ref.plan)
    assert got.outputs == ref.outputs == ["output"]


@pytest.mark.parametrize(
    "name", ["px/http_stats", "px/service_stats", *UPID_SCRIPTS,
             *JOIN_SCRIPTS]
)
def test_script_copies_match_jax_package(name):
    assert load_script(name).pxl == jax_load_script(name).pxl


@pytest.mark.parametrize("script", [
    "import pxtrace\n",
    "import px\ndf = px.DataFrame(table='http_events')\n"
    "px.export(df, px.otel.Data())\n",
    "import px\ndf = px.DataFrame(table='http_events')\n"
    "df.svc = df.ctx['service']\npx.display(df)\n",
])
def test_features_outside_the_slice_raise(script):
    state = CompilerState(
        schemas={"http_events": Relation(
            [(n, DataType[t]) for n, t in HTTP_EVENTS])},
        registry=default_registry(), now_ns=1,
    )
    # ``df.ctx`` is in the port now; without a metadata state attached it
    # raises as the JAX package does.
    match = ("no metadata state attached" if "ctx[" in script
             else "not in this slice")
    with pytest.raises(PxLError, match=match):
        compile_pxl(script, state)
