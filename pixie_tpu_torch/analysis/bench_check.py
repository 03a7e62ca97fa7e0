"""Plan verification over the bench shapes.

    python -m pixie_tpu_torch.analysis.bench_check

Compiles every bench shape's query (the shipped library scripts and the
inline queries ``pixie_tpu_torch/bench.py`` runs) against the bench
replays' schemas with the plan verifier on, then splits each through
the ``DistributedPlanner`` (2 PEMs + 1 Kelvin) and walks the
distributed plan with ``verify_distributed_plan``. Any error diagnostic
is a failure: these plans are the repo's performance-critical shapes
and must stay statically clean. It also reports the standalone verify
and split time against the compile time.

The schemas mirror the bench's replays (``bench.py``'s recipes); a
column drift there fails here with an unbound-column diagnostic.
dashboard_repeat runs http_stats' and service_stats' scripts over the
same table, so it has no entry of its own.
"""

from __future__ import annotations

import sys
import time

from ..types.dtypes import DataType
from ..types.relation import Relation

T, I, S = DataType.TIME64NS, DataType.INT64, DataType.STRING

#: shape -> {table: relation} of its replay.
SHAPE_SCHEMAS = {
    "http_stats": {
        "http_events": Relation([
            ("time_", T), ("latency_ns", I), ("resp_status", I),
            ("service", S), ("req_path", S),
        ]),
    },
    "service_stats": {
        "http_events": Relation([
            ("time_", T), ("latency_ns", I), ("resp_status", I),
            ("service", S), ("req_path", S),
        ]),
    },
    "net_flow_graph": {
        "conn_stats": Relation([
            ("time_", T), ("src_addr", S), ("src_pod", S),
            ("remote_addr", S), ("bytes_sent", I), ("bytes_recv", I),
        ]),
    },
    "sql_stats": {
        "mysql_events": Relation([
            ("time_", T), ("query_str", S), ("latency_ns", I),
        ]),
    },
    "perf_flamegraph": {
        "stack_traces.beta": Relation([
            ("time_", T), ("stack_trace", S), ("count", I),
        ]),
    },
    "device_join": {
        "conn_l": Relation([("time_", T), ("k", I), ("b", I)]),
        "conn_r": Relation([("time_", T), ("k", I), ("v", I)]),
    },
    # One query whose group keys span both sides: the eager-aggregate
    # rewrite cannot fire, so this verifies the N:M JoinOp plan.
    "device_join_skew": {
        "conn_l": Relation([("time_", T), ("k", I), ("b", I)]),
        "conn_r": Relation([("time_", T), ("k", I), ("c", I), ("v", I)]),
    },
    "device_join_select": {
        "conn_l": Relation([("time_", T), ("k", I), ("b", I)]),
        "conn_r": Relation([("time_", T), ("k", I), ("c", I), ("v", I)]),
    },
    # A selective scan whose FilterOp drives zone-map window skipping
    # over a mostly-cold table.
    "cold_scan": {
        "events": Relation([
            ("time_", T), ("shard", I), ("latency_ns", I), ("service", S),
        ]),
    },
}

_COLD_SCAN_QUERY = """
import px
df = px.DataFrame(table='events')
df = df[df.shard == 7]
out = df.groupby('shard').agg(
    n=('latency_ns', px.count), s=('latency_ns', px.sum))
px.display(out)
"""


def _shape_query(shape: str) -> str:
    """The PxL source the bench runs for ``shape`` (cold_scan's selective
    scan with a fixed shard)."""
    from .. import bench

    if shape == "device_join":
        return bench._DEVICE_JOIN_QUERY
    if shape in ("device_join_skew", "device_join_select"):
        return bench._JOIN_BOTH_SIDES_QUERY
    if shape == "cold_scan":
        return _COLD_SCAN_QUERY
    from ..scripts import load_script

    return load_script(f"px/{shape}").pxl


def check_bench_shapes(verbose: bool = True) -> int:
    """Compile and verify every bench shape; returns the number of
    failing shapes (0 = clean)."""
    from ..planner import CompilerState, compile_pxl
    from ..planner.distributed import DistributedPlanner
    from ..planner.distributed.distributed_state import DistributedState
    from ..planner.objects import PxLError
    from ..udf.registry import default_registry
    from .diagnostics import Severity
    from .verifier import verify_distributed_plan, verify_plan

    registry = default_registry()
    dstate = DistributedState.homogeneous(2, 1)
    failures = 0
    compile_total = verify_total = 0.0
    for shape, schemas in SHAPE_SCHEMAS.items():
        state = CompilerState(schemas=dict(schemas), registry=registry)
        try:
            t0 = time.perf_counter()
            compiled = compile_pxl(_shape_query(shape), state)
            t1 = time.perf_counter()
            # The verifier again, standalone, to time it (compile_pxl
            # already ran it once inside t1 - t0).
            diags = verify_plan(compiled.plan, schemas, registry)
            dplan = DistributedPlanner(registry).plan(compiled.plan, dstate)
            diags += verify_distributed_plan(dplan, schemas, registry)
            t2 = time.perf_counter()
        except PxLError as e:
            # A verifier refusal (PlanCheckError), or the frontend's own
            # (a column the script names that the schema lacks): this
            # shape's failure, not the gate's.
            failures += 1
            if verbose:
                print(f"[analyze] {shape}: FAIL\n{e}", file=sys.stderr)
            continue
        compile_total += t1 - t0
        verify_total += t2 - t1
        errors = [d for d in diags if d.severity == Severity.ERROR]
        if errors:
            failures += 1
            if verbose:
                print(f"[analyze] {shape}: FAIL", file=sys.stderr)
                for d in errors:
                    print(f"  {d.render()}", file=sys.stderr)
        elif verbose:
            print(
                f"[analyze] {shape}: ok "
                f"({len(compiled.plan.nodes)} logical nodes, "
                f"{len(dplan.split.before_blocking.nodes)}+"
                f"{len(dplan.split.after_blocking.nodes)} split)",
                file=sys.stderr,
            )
    if verbose and compile_total > 0:
        print(
            f"[analyze] compile {compile_total * 1e3:.1f}ms, "
            f"standalone verify+split {verify_total * 1e3:.1f}ms "
            f"({verify_total / compile_total:.1%} of compile)",
            file=sys.stderr,
        )
    return failures


def main() -> int:
    failures = check_bench_shapes()
    if failures:
        print(f"[analyze] {failures} bench shape(s) failed verification",
              file=sys.stderr)
        return 1
    print(f"[analyze] all {len(SHAPE_SCHEMAS)} bench shapes verify clean",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
