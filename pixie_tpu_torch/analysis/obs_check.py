"""Self-observability gate.

    python -m pixie_tpu_torch.analysis.obs_check

Compiles every bundled self-monitoring PxL script against the telemetry
tables' schemas (``ingest/schemas.py`` ``TELEMETRY_SCHEMAS``) with the
plan verifier on, then splits each through the ``DistributedPlanner``
(2 PEMs + 1 Kelvin) and walks the distributed plan, as
``bench_check.py`` does for the bench shapes. A schema drift in the
telemetry fold (``services/telemetry.py``) fails here with an
unbound-column diagnostic, before any cluster runs the script.
"""

from __future__ import annotations

import sys

#: The bundled self-monitoring scripts this gate covers.
OBS_SCRIPTS = (
    "px/slow_queries", "px/query_cost", "px/agent_health",
    # The program registry's __programs__ table and the predicted-vs-
    # observed calibration over __queries__.
    "px/program_cost", "px/bound_accuracy",
    # Table health and per-agent watermark lag over __tables__.
    "px/table_health", "px/ingest_lag",
    # Result-cache dispositions per script hash over __queries__.
    "px/cache_stats",
    # Attributed CPU from __stacks__: per script and tenant, per-tenant
    # phases, and the folded-stack diff feed.
    "px/query_cpu", "px/tenant_cpu", "px/flame_diff",
    # Bus throughput, lag, queue high-water and request round trips
    # over __bus__.
    "px/bus_health", "px/rpc_latency",
)


def check_obs_scripts(verbose: bool = True) -> int:
    """Compile and verify every self-monitoring script; returns the
    number of failing scripts (0 = clean)."""
    from ..ingest.schemas import TELEMETRY_SCHEMAS
    from ..planner import CompilerState, compile_pxl
    from ..planner.distributed import DistributedPlanner
    from ..planner.distributed.distributed_state import DistributedState
    from ..scripts import load_script
    from ..udf.registry import default_registry
    from .diagnostics import Severity
    from .verifier import verify_distributed_plan, verify_plan

    registry = default_registry()
    dstate = DistributedState.homogeneous(2, 1)
    schemas = dict(TELEMETRY_SCHEMAS)
    failures = 0
    for name in OBS_SCRIPTS:
        try:
            pxl = load_script(name).pxl
            state = CompilerState(schemas=dict(schemas), registry=registry)
            compiled = compile_pxl(pxl, state)
            diags = verify_plan(compiled.plan, schemas, registry)
            dplan = DistributedPlanner(registry).plan(compiled.plan, dstate)
            diags += verify_distributed_plan(dplan, schemas, registry)
        except Exception as e:  # noqa: BLE001 — any failure is the script's
            failures += 1
            if verbose:
                print(f"[obs] {name}: FAIL\n{e}", file=sys.stderr)
            continue
        errors = [d for d in diags if d.severity == Severity.ERROR]
        if errors:
            failures += 1
            if verbose:
                print(f"[obs] {name}: FAIL", file=sys.stderr)
                for d in errors:
                    print(f"  {d.render()}", file=sys.stderr)
        elif verbose:
            print(
                f"[obs] {name}: ok ({len(compiled.plan.nodes)} logical "
                f"nodes, {len(dplan.split.before_blocking.nodes)}+"
                f"{len(dplan.split.after_blocking.nodes)} split)",
                file=sys.stderr,
            )
    return failures


def main() -> int:
    failures = check_obs_scripts()
    if failures:
        print(f"[obs] {failures} self-monitoring script(s) failed "
              "verification", file=sys.stderr)
        return 1
    print(f"[obs] all {len(OBS_SCRIPTS)} self-monitoring scripts verify "
          "clean against the telemetry schemas", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
