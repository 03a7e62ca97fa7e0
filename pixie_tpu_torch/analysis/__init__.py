"""Static analysis of compiled plans, run on every compile.

A port of the JAX package's ``analysis/`` with two of its passes:

- ``verifier``: schema propagation, column binding, dtype checking of
  every expression against the ``udf/registry.py`` signatures, topology
  checks, and the distributed-plan invariants. Diagnostics carry
  plan-node provenance (node id + operator) instead of a device-side
  shape error.
- ``bounds`` (pxbound): an abstract interpreter propagating per-node
  resource bounds (row intervals, bytes, group counts, join output,
  bridge wire bytes) seeded from ingest sketches; its
  ``PlanResourceReport`` pre-sizes the engine's aggregate group
  capacity and join output buffers.

Three gates replay the bench's shapes (each a ``python -m`` entry):
``bench_check`` (every bench shape's plan verifies clean, split for 2
PEMs and a Kelvin), ``obs_check`` (the same for the self-monitoring
scripts over the telemetry schemas) and ``bound_check`` (observed usage
within the predicted bounds on the engine's device, the over-budget
refusal, the memoized pass under 5% of a compile). ``lockdep`` is the
runtime lock-order validator (``lockdep.enable()`` before anything
builds its locks). The source lint is a later slice.
"""

from . import lockdep
from .bounds import (
    PlanResourceReport,
    apply_plan_bounds,
    check_plan_bounds,
    distributed_bounds,
    merged_cost,
    plan_bounds,
    presize_plan_aggs,
)
from .diagnostics import Diagnostic, PlanCheckError, Severity
from .verifier import (
    check_distributed_plan,
    check_plan,
    check_script_plan,
    verify_dispatch_sets,
    verify_distributed_plan,
    verify_plan,
)

__all__ = [
    "lockdep",
    "Diagnostic",
    "PlanCheckError",
    "PlanResourceReport",
    "Severity",
    "apply_plan_bounds",
    "check_distributed_plan",
    "check_plan",
    "check_plan_bounds",
    "check_script_plan",
    "distributed_bounds",
    "merged_cost",
    "plan_bounds",
    "presize_plan_aggs",
    "verify_dispatch_sets",
    "verify_distributed_plan",
    "verify_plan",
]
