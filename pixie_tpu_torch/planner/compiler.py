"""Compiler entry point: PxL source -> analyzed exec Plan.

Reference parity: ``src/carnot/planner/compiler/compiler.h:39``
(Compiler::CompileToIR: parse -> ASTVisitor -> IR -> Analyze -> Optimize)
plus the LogicalPlanner facade (``planner/logical_planner.h:40``).
A copy of the JAX package's compiler without its pxtrace mutation pass
and its verifier and bounds passes.
"""

from __future__ import annotations

import ast
import time
from dataclasses import dataclass, field

from ..exec.plan import Plan
from .ast_visitor import ASTVisitor
from .objects import PlanBuilder, PxLError
from .px_module import PxModule
from .rules import run_rules


@dataclass
class CompilerState:
    """Per-query compile inputs (reference:
    ``planner/compiler_state/compiler_state.h`` — schemas, time, max
    output rows, registry info)."""

    schemas: dict  # table name -> Relation
    registry: object
    now_ns: int = 0
    max_output_rows: int = 10_000
    max_groups: int = 4096
    # Ingest-sketch statistics per table (``table_store/sketches.py``):
    # {table: {"rows": int, "ndv": {col: estimated distinct values}}}.
    # Optimizer rules consult them (e.g. eager aggregation sizes its
    # partial agg's group capacity from the join key's NDV instead of a
    # blind default that climbs the overflow-doubling ladder at run
    # time). Estimates only — never correctness-bearing.
    table_stats: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.now_ns:
            self.now_ns = time.time_ns()


@dataclass
class CompiledScript:
    plan: Plan
    outputs: list  # sink names in display order
    funcs: dict = field(default_factory=dict)  # module-level PxL functions
    # Export sinks (px.export) have no named output; callers must not
    # treat outputs == [] as "nothing to execute" when this is non-zero.
    n_exports: int = 0


def parse_pxl(query: str) -> ast.Module:
    """Parse PxL source (reference wraps libpypa, ``parser/parser.h:45``;
    PxL is Python-shaped so CPython's ast is the natural parser here)."""
    try:
        return ast.parse(query)
    except SyntaxError as e:
        raise PxLError(f"syntax error: {e.msg}", e.lineno)


def compile_pxl(query: str, state: CompilerState) -> CompiledScript:
    # Telemetry feedback resolution (services/telemetry.py): the engine
    # exposes OBSERVED per-script cardinalities from past runs under
    # table_stats["__observed__"] keyed by script hash; resolve THIS
    # script's entry so optimizer rules can consult it without knowing
    # the script (arXiv:2102.02440 — observed stats over estimates).
    observed = state.table_stats.get("__observed__")
    if observed:
        import hashlib

        ent = observed.get(
            hashlib.sha256(query.encode()).hexdigest()[:12]
        )
        if ent:
            state.table_stats = {
                **state.table_stats, "__observed_self__": dict(ent),
            }
    tree = parse_pxl(query)
    builder = PlanBuilder(
        plan=Plan(),
        schemas=dict(state.schemas),
        registry=state.registry,
        max_groups=state.max_groups,
    )
    px = PxModule(builder, state.now_ns)
    visitor = ASTVisitor(px)
    visitor.run(tree)
    if (not builder.sinks and not builder.n_exports
            and not builder.n_table_sinks):
        raise PxLError(
            "script produced no output tables; call px.display(df), "
            "px.to_table(df, name), or "
            "px.export(df, ...) (or the script only defines functions — "
            "call one and display its result)"
        )
    run_rules(builder.plan, state.max_output_rows,
              table_stats=state.table_stats)
    # The JAX package runs its static plan verifier and resource-bound
    # pass here (``analysis.verifier``, ``analysis.bounds``); this port
    # has neither yet.
    return CompiledScript(
        plan=builder.plan, outputs=list(builder.sinks), funcs=visitor.funcs,
        n_exports=builder.n_exports,
    )
