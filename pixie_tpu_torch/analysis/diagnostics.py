"""Structured diagnostics with plan-node provenance.

A copy of the JAX package's ``analysis/diagnostics.py``. Reference
parity: Carnot's compiler surfaces typed Status errors with IR
node context (``src/carnot/planner/compiler/...``); its C++ type system
catches bad plans before execution. The Python rebuild discovers the
same bugs as device-side shape errors mid-query — a ``Diagnostic``
restores the compile-time failure mode: every finding names the plan
node (id + operator) or source location it came from, a stable rule
code, and a human message.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..planner.objects import PxLError


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"


@dataclass(frozen=True)
class Diagnostic:
    """One verifier/lint finding.

    ``code`` is the stable rule identifier (``unbound-column``,
    ``udf-signature``, ``dangling-output``, ...); ``node`` / ``op`` give
    plan provenance for verifier findings, ``path`` / ``line`` source
    provenance for lint findings.
    """

    code: str
    message: str
    severity: Severity = Severity.ERROR
    node: int | None = None  # plan node id
    op: str | None = None  # operator class name at that node
    plan: str = ""  # which plan: "logical" | "data" | "merge"
    path: str | None = None  # lint: source file
    line: int | None = None  # lint: 1-based line

    def render(self) -> str:
        where = ""
        if self.node is not None:
            frag = f" in {self.plan} plan" if self.plan else ""
            where = f" [node {self.node}: {self.op}{frag}]"
        elif self.path is not None:
            where = f" [{self.path}:{self.line}]"
        return f"{self.code}: {self.message}{where}"


class PlanCheckError(PxLError):
    """A compiled plan failed static verification.

    Subclasses ``PxLError`` so every existing compile-error path (CLI
    stderr, API error payloads, broker error replies) renders it as a
    compile-time failure rather than a mid-query execution error.
    """

    def __init__(self, diagnostics: list):
        self.diagnostics = list(diagnostics)
        lines = [d.render() for d in self.diagnostics]
        super().__init__(
            "plan verification failed:\n  " + "\n  ".join(lines)
        )
