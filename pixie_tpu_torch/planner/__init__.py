"""PxL frontend: compile PxL (a Pythonic pandas-like DSL) to exec Plans.

Reference parity: ``src/carnot/planner/`` — parser (libpypa there, CPython
``ast`` here), ASTVisitor + QLObject model (``compiler/ast_visitor.h:75``,
``objects/dataframe.h:40``), typed IR with analyzer/optimizer rule batches
(``compiler/analyzer/``, ``compiler/optimizer/``), and the logical planner
facade (``logical_planner.h:40``).

The reference compiles PxL to a protobuf plan shipped to C++ exec nodes;
here the compiler emits the exec-layer ``Plan`` DAG directly, and the
fragment compiler turns maximal linear chains of it into one window fold.
The modules are copies of the JAX package's planner with imports
repointed (``otel_module.py`` is ``px.otel``); pxtrace raises
``PxLError``.
"""

from .compiler import CompiledScript, CompilerState, compile_pxl
from .objects import PxLError

__all__ = ["CompiledScript", "CompilerState", "compile_pxl", "PxLError"]
