"""User-Defined Table Functions: registry-backed table sources.

Reference parity: ``src/carnot/udf/udtf.h`` — a UDTF declares an output
relation, an executor class (where in the cluster it runs), and init
args; the planner surfaces it as ``px.<Name>(...)`` producing a
DataFrame. Cluster-introspection UDTFs live in ``src/vizier/funcs``
(``md_udtfs_impl.h:105-717``) and are registered here by the engine and
service layers with their backing context bound in.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable

from ..types.dtypes import DataType


class UDTFExecutor(enum.Enum):
    """Where a UDTF instance runs (udtf.h UDTFSourceExecutor)."""

    ALL_AGENTS = "all_agents"  # every data agent runs one instance
    ALL_PEM = "all_pem"  # data agents only
    ONE_KELVIN = "one_kelvin"  # a single merge-tier instance


@dataclass(frozen=True)
class UDTFDef:
    name: str
    # Output schema: tuple[(col name, DataType)].
    relation: tuple
    # fn(ctx, **init_args) -> {col: sequence}; ctx is the executing
    # engine (tables + registry) plus whatever the registrar closed over.
    fn: Callable
    executor: UDTFExecutor = UDTFExecutor.ONE_KELVIN
    # Declared init args, checked at compile time: each entry is
    # (name, DataType) for a required arg or (name, DataType, default)
    # for an optional one (udtf.h UDTFArg semantics).
    init_args: tuple = ()
    doc: str = ""

    def arg_required(self, name: str) -> bool:
        for entry in self.init_args:
            if entry[0] == name:
                return len(entry) == 2
        return False
