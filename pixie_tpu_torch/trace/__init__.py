from .spec import (
    ProbeDef,
    TraceExpr,
    TracepointDelete,
    TracepointDeployment,
    parse_ttl,
)

__all__ = [
    "ProbeDef",
    "TraceExpr",
    "TracepointDelete",
    "TracepointDeployment",
    "parse_ttl",
]
