"""String scalar UDFs — executed against the dictionary, not the rows.

Reference parity: ``src/carnot/funcs/builtins/string_ops.cc`` (contains,
length, find, substring, tolower, toupper, trim, strip_prefix, atoi, ...).

Every function here is HOST_DICT: it maps distinct dictionary strings to
new values once per plan binding; the device applies an int32 gather.
O(distinct strings), not O(rows) — the opposite cost model from Carnot's
per-row Exec() calls.
"""

from __future__ import annotations

from ..udf import BOOLEAN, INT64, STRING, Executor


def _atoi(s: str) -> int:
    try:
        return int(s.strip())
    except ValueError:
        return 0


def register(reg):
    def dict_udf(name, arg_types, ret, fn, dict_arg=0, doc=""):
        reg.scalar(name, arg_types, ret, fn, executor=Executor.HOST_DICT, dict_arg=dict_arg, doc=doc)

    dict_udf("contains", (STRING, STRING), BOOLEAN, lambda s, sub: sub in s,
             doc="True when s contains the substring.")
    dict_udf("length", (STRING,), INT64, len)
    dict_udf("find", (STRING, STRING), INT64, lambda s, sub: s.find(sub))
    dict_udf("substring", (STRING, INT64, INT64), STRING,
             lambda s, pos, length: s[pos : pos + length])
    dict_udf("tolower", (STRING,), STRING, str.lower)
    dict_udf("toupper", (STRING,), STRING, str.upper)
    dict_udf("trim", (STRING,), STRING, str.strip)
    dict_udf("strip_prefix", (STRING, STRING), STRING,
             lambda prefix, s: s[len(prefix):] if s.startswith(prefix) else s,
             dict_arg=1, doc="Remove prefix from s when present.")
    dict_udf("atoi", (STRING,), INT64, _atoi)
    dict_udf("startswith", (STRING, STRING), BOOLEAN, lambda s, p: s.startswith(p))
    dict_udf("endswith", (STRING, STRING), BOOLEAN, lambda s, p: s.endswith(p))
    from ...types.semantic import SemanticType

    reg.scalar(
        "pod_name_to_namespace", (STRING,), STRING,
        lambda s: s.split("/", 1)[0] if "/" in s else "",
        executor=Executor.HOST_DICT,
        semantic_type=int(SemanticType.ST_NAMESPACE_NAME),
        doc="Namespace of a 'namespace/pod' name ('' if unqualified).",
    )
