"""JSON scalar UDFs (dictionary-side).

Reference parity: ``src/carnot/funcs/builtins/json_ops.cc`` — pluck,
pluck_int64, pluck_float64, pluck_array (rapidjson per row). Here each runs
once per distinct dictionary string. A copy of the JAX package's
``udf/builtins/json_ops.py``, except that ``pluck_array`` of a JSON
object gives "" (the JAX package's raises KeyError and fails the query).
"""

from __future__ import annotations

import json

from ..udf import FLOAT64, INT64, STRING, Executor


def _pluck(s: str, key: str):
    try:
        v = json.loads(s).get(key)
    except (json.JSONDecodeError, AttributeError, TypeError):
        return None
    return v


def _pluck_str(s: str, key: str) -> str:
    v = _pluck(s, key)
    if v is None:
        return ""
    if isinstance(v, str):
        return v
    return json.dumps(v)


def _pluck_int(s: str, key: str) -> int:
    v = _pluck(s, key)
    try:
        return int(v)
    except (TypeError, ValueError):
        return 0


def _pluck_float(s: str, key: str) -> float:
    v = _pluck(s, key)
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


def _pluck_array(s: str, idx: int) -> str:
    try:
        v = json.loads(s)
        return json.dumps(v[idx]) if isinstance(v[idx], (dict, list)) else str(v[idx])
    except (json.JSONDecodeError, IndexError, KeyError, TypeError):
        return ""  # (a JSON object has no index: "" too)


def register(reg):
    kw = dict(executor=Executor.HOST_DICT, dict_arg=0)
    reg.scalar("pluck", (STRING, STRING), STRING, _pluck_str, **kw,
               doc="Extract a key from a JSON object as a string.")
    reg.scalar("pluck_int64", (STRING, STRING), INT64, _pluck_int, **kw)
    reg.scalar("pluck_float64", (STRING, STRING), FLOAT64, _pluck_float, **kw)
    reg.scalar("pluck_array", (STRING, INT64), STRING, _pluck_array, **kw)
