"""JSON scalar UDFs (dictionary-side): the ``pluck_float64`` overload.

Reference parity: ``src/carnot/funcs/builtins/json_ops.cc``. It runs once
per distinct dictionary string (HOST_DICT). Scripts reach it through
``px.pluck_float64(df.lat_q, 'p50')``, which the planner usually fuses
into a ``_quantile_*`` UDA before binding.
"""

from __future__ import annotations

import json

from ..udf import FLOAT64, STRING, Executor


def _pluck_float(s: str, key: str) -> float:
    try:
        return float(json.loads(s).get(key))
    except (json.JSONDecodeError, AttributeError, TypeError, ValueError):
        return float("nan")


def register(reg):
    reg.scalar("pluck_float64", (STRING, STRING), FLOAT64, _pluck_float,
               executor=Executor.HOST_DICT, dict_arg=0)
