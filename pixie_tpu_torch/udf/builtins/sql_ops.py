"""SQL query normalization UDFs (dictionary-side).

Reference parity: ``src/carnot/funcs/builtins/sql_ops.cc`` +
``sql_parsing/`` — NormalizeMySQLUDF / NormalizePostgresSQLUDF replace
literals with placeholders so queries group by shape. The reference uses a
real SQL tokenizer; this is a tokenizer-lite regex pipeline (string
literals, numeric literals, IN-lists) — adequate for grouping, and it runs
once per distinct query string in the dictionary.
"""

from __future__ import annotations

import re

from ..udf import STRING, Executor

_STRING_LIT = re.compile(r"'(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"")
_NUM_LIT = re.compile(r"\b\d+(?:\.\d+)?\b")
_IN_LIST = re.compile(r"(?i)(\bIN\s*\()\s*(?:\?\s*,\s*)*\?\s*(\))")
_WS = re.compile(r"\s+")


def normalize_sql(q: str) -> str:
    q = _STRING_LIT.sub("?", q)
    q = _NUM_LIT.sub("?", q)
    q = _IN_LIST.sub(r"\1?\2", q)  # collapse IN (?, ?, ?) -> IN (?)
    return _WS.sub(" ", q).strip()


def register(reg):
    for name in ("normalize_mysql", "normalize_pgsql"):
        reg.scalar(
            name, (STRING,), STRING, normalize_sql,
            executor=Executor.HOST_DICT, dict_arg=0,
            doc="Replace SQL literals with '?' placeholders so queries group by shape.",
        )
