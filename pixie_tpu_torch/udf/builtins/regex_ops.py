"""Regex scalar UDFs (dictionary-side).

Reference parity: ``src/carnot/funcs/builtins/regex_ops.cc`` — RegexMatchUDF
("regex_match", pattern compiled once in Init) and RegexReplaceUDF
("replace"). Patterns compile once per plan binding and run over distinct
dictionary strings only.
"""

from __future__ import annotations

import functools
import re

from ..udf import BOOLEAN, STRING, Executor


@functools.lru_cache(maxsize=256)
def _compile(pattern: str):
    try:
        return re.compile(pattern)
    except re.error:
        return None


def _match(pattern: str, s: str) -> bool:
    rx = _compile(pattern)
    return bool(rx.fullmatch(s)) if rx else False


def _replace(pattern: str, s: str, sub: str) -> str:
    rx = _compile(pattern)
    return rx.sub(sub, s) if rx else s


def register(reg):
    reg.scalar(
        "regex_match", (STRING, STRING), BOOLEAN, _match,
        executor=Executor.HOST_DICT, dict_arg=1,
        doc="Full-string regex match (RE2 semantics approximated by re).",
    )
    reg.scalar(
        "replace", (STRING, STRING, STRING), STRING, _replace,
        executor=Executor.HOST_DICT, dict_arg=1,
        doc="Replace all regex matches in s with sub.",
    )
