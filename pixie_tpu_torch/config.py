"""Flags the port reads, with environment-variable fallback.

The same registry shape as the JAX package's ``config.py``: a value
resolves from an explicit ``set_flag`` override, then the
``PIXIE_TPU_<NAME>`` environment variable, then the default. Only the
flags this slice of the port reads are defined. None of them routes
work between a kernel and its plain version: the device decides that.
"""

from __future__ import annotations

import os
import threading

_DEFAULTS: dict[str, int] = {}
_DOCS: dict[str, str] = {}
_OVERRIDES: dict[str, int] = {}
_LOCK = threading.Lock()


def define_flag(name: str, default: int, doc: str) -> None:
    _DEFAULTS[name] = default
    _DOCS[name] = doc


def get_flag(name: str) -> int:
    default = _DEFAULTS[name]
    with _LOCK:
        if name in _OVERRIDES:
            return _OVERRIDES[name]
    env = os.environ.get("PIXIE_TPU_" + name.upper())
    return int(env) if env is not None else default


def set_flag(name: str, value: int) -> None:
    if name not in _DEFAULTS:
        raise KeyError(name)
    with _LOCK:
        _OVERRIDES[name] = int(value)


def clear_flag(name: str) -> None:
    with _LOCK:
        _OVERRIDES.pop(name, None)


define_flag("window_rows", 1 << 17, "Rows per streamed device window.")
define_flag("max_groups_limit", 1 << 22,
            "Hard cap for group-by capacity (the planner's eager-"
            "aggregation sizing reads it).")
define_flag("dense_domain_limit", 1 << 20,
            "Group-bys whose key columns all have statically-known domains "
            "(dictionary-encoded strings, booleans) with product <= this "
            "use the packed key as the group id.")
define_flag("int_dense_domain_limit", 1 << 23,
            "Dense-domain budget for a single integer key bounded by the "
            "table's append-time min/max stats (Table.col_stats).")
