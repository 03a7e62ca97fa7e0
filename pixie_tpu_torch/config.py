"""Flags the port reads, with environment-variable fallback.

The same registry shape as the JAX package's ``config.py``: a value
resolves from an explicit ``set_flag`` override, then the
``PIXIE_TPU_<NAME>`` environment variable, then the default. A flag
whose default is a bool parses "1", "true", "yes" and "on" as True. Only
the flags the port reads are defined, with the JAX package's names,
defaults and docs. None of them routes work between a kernel and its
plain version: the device decides that.
"""

from __future__ import annotations

import os
import threading

_DEFAULTS: dict[str, int | bool] = {}
_DOCS: dict[str, str] = {}
_OVERRIDES: dict[str, int | bool] = {}
_LOCK = threading.Lock()


def define_flag(name: str, default: int | bool, doc: str) -> None:
    _DEFAULTS[name] = default
    _DOCS[name] = doc


def _parse(name: str, value) -> int | bool:
    if isinstance(_DEFAULTS[name], bool):
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    return int(value)


def get_flag(name: str) -> int | bool:
    default = _DEFAULTS[name]
    with _LOCK:
        if name in _OVERRIDES:
            return _OVERRIDES[name]
    env = os.environ.get("PIXIE_TPU_" + name.upper())
    return _parse(name, env) if env is not None else default


def set_flag(name: str, value) -> None:
    if name not in _DEFAULTS:
        raise KeyError(name)
    with _LOCK:
        _OVERRIDES[name] = _parse(name, value)


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
define_flag("pipeline_depth", 2,
            "Window-executor prefetch depth: host slicing/packing/"
            "device_put of window N+1 runs on a background thread while "
            "window N computes, with at most this many windows in "
            "flight. 1 = serial (no prefetch thread, today's behavior).")
define_flag("ingest_sketches", True,
            "Maintain per-tablet ingest sketches (row count, HLL NDV, "
            "zone maps on key columns) on the append path; join routing "
            "and the planner's eager-aggregation sizing consult them.")
define_flag("device_residency", True,
            "Stage full table windows into device memory (HBM) at append "
            "time so steady-state queries run without host transfers.")
define_flag("device_cache_bytes", 6 << 30,
            "Byte budget for device-resident table windows (LRU-evicted).")
define_flag("scan_zone_skip", True,
            "Skip scan windows whose per-column zone maps cannot satisfy a "
            "query's FilterOp predicate (exec/zoneskip.py) — checked BEFORE "
            "stage/decode, so selective scans over cold data never decode "
            "dead windows. Generalizes join_zone_skip to plain table scans.")
