"""Predicate-driven window skipping: zone maps vs FilterOp predicates.

A port of the JAX package's ``exec/zoneskip.py``. A FilterOp predicate
over a sketched column implies a per-column value interval; any scan
window whose ingest zone map (``table_store/sketches.py``) cannot meet
that interval is pruned BEFORE it is staged (``Table.scan`` and
``Table.device_scan`` call the pruner first).

Two halves:

- ``predicate_ranges(ops, dicts)``, at compile time: walk the linear
  Map/Filter/Limit chain and intersect every conjunctive comparison of
  a *source* column against a literal into ``{col: (lo, hi)}``. Column
  provenance goes back through MapOps via ``trace_map_renames`` (a
  computed column's values are not described by the ingest sketch, so
  its constraints are dropped). String literals resolve through the
  table dictionaries (ids ARE the sketch domain); a string absent from
  the dictionary matches nothing, so equality on it prunes every window
  (``EMPTY``).
- ``make_pruner(table, ranges, stats)``, at run time: a
  ``prune(row_lo, row_hi) -> bool`` closure over the tablet's sketches.
  ``window_zone`` returning None means *unbounded*: never skip on
  missing information. Each skip charges one "skip" to the query's
  stats (the pruner runs on the pipeline's producer thread, so the
  stats object takes the count under its lock).

Disable with the ``scan_zone_skip`` flag.
"""

from __future__ import annotations

from ..config import get_flag
from .plan import ColumnRef, FilterOp, FuncCall, LimitOp, Literal, MapOp, \
    trace_map_renames

#: Sentinel: the predicate is unsatisfiable against the table (e.g.
#: equality with a string the dictionary has never seen); every window
#: prunes.
EMPTY = "empty"

_CMP = {
    "equal": "eq",
    "lessThan": "lt",
    "lessThanEqual": "le",
    "greaterThan": "gt",
    "greaterThanEqual": "ge",
}

_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


def _literal_value(lit: Literal, col: str, dicts) -> int | None | str:
    """Literal -> sketch-domain int. Strings go through the table
    dictionary; an unknown string returns EMPTY (matches nothing). None
    = not comparable (float, etc.)."""
    v = lit.value
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, str):
        d = dicts.get(col)
        if d is None:
            return None
        sid = d.lookup(v)
        # lookup returns NULL_ID for unseen strings; stored window codes
        # are always >= 0, so no window can match.
        return EMPTY if sid is None or int(sid) < 0 else int(sid)
    return None


def _constraints(pred, out: dict, dicts, source) -> bool:
    """Fold one predicate tree into ``out`` ({source col: (lo, hi)}).
    ``source(col)`` is the table column a chain column passes through
    unchanged, or None for a computed one, whose values the ingest
    sketch does not describe: its comparisons constrain nothing (and a
    string literal is looked up in the source column's dictionary, never
    in that of a table column the chain has overwritten). Returns False
    when the predicate is unsatisfiable (EMPTY). Unrecognized subtrees
    contribute nothing (a conjunction can only narrow, so ignoring a
    conjunct is safe; disjunctions and negations are skipped whole)."""
    if not isinstance(pred, FuncCall):
        return True
    if pred.name == "logicalAnd":
        return all(_constraints(a, out, dicts, source) for a in pred.args)
    if pred.name not in _CMP or len(pred.args) != 2:
        return True
    a, b = pred.args
    op = _CMP[pred.name]
    if isinstance(a, Literal) and isinstance(b, ColumnRef):
        a, b, op = b, a, _FLIP[op]
    if not (isinstance(a, ColumnRef) and isinstance(b, Literal)):
        return True
    col = source(a.name)
    if col is None:
        return True
    v = _literal_value(b, col, dicts)
    if v is EMPTY:
        return False
    if v is None:
        return True
    lo, hi = out.get(col, (None, None))
    if op == "eq":
        lo = v if lo is None else max(lo, v)
        hi = v if hi is None else min(hi, v)
    elif op in ("lt", "le"):
        b_hi = v - 1 if op == "lt" else v
        hi = b_hi if hi is None else min(hi, b_hi)
    else:  # gt / ge
        b_lo = v + 1 if op == "gt" else v
        lo = b_lo if lo is None else max(lo, b_lo)
    out[col] = (lo, hi)
    return True


def predicate_ranges(ops, dicts):
    """Walk a linear op chain; return {source_col: (lo|None, hi|None)},
    EMPTY (prune everything), or None (nothing to skip on).

    A FilterOp's columns map back to source columns through every
    earlier MapOp via trace_map_renames before its constraints are
    read: a rename survives, a computed column (even one that took a
    table column's name) contributes no constraint.
    """
    ranges: dict = {}
    maps_before: list = []

    def source(col):
        mapping = {col: col}
        for m in reversed(maps_before):
            mapping = trace_map_renames(m, mapping)
            if mapping is None:
                return None
        return mapping[col]

    for op in ops:
        if isinstance(op, MapOp):
            maps_before.append(op)
        elif isinstance(op, FilterOp):
            local: dict = {}
            if not _constraints(op.predicate, local, dicts, source):
                return EMPTY
            for src_name, (lo, hi) in local.items():
                cur = ranges.get(src_name, (None, None))
                ranges[src_name] = (
                    lo if cur[0] is None else (cur[0] if lo is None else max(cur[0], lo)),
                    hi if cur[1] is None else (cur[1] if hi is None else min(cur[1], hi)),
                )
        elif isinstance(op, LimitOp):
            continue
        else:
            break  # aggregate: later filters see derived rows
    ranges = {
        c: (lo, hi) for c, (lo, hi) in ranges.items()
        if lo is not None or hi is not None
    }
    for lo, hi in ranges.values():
        if lo is not None and hi is not None and lo > hi:
            return EMPTY
    return ranges or None


def make_pruner(table, ranges, stats=None):
    """Build ``prune(row_lo, row_hi) -> bool`` for one tablet, or None
    when there is nothing to prune on. ``ranges`` comes from
    ``predicate_ranges``; EMPTY prunes every window."""
    if ranges is None:
        return None
    if ranges is EMPTY:
        def prune_all(row_lo: int, row_hi: int) -> bool:
            if stats is not None:
                stats.add("skip")
            return True

        return prune_all
    sk = table.sketches
    if sk is None:
        return None
    cols = {c: b for c, b in ranges.items() if c in sk.cols}
    if not cols:
        return None

    def prune(row_lo: int, row_hi: int) -> bool:
        for c, (lo, hi) in cols.items():
            zone = sk.cols[c].window_zone(row_lo, row_hi)
            if zone is None:
                continue  # unbounded: never skip on missing info
            zlo, zhi = zone
            if (hi is not None and zlo > hi) or (lo is not None and zhi < lo):
                if stats is not None:
                    stats.add("skip")
                return True
        return False

    return prune


def chain_pruner(table, ops, dicts, stats=None):
    """predicate_ranges + make_pruner + the scan_zone_skip flag gate, in
    one call: the shape every scan site uses."""
    if not get_flag("scan_zone_skip"):
        return None
    return make_pruner(table, predicate_ranges(ops, dicts), stats=stats)
