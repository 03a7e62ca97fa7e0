"""Watermark-validated result cache: the repeat-query fast path.

A port of the JAX package's ``exec/result_cache.py``. Dashboards re-run
the same shipped scripts over and over; between advances of the scanned
tables' event-time watermarks (``Table.watermark_ns``, which never
regresses) the answer cannot have changed, so a repeat is served from
the cache without compiling or touching the device.

An entry is keyed on ``(sha256(script text), max_output_rows)``, not on
``now_ns``, so a dashboard replaying a script over an advancing window
still hits. Each entry stores the scanned tables and each one's
watermark at execute time, the resolved ``now_ns`` the time predicates
were compiled against, and whether any source is time-bounded. A
lookup reads the current watermarks of the stored tables (no compile)
and classifies the repeat:

- ``miss``: no entry, or a stored watermark is above the current one
  (the table regressed: the entry is dropped and the query executes);
- ``hit``: every watermark is unchanged or advanced by at most the
  script's staleness budget and, for a time-bounded plan, the requested
  ``now`` moved by at most that budget; the answer's freshness lag is
  measured again against the current clock;
- ``stale``: a watermark advanced (or ``now`` moved) past the budget:
  the query executes and its result replaces the entry.

The staleness budget is the script manifest's ``staleness_budget_ms``
when the executed text is a shipped script, else the
``result_cache_staleness_ms`` flag. A result that scans no table, or a
table without a watermark, is never stored (``bypass``). Capacity is a
byte-budgeted LRU (``result_cache_mb``; 0 turns the cache off). The
hit, miss and stale counters are plain integers, which ``cachez()``
reports with the entries.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

from ..config import get_flag

#: The dispositions a query's ``QueryStats.cache`` can carry.
HIT, MISS, STALE, BYPASS, VIEW = "hit", "miss", "stale", "bypass", "view"


def script_sha(script: str) -> str:
    return hashlib.sha256((script or "").encode()).hexdigest()


def scan_info(plan) -> tuple[tuple, bool]:
    """(scanned tables, time_dependent) of a compiled plan.
    ``time_dependent`` is True when a source has a start or stop bound:
    only then can a repeat at a later ``now`` select other rows from
    unchanged data, so only then does the ``now`` check apply."""
    from .plan import MemorySourceOp

    tables: list = []
    time_dep = False
    for nid in plan.topo_order():
        op = plan.nodes[nid].op
        if isinstance(op, MemorySourceOp):
            if op.table not in tables:
                tables.append(op.table)
            if op.start_time is not None or op.stop_time is not None:
                time_dep = True
    return tuple(tables), time_dep


def result_nbytes(obj) -> int:
    """Size estimate of a result for the LRU budget: ``.nbytes`` where
    an object has it, sums over containers otherwise."""
    nb = getattr(obj, "nbytes", None)
    if nb is not None:
        try:
            return int(nb)
        except (TypeError, ValueError):
            pass
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if isinstance(obj, str):
        return len(obj.encode("utf-8", "ignore"))
    if isinstance(obj, dict):
        return sum(result_nbytes(k) + result_nbytes(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return sum(result_nbytes(v) for v in obj)
    return 64  # scalars and small objects


_BUDGET_CACHE: dict | None = None
_BUDGET_LOCK = threading.Lock()


def manifest_budgets() -> dict:
    """{sha256(pxl text): staleness_budget_ms} over the shipped script
    library (the port's own ``scripts.load_all``), read once per
    process."""
    global _BUDGET_CACHE
    with _BUDGET_LOCK:
        if _BUDGET_CACHE is None:
            from ..scripts import load_all

            _BUDGET_CACHE = {
                script_sha(sd.pxl): float(sd.manifest["staleness_budget_ms"])
                for sd in load_all()
                if sd.manifest.get("staleness_budget_ms") is not None
            }
        return _BUDGET_CACHE


@dataclass
class CacheEntry:
    key: tuple
    script_hash: str  # the first 12 hex digits of ``sha``
    sha: str  # sha256 of the script text (the manifest budget's key)
    result: dict
    tables: tuple
    watermarks: dict  # table -> watermark_ns at store time
    stored_now_ns: int  # the resolved compile-time now
    time_dependent: bool
    nbytes: int
    stored_unix_ns: int = field(default_factory=time.time_ns)
    hits: int = 0


class ResultCache:
    """Byte-budgeted LRU of query results, validated by watermarks.
    Thread-safe; a lookup is a dict probe and one watermark read per
    scanned table."""

    def __init__(self):
        self._entries: "OrderedDict[tuple, CacheEntry]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.counts = {HIT: 0, MISS: 0, STALE: 0}

    # -- config --------------------------------------------------------------
    @staticmethod
    def budget_bytes() -> int:
        return int(get_flag("result_cache_mb")) << 20

    def enabled(self) -> bool:
        return self.budget_bytes() > 0

    @staticmethod
    def staleness_budget_ms(sha: str) -> float:
        ms = manifest_budgets().get(sha)
        if ms is None:
            ms = float(get_flag("result_cache_staleness_ms"))
        return max(0.0, ms)

    def _count(self, status: str) -> None:
        with self._lock:
            self.counts[status] += 1

    # -- core ----------------------------------------------------------------
    def lookup(self, script: str, now_ns: int, max_output_rows: int,
               wm_of) -> tuple[str, CacheEntry | None, float]:
        """Classify a repeat: ``(status, entry, freshness_lag_ms)``.
        ``wm_of(table)`` reads a table's current watermark (None when it
        has none). ``entry`` is set only for a hit, with the lag of its
        oldest table against the current clock."""
        sha = script_sha(script)
        key = (sha, int(max_output_rows))
        with self._lock:
            e = self._entries.get(key)
        if e is None:
            self._count(MISS)
            return MISS, None, 0.0
        budget_ms = self.staleness_budget_ms(sha)
        req_now = int(now_ns) or time.time_ns()
        stale = False
        lag_ms = 0.0
        for t in e.tables:
            cur = wm_of(t)
            stored = e.watermarks[t]
            if cur is None or cur < stored:
                # The watermark regressed: rows the cached answer covers
                # may be gone, so the entry goes and the query executes.
                self._drop(key)
                self._count(MISS)
                return MISS, None, 0.0
            if (cur - stored) / 1e6 > budget_ms:
                stale = True
            lag_ms = max(lag_ms, (req_now - stored) / 1e6)
        if e.time_dependent and (req_now - e.stored_now_ns) / 1e6 > budget_ms:
            stale = True
        if stale:
            self._count(STALE)
            return STALE, None, 0.0
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
            e.hits += 1
            self.counts[HIT] += 1
        return HIT, e, max(0.0, round(lag_ms, 3))

    def store(self, script: str, resolved_now_ns: int, max_output_rows: int,
              plan, result: dict, wm_of) -> str:
        """Insert a freshly computed result. Returns ``miss`` when stored
        (or too large to store) and ``bypass`` when the plan scans no
        table or a table without a watermark."""
        tables, time_dep = scan_info(plan)
        if not tables:
            return BYPASS
        wms: dict = {}
        for t in tables:
            wm = wm_of(t)
            if wm is None:
                return BYPASS
            wms[t] = int(wm)
        nbytes = result_nbytes(result)
        budget = self.budget_bytes()
        if nbytes > budget:
            return MISS  # larger than the whole budget: never served
        sha = script_sha(script)
        key = (sha, int(max_output_rows))
        e = CacheEntry(
            key=key, script_hash=sha[:12], sha=sha, result=result,
            tables=tables, watermarks=wms,
            stored_now_ns=int(resolved_now_ns) or time.time_ns(),
            time_dependent=time_dep, nbytes=nbytes,
        )
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = e
            self._bytes += nbytes
            while self._bytes > budget and len(self._entries) > 1:
                _k, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
        return MISS

    def _drop(self, key: tuple) -> None:
        with self._lock:
            e = self._entries.pop(key, None)
            if e is not None:
                self._bytes -= e.nbytes

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def cachez(self) -> dict:
        """The cache's state: budget, bytes, counters and entries."""
        with self._lock:
            entries = [
                {
                    "script_hash": e.script_hash,
                    "tables": list(e.tables),
                    "watermarks": dict(e.watermarks),
                    "time_dependent": e.time_dependent,
                    "nbytes": e.nbytes,
                    "hits": e.hits,
                    "stored_unix_ns": e.stored_unix_ns,
                    "max_output_rows": e.key[1],
                    "staleness_budget_ms": self.staleness_budget_ms(e.sha),
                }
                for e in self._entries.values()
            ]
            total = self._bytes
            counts = dict(self.counts)
        return {
            "enabled": self.enabled(),
            "budget_bytes": self.budget_bytes(),
            "bytes": total,
            "hits": counts[HIT],
            "misses": counts[MISS],
            "stale": counts[STALE],
            "entries": entries,
        }
