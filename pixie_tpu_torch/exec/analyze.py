"""Per-query execution statistics: the stats spine of every query.

A port of the JAX package's ``exec/analyze.py`` (reference parity: the
``ExecNodeStats`` every Carnot ExecNode keeps, ``src/carnot/exec/
exec_node.h:40-127``). The unit of execution is a compiled fragment (a
whole Map/Filter/Agg chain), so stats attach per fragment, with a
per-stage breakdown of the window path:

- ``read``     host ring -> host window
- ``stage``    pad + host -> device copy, or the cache probe of a
               resident window
- ``compute``  filter, maps and the window fold
- ``finalize`` the aggregate's finalize
- ``materialize`` device -> host copy and host batch assembly
- ``decode``   cold-tier windows decoded (prefetch thread)
- ``skip``     windows pruned by their zone maps (a count)

Every query gets a ``QueryStats``; the query-lifecycle tracer
(``exec/trace.py``) owns it as its ``TraceStats`` spine. ``sync=False``
stamps host-side boundaries only; an attribution run
(``execute_query(..., analyze=True)``) sets ``sync=True``, which fences
the card after each stage so stage times hold its device work.

Besides the per-fragment records, ``QueryStats`` keeps the port's flat
per-query counters (``Engine.last_stats``): rows and windows folded,
resident, staged and skipped windows, rebuckets, join retries, the
stage seconds, cold decode, the repeat-serving disposition and the
pipeline's counters. Staging runs on the prefetch thread while compute
runs on the query thread, so every accumulation is locked.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

# Stage names -> the QueryStats field that sums their seconds, and event
# names -> the field that counts them.
_SECONDS = {
    "read": "read_s", "stage": "stage_s", "compute": "fold_s",
    "finalize": "finalize_s", "materialize": "finalize_s",
    "decode": "decode_s",
}
_COUNTS = {
    "skip": "skipped_windows", "resident": "resident_windows",
    "staged": "staged_windows",
}


@dataclass
class StageStat:
    seconds: float = 0.0
    rows: int = 0
    count: int = 0
    # Bytes moved by this stage: host -> device bytes of staged windows,
    # decoded bytes of cold windows.
    nbytes: int = 0


@dataclass
class FragmentStats:
    """Stats for one executed fragment. ``compiled`` is the fragment's
    ``CompiledFragment`` (None for a join driver); its attributes read
    through (``uses_dense_fold``, ``init_state``, ...), so callers that
    inspect the fragments a query ran see both at once."""

    ops: tuple = ()  # operator type names in chain order
    windows: int = 0
    rows_in: int = 0
    rows_out: int = 0
    sync: bool = True
    stages: dict = field(default_factory=dict)  # {stage: StageStat}
    compiled: object = field(default=None, repr=False, compare=False)
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def __getattr__(self, name):
        # Only reached for names the dataclass does not define.
        compiled = self.__dict__.get("compiled")
        if compiled is None or name.startswith("_"):
            raise AttributeError(name)
        return getattr(compiled, name)

    def add(self, stage: str, seconds: float, rows: int = 0,
            nbytes: int = 0, start_ns: int | None = None) -> None:
        """Charge ``seconds`` to ``stage``; ``start_ns`` (the interval's
        start on ``time.time_ns``) places a traced fragment's span."""
        with self._lock:
            s = self.stages.setdefault(stage, StageStat())
            s.seconds += seconds
            s.rows += int(rows)
            s.count += 1
            s.nbytes += int(nbytes)

    @contextlib.contextmanager
    def timed(self, stage: str, rows: int = 0, nbytes: int = 0):
        """Charge the seconds spent inside the block to ``stage``, inside
        the stage's ``region`` (``exec/trace.py``)."""
        from .trace import STAGE_PHASES, region

        t0 = time.time_ns()
        try:
            with region(stage, STAGE_PHASES.get(stage, "host")):
                yield self
        finally:
            self.add(stage, (time.time_ns() - t0) / 1e9, rows, nbytes,
                     start_ns=t0)

    def stage_snapshot(self) -> dict:
        """{stage: (seconds, rows, count, nbytes)} under the lock."""
        with self._lock:
            return {
                k: (v.seconds, v.rows, v.count, v.nbytes)
                for k, v in self.stages.items()
            }

    def to_dict(self) -> dict:
        stages = self.stage_snapshot()
        return {
            "ops": list(self.ops),
            "windows": self.windows,
            "rows_in": self.rows_in,
            "rows_out": self.rows_out,
            "stages": {
                k: {"seconds": round(s, 6), "rows": r, "count": c,
                    "bytes": b}
                for k, (s, r, c, b) in stages.items()
            },
        }


@dataclass
class QueryStats:
    """One query's fragments, counters and stage times, on the host clock.

    - ``fragments``: one ``FragmentStats`` per fragment executed (each
      rebucket attempt is its own);
    - ``wall_s``: the plan's execution, to the host result
      (``total_seconds`` reads it);
    - ``windows`` / ``rows``: windows folded and rows in them;
    - ``resident_windows``: windows served from the device cache;
      ``staged_windows`` / ``staged_bytes``: windows copied from the host
      by this query and their bytes; ``skipped_windows``: windows pruned
      by their zone maps, never staged;
    - ``pipeline``: the window pipeline's counters (depth, windows,
      stage_secs, stall_secs);
    - ``rebuckets``: group-by overflows refolded at twice the group
      capacity (each refold's windows and rows count again);
    - ``join_retries``: device-join dispatches rerun at twice their
      output capacity; ``join_capacity_evictions``: learned join
      capacities the engine's LRU cache dropped;
    - ``read_s``, ``stage_s``, ``fold_s`` and ``finalize_s``: with
      ``sync`` (an attribution run) each stage is fenced and the stages
      do not overlap; otherwise they are host enqueue times, and the
      stages of two windows overlap on the prefetch thread;
    - ``decode_s`` / ``decode_bytes``: cold-tier windows decoded for
      this query, their seconds and decoded bytes;
    - ``cache``: the repeat-serving disposition (``hit``, ``miss``,
      ``stale``, ``bypass``, ``view``; "" when the query did not go
      through the result cache or a view); ``freshness_lag_ms``: how far
      a served answer's newest event time trails the clock.
    """

    fragments: list = field(default_factory=list)  # list[FragmentStats]
    sync: bool = False
    wall_s: float = 0.0
    rows: int = 0
    windows: int = 0
    resident_windows: int = 0
    staged_windows: int = 0
    staged_bytes: int = 0
    skipped_windows: int = 0
    rebuckets: int = 0
    join_retries: int = 0
    join_capacity_evictions: int = 0
    read_s: float = 0.0
    stage_s: float = 0.0
    fold_s: float = 0.0
    finalize_s: float = 0.0
    decode_s: float = 0.0
    decode_bytes: int = 0
    cache: str = ""
    freshness_lag_ms: float = 0.0
    pipeline: dict = field(default_factory=lambda: {
        "depth": 0, "windows": 0, "stage_secs": 0.0, "stall_secs": 0.0,
    })
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    # The (rows, windows) totals when the current fragment began: its own
    # counters are the difference when the next one begins.
    _frag_base: tuple = field(default=(0, 0), repr=False)

    @property
    def total_seconds(self) -> float:
        return self.wall_s

    def _fragment(self, ops, compiled) -> FragmentStats:
        return FragmentStats(
            ops=tuple(type(o).__name__ for o in ops), sync=self.sync,
            compiled=compiled,
        )

    def new_fragment(self, ops, compiled=None) -> FragmentStats:
        """Begin the record of the next fragment (the previous one's
        windows and rows are sealed here)."""
        fs = self._fragment(ops, compiled)
        with self._lock:
            self._seal_locked()
            self.fragments.append(fs)
            self._frag_base = (self.rows, self.windows)
        return fs

    def seal(self) -> None:
        """Seal the last fragment's windows and rows (the query's end)."""
        with self._lock:
            self._seal_locked()

    def _seal_locked(self) -> None:
        if self.fragments:
            f = self.fragments[-1]
            rows0, windows0 = self._frag_base
            f.rows_in = self.rows - rows0
            f.windows = self.windows - windows0

    def add(self, stage: str, secs: float = 0.0, nbytes: int = 0,
            start_ns: int | None = None) -> None:
        """Charge ``secs`` (and, for "decode", ``nbytes``) to a stage, or
        count one event ("skip", "resident", "staged"; a staged window's
        ``nbytes`` are its copied bytes). The current fragment records
        the stage (and skips) too, its interval from ``start_ns`` (on
        ``time.time_ns``) when given. Called from the pipeline's producer
        thread."""
        with self._lock:
            if stage in _COUNTS:
                name = _COUNTS[stage]
                setattr(self, name, getattr(self, name) + 1)
                if stage == "staged":
                    self.staged_bytes += int(nbytes)
            else:
                name = _SECONDS[stage]
                setattr(self, name, getattr(self, name) + secs)
                if stage == "decode":
                    self.decode_bytes += int(nbytes)
            frag = self.fragments[-1] if self.fragments else None
        if frag is not None and stage not in ("resident", "staged"):
            frag.add(stage, secs, nbytes=nbytes, start_ns=start_ns)

    def note_freshness_lag(self, lag_ms: float, table: str = "") -> None:
        """Keep the worst lag of the tables this query read (``table``
        names it for the trace's per-table detail)."""
        with self._lock:
            self.freshness_lag_ms = max(self.freshness_lag_ms,
                                        max(0.0, float(lag_ms)))

    def to_dict(self) -> dict:
        frags = [f.to_dict() for f in self.fragments]
        totals: dict = {}
        for fd in frags:
            for k, v in fd["stages"].items():
                totals[k] = totals.get(k, 0.0) + v["seconds"]
        return {
            "total_seconds": round(self.total_seconds, 6),
            "stage_totals": {k: round(v, 6) for k, v in sorted(totals.items())},
            "fragments": frags,
        }

