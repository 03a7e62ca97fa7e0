"""Incremental materialized views: hot scripts answered by folding only
the rows appended since their last answer.

A port of the JAX package's ``exec/views.py``. The streaming cursor
(``exec/streaming.py``) already is incremental view maintenance: an
aggregate's group state persists across polls and each poll folds only
the windows appended since the one before. A ``MaterializedView`` wraps
one ``StreamingQuery`` per registered script; a repeat of the script
polls it once and is answered from the captured ``mode="replace"``
batch.

A script registers when its manifest says ``materialize: true`` (a hint
that acts only while ``result_cache_mb`` is set), or once it has run
``view_auto_min_runs`` times, counting both the runs seen here and
those the engine's self-telemetry observed (0 turns that off). The
answer equals a one-shot rescan at the same ``now``
(same fragment, same window order, same finalize), across a group
rebucket (the stream refolds at twice the capacity) and across true
expiry (the stream refolds from the live rows). A time-bounded script
is served while the requested ``now`` stays within its staleness budget
of the view's registration; past it the view registers again at the
new ``now`` (one full fold, then incremental again). Each view's stream
has its own lifecycle trace: a view replaced by a new registration is
closed, and ``ViewRegistry.close`` closes every view, so no trace is
left in flight.
"""

from __future__ import annotations

import threading
import time

from ..config import get_flag
from .result_cache import VIEW, ResultCache, script_sha
from .stream import QueryError

_MAT_LOCK = threading.Lock()
_MAT_CACHE: set | None = None


def manifest_materialized() -> set:
    """sha256(pxl) of every shipped script whose manifest sets
    ``materialize: true``, read once per process."""
    global _MAT_CACHE
    with _MAT_LOCK:
        if _MAT_CACHE is None:
            from ..scripts import load_all

            _MAT_CACHE = {
                script_sha(sd.pxl) for sd in load_all()
                if sd.manifest.get("materialize")
            }
        return _MAT_CACHE


def view_candidates_enabled(query: str) -> bool:
    """The execute path's cheap gate: views are in play when
    auto-registration is on, or when the result cache is on and this
    script's manifest asks for a view. With every flag at its default
    the query takes the plain execute path."""
    if "pxtrace" in query:
        return False
    if int(get_flag("view_auto_min_runs")) > 0:
        return True
    if int(get_flag("result_cache_mb")) <= 0:
        return False
    return script_sha(query) in manifest_materialized()


class MaterializedView:
    """One continuously maintained view: a StreamingQuery over an
    aggregate chain and the latest finalized batch it emitted."""

    def __init__(self, engine, script: str, now_ns: int = 0,
                 max_output_rows: int = 10_000):
        from .streaming import stream_query

        self.sha = script_sha(script)
        self.now_ns = int(now_ns) or time.time_ns()
        self.max_output_rows = int(max_output_rows)
        self.registered_unix_ns = time.time_ns()
        self._last: dict = {}
        self._lock = threading.Lock()
        self.answers = 0
        self.sq = stream_query(
            engine, script, emit=self._capture,
            now_ns=self.now_ns, max_output_rows=self.max_output_rows,
        )
        if not self.sq.chain.is_agg:
            self.sq.close()
            raise QueryError(
                "only aggregate chains materialize: an append stream "
                "has no finalize-over-state to answer from"
            )

    def _capture(self, update) -> None:
        if update.mode == "replace":
            self._last[update.table] = update.batch

    @property
    def time_dependent(self) -> bool:
        return self.sq.chain.source.start_time is not None

    def freshness_lag_ms(self) -> float:
        """How far the view's source table trails the clock now (0 when
        the table has no time index)."""
        from ..table_store import table as _table_mod

        wm = _table_mod.max_watermark_ns(self.sq.tablets)
        if wm is None:
            return 0.0
        return max(0.0, round((time.time_ns() - wm) / 1e6, 3))

    def answer(self) -> dict:
        """Fold the windows appended since the last answer and return
        {sink: HostBatch}; the poll's counters are ``sq.last_stats``."""
        with self._lock:
            self.sq.poll()
            self.answers += 1
            return dict(self._last)

    def close(self) -> None:
        """End the view's stream (and its trace)."""
        self.sq.close()

    def to_dict(self) -> dict:
        return {
            "script_hash": self.sha[:12],
            "table": self.sq.chain.source.table,
            "sink": self.sq.chain.sink_name,
            "time_dependent": self.time_dependent,
            "max_output_rows": self.max_output_rows,
            "answers": self.answers,
            "polls": self.sq.seq,
            "registered_unix_ns": self.registered_unix_ns,
            "freshness_lag_ms": self.freshness_lag_ms(),
        }


class ViewRegistry:
    """An engine's views: run counting, registration (manifest or run
    count), registration again when a time-bounded view's ``now``
    drifts, and the answer path."""

    def __init__(self, engine):
        self.engine = engine
        self._lock = threading.RLock()
        self._views: dict = {}  # (sha, max_output_rows) -> view
        self._runs: dict = {}  # sha -> runs in this process
        self._failed: set = set()  # shas that cannot stream: never retried

    def _observed_runs(self, sha: str) -> int:
        """Telemetry-seeded run history (the collector's ``runs`` per
        short script hash): the run count includes the executed runs
        the engine's telemetry saw, not just the ones counted here."""
        tel = self.engine.telemetry
        if tel is None:
            return 0
        return int((tel.observed().get(sha[:12]) or {}).get("runs", 0))

    def _should_register(self, sha: str) -> bool:
        if sha in manifest_materialized():
            return True
        min_runs = int(get_flag("view_auto_min_runs"))
        return min_runs > 0 and (
            self._runs.get(sha, 0) + self._observed_runs(sha) >= min_runs
        )

    def register(self, query: str, now_ns: int = 0,
                 max_output_rows: int = 10_000) -> MaterializedView:
        """Register a view explicitly; raises QueryError when the script
        cannot stream (joins, unions, time-bounded sources, row chains)."""
        sha = script_sha(query)
        v = MaterializedView(
            self.engine, query, now_ns=now_ns, max_output_rows=max_output_rows,
        )
        with self._lock:
            old = self._views.pop((sha, int(max_output_rows)), None)
            self._views[(sha, int(max_output_rows))] = v
        if old is not None:
            old.close()
        return v

    def serve(self, query: str, now_ns: int = 0,
              max_output_rows: int = 10_000, trace=None):
        """Answer ``query`` from its view, registering one first when the
        manifest or the run count says so; None when no view covers it.
        The answer's poll counters become the engine's ``last_stats``,
        with ``cache`` set to ``view``; the view's freshness lag goes
        onto ``trace``, the query's own trace, when one is given."""
        sha = script_sha(query)
        key = (sha, int(max_output_rows))
        req_now = int(now_ns) or time.time_ns()
        with self._lock:
            self._runs[sha] = self._runs.get(sha, 0) + 1
            v = self._views.get(key)
            if v is None:
                if sha in self._failed or not self._should_register(sha):
                    return None
                try:
                    v = self.register(query, now_ns=now_ns,
                                      max_output_rows=max_output_rows)
                except QueryError:
                    # Not streamable: remember, so later repeats skip
                    # the compile.
                    self._failed.add(sha)
                    return None
            elif v.time_dependent:
                budget_ms = ResultCache.staleness_budget_ms(sha)
                if (req_now - v.now_ns) / 1e6 > budget_ms:
                    # The requested window drifted past the budget:
                    # register again at the new now.
                    try:
                        v = self.register(query, now_ns=req_now,
                                          max_output_rows=max_output_rows)
                    except QueryError:
                        self._failed.add(sha)
                        return None
        result = v.answer()
        st = v.sq.last_stats
        st.cache = VIEW
        st.freshness_lag_ms = v.freshness_lag_ms()
        if trace is not None:
            trace.note_freshness_lag(v.sq.chain.source.table,
                                     st.freshness_lag_ms)
        self.engine.last_stats = st
        self.engine.last_join_decision = None
        return result

    def viewz(self) -> list:
        with self._lock:
            views = list(self._views.values())
        return [v.to_dict() for v in views]

    def close(self) -> None:
        """Close and drop every view (later repeats execute, or register
        again)."""
        with self._lock:
            views = list(self._views.values())
            self._views.clear()
        for v in views:
            v.close()
