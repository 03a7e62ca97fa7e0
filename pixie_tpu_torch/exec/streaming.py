"""Live (streaming) queries: a cursor over a growing table with
incremental results.

A port of the single-engine half of the JAX package's
``exec/streaming.py``. Reference parity:
``src/carnot/exec/memory_source_node.cc`` (a memory source with no stop
time streams forever) and ``query_result_forwarder.go`` StreamResults
(incremental batches to a subscribed client until cancel).

A ``StreamingQuery`` holds a row watermark per tablet and, on each
``poll()``, folds only the windows appended since the last poll through
the chain's compiled fragment, reading them through
``Table.device_scan(start_row=, stop_row=)`` (resident windows from the
device cache; a tail that grew is staged again, since its cache key
holds its length):

- a row chain (map, filter, limit) emits each new window's surviving
  rows once (``mode="append"``);
- an aggregate keeps its group state across polls: the new windows fold
  into it and the finalized aggregate is emitted (``mode="replace"``),
  which is incremental view maintenance (``exec/views.py``).

A watermark is committed only after its window is folded or emitted, so
an error or a cancel drops nothing. A zone-map-pruned tail still
commits (and counts as progress). True expiry past the state's fold
start refolds from the live rows; a group overflow rebuckets at twice
the capacity and refolds. Each poll's counters are in ``last_stats``
(an ``exec/analyze.py`` ``QueryStats``). A time-bounded source, a join,
a union and a UDTF source are refused.

A stream has one lifecycle trace (``exec/trace.py``, kind ``stream``):
it shows in ``/debug/queryz`` as in flight until ``close()`` or the end
of ``run()`` ends it, each compile (rebuckets too) is a fragment of it,
every poll's window work and freshness lag are charged to it as well as
to ``last_stats``, and the finished trace is a ``__queries__`` row like
a one-shot query's.

The per-agent half of a distributed live query ends in a
``BridgeSinkOp``: each poll ships the current partial state
(``mode="state"``, an ``AggStatePayload``) or the new rows
(``mode="rows"``, a ``RowsPayload``) to the merge agent instead of
emitting results (``services/agent.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ..table_store.coldstore import take_decode_meter
from .analyze import QueryStats
from .engine import Engine, _charge_decode
from .fragment import compile_fragment
from .pipeline import WindowPipeline
from .plan import (
    AggOp,
    BridgeSinkOp,
    ColumnRef,
    FilterOp,
    LimitOp,
    MapOp,
    MemorySourceOp,
    Plan,
    ResultSinkOp,
    TableSinkOp,
)
from .stream import (
    QueryCancelled,
    QueryError,
    _apply_limit,
    _double_agg_groups,
    _Stream,
    _stream_col_stats,
    _timed,
    _to_host_batch,
)
from .trace import plan_script
from .zoneskip import chain_pruner


@dataclass
class StreamUpdate:
    """One incremental result delivery."""

    table: object  # the sink's name (None for a bridge update)
    batch: object  # HostBatch, or a bridge payload
    seq: int
    # "append": ``batch`` holds only new rows; "replace": ``batch`` is the
    # whole current aggregate and supersedes every earlier update;
    # "state": an agg bridge's partial state (supersedes this agent's
    # earlier ones); "rows": a row bridge's new rows.
    mode: str
    bridge_id: object = None


class _PollStats(QueryStats):
    """One poll's counters (``StreamingQuery.last_stats``), charged to
    the stream's trace as well: stage times and window events through
    ``add``, rows and windows through ``count``."""

    def __init__(self, trace_stats=None):
        super().__init__()
        self.trace_stats = trace_stats

    def add(self, stage: str, secs: float = 0.0, nbytes: int = 0,
            start_ns: int | None = None) -> None:
        super().add(stage, secs, nbytes, start_ns)
        if self.trace_stats is not None:
            self.trace_stats.add(stage, secs, nbytes, start_ns)

    def count(self, rows: int) -> None:
        """One window of ``rows`` rows folded or emitted."""
        self.rows += rows
        self.windows += 1
        ts = self.trace_stats
        if ts is not None:
            with ts._lock:
                ts.rows += rows
                ts.windows += 1

    def note_freshness_lag(self, lag_ms: float, table: str = "") -> None:
        super().note_freshness_lag(lag_ms, table)
        if self.trace_stats is not None:
            self.trace_stats.note_freshness_lag(lag_ms, table)

    def close(self, wall_s: float) -> None:
        """End the poll: its wall time and pipeline counters go to the
        trace too."""
        self.wall_s = wall_s
        ts = self.trace_stats
        if ts is None:
            return
        with ts._lock:
            ts.wall_s += wall_s
            ts.pipeline["depth"] = self.pipeline["depth"]
            for k in ("windows", "stage_secs", "stall_secs"):
                ts.pipeline[k] += self.pipeline[k]


@dataclass
class _StreamChain:
    """A linear source -> ops -> sink slice of a streamable plan."""

    source: MemorySourceOp
    ops: list
    sink_name: str
    is_agg: bool
    bridge_id: object = None  # set when the terminal is a BridgeSinkOp


def _linearize(plan: Plan) -> _StreamChain:
    """Check and flatten a streamable plan: exactly one memory source
    feeding a linear run of maps, filters, at most one aggregate and
    limits into one result or table sink."""
    sources = [n for n in plan.nodes.values() if isinstance(n.op, MemorySourceOp)]
    if len(sources) != 1:
        raise QueryError(
            f"streaming needs exactly one memory source, plan has {len(sources)}"
        )
    node = sources[0]
    src = node.op
    if src.stop_time is not None:
        raise QueryError("a time-bounded source cannot stream (stop_time set)")
    consumers = {
        nid: [m.id for m in plan.nodes.values() if nid in m.inputs]
        for nid in plan.nodes
    }
    ops: list = []
    cur = node.id
    bridge_id = None
    while True:
        outs = consumers[cur]
        if len(outs) != 1:
            raise QueryError("streaming plans must be linear (fan-out found)")
        nxt = plan.nodes[outs[0]]
        if isinstance(nxt.op, (MapOp, FilterOp, AggOp, LimitOp)):
            ops.append(nxt.op)
            cur = nxt.id
        elif isinstance(nxt.op, ResultSinkOp):
            name = nxt.op.name
            break
        elif isinstance(nxt.op, TableSinkOp):
            name = nxt.op.table
            break
        elif isinstance(nxt.op, BridgeSinkOp):
            name = None
            bridge_id = nxt.op.bridge_id
            break
        else:
            raise QueryError(f"operator {type(nxt.op).__name__} is not streamable")
    n_aggs = sum(isinstance(o, AggOp) for o in ops)
    if n_aggs > 1:
        raise QueryError("streaming supports at most one aggregate")
    return _StreamChain(source=src, ops=ops, sink_name=name,
                        is_agg=n_aggs == 1, bridge_id=bridge_id)


class StreamingQuery:
    """A live cursor over one plan: ``poll()`` folds everything appended
    since the last poll and emits 0..n StreamUpdates; ``run()`` polls
    until cancelled."""

    def __init__(self, engine: Engine, plan: Plan, emit, cancel=None,
                 script: str = ""):
        self.engine = engine
        self.emit = emit
        self.cancel = cancel
        self.chain = _linearize(plan)
        src = self.chain.source
        tablets = engine.table_store.tablets(src.table)
        if not tablets:
            raise QueryError(f"no table named {src.table!r}")
        self.tablets = tablets
        base = next((t for t in tablets if len(t.relation)), tablets[0])
        self.relation = base.relation
        self.dicts = dict(base.dicts)
        pre = []
        if src.columns is not None:
            pre.append(MapOp(exprs=tuple((c, ColumnRef(c)) for c in src.columns)))
        self.ops = pre + list(self.chain.ops)
        self.seq = 0
        self.rows_emitted = 0
        self.last_stats = QueryStats()
        self._wm: dict = {}  # id(tablet) -> row watermark
        for t in tablets:
            if t._backend is None:
                self._wm[id(t)] = 0
            elif src.start_time is not None:
                self._wm[id(t)] = t.row_id_for_time(int(src.start_time), False)
            else:
                self._wm[id(t)] = t.first_row_id()
        # Where the current group state's fold started, per tablet: true
        # expiry past this mark means folded rows are gone, and the state
        # refolds from the live rows (as a one-shot rescan would see).
        self._fold_lo: dict = dict(self._wm)
        self._state = None
        self._frag = None
        self._tfrag = None  # the current compile's fragment on the trace
        # Begun last, so that an earlier raise leaves no trace in flight.
        self.trace = engine.tracer.begin_query(
            script=script or plan_script(plan), kind="stream"
        )
        try:
            self._compile()
        except BaseException as e:
            self.close(status="error", error=f"{type(e).__name__}: {e}")
            raise

    def _compile(self):
        stream = _Stream(self.relation, self.dicts, list(self.ops), self.tablets)
        self._frag = compile_fragment(
            self.ops, self.relation, self.dicts, self.engine.registry,
            self.engine.device, col_stats=_stream_col_stats(stream),
        )
        if self.trace is not None:
            # Each compile (a rebucket's too) is a fragment of the trace.
            self._tfrag = self.trace.stats.new_fragment(self.ops, self._frag)
        self._state = None  # a recompiled aggregate refolds from the start

    def close(self, status: str = "ok", error: str = "") -> None:
        """End the stream's trace; a second call does nothing. ``run()``
        calls it on its way out; a caller that drives ``poll()`` itself
        closes the stream, or ``/debug/queryz`` lists it in flight."""
        tr, self.trace = self.trace, None
        if tr is not None:
            tr.pipeline = dict(tr.stats.pipeline)
            self.engine.tracer.end_query(tr, status=status, error=error)

    def _new_windows(self, stats: QueryStats):
        """(cols, valid, window, (tablet key, row_hi)) per device window
        appended since the last poll. ``cols`` None marks a zone-pruned
        tail: no row past the last surviving window can match, and the
        consumer commits ``row_hi`` without folding.

        Watermarks are not advanced here: under the prefetch pipeline
        this generator runs ahead of the consumer, and a window it
        staged may be dropped by an error or a cancel. The consumer
        commits ``self._wm[key] = row_hi`` after folding or emitting.
        The thread's decode meter is cleared first, so the poll is
        charged only the cold windows it decodes."""
        take_decode_meter()
        for t in self.tablets:
            if t._backend is None:
                continue
            # True expiry may have dropped rows under the watermark
            # (demotion does not move first_row_id, so demoted rows that
            # were never folded are still visited).
            wm = max(self._wm[id(t)], t.first_row_id())
            self._wm[id(t)] = wm
            end = t.end_row_id()
            if end <= wm:
                continue
            last_hi = wm
            pruner = chain_pruner(t, self.ops, self.dicts, stats=stats)
            scan = t.device_scan(
                window_rows=self.engine.window_rows, start_row=wm,
                stop_row=end, prune=pruner, stats=stats,
            )
            while True:
                with _timed(stats, "stage"):
                    item = next(scan, None)
                _charge_decode(stats)
                if item is None:
                    break
                win, lo, hi = item
                last_hi = hi
                yield win.cols, (lo - win.row0, hi - win.row0), win, (id(t), hi)
            if last_hi < end:
                # Zone maps pruned the tail windows. Pruned windows in the
                # middle are covered by the next surviving window's
                # commit, but a pruned tail would leave the watermark
                # short and every later poll would prune it again.
                yield None, None, None, (id(t), end)

    def _check_cancel(self):
        if self.cancel is not None and self.cancel.is_set():
            raise QueryCancelled("stream cancelled")

    def _has_new_rows(self) -> bool:
        return any(
            t._backend is not None
            and t.end_row_id() > max(self._wm[id(t)], t.first_row_id())
            for t in self.tablets
        )

    def _pipelined_windows(self, stats: QueryStats) -> WindowPipeline:
        """``_new_windows`` behind the engine's prefetch pipeline. A poll
        with nothing new runs serially: an idle stream must not start a
        thread per poll."""
        depth = self.engine.pipeline_depth
        if depth is None:
            from ..config import get_flag

            depth = get_flag("pipeline_depth")
        if depth > 1 and not self._has_new_rows():
            depth = 1
        return WindowPipeline(self._new_windows(stats), depth, cancel=self.cancel)

    def _fold_new(self, frag, stats: QueryStats):
        """Fold the newly appended windows into the persistent group
        state. Returns (rows folded, whether any window was consumed)."""
        if self._state is not None and any(
            t._backend is not None
            and t.first_row_id() > self._fold_lo.get(id(t), 0)
            for t in self.tablets
        ):
            # True expiry dropped rows already folded into the state:
            # refold from the live rows. Demotion never does this, since
            # the first row id across both tiers moves only on eviction.
            self._state = None
        if self._state is None:
            self._state = frag.init_state()
            start = self.chain.source.start_time
            for t in self.tablets:
                if t._backend is not None:
                    pos = (
                        t.row_id_for_time(int(start), False)
                        if start is not None else t.first_row_id()
                    )
                    self._wm[id(t)] = pos
                    self._fold_lo[id(t)] = max(pos, t.first_row_id())
        rows, folded = 0, False
        pipe = self._pipelined_windows(stats)
        try:
            for cols, valid, win, (wm_key, wm_hi) in pipe:
                self._check_cancel()
                if cols is not None:
                    win.handoff()
                    with _timed(stats, "compute"):
                        self._state = frag.merge_states(
                            self._state, frag.window_state(cols, valid)
                        )
                    n = valid[1] - valid[0]
                    rows += n
                    stats.count(n)
                # A pruned tail folds nothing but is still progress: rows
                # were consumed, so the poll emits.
                folded = True
                self._wm[wm_key] = wm_hi  # commit after the fold
        finally:
            pipe.close()
            self.engine._note_pipeline(pipe, stats)
        return rows, folded

    def _rebucket(self):
        """Group overflow: double the capacity (recompiled against fresh
        stats) and refold from the start."""
        stream = _Stream(self.relation, self.dicts, list(self.ops), self.tablets)
        self.ops = list(_double_agg_groups(stream).chain)
        self._compile()

    def _note_freshness(self, stats: QueryStats) -> None:
        """The poll's staleness: now less the source's max event-time
        watermark. One watermark sweep per poll (a rebucket re-enters
        ``_poll_inner``, not ``poll``)."""
        from ..table_store import table as _table_mod

        wm = _table_mod.max_watermark_ns(self.tablets)
        if wm is not None:
            stats.note_freshness_lag((time.time_ns() - wm) / 1e6,
                                     self.chain.source.table)

    def poll(self) -> int:
        """Fold the new rows and emit updates. Returns rows consumed;
        ``last_stats`` holds the poll's counters, which the stream's
        trace is charged too."""
        tr = self.trace
        stats = self.last_stats = _PollStats(
            tr.stats if tr is not None else None
        )
        t0 = time.perf_counter()
        try:
            self._note_freshness(stats)
            return self._poll_inner(stats)
        finally:
            stats.close(time.perf_counter() - t0)

    def _poll_inner(self, stats: QueryStats) -> int:
        frag = self._frag
        if self.chain.is_agg:
            rows, folded = self._fold_new(frag, stats)
            if not folded and self.seq > 0:
                return 0
            if self.chain.bridge_id is not None:
                return self._ship_state(frag, stats, rows)
            with _timed(stats, "finalize"):
                cols, valid, overflow = frag.finalize(self._state)
                overflowed = bool(overflow)
            if overflowed:
                stats.rebuckets += 1
                self._rebucket()
                return self._poll_inner(stats)
            with _timed(stats, "finalize"):
                hb = _apply_limit(
                    _to_host_batch(frag.out_meta, cols, valid), frag.limit
                )
            self.emit(StreamUpdate(
                table=self.chain.sink_name, batch=hb, seq=self.seq,
                mode="replace",
            ))
            self.seq += 1
            return rows
        # A row chain: each new window's rows are emitted once.
        rows = 0
        pipe = self._pipelined_windows(stats)
        try:
            for cols, valid, win, (wm_key, wm_hi) in pipe:
                self._check_cancel()
                if cols is None:
                    # A pruned tail: no row can match; advance only.
                    self._wm[wm_key] = wm_hi
                    continue
                win.handoff()
                with _timed(stats, "compute"):
                    out_cols, out_valid = frag.update(cols, valid)
                left = None
                if frag.limit is not None:
                    left = frag.limit - self.rows_emitted
                    if left <= 0:
                        raise StopStream()
                with _timed(stats, "materialize"):
                    hb = _to_host_batch(frag.out_meta, out_cols, out_valid, left)
                n = valid[1] - valid[0]
                rows += n
                stats.count(n)
                if self._tfrag is not None:
                    self._tfrag.rows_out += hb.length
                if hb.length:
                    self.emit(self._rows_update(hb))
                    self.seq += 1
                    self.rows_emitted += hb.length
                self._wm[wm_key] = wm_hi  # commit after the emit
                if frag.limit is not None and self.rows_emitted >= frag.limit:
                    raise StopStream()
        finally:
            pipe.close()
            self.engine._note_pipeline(pipe, stats)
        return rows

    def _rows_update(self, hb) -> StreamUpdate:
        if self.chain.bridge_id is None:
            return StreamUpdate(table=self.chain.sink_name, batch=hb,
                                seq=self.seq, mode="append")
        from .bridge import RowsPayload

        return StreamUpdate(table=None, batch=RowsPayload(batch=hb),
                            seq=self.seq, mode="rows",
                            bridge_id=self.chain.bridge_id)

    def _ship_state(self, frag, stats: QueryStats, rows: int) -> int:
        """The per-agent half of a distributed live aggregate: ship the
        current partial state to the merge agent (the first poll ships
        even a neutral state: the merge waits to hear from every agent).
        An overflowed state rebuckets and refolds before it ships."""
        from .bridge import AggStatePayload, state_to_host

        if bool(self._state["overflow"]):
            stats.rebuckets += 1
            self._rebucket()
            return self._poll_inner(stats)
        with _timed(stats, "materialize"):
            state = state_to_host(self._state)
        self.emit(StreamUpdate(
            table=None,
            batch=AggStatePayload(
                chain=tuple(self.ops),
                input_relation=self.relation,
                input_dicts=dict(self.dicts),
                state=state,
                dense_domains=frag.dense_domains,
                dense_offsets=frag.dense_offsets,
                dense_strides=frag.dense_strides,
            ),
            seq=self.seq, mode="state", bridge_id=self.chain.bridge_id,
        ))
        self.seq += 1
        return rows

    def run(self, poll_interval_s: float = 0.25, max_rounds=None) -> int:
        """Poll until cancelled, the row limit is met or ``max_rounds``
        polls have run, then end the stream's trace: ``ok``,
        ``cancelled`` or ``error``. Returns the number of updates
        emitted."""
        rounds = 0
        status, error = "ok", ""
        try:
            while True:
                self._check_cancel()
                self.poll()
                rounds += 1
                if max_rounds is not None and rounds >= max_rounds:
                    break
                if self.cancel is not None:
                    if self.cancel.wait(poll_interval_s):
                        status = "cancelled"
                        break
                else:
                    time.sleep(poll_interval_s)
        except StopStream:
            pass  # the row limit is met: a normal end
        except QueryCancelled as e:
            status, error = "cancelled", str(e)
        except BaseException as e:
            status, error = "error", f"{type(e).__name__}: {e}"
            raise
        finally:
            self.close(status=status, error=error)
        return self.seq


class StopStream(Exception):
    """The row limit is met: the stream ends itself (LimitNode's abort
    signal to upstream sources)."""


def stream_query(engine: Engine, query: str, emit, cancel=None,
                 now_ns: int = 0,
                 max_output_rows: int | None = None) -> StreamingQuery:
    """Compile a PxL script into a live StreamingQuery on ``engine``.
    ``max_output_rows=None`` lifts the result sink's row cap (a live
    stream is unbounded); pass a value to cap an append stream."""
    from ..planner import CompilerState, compile_pxl

    state = CompilerState(
        schemas={
            name: t.relation
            for name, t in engine.tables.items()
            if t is not None and len(t.relation)
        },
        registry=engine.registry,
        now_ns=now_ns,
        max_output_rows=max_output_rows or (1 << 62),
        table_stats=engine._compile_table_stats(),
    )
    compiled = compile_pxl(query, state)
    return StreamingQuery(engine, compiled.plan, emit, cancel=cancel,
                          script=query)
