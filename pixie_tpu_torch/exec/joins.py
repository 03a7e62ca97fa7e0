"""Join routing + union: host N:1 / host N:M / device kernels / fused
in-fragment lookup joins.

A port of the JAX package's ``exec/joins.py``. Reference parity:
``src/carnot/exec/equijoin_node.cc`` (build+probe hash join) and
``union_node.cc`` (k-way ordered merge). Joins route by shape, device
and ingest sketches instead of always hash-joining:

- small unique-key inner/left joins run a host dict join (``host_dict``),
- large N:M joins run a device kernel on a CUDA engine — single-shot
  sort-based (``single``), or the windowed drivers (``sorted``,
  ``radix``) that put the build side on the card once and stream probe
  windows through the prefetch pipeline — and a numpy hash join
  (``host_hash``) on a CPU engine, as the JAX engine does on its CPU
  backend,
- N:1 joins against a dense-domain build side fuse INTO the probe
  stream's fragment as device gathers (``try_fused_join``), so output
  rows never reach the host.

Sketch-guided routing (``choose_join_strategy``): the table store's
ingest sketches (row counts, HLL NDV, zone maps) pick the build side,
estimate the output cardinality to size the first output capacity, and
skip probe windows whose key range cannot meet the build side. Final
capacities persist per plan on the engine (``_join_capacity_cache``), so
a repeated query starts at the rung its last run settled on. The JAX
package's prometheus counters of capacity retries and cache evictions
are counts here: ``JoinDecision.retries`` and the query's
``QueryStats.join_retries`` / ``join_capacity_evictions``.

Host syncs: each device dispatch (the single shot, each probe window)
reads its output back in ONE copy, the overflow flag packed in with the
indices (``_readback``), and compacts on the host. The JAX package's
jit caches per shape become plain calls. The host N:M path
(``host_hash``) is the native build + probe hash join
(``native/hash_join.cc``, built with g++ at first use); the numpy sort /
bincount form serves only sides too long for its i32 row indices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..config import get_flag
from ..native import hash_join_call
from ..types.batch import HostBatch, bucket_capacity, handoff, stage_planes
from ..types.dtypes import DataType, device_dtypes
from ..types.strings import NULL_ID, StringDictionary
from .plan import (
    AggOp,
    ColumnRef,
    FilterOp,
    JoinOp,
    LimitOp,
    LookupJoinOp,
    MapOp,
    trace_map_renames,
)
from .stream import (
    QueryError,
    _chain_out_relation,
    _Stream,
    _timed,
)


def _key_tuples(hb: HostBatch, on, remaps):
    keys = []
    for c in on:
        ids = hb.cols[c][0]
        if c in remaps:
            # Null string ids (-1) must stay null, not wrap to the last entry.
            ids = np.where(
                ids >= 0, remaps[c][np.clip(ids, 0, None)], NULL_ID
            ).astype(ids.dtype)
        keys.append(ids)
    extra = [hb.cols[c][1] for c in on if len(hb.cols[c]) > 1]
    return list(zip(*(list(k) for k in (keys + extra)))) if keys else []


# The windowed driver prefers the radix-partitioned probe over the full
# searchsorted once the build side clears this many rows (below it the
# partition bookkeeping costs more than the shorter binary search saves).
RADIX_MIN_BUILD_ROWS = 1 << 16


# -- sketch-backed side statistics -------------------------------------------
@dataclass
class JoinSideStats:
    """What routing knows about one join input without touching data.

    ``lo``/``hi``/``ndv`` describe the SINGLE key column when the join
    key is one single-plane INT64/STRING column; multi-key joins carry
    rows only. All fields are conservative estimates: rows is an upper
    bound when the stream filters, NDV is HLL (~3% error), zone bounds
    never shrink under expiry.
    """

    rows: int
    lo: int | None = None
    hi: int | None = None
    ndv: int | None = None
    origin: str = "none"  # 'sketch' | 'scan' | 'none'


def _chain_key_sources(chain, on_cols):
    """Trace join key columns back through a stream's op chain to source
    table columns, or None when any op rewrites/aggregates them (then
    ingest sketches no longer describe the key values). The chain is in
    application order, so the walk is in reverse."""
    mapping = {c: c for c in on_cols}
    for op in reversed(chain):
        if isinstance(op, (FilterOp, LimitOp)):
            continue  # values survive, rows only shrink
        if isinstance(op, MapOp):
            mapping = trace_map_renames(op, mapping)
            if mapping is None:
                return None
        else:
            return None
    return mapping


def stream_join_stats(res, on_cols) -> JoinSideStats | None:
    """Ingest-sketch stats for one join input (the stream BEFORE it is
    materialized), or None when the input is not a table-backed stream
    with the key columns passing through unmodified."""
    if not isinstance(res, _Stream) or not isinstance(res.source, list):
        return None
    mapping = _chain_key_sources(res.chain, on_cols)
    if mapping is None:
        return None
    tablets = [t for t in res.source if getattr(t, "sketches", None)]
    if not tablets or len(tablets) != len(res.source):
        return None
    rows = sum(t.sketches.rows for t in tablets)
    stats = JoinSideStats(rows=rows, origin="sketch")
    if len(on_cols) == 1:
        src = mapping[on_cols[0]]
        sks = [t.sketches.col(src) for t in tablets]
        if all(s is not None and s.rows for s in sks):
            stats.lo = min(s.lo for s in sks)
            stats.hi = max(s.hi for s in sks)
            if len(sks) == 1:
                stats.ndv = sks[0].ndv
            else:
                # Cross-tablet NDV: HLL registers merge exactly
                # (elementwise max); never sum per-tablet estimates.
                from ..ops.hll import hll_estimate_np

                reg = sks[0].registers.copy()
                for s in sks[1:]:
                    np.maximum(reg, s.registers, out=reg)
                stats.ndv = max(1, min(hll_estimate_np(reg), rows))
    return stats


def _scan_side_stats(keys: np.ndarray) -> JoinSideStats:
    """Fallback stats computed from packed key ids: exact zone bounds and
    HLL NDV. Used when ingest sketches don't cover an input."""
    from ..ops.hll import hll_estimate_np, hll_init_np, hll_update_np

    n = len(keys)
    if n == 0:
        return JoinSideStats(rows=0, origin="scan")
    reg = hll_init_np()
    hll_update_np(reg, keys)
    return JoinSideStats(
        rows=n, lo=int(keys.min()), hi=int(keys.max()),
        ndv=max(1, min(hll_estimate_np(reg), n)), origin="scan",
    )


# -- learned capacity + retry accounting -------------------------------------
# (mode, plan-hash, node) -> final (post-overflow) output capacity of a
# join node, stored on ``Engine._join_capacity_cache``: a repeated query
# starts at the rung its last run finished on instead of re-climbing the
# doubling ladder. Engine-scoped because the plan fingerprint hashes
# operators, not data. Engine-less driver calls pass cap_key=None and
# learn nothing. Eviction is LRU (dicts are insertion-ordered; a hit
# re-inserts its key at the back) with a hard size cap; evictions are
# counted on the query's stats.
_CAPACITY_LOCK = threading.Lock()
_CAPACITY_CACHE_MAX = 4096


def learned_capacity(engine, cap_key) -> int | None:
    cache = getattr(engine, "_join_capacity_cache", None)
    if cap_key is None or cache is None:
        return None
    with _CAPACITY_LOCK:
        cap = cache.get(cap_key)
        if cap is not None:
            # Refresh recency: re-insert at the back of the order.
            del cache[cap_key]
            cache[cap_key] = cap
        return cap


def remember_capacity(engine, cap_key, capacity: int, qstats=None) -> None:
    cache = getattr(engine, "_join_capacity_cache", None)
    if cap_key is None or cache is None:
        return
    evicted = 0
    with _CAPACITY_LOCK:
        cache.pop(cap_key, None)
        while len(cache) >= _CAPACITY_CACHE_MAX:
            cache.pop(next(iter(cache)))  # LRU: oldest-inserted first
            evicted += 1
        cache[cap_key] = capacity
    if evicted and qstats is not None:
        qstats.join_capacity_evictions += evicted


def _count_retry(decision, qstats) -> None:
    """One overflow retry: the kernel reran at twice the capacity."""
    decision.retries += 1
    if qstats is not None:
        qstats.join_retries += 1


def estimate_join_capacity(probe_rows: int, build: JoinSideStats | None,
                           probe: JoinSideStats | None, how: str,
                           overlap: float | None = None) -> int:
    """Estimated output rows for ``probe_rows`` probe rows against the
    build side: fan-out = build_rows / NDV(build), scaled by the zone
    overlap fraction of the probe range (keys outside the build side's
    [lo, hi] cannot match). ``overlap`` overrides the fraction when the
    caller knows it more precisely (the windowed driver passes the WORST
    surviving window's overlap). Conservative where sketches are
    missing."""
    safety = float(get_flag("join_capacity_safety"))
    if build is None or not build.ndv:
        # No build stats: the historical default (2x probe rows).
        return bucket_capacity(max(2 * probe_rows, 1))
    fanout = build.rows / max(build.ndv, 1)
    if overlap is None:
        overlap = 1.0
        if (
            probe is not None and probe.lo is not None
            and probe.hi is not None
            and build.lo is not None and build.hi is not None
            and probe.hi > probe.lo
        ):
            inter = min(probe.hi, build.hi) - max(probe.lo, build.lo) + 1
            overlap = max(0.0, min(1.0, inter / (probe.hi - probe.lo + 1)))
    est = probe_rows * fanout * overlap
    if how in ("left", "outer"):
        est = max(est, probe_rows)  # unmatched rows still emit
    return bucket_capacity(max(int(est * safety) + 1, 1 << 10))


# -- strategy choice ---------------------------------------------------------
@dataclass
class JoinDecision:
    """Routing outcome, recorded on ``engine.last_join_decision`` so
    callers and tests can see which strategy served a query.
    ``capacity`` is the output capacity the join finished at (per
    window on the windowed paths); ``windows`` counts device dispatches
    that were read back (the single shot, or each probe window)."""

    strategy: str  # degenerate|host_dict|host_hash|single|sorted|radix|fused
    swap: bool = False  # probe the RIGHT side (inner only)
    capacity: int | None = None
    window_rows: int = 0  # probe rows per dispatch (windowed paths)
    zone_skip: bool = False
    retries: int = 0  # overflow retries actually paid
    skipped_windows: int = 0
    windows: int = 0
    reason: str = ""


def _engine_device(engine) -> torch.device:
    if engine is not None:
        return engine.device
    from .engine import resolve_device

    return resolve_device()


def choose_join_strategy(left: HostBatch, right: HostBatch, op: JoinOp,
                         engine=None, left_stats=None, right_stats=None,
                         device_only: bool = False) -> JoinDecision:
    """Pick the N:M execution strategy from shape, device and sketches.

    The host-dict (small unique-key) and degenerate (empty-side) routes
    are resolved by the dispatcher before this is called; this chooses
    among the bulk N:M paths. A CUDA engine never takes ``host_hash``
    under ``auto``: its N:M joins run on the card, as the JAX engine's
    do on the TPU. ``device_only`` skips the host-hash route.
    """
    forced = str(get_flag("join_strategy"))
    window_rows = int(get_flag("join_probe_window_rows"))
    radix_bits = int(get_flag("join_radix_bits"))
    zone_skip = bool(get_flag("join_zone_skip"))
    on_card = _engine_device(engine).type == "cuda"

    if not device_only and op.how in ("inner", "left") and (
        forced == "host" or (forced == "auto" and not on_card)
    ):
        return JoinDecision(
            strategy="host_hash", zone_skip=zone_skip,
            reason="cpu engine" if forced == "auto" else "forced",
        )

    # Build-side swap (inner only: left/right/outer pin the null side).
    # The build side is sorted/partitioned and resident for the whole
    # query while the probe side streams, so build = the side with the
    # LOWER rows x log2(NDV) sort cost, with 4x hysteresis.
    swap = False
    if op.how == "inner" and right.length > 4 * left.length:
        def score(n_rows, st):
            ndv = st.ndv if st is not None and st.ndv else max(n_rows, 2)
            return n_rows * math.log2(max(ndv, 2))

        swap = score(left.length, left_stats) < score(right.length,
                                                      right_stats) / 4
    probe_rows = right.length if swap else left.length

    windowable = (
        op.how in ("inner", "left") and window_rows > 0
        and probe_rows > window_rows
    )
    if forced in ("sorted", "radix", "single"):
        strategy = forced
        if forced != "single" and op.how not in ("inner", "left"):
            strategy = "single"  # right/outer need the global kernel
    elif not windowable:
        strategy = "single"
    else:
        build_rows = left.length if swap else right.length
        strategy = (
            "radix"
            if radix_bits > 0 and build_rows >= RADIX_MIN_BUILD_ROWS
            else "sorted"
        )
    return JoinDecision(
        strategy=strategy, swap=swap and strategy != "single",
        window_rows=window_rows, zone_skip=zone_skip,
        reason="forced" if forced != "auto" else "auto",
    )


def _join_dispatch(left: HostBatch, right: HostBatch, op: JoinOp,
                   engine=None, left_stats=None, right_stats=None,
                   cap_key=None, planned_capacity=None, qstats=None,
                   cancel=None) -> HostBatch:
    """Route a join: host N:1 dict, host N:M hash, or a device strategy
    chosen by ``choose_join_strategy``. ``engine`` carries the device,
    the pipeline depth and the learned-capacity cache; ``qstats`` and
    ``cancel`` are the query's stats and cancel handle;
    ``left_stats``/``right_stats`` are ingest-sketch ``JoinSideStats``;
    ``cap_key`` keys the learned-capacity cache."""
    if len(op.left_on) != len(op.right_on):
        raise QueryError("join key arity mismatch")
    small = left.length + right.length < int(get_flag("device_join_min_rows"))
    if op.how in ("inner", "left") and small:
        try:
            out = _join_host(left, right, op)
            if engine is not None:
                engine.last_join_decision = JoinDecision(
                    strategy="host_dict", reason="small unique-key build"
                )
            return out
        except _BuildNotUnique:
            pass  # N:M fan-out -> bulk strategies
    if left.length == 0 or right.length == 0:
        if engine is not None:
            engine.last_join_decision = JoinDecision(
                strategy="degenerate", reason="empty side"
            )
        return _join_degenerate(left, right, op)

    decision = choose_join_strategy(
        left, right, op, engine, left_stats, right_stats
    )
    if engine is not None:
        engine.last_join_decision = decision
    if decision.strategy == "host_hash":
        return _join_host_nm(left, right, op, right_stats, decision)
    return _join_device(left, right, op, engine, decision,
                        left_stats, right_stats, cap_key,
                        planned_capacity=planned_capacity, qstats=qstats,
                        cancel=cancel)


class _BuildNotUnique(Exception):
    pass


def _align_join_dicts(left, right, op):
    """String-dictionary id remaps so key ids compare across sides.

    Returns (l_remap, r_remap, key_dicts): key_dicts maps a left key
    column to the merged dictionary (union preserves left ids, so pair
    rows stay valid and coalesced build-side ids land past them).
    """
    l_remap: dict = {}
    r_remap: dict = {}
    key_dicts: dict = {}
    for lc, rc in zip(op.left_on, op.right_on):
        ld, rd = left.dicts.get(lc), right.dicts.get(rc)
        if ld is not None and rd is not None and ld is not rd:
            merged, rl, rr = ld.union(rd)
            l_remap[lc], r_remap[rc] = rl, rr
            key_dicts[lc] = merged
    return l_remap, r_remap, key_dicts


def _join_out_schema(left, right, op):
    """(out_rel, ordered (side, src_col) pairs) for join output columns."""
    out_rel = left.relation.merge(
        right.relation.select(
            [c for c in right.relation.column_names if c not in op.right_on]
        ),
        suffix=op.suffix,
    )
    src = [("l", c) for c in left.relation.column_names] + [
        ("r", c) for c in right.relation.column_names if c not in op.right_on
    ]
    return out_rel, src


def _join_degenerate(left, right, op: JoinOp) -> HostBatch:
    """Joins where one side is empty (the device kernel needs real rows)."""
    out_rel, src = _join_out_schema(left, right, op)
    if op.how == "inner" or (op.how == "left" and left.length == 0) or (
        op.how == "right" and right.length == 0
    ):
        keep_l = keep_r = np.zeros(0, dtype=np.int64)
    elif op.how in ("left", "outer") and right.length == 0:
        keep_l, keep_r = np.arange(left.length), np.full(left.length, -1)
    elif op.how in ("right", "outer") and left.length == 0:
        keep_l, keep_r = np.full(right.length, -1), np.arange(right.length)
    else:  # both empty
        keep_l = keep_r = np.zeros(0, dtype=np.int64)
    _, r_remap, key_dicts = _align_join_dicts(left, right, op)
    return _assemble_join(
        left, right, op, out_rel, src,
        keep_l, keep_l >= 0, keep_r, keep_r >= 0,
        r_remap=r_remap, key_dicts=key_dicts,
    )


def _assemble_join(left, right, op, out_rel, src, l_idx, l_take, r_idx, r_take,
                   r_remap=None, key_dicts=None):
    """Gather output columns from per-row indices + take masks.

    Join key columns coalesce (SQL USING semantics): a right/outer extra
    row — whose probe side is null — takes its key from the build side,
    remapped into the merged dictionary for strings.
    """
    r_remap = r_remap or {}
    key_dicts = key_dicts or {}
    key_map = dict(zip(op.left_on, op.right_on))
    out_cols: dict = {}
    out_dicts: dict = {}
    names = iter(out_rel.column_names)
    for side, c in src:
        n = next(names)
        hb = left if side == "l" else right
        idx = l_idx if side == "l" else r_idx
        take = l_take if side == "l" else r_take
        rc = key_map.get(c) if side == "l" else None
        nullv = NULL_ID if hb.relation.col_type(c) == DataType.STRING else 0
        planes = []
        for pi, p in enumerate(hb.cols[c]):
            if len(p) == 0:
                taken = np.full(len(idx), nullv, dtype=p.dtype)
            else:
                taken = p[np.clip(idx, 0, len(p) - 1)]
            if not take.all():
                if rc is not None:
                    q = right.cols[rc][pi]
                    if pi == 0 and rc in r_remap:
                        q = np.where(
                            q >= 0, r_remap[rc][np.clip(q, 0, None)], NULL_ID
                        ).astype(q.dtype)
                    alt = (
                        np.full(len(r_idx), nullv, dtype=p.dtype)
                        if len(q) == 0
                        else q[np.clip(r_idx, 0, len(q) - 1)]
                    )
                    taken = np.where(
                        take, taken, np.where(r_take, alt, nullv)
                    ).astype(p.dtype)
                else:
                    taken = np.where(take, taken, nullv).astype(p.dtype)
            planes.append(taken)
        out_cols[n] = tuple(planes)
        if c in hb.dicts:
            out_dicts[n] = (
                key_dicts.get(c, hb.dicts[c]) if side == "l" else hb.dicts[c]
            )
    return HostBatch(
        relation=out_rel, cols=out_cols, length=len(l_idx), dicts=out_dicts
    )


def _join_key_planes(hb, cols, remaps):
    planes = []
    for c in cols:
        for i, p in enumerate(hb.cols[c]):
            if i == 0 and c in remaps:
                p = np.where(
                    p >= 0, remaps[c][np.clip(p, 0, None)], NULL_ID
                ).astype(p.dtype)
            planes.append(p)
    return planes


def _key_bits(p: np.ndarray) -> np.ndarray:
    """A host key plane as int64 lanes that are equal exactly when the
    keys are: integers widened (uint64 by its bits), bools as 0/1,
    floats by their bits with -0.0 made +0.0 (bit-equal NaNs match, as
    the JAX package's grouping does)."""
    if p.dtype == np.uint64:
        return p.view(np.int64)
    if p.dtype == np.bool_ or np.issubdtype(p.dtype, np.integer):
        return p.astype(np.int64)
    f = np.where(p == 0, 0.0, p).astype(np.float64)
    return f.view(np.int64)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _track_join(kind: str, key: tuple, label: str) -> None:
    """Record one device join dispatch in the program registry
    (``exec/programs.py``), keyed as the JAX drivers' programs are
    (driver, bucketed shapes, capacity, how): the first dispatch of a
    key is its compile, every later one a hit. Eager drivers compile
    nothing, so the compile time is 0."""
    from .programs import default_program_registry

    default_program_registry().observe(kind, key, label)


def _readback(out):
    """Copy one kernel output to the host in ONE transfer (the indices,
    the three masks packed as bits, and the overflow flag) and compact
    it there: (probe_idx, probe_take, build_idx, build_take) of the
    valid output rows as numpy, and the overflow flag as a bool."""
    p_idx, p_take, b_idx, b_take, out_valid, overflow = out
    flags = (
        p_take.to(torch.int32) | (b_take.to(torch.int32) << 1)
        | (out_valid.to(torch.int32) << 2)
    )
    c = p_idx.shape[0]
    host = torch.cat([
        p_idx, b_idx, flags, overflow.reshape(1).to(torch.int32)
    ]).cpu().numpy()
    fl = host[2 * c:3 * c]
    sel = np.flatnonzero(fl & 4)
    fl = fl[sel]
    return (
        host[:c][sel].astype(np.int64), (fl & 1) != 0,
        host[c:2 * c][sel].astype(np.int64), (fl & 2) != 0,
        bool(host[3 * c]),
    )


def _window_zones(keys: np.ndarray, window_rows: int):
    """(lo[W], hi[W]) per probe window — one vectorized pass (the
    windowed drivers' exact zone maps; ingest sketches only gate whether
    this pass is worth running)."""
    n = len(keys)
    offs = np.arange(0, n, window_rows)
    return (
        np.minimum.reduceat(keys, offs),
        np.maximum.reduceat(keys, offs),
    )


def _join_device_windowed(left: HostBatch, right: HostBatch, op: JoinOp,
                          window_rows: int, engine=None, decision=None,
                          left_stats=None, right_stats=None,
                          cap_key=None, qstats=None,
                          cancel=None) -> HostBatch:
    """Multi-window device join driver (inner/left N:M).

    The build side is packed to comparable int64 key ids, then sorted
    (``strategy="sorted"``) or radix-partitioned by splitmix64 hash
    (``strategy="radix"``) and put on the device ONCE per query, on the
    consumer's stream. Probe windows stream through the window-prefetch
    pipeline: the producer thread stages each into pinned buffers and
    copies it on the device's copy stream, and the consumer waits on
    the copy's event (``handoff``) before it probes, so staging window
    N+1 overlaps the kernel on window N. Each window's output is read
    back in one copy, its overflow flag included, and compacted on the
    host. Without a build-side swap, output rows equal the single-shot
    kernel's: windows emit in probe order, and matches within a probe
    row follow build order on every path (both partitionings are stable
    on equal keys). A swap emits the same row multiset in build-major
    order instead.

    The first output capacity comes from the learned per-plan cache,
    else the NDV-based cardinality estimate; windows whose key zone
    cannot meet the build side are never staged (inner skips them
    outright, left emits their null rows on the host); ``decision`` may
    swap probe and build for inner joins.
    """
    from ..ops.join import probe_sorted_join, radix_partition_build, radix_probe_join
    from .pipeline import WindowPipeline

    device = _engine_device(engine)
    if decision is None:
        decision = JoinDecision(strategy="sorted", window_rows=window_rows)
    # The join is a fragment of the query's trace, as in the JAX engine:
    # its live probe windows and rows, its stage times and its output.
    fstats = qstats.new_fragment([op]) if qstats is not None else None

    l_remap, r_remap, key_dicts = _align_join_dicts(left, right, op)
    lkeys, rkeys = _packed_key_ids(left, op.left_on, l_remap,
                                   right, op.right_on, r_remap)
    swap = bool(decision.swap)
    if swap and op.how != "inner":
        raise QueryError("join build-side swap is inner-only")
    pkeys, bkeys = (rkeys, lkeys) if swap else (lkeys, rkeys)
    n_probe = len(pkeys)
    bstats = left_stats if swap else right_stats
    if (
        bstats is None or not bstats.ndv or len(op.left_on) > 1
        or l_remap or r_remap
    ):
        # Multi-plane keys were re-packed into dense ids, and divergent
        # string dictionaries were remapped into a merged id space —
        # table sketches describe RAW values, so their zone bounds no
        # longer apply; rescan the packed ids.
        bstats = _scan_side_stats(bkeys)
    elif bstats.rows > len(bkeys):
        # Sketch rows are table-lifetime counts (expiry/filters shrink
        # the materialized batch); fan-out comes from live rows.
        bstats = dataclasses.replace(bstats, rows=len(bkeys))

    rb = len(bkeys)
    nb = bucket_capacity(rb)
    sentinel = np.iinfo(np.int64).max  # sorts past every real key
    sbk = np.full(nb, sentinel, dtype=np.int64)
    if decision.strategy == "radix":
        radix_bits = int(get_flag("join_radix_bits"))
        order, part_starts, steps = radix_partition_build(bkeys, radix_bits)
        sbk[:rb] = bkeys[order]
        sbk_dev = _to_device(sbk, device)  # once; every window reads it
        starts_dev = _to_device(part_starts, device)

        def probe(pk_dev, pv_dev, cap):
            _track_join(
                "join_probe_radix",
                ("radix", nb, wcap, cap, op.how, radix_bits, steps),
                f"radix nb={nb} w={wcap} cap={cap} {op.how}",
            )
            return radix_probe_join(sbk_dev, starts_dev, pk_dev, pv_dev, cap,
                                    op.how, radix_bits, steps)
    else:
        order = np.argsort(bkeys, kind="stable")
        sbk[:rb] = bkeys[order]
        sbk_dev = _to_device(sbk, device)

        def probe(pk_dev, pv_dev, cap):
            _track_join(
                "join_probe_sorted", ("sorted", nb, wcap, cap, op.how),
                f"sorted nb={nb} w={wcap} cap={cap} {op.how}",
            )
            return probe_sorted_join(sbk_dev, rb, pk_dev, pv_dev, cap, op.how)

    wcap = bucket_capacity(min(window_rows, n_probe))
    n_windows = (n_probe + window_rows - 1) // window_rows

    # Zone-map window skipping: a probe window whose [min, max] cannot
    # meet the build side's key range joins nothing — inner skips it
    # outright (the prefetch thread never stages it), left emits its
    # null rows on the host with no device work.
    skip = np.zeros(n_windows, dtype=bool)
    build_lo = int(bkeys.min()) if rb else 0
    build_hi = int(bkeys.max()) if rb else 0
    window_overlap = None  # worst surviving window's zone overlap
    if n_windows > 1:
        # Per-window zones feed both the skip and the capacity
        # estimate's overlap fraction, which must cover the worst
        # WINDOW, not the probe-wide average.
        wlo, whi = _window_zones(pkeys, window_rows)
        if decision.zone_skip:
            skip = (whi < build_lo) | (wlo > build_hi)
            decision.skipped_windows = int(skip.sum())
        live = ~skip
        if live.any():
            span = np.maximum(whi[live] - wlo[live] + 1, 1)
            inter = (
                np.minimum(whi[live], build_hi)
                - np.maximum(wlo[live], build_lo) + 1
            )
            window_overlap = float(np.clip(inter / span, 0.0, 1.0).max())

    ones = np.ones(min(window_rows, n_probe), dtype=bool)

    def staged_probe_windows():
        for w in range(n_windows):
            if skip[w]:
                continue
            off = w * window_rows
            m = min(window_rows, n_probe - off)
            with _timer(qstats, "stage"):
                (pk_dev, pv_dev), event = stage_planes(
                    [pkeys[off:off + m], ones[:m]], [sentinel, False],
                    [torch.int64, torch.bool], wcap, device,
                )
            if qstats is not None:
                qstats.rows += m
            yield off, pk_dev, pv_dev, event

    probe_side = JoinSideStats(
        rows=n_probe,
        lo=int(pkeys.min()) if n_probe else None,
        hi=int(pkeys.max()) if n_probe else None,
        origin="scan",
    )
    # Namespace the learned rung by execution mode + window size: a
    # windowed rung is PER WINDOW, a single-shot rung covers the whole
    # output.
    cap_key = None if cap_key is None else ("windowed", window_rows, cap_key)
    capacity = learned_capacity(engine, cap_key)
    if capacity is None:
        # Clamp the ESTIMATE (a skew blowup would allocate absurd
        # expansion buffers); a learned value is never clamped.
        capacity = min(
            estimate_join_capacity(
                min(window_rows, n_probe), bstats, probe_side, op.how,
                overlap=window_overlap,
            ),
            bucket_capacity(max(2 * window_rows, 1) * 64),
        )

    parts: dict = {}  # off -> (probe_idx, probe_take, build_row, build_take)
    depth = (
        engine.pipeline_depth if engine is not None
        and engine.pipeline_depth else get_flag("pipeline_depth")
    )
    if qstats is not None and qstats.sync:
        depth = 1
    pipe = WindowPipeline(staged_probe_windows(), depth, cancel=cancel)


    try:
        for off, pk_dev, pv_dev, event in pipe:
            handoff({"k": (pk_dev, pv_dev)}, event, set())
            with _timer(qstats, "compute"):
                while True:
                    # One readback per window: the compacted indices
                    # bound host memory to one window's capacity, and
                    # the overflow flag rides in the same copy.
                    p_idx, p_take, b_idx, b_take, overflow = _readback(
                        probe(pk_dev, pv_dev, capacity)
                    )
                    decision.windows += 1
                    if not overflow:
                        break
                    # The estimate or learned rung was low: double, and
                    # keep the larger capacity for every later window.
                    capacity *= 2
                    _count_retry(decision, qstats)
            if qstats is not None:
                qstats.windows += 1
            parts[off] = (
                p_idx + off, p_take,
                order[np.clip(b_idx, 0, max(rb - 1, 0))], b_take,
            )
    finally:
        pipe.close()
        if engine is not None and qstats is not None:
            engine._note_pipeline(pipe, qstats)

    if op.how == "left":
        # Zone-skipped windows of a left join still emit one null-right
        # row per probe row — assembled on the host, no device dispatch.
        for w in np.nonzero(skip)[0]:
            off = int(w) * window_rows
            m = min(window_rows, n_probe - off)
            parts[off] = (
                np.arange(off, off + m, dtype=np.int64),
                np.ones(m, dtype=bool),
                np.zeros(m, dtype=np.int64),
                np.zeros(m, dtype=bool),
            )
    remember_capacity(engine, cap_key, capacity, qstats)
    decision.capacity = capacity

    ordered = [parts[off] for off in sorted(parts)]

    def cat(i, dtype):
        if not ordered:
            return np.zeros(0, dtype=dtype)
        return np.concatenate([p[i] for p in ordered]).astype(
            dtype, copy=False
        )

    p_all = (cat(0, np.int64), cat(1, bool))
    b_all = (cat(2, np.int64), cat(3, bool))
    l_idx, l_take = (b_all if swap else p_all)
    r_idx, r_take = (p_all if swap else b_all)
    out_rel, src = _join_out_schema(left, right, op)
    out = _assemble_join(
        left, right, op, out_rel, src,
        l_idx, l_take, r_idx, r_take,
        r_remap=r_remap, key_dicts=key_dicts,
    )
    if fstats is not None:
        fstats.rows_out = out.length
    return out


def _timer(qstats, stage: str):
    """``_timed`` when the call belongs to a query, else nothing."""
    return _timed(qstats, stage) if qstats is not None else contextlib.nullcontext()


def _join_device(left: HostBatch, right: HostBatch, op: JoinOp,
                 engine=None, decision=None, left_stats=None,
                 right_stats=None, cap_key=None,
                 planned_capacity=None, qstats=None,
                 cancel=None) -> HostBatch:
    """N:M device join: pad to bucketed capacities, run the sort-based
    kernel at the sketch-estimated (or learned) capacity, rerun doubled
    on overflow (counted), gather columns on the host. Large windowable
    probes route to the windowed drivers instead."""
    from ..ops.join import device_join

    device = _engine_device(engine)
    if decision is None or decision.strategy == "host_hash":
        decision = choose_join_strategy(
            left, right, op, engine, left_stats, right_stats,
            device_only=True,
        )
        if engine is not None:
            engine.last_join_decision = decision
    probe_window = get_flag("join_probe_window_rows")
    probe_rows = right.length if decision.swap else left.length
    if (
        decision.strategy in ("sorted", "radix")
        and op.how in ("inner", "left")
        and probe_window > 0
        and probe_rows > probe_window
        and left.length > 0
        and right.length > 0
    ):
        # Same key-dtype guard as the single-shot path below — the
        # packed-id densify would otherwise paper over a mismatch via
        # numpy promotion (int64 vs float64 collides above 2^53).
        for lc, rc in zip(op.left_on, op.right_on):
            for lp_, rp_ in zip(left.cols[lc], right.cols[rc]):
                if lp_.dtype != rp_.dtype:
                    raise QueryError(
                        f"join key dtype mismatch: {rp_.dtype} vs {lp_.dtype}"
                    )
        return _join_device_windowed(
            left, right, op, probe_window, engine, decision,
            left_stats, right_stats, cap_key, qstats=qstats, cancel=cancel,
        )
    l_remap, r_remap, key_dicts = _align_join_dicts(left, right, op)
    probe_planes = _join_key_planes(left, op.left_on, l_remap)
    build_planes = _join_key_planes(right, op.right_on, r_remap)
    for bp, pp in zip(build_planes, probe_planes):
        if bp.dtype != pp.dtype:
            raise QueryError(
                f"join key dtype mismatch: {bp.dtype} vs {pp.dtype}"
            )

    nb, np_ = bucket_capacity(right.length), bucket_capacity(left.length)

    def pad(p, cap):
        out = np.zeros(cap, dtype=np.int64)
        out[: len(p)] = _key_bits(p)
        return _to_device(out, device)

    bk = [pad(p, nb) for p in build_planes]
    pk = [pad(p, np_) for p in probe_planes]
    bv = torch.arange(nb, device=device) < right.length
    pv = torch.arange(np_, device=device) < left.length

    # First capacity: learned rung, else the NDV-based estimate, else the
    # probe+build default. right/outer append one extra row per
    # unmatched build row past the pair region. Single-shot rungs cover
    # the WHOLE output and are namespaced apart from windowed ones.
    cap_key = None if cap_key is None else ("single", cap_key)
    capacity = learned_capacity(engine, cap_key)
    if capacity is None:
        if right_stats is not None and right_stats.ndv:
            # Sketch rows are table-LIFETIME counts; fan-out comes from
            # the rows actually materialized. Divergent string
            # dictionaries were remapped into a merged id space, so only
            # the NDV/rows half of the sketches applies there.
            remapped = bool(l_remap or r_remap)
            capacity = estimate_join_capacity(
                left.length,
                dataclasses.replace(
                    right_stats, rows=min(right_stats.rows, right.length)
                ),
                left_stats, op.how,
                overlap=1.0 if remapped else None,
            )
            if op.how in ("right", "outer"):
                capacity = bucket_capacity(capacity + right.length)
            # Clamp to the theoretical maximum output.
            capacity = min(
                capacity, bucket_capacity(max(left.length, 1) * right.length)
            )
        elif planned_capacity:
            # A plan-time estimate, clamped like the run-time one.
            capacity = min(
                bucket_capacity(max(int(planned_capacity), 1)),
                bucket_capacity(max(left.length, 1) * right.length),
            )
        else:
            capacity = bucket_capacity(max(left.length + right.length, 1))
    with _timer(qstats, "compute"):
        while True:
            _track_join(
                "join_single_shot",
                ("single", nb, np_, len(bk), capacity, op.how),
                f"single nb={nb} np={np_} cap={capacity} {op.how}",
            )
            p_idx, p_take, b_idx, b_take, overflow = _readback(
                device_join(bk, bv, pk, pv, capacity, op.how)
            )
            decision.windows += 1
            if not overflow:
                break
            capacity *= 2
            _count_retry(decision, qstats)
    remember_capacity(engine, cap_key, capacity, qstats)
    decision.capacity = capacity

    out_rel, src = _join_out_schema(left, right, op)
    return _assemble_join(
        left, right, op, out_rel, src, p_idx, p_take, b_idx, b_take,
        r_remap=r_remap, key_dicts=key_dicts,
    )


def _join_host(left: HostBatch, right: HostBatch, op: JoinOp) -> HostBatch:
    """N:1 equijoin on the host (post-agg inputs are small).

    Reference: ``src/carnot/exec/equijoin_node.cc`` build+probe — here the
    build side must be unique on the key (raises _BuildNotUnique for the
    dispatcher to fall through to the bulk strategies).
    """
    l_remap, r_remap, _ = _align_join_dicts(left, right, op)

    lk = _key_tuples(left, op.left_on, l_remap)
    rk = _key_tuples(right, op.right_on, r_remap)
    lookup: dict = {}
    for i, k in enumerate(rk):
        if k in lookup:
            raise _BuildNotUnique(op.right_on, k)
        lookup[k] = i

    match = np.fromiter((lookup.get(k, -1) for k in lk), dtype=np.int64,
                        count=len(lk))
    if op.how == "inner":
        l_idx = np.nonzero(match >= 0)[0]
    elif op.how == "left":
        l_idx = np.arange(left.length)
    else:
        raise QueryError(f"unsupported join how={op.how!r}")
    r_idx = match[l_idx]
    return _assemble_join_host(left, right, op, l_idx, r_idx)


def _join_host_nm(left: HostBatch, right: HostBatch, op: JoinOp,
                  right_stats=None, decision=None) -> HostBatch:
    """N:M inner/left equijoin on the host — a CPU engine's bulk path:
    the native hash join (``native/hash_join.cc``), or, for sides past
    its i32 row indices, the numpy sort/searchsorted form or bincount
    offsets over a dense key range.

    Zone pre-filter (the host analog of the windowed drivers' window
    skipping): rows whose key lies outside the other side's [min, max]
    cannot join — inner drops them from the probe, both hows drop them
    from the build, so a selective join hashes only the overlap."""
    l_remap, r_remap, _ = _align_join_dicts(left, right, op)
    lkeys, rkeys = _packed_key_ids(left, op.left_on, l_remap,
                                   right, op.right_on, r_remap)

    sel_l = sel_r = None  # compressed-row -> original-row maps
    if (
        decision is not None and decision.zone_skip
        and len(lkeys) and len(rkeys)
    ):
        llo, lhi = int(lkeys.min()), int(lkeys.max())
        rlo, rhi = int(rkeys.min()), int(rkeys.max())
        if op.how == "inner" and (llo < rlo or lhi > rhi):
            keep = (lkeys >= rlo) & (lkeys <= rhi)
            if int(keep.sum()) < int(0.9 * len(lkeys)):
                sel_l = np.nonzero(keep)[0]
                lkeys = lkeys[sel_l]
        if rlo < llo or rhi > lhi:
            keep = (rkeys >= llo) & (rkeys <= lhi)
            if int(keep.sum()) < int(0.9 * len(rkeys)):
                sel_r = np.nonzero(keep)[0]
                rkeys = rkeys[sel_r]

    def _emit(l_idx, r_idx):
        if sel_l is not None:
            l_idx = sel_l[l_idx]
        if sel_r is not None and len(sel_r):
            r_idx = np.where(r_idx >= 0, sel_r[np.clip(r_idx, 0, None)], -1)
        return _assemble_join_host(left, right, op, l_idx, r_idx)

    if op.how == "left" and len(lkeys) and not len(rkeys):
        # The pre-filter emptied the build side: every probe row is
        # unmatched (the generic path below assumes a non-empty build).
        return _emit(
            np.arange(left.length, dtype=np.int64),
            np.full(left.length, -1, dtype=np.int64),
        )
    if op.how == "inner" and (not len(lkeys) or not len(rkeys)):
        return _emit(
            np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
        )

    if len(rkeys) and len(lkeys):
        native = hash_join_call(rkeys, lkeys, left_outer=(op.how == "left"))
        if native is not None:
            l_idx, r_idx = native
            return _emit(l_idx.astype(np.int64), r_idx.astype(np.int64))
    order = np.argsort(rkeys, kind="stable")
    span = 0
    if len(rkeys) and len(lkeys):
        kmin = min(int(rkeys.min()), int(lkeys.min()))
        kmax = max(int(rkeys.max()), int(lkeys.max()))
        span = kmax - kmin + 1
    if 0 < span <= 4 * (len(lkeys) + len(rkeys)):
        # Dense key range: bincount + cumsum offsets replace the two
        # binary searches.
        kcounts = np.bincount(rkeys - kmin, minlength=span)
        key_starts = np.zeros(span + 1, dtype=np.int64)
        np.cumsum(kcounts, out=key_starts[1:])
        lo = key_starts[lkeys - kmin]
        counts = kcounts[lkeys - kmin]
        hi = lo + counts
    else:
        srk = rkeys[order]
        lo = np.searchsorted(srk, lkeys, side="left")
        hi = np.searchsorted(srk, lkeys, side="right")
        counts = hi - lo
    if op.how == "left":
        counts = np.maximum(counts, 1)  # unmatched keep one null row
        unmatched = (hi - lo) == 0
    total = int(counts.sum())
    starts = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    l_idx = np.repeat(np.arange(len(lkeys), dtype=np.int64), counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(starts[:-1], counts)
    if len(rkeys):
        r_idx = order[
            np.clip(np.repeat(lo, counts) + within, 0, len(rkeys) - 1)
        ]
    else:
        r_idx = np.full(total, -1, dtype=np.int64)
    if op.how == "left" and len(rkeys):
        r_idx = np.where(np.repeat(unmatched, counts), -1, r_idx)
    return _emit(l_idx, r_idx)


def _packed_key_ids(left, left_on, l_remap, right, right_on, r_remap):
    """Dense i64 key ids comparable across both sides (np.unique over the
    stacked key planes of the concatenated inputs)."""
    def planes(b, cols, remap):
        out = []
        for c in cols:
            for i, p in enumerate(b.cols[c]):
                q = p
                if i == 0 and c in remap:
                    q = remap[c][np.clip(p, 0, None)]
                    q = np.where(p >= 0, q, NULL_ID)
                out.append(np.asarray(q))
        return out
    lp = planes(left, left_on, l_remap)
    rp = planes(right, right_on, r_remap)
    if (
        len(lp) == 1
        and np.issubdtype(lp[0].dtype, np.integer)
        and np.issubdtype(rp[0].dtype, np.integer)
    ):
        # Single-plane INTEGER keys compare directly (the int64 cast is
        # equality-preserving, wrapping uints bijectively). Floats must
        # densify: casting would truncate 1.2 and 1.7 onto one key.
        return (lp[0].astype(np.int64, copy=False),
                rp[0].astype(np.int64, copy=False))
    # Exact densify: per-plane np.unique codes (lossless for ANY dtype),
    # then one unique over the code tuples for multi-plane keys.
    codes = []
    for a, b in zip(lp, rp):
        _, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
        codes.append(inv.astype(np.int64).reshape(-1))
    if len(codes) == 1:
        inv = codes[0]
    else:
        _, inv = np.unique(
            np.stack(codes, axis=1), axis=0, return_inverse=True
        )
        inv = inv.astype(np.int64).reshape(-1)
    return inv[: left.length], inv[left.length:]


def _assemble_join_host(left, right, op, l_idx, r_idx) -> HostBatch:
    """Row assembly for the host N:1 / N:M paths (r_idx=-1 -> null)."""
    out_rel = left.relation.merge(
        right.relation.select(
            [c for c in right.relation.column_names if c not in op.right_on]
        ),
        suffix=op.suffix,
    )
    out_cols: dict = {}
    out_dicts: dict = {}
    names = iter(out_rel.column_names)
    for c in left.relation.column_names:
        n = next(names)
        out_cols[n] = tuple(p[l_idx] for p in left.cols[c])
        if c in left.dicts:
            out_dicts[n] = left.dicts[c]
    for c in right.relation.column_names:
        if c in op.right_on:
            continue
        n = next(names)
        planes = []
        nullv = NULL_ID if right.relation.col_type(c) == DataType.STRING else 0
        for p in right.cols[c]:
            if len(p) == 0:  # empty build side: all-null fill
                taken = np.full(len(l_idx), nullv, dtype=p.dtype)
            else:
                taken = p[np.clip(r_idx, 0, None)]
                if op.how == "left":
                    taken = np.where(r_idx >= 0, taken, nullv).astype(p.dtype)
            planes.append(taken)
        out_cols[n] = tuple(planes)
        if c in right.dicts:
            out_dicts[n] = right.dicts[c]
    return HostBatch(
        relation=out_rel, cols=out_cols, length=len(l_idx), dicts=out_dicts
    )


def _union_host(mats) -> HostBatch:
    """Schema-aligned union with dictionary re-encoding.

    When the schema carries a ``time_`` column the result is merged in
    time order — the reference UnionNode's k-way ordered merge
    (``src/carnot/exec/union_node.cc``); a stable sort over the
    concatenation is equivalent given each input is itself time-ordered.
    """
    first = mats[0]
    for m in mats[1:]:
        if tuple(m.relation.column_names) != tuple(first.relation.column_names):
            raise QueryError("union inputs must share a schema")
    out_cols: dict = {}
    out_dicts: dict = {}
    for c, dt in first.relation.items():
        if dt == DataType.STRING:
            merged = StringDictionary()
            planes = []
            for m in mats:
                d = m.dicts.get(c, StringDictionary())
                # union preserves existing ids (append-only), so earlier
                # planes stay valid as merged grows.
                merged, _, remap = merged.union(d)
                ids = m.cols[c][0]
                planes.append(
                    np.where(ids >= 0, remap[np.clip(ids, 0, None)],
                             NULL_ID).astype(np.int32)
                )
            out_cols[c] = (np.concatenate(planes),)
            out_dicts[c] = merged
        else:
            out_cols[c] = tuple(
                np.concatenate([m.cols[c][i] for m in mats])
                for i in range(len(first.cols[c]))
            )
    if first.relation.has_column("time_"):
        order = np.argsort(out_cols["time_"][0], kind="stable")
        if not np.array_equal(order, np.arange(len(order))):
            out_cols = {
                c: tuple(p[order] for p in ps) for c, ps in out_cols.items()
            }
    return HostBatch(
        relation=first.relation,
        cols=out_cols,
        length=sum(m.length for m in mats),
        dicts=out_dicts,
    )


# -- fused lookup join --------------------------------------------------------
def try_fused_join(engine, nid, node, results, consumers, qstats=None,
                   cancel=None):
    """N:1 join as an in-fragment device lookup, or None to fall back.

    Reference contrast: ``equijoin_node.cc`` materializes output rows
    through a host hash map; here, when the build side resolves to a
    dense-domain table, the probe stream keeps flowing — each window
    gathers the build columns on the device and the downstream
    Map/Filter/Agg run in the same fragment. The side tables go onto
    the engine's device once per query (``Engine._put_side``).
    """
    op = node.op
    if op.how not in ("inner", "left") or len(op.left_on) != 1:
        return None
    left_id, right_id = node.inputs
    left_res = results[left_id]
    if not isinstance(left_res, _Stream) or consumers.get(left_id, 0) > 1:
        return None
    if any(isinstance(o, (AggOp, LimitOp)) for o in left_res.chain):
        return None
    lc, rc = op.left_on[0], op.right_on[0]
    bound = _chain_out_relation(left_res, engine.registry)
    if bound is None:
        return None
    left_rel, left_dicts = bound
    if not left_rel.has_column(lc):
        return None
    l_dt = left_rel.col_type(lc)
    if len(device_dtypes(l_dt)) != 1:
        return None

    right_res = results[right_id]
    if (
        isinstance(right_res, _Stream)
        and consumers.get(right_id, 0) <= 1
        and any(isinstance(o, AggOp) for o in right_res.chain)
    ):
        built = _dense_agg_build(engine, right_res, op, l_dt, left_dicts,
                                 lc, rc, qstats, cancel)
        if isinstance(built, tuple) and built[0] == "fallback":
            # The aggregate already executed; keep its rows for the
            # generic join path rather than re-folding the stream.
            results[right_id] = built[1]
            built = _host_table_build(
                built[1], op, l_dt, left_dicts, lc, rc
            )
    else:
        if not isinstance(right_res, HostBatch):
            return None
        built = _host_table_build(right_res, op, l_dt, left_dicts, lc, rc)
    if built is None:
        return None
    lo, dom, found, value_tables, right_rel = built

    # Output naming: all left columns keep their names; right value
    # columns (minus the key) merge with the join suffix — the schema
    # ``_join_out_schema`` produces for the host paths.
    try:
        out_rel = left_rel.merge(
            right_rel.select(
                [c for c in right_rel.column_names if c not in op.right_on]
            ),
            suffix=op.suffix,
        )
    except Exception:
        return None
    value_srcs = [c for c in right_rel.column_names if c not in op.right_on]
    out_names = out_rel.column_names[len(left_rel.column_names):]

    out_cols = []
    side: dict = {}
    prefix = f"__lj{nid}"
    for src, out_name in zip(value_srcs, out_names):
        dt = right_rel.col_type(src)
        if dt == DataType.STRING:
            return None  # string values need mid-chain dict plumbing
        planes = value_tables[src]
        out_cols.append((out_name, dt, len(planes)))
        for j, p in enumerate(planes):
            side[f"{prefix}:{out_name}:{j}"] = p
    side[f"{prefix}:found"] = found

    lj = LookupJoinOp(
        key_col=lc, how=op.how, prefix=prefix, lo=int(lo), dom=int(dom),
        out_cols=tuple(out_cols),
    )
    st = left_res.extend(lj)
    st.side.update({k: engine._put_side(v) for k, v in side.items()})
    return st


def _dense_agg_build(engine, right_stream, op, l_dt, left_dicts, lc, rc,
                     qstats=None, cancel=None):
    """Build lookup tables straight from a dense aggregate's device
    state: the slot-aligned finalize output IS the table (slot =
    key - lo), so the build side never visits the host."""
    if any(isinstance(o, LimitOp) for o in right_stream.chain):
        return None
    frag_probe = engine._compile(right_stream)
    if (
        not frag_probe.is_agg
        or len(frag_probe.dense_domains) != 1
        or frag_probe.dense_strides not in ((), (1,))
        or frag_probe.limit is not None
    ):
        # (strided domains step-index their slots; the LookupJoinOp
        # gather arithmetic assumes stride 1.)
        return None
    # The dense slot space must be the probe key's own code space.
    agg_i = next(
        i for i, o in enumerate(right_stream.chain) if isinstance(o, AggOp)
    )
    agg = right_stream.chain[agg_i]
    if tuple(agg.group_cols) != (rc,):
        return None
    # Post-agg ops must leave the key column untouched — the slot
    # arithmetic pairs probe keys with SLOT indices.
    for o in right_stream.chain[agg_i + 1:]:
        if isinstance(o, MapOp):
            key_expr = dict(o.exprs).get(rc)
            if key_expr != ColumnRef(rc):
                return None
    out_rel = frag_probe.relation
    if rc not in out_rel.column_names:
        return None
    if out_rel.col_type(rc) != l_dt:
        return None
    if l_dt == DataType.STRING:
        meta = next(m for m in frag_probe.out_meta if m.name == rc)
        if left_dicts.get(lc) is not meta.dict:
            return None
    if any(m.struct_fields for m in frag_probe.out_meta):
        return None
    # Run the PROBE's fragment, not a recompile: an append racing
    # between two compiles would give the run a different dense domain
    # than the lo/dom captured here. A racing append past the captured
    # domain surfaces as the overflow flag and takes the reject path.
    cols, valid, overflow = engine._fold_finalize(
        right_stream, frag_probe, qstats, cancel
    )
    reject = bool(overflow)  # stats raced an append (one read)
    value_tables = {
        n: tuple(cols[n])
        for n in out_rel.column_names
        if n != rc and n in cols
    }
    if set(value_tables) != {c for c in out_rel.column_names if c != rc}:
        reject = True
    if reject:
        # Don't discard the executed aggregate: hand the (rebucketed if
        # needed) rows back so the generic join path reuses them.
        return ("fallback", engine._agg_result(
            right_stream, frag_probe, cols, valid, overflow, qstats, cancel,
        ))
    return (
        frag_probe.dense_offsets[0], frag_probe.dense_domains[0],
        valid, value_tables, out_rel,
    )


_NP_DTYPES = {
    torch.bool: np.bool_, torch.int32: np.int32, torch.int64: np.int64,
    torch.float32: np.float32, torch.uint64: np.uint64,
}


def _host_table_build(right_hb, op, l_dt, left_dicts, lc, rc):
    """Build dense lookup tables from a materialized unique-key host
    batch (the post-agg N:1 case arriving as rows)."""
    if not right_hb.relation.has_column(rc):
        return None
    if right_hb.relation.col_type(rc) != l_dt:
        return None
    if right_hb.length == 0:
        return None
    kb = np.asarray(right_hb.cols[rc][0])
    if l_dt == DataType.STRING:
        ld = left_dicts.get(lc)
        rd = right_hb.dicts.get(rc)
        if ld is None or rd is None:
            return None
        if rd is not ld:
            # Re-express build keys in the probe's id space without
            # growing it: unseen keys can never match a probe row.
            remap = np.fromiter(
                (ld.lookup(s) for s in rd.strings),
                dtype=np.int64, count=len(rd),
            )
            kb = np.where(kb >= 0, remap[np.clip(kb, 0, None)], -1)
        lo, dom = 0, len(ld) + 1
        in_dom = kb >= 0
    elif l_dt in (DataType.INT64, DataType.TIME64NS):
        lo, hi = int(kb.min()), int(kb.max())
        dom = hi - lo + 1
        if dom > get_flag("int_dense_domain_limit"):
            return None
        in_dom = np.ones(len(kb), dtype=bool)
    else:
        return None
    idx = np.where(in_dom, kb - lo, 0)
    found = np.zeros(dom, dtype=bool)
    # Uniqueness: a duplicate build key means N:M — not this path.
    found[idx[in_dom]] = True
    if int(found.sum()) != int(in_dom.sum()):
        return None

    value_tables = {}
    for c in right_hb.relation.column_names:
        if c == rc:
            continue
        ddts = device_dtypes(right_hb.relation.col_type(c))
        planes = []
        for p, ddt in zip(right_hb.cols[c], ddts):
            # Device dtype, not host: FLOAT64 host planes are f64 but
            # the device-plane invariant is f32.
            p = np.asarray(p)
            t = np.zeros(dom, dtype=_NP_DTYPES[ddt])
            if len(p):
                t[idx[in_dom]] = p[in_dom]
            planes.append(t)
        value_tables[c] = tuple(planes)
    return lo, dom, found, value_tables, right_hb.relation

