"""Device-side N:M equijoin with fixed output capacities.

A port of the JAX package's ``ops/join.py``. Reference parity:
``src/carnot/exec/equijoin_node.{h,cc}`` — build+probe hash join
supporting inner/left/right/outer with N:M fan-out and chunked output.
The design is sort-based, as in the JAX package:

1. Both sides' key planes map to one exact key-id space by a multi-key
   stable sort over the concatenated rows (no hash collisions).
2. The build side is sorted by key id; ``searchsorted`` gives each probe
   row its contiguous match range [lo, hi).
3. Match ranges expand into a fixed-capacity output via exclusive prefix
   sums and an owner per output slot (the JAX package scatters each
   emitting row's start and takes a cumulative max; the port binary-
   searches the non-decreasing starts, the same rows with int32 slots
   and no [capacity] int64 scan); rows beyond ``capacity`` are dropped and
   flagged (``overflow``) so the caller reruns at twice the capacity —
   the fixed-shape analog of Carnot's growing output chunks.

Every kernel returns gather indices and take-masks, not columns:
(probe_idx, probe_take, build_idx, build_take, out_valid, overflow).
Unmatched sides emit take=False, which callers turn into nulls; where a
take-mask is False the paired index is arbitrary but in bounds. Indices
are int32, masks bool, ``overflow`` a bool device scalar: nothing here
waits for the device.

The JAX package numbers the keys with its hash form and falls back to
its sort form under ``lax.cond`` when the hash table overflows. The
output does not depend on how ids are numbered (each probe row's matches
share one key, the build sort is stable, and right/outer extras follow
build order), so the port always sorts: exact, and no data-dependent
branch to read back. ``ops/scan.py``'s blocked scans only work around a
TPU scoped-memory limit; ``torch.cumsum`` stands in for them.
"""

from __future__ import annotations

import numpy as np
import torch

from .groupby import sorted_key_runs
from .hashtable import _mix64, mix64, shr64

_HOWS = ("inner", "left", "right", "outer")


def _exclusive_cumsum(x):
    """(exclusive cumsum, total) of an integer vector, in int64."""
    c = torch.cumsum(x, 0, dtype=torch.int64)
    return c - x, c[-1]


def _owner_rows(starts, j):
    """Per-output-slot owner row: the last row whose start is <= the
    slot. Starts are exclusive prefix sums (non-decreasing), so among
    rows that share a start only the last can emit, and for every slot
    below the total the owner is the emitting row whose range holds it —
    the row the JAX package's scatter-and-cumulative-max finds. Slots at
    or past the total get an arbitrary row; callers mask them."""
    return torch.clamp(
        torch.searchsorted(starts, j, right=True, out_int32=True) - 1, min=0
    )


def _expand(lo, hi, probe_valid, capacity: int, pad_unmatched: bool, b: int):
    """Expand per-probe match ranges [lo, hi) into the fixed-capacity
    output: (probe_idx, pair_valid, build_pos, is_match, total_pairs),
    with ``build_pos`` a position in the build side's sorted order. The
    [capacity] planes are int32 (capacities stay below 2^31), which
    halves the expansion's memory against int64."""
    c = capacity
    if c >= 1 << 31:
        raise ValueError(f"join output capacity {c} needs 64-bit slots")
    m = torch.where(probe_valid, hi - lo, 0)
    e = torch.clamp(m, min=1) if pad_unmatched else m
    e = torch.where(probe_valid, e, 0)
    start, total_pairs = _exclusive_cumsum(e)
    start_c = torch.clamp(start, max=c).to(torch.int32)
    j = torch.arange(c, dtype=torch.int32, device=lo.device)
    probe_idx = _owner_rows(start_c, j)
    t = j - start_c.index_select(0, probe_idx)
    pair_valid = j < total_pairs
    m_p = m.to(torch.int32).index_select(0, probe_idx)
    is_match = t < m_p
    build_pos = torch.clamp(
        lo.to(torch.int32).index_select(0, probe_idx)
        + torch.minimum(t, m_p - 1), 0, b - 1,
    )
    return probe_idx, pair_valid, build_pos, is_match, total_pairs


def _expand_ranges(lo, hi, probe_valid, capacity: int, how: str, b: int):
    """The shared back half of the windowed probe kernels."""
    probe_idx, pair_valid, build_pos, is_match, total = _expand(
        lo, hi, probe_valid, capacity, how == "left", b
    )
    return (
        probe_idx, pair_valid, build_pos, pair_valid & is_match, pair_valid,
        total > capacity,
    )


def probe_sorted_join(sorted_build_keys, n_build: int, probe_keys, probe_valid,
                      capacity: int, how: str = "inner"):
    """Probe one window against a PRE-SORTED device-resident build side.

    The windowed driver (``exec/joins.py``) packs both sides' keys into
    one comparable int64 id space on the host, sorts the build ids ONCE
    and puts them on the device once per query; each probe window then
    runs only the searchsorted and expansion half of ``device_join``.

    Args:
      sorted_build_keys: int64[B]; entries [0, n_build) ascending, the
        rest padded with int64 max (never matched: ranges clamp to
        ``n_build``).
      n_build: count of real build rows.
      probe_keys / probe_valid: int64[N] ids and bool[N] mask of this
        probe window.
      capacity: output row capacity C.
      how: 'inner' | 'left' (each probe row's output is independent of
        every other window's; right/outer stay single-shot).

    Returns the ``device_join`` tuple, with ``build_idx`` indexing the
    SORTED build order (the join driver maps it back through its host sort
    permutation).
    """
    if how not in ("inner", "left"):
        raise ValueError(f"probe_sorted_join supports inner/left, not {how!r}")
    lo = torch.clamp(
        torch.searchsorted(sorted_build_keys, probe_keys, side="left"),
        max=n_build,
    )
    hi = torch.clamp(
        torch.searchsorted(sorted_build_keys, probe_keys, side="right"),
        max=n_build,
    )
    return _expand_ranges(
        lo, hi, probe_valid, capacity, how, sorted_build_keys.shape[0]
    )


# -- radix-partitioned probe -------------------------------------------------
def radix_partition_build(keys: np.ndarray, radix_bits: int):
    """Host-side build partitioning for ``radix_probe_join``.

    Hashes the packed int64 build keys with splitmix64
    (``ops/hashtable._mix64``) and sorts them by (top ``radix_bits`` of
    the hash, key). Within a partition keys ascend, so a probe row
    binary-searches ONE partition instead of the whole build side.

    Returns (order, part_starts, search_steps):
      order        int64[B] — build-row permutation (sorted position ->
                   original row).
      part_starts  int32[P+1] — partition offsets into the sorted keys
                   (real rows only; padding stays outside every range).
      search_steps trip count of the kernel's bounded binary search:
                   enough for the LARGEST partition, with slack.
    """
    p = 1 << radix_bits
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    h = _mix64(keys.view(np.uint64))
    part = (h >> np.uint64(64 - radix_bits)).astype(np.int64)
    order = np.lexsort((keys, part)).astype(np.int64)
    counts = np.bincount(part, minlength=p)
    part_starts = np.zeros(p + 1, dtype=np.int64)
    np.cumsum(counts, out=part_starts[1:])
    # +1 step of slack over ceil(log2(max+1)): the branchless search
    # no-ops once converged, so slack costs one gather, never wrongness.
    steps = max(4, int(np.ceil(np.log2(int(counts.max()) + 2))) + 1)
    return order, part_starts.astype(np.int32), steps


def _bounded_searchsorted(a, keys, lo0, hi0, steps: int, side: str):
    """Per-row binary search of ``keys`` into ``a`` restricted to
    [lo0, hi0), for a fixed number of steps (extra steps no-op once
    lo == hi)."""
    lo, hi = lo0, hi0
    top = a.shape[0] - 1
    for _ in range(steps):
        mid = (lo + hi) >> 1
        v = a[torch.clamp(mid, 0, top)]
        go = (v < keys) if side == "left" else (v <= keys)
        upd = lo < hi
        lo = torch.where(upd & go, mid + 1, lo)
        hi = torch.where(upd & ~go, mid, hi)
    return lo


def radix_probe_join(sorted_build_keys, part_starts, probe_keys, probe_valid,
                     capacity: int, how: str = "inner", radix_bits: int = 8,
                     search_steps: int = 24):
    """Probe one window against a radix-partitioned device build side.

    The join driver partitions the build side ONCE per query with
    ``radix_partition_build`` and puts ``sorted_build_keys`` (int64[B],
    padded with int64 max) and ``part_starts`` (int32[P+1]) on the
    device; each probe window hashes its keys with the same splitmix64
    (``ops/hashtable.mix64``, bit for bit the host mixer), reads its
    partition's [start, end) and binary-searches only that partition.
    Same output and ``how`` support (inner/left) as
    ``probe_sorted_join``.
    """
    if how not in ("inner", "left"):
        raise ValueError(f"radix_probe_join supports inner/left, not {how!r}")
    if radix_bits > 0:
        p = shr64(mix64(probe_keys), 64 - radix_bits)
    else:  # one partition (a shift by 64 is undefined)
        p = torch.zeros_like(probe_keys)
    starts = part_starts.to(torch.int64)
    lo0 = starts[p]
    hi0 = starts[p + 1]
    lo = _bounded_searchsorted(
        sorted_build_keys, probe_keys, lo0, hi0, search_steps, "left"
    )
    hi = _bounded_searchsorted(
        sorted_build_keys, probe_keys, lo0, hi0, search_steps, "right"
    )
    return _expand_ranges(
        lo, hi, probe_valid, capacity, how, sorted_build_keys.shape[0]
    )


def _key_ids(planes):
    """Dense int64 ids of the rows' key tuples (equal tuples, equal ids)
    by a multi-key stable sort."""
    n, dev = planes[0].shape[0], planes[0].device
    order, is_new = sorted_key_runs(planes, n, dev)
    ids = torch.empty(n, dtype=torch.int64, device=dev)
    ids.scatter_(0, order, torch.cumsum(is_new, 0))
    return ids


def device_join(build_keys, build_valid, probe_keys, probe_valid,
                capacity: int, how: str = "inner"):
    """Join probe (left) rows against build (right) rows on equal keys.

    Args:
      build_keys / probe_keys: lists of [B] / [N] key planes (same plane
        count and dtypes per position; a UINT128 key contributes two).
        Both sides must be non-empty (mask rows invalid instead).
      build_valid / probe_valid: bool masks.
      capacity: output row capacity C.
      how: 'inner' | 'left' | 'right' | 'outer'.

    Returns:
      probe_idx int32[C], probe_take bool[C]  — left-side gather/null
      build_idx int32[C], build_take bool[C]  — right-side gather/null
      out_valid bool[C], overflow bool[]      — occupancy + truncation
    """
    if how not in _HOWS:
        raise ValueError(f"unsupported join how={how!r}")
    b = build_valid.shape[0]
    n = probe_valid.shape[0]
    c = capacity
    if b == 0 or n == 0:
        raise ValueError("device_join sides must be non-empty (mask instead)")

    # 1. Shared exact key-id space; invalid build and invalid probe rows
    # get two different trash ids, so they never match each other.
    cat_keys = [torch.cat([bk, pk]) for bk, pk in zip(build_keys, probe_keys)]
    ids = _key_ids(cat_keys)
    kb = torch.where(build_valid, ids[:b], b + n)
    kp = torch.where(probe_valid, ids[b:], b + n + 1)

    # 2. Sort build by key id; per-probe match ranges.
    perm = torch.argsort(kb, stable=True)  # invalid last
    skb = kb[perm]
    lo = torch.searchsorted(skb, kp, side="left")
    hi = torch.searchsorted(skb, kp, side="right")

    # 3. Expansion: emitted rows per probe row.
    probe_idx, pair_valid, build_pos, is_match, total_pairs = _expand(
        lo, hi, probe_valid, c, how in ("left", "outer"), b
    )
    build_idx = perm.index_select(0, build_pos)
    probe_take = pair_valid
    build_take = pair_valid & is_match
    out_valid = pair_valid
    overflow = total_pairs > c

    if how in ("right", "outer"):
        # Build rows whose key matches no probe row emit once with a null
        # left side, appended after the pair region.
        skp = torch.sort(kp).values
        lo_b = torch.searchsorted(skp, kb, side="left")
        hi_b = torch.searchsorted(skp, kb, side="right")
        unmatched = build_valid & (hi_b == lo_b)
        su, n_extra = _exclusive_cumsum(unmatched.to(torch.int64))
        # The extras region starts at total_pairs: slot j holds the
        # unmatched build row whose rank among them is j - total_pairs
        # (the pair machinery's owner there is stale, so extras override).
        j = torch.arange(c, dtype=torch.int64, device=kb.device)
        q = j - total_pairs
        extra_row = _owner_rows(su, q)
        in_extras = (q >= 0) & (q < n_extra)
        build_idx = torch.where(in_extras, extra_row, build_idx)
        build_take = build_take | in_extras
        probe_take = probe_take & ~in_extras
        out_valid = out_valid | in_extras
        overflow = overflow | (total_pairs + n_extra > c)

    return (
        probe_idx, probe_take, build_idx.to(torch.int32), build_take,
        out_valid, overflow,
    )
