"""Group-by machinery: exact dense group ids for keys without a static
dense domain.

A port of the JAX package's ``ops/groupby.py``. Reference parity:
Carnot's BlockingAggNode keys an absl flat_hash_map by RowTuple
(``src/carnot/exec/agg_node.h:66``). Two exact device strategies:

- ``dense_group_ids``: a multi-key stable sort and a first-occurrence
  cumsum. No hashing and no host sync; the regroup of two [G] states
  always takes it.
- ``dense_group_ids_hash``: a bounded-probe open-addressing insert on
  the device. Rows claim slots of a 2G-slot table by scatter-min on
  their row index, and slot ranks give dense ids. Exact (full keys are
  compared; the hash only picks the probe order). Probe exhaustion
  reports overflow, which the engine's rebucketing doubles away.

Plus the regroup layer: ``regroup_pair`` aligns two group states (the
accumulated state and a new window's) onto one dense id space, and
``scatter_carry`` moves each UDA carry onto it, so carries merge slot by
slot.

Bits and dtypes. The hash is the JAX package's, bit for bit: wrapping
uint32 arithmetic held in int64 and masked to 32 bits (torch has no
uint32 shift to rely on), a 64-bit plane hashed as its two 32-bit
halves. Torch lacks gathers, scatters, shifts and orderings of uint64
on some devices, so every uint64 plane (a UINT128 column's hi and lo)
is worked on through its int64 view, the same bits, and viewed back as
uint64 in what these functions return. The sort form flips the top bit
of that view, which makes the signed sort order the unsigned one, so
its ids equal the JAX package's even for keys at or above 2^63.
``ops/scan.py``'s blocked scans only work around a TPU scoped-memory
limit; ``torch.cumsum`` stands in for them.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)  # the int64 with only the top bit set


def _i64(p):
    """The int64 view of a uint64 plane (the same bits); others as is."""
    return p.view(torch.int64) if p.dtype == torch.uint64 else p


def _as(p, dtype):
    """Undo ``_i64``: view an int64 result back as ``dtype``."""
    return p.view(torch.uint64) if dtype == torch.uint64 else p


def full_plane(n: int, value, dtype, device):
    """``torch.full`` that also makes uint64 planes (through int64)."""
    if dtype == torch.uint64:
        return torch.full((n,), value, dtype=torch.int64, device=device).view(
            torch.uint64
        )
    return torch.full((n,), value, dtype=dtype, device=device)


def _wide(dtype) -> bool:
    return dtype in (torch.int64, torch.uint64)


def _sortable(plane):
    """A key plane in a form whose signed sort order is the order the JAX
    package sorts it in. Grouping is on bit patterns, so float keys group
    exactly by payload (bit-identical NaNs form one group), matching the
    hash form; -0.0 and +0.0 are one group."""
    if plane.dtype == torch.bool:
        return plane.to(torch.int8)
    if plane.is_floating_point():
        return _to_bits(plane)  # uint32 bits, held non-negative in int64
    if plane.dtype == torch.uint64:
        return plane.view(torch.int64) ^ _SIGN
    return plane


def _to_bits(p):
    """Bit-exact view of a key plane as int64: a 64-bit plane's own bits,
    any other plane's 32 bits as the JAX package's uint32 value (floats
    with -0.0 made +0.0 first, bools 0/1)."""
    if p.dtype == torch.bool:
        return p.to(torch.int64)
    if p.is_floating_point():
        p = torch.where(p == 0, torch.zeros_like(p), p)
        return p.view(torch.int32).to(torch.int64) & _M32
    if _wide(p.dtype):
        return _i64(p)
    return p.to(torch.int64) & _M32


def _from_bits(bits, dtype):
    """Inverse of ``_to_bits`` for a plane of ``dtype``."""
    if dtype == torch.bool:
        return bits != 0
    if _wide(dtype):
        return _as(bits, dtype)
    b32 = torch.where(bits >= (1 << 31), bits - (1 << 32), bits).to(torch.int32)
    return b32.view(dtype) if dtype == torch.float32 else b32.to(dtype)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    if c < (1 << 31):
        return (x * c) & _M32
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """32-bit finalizer (lowbias32) of uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _hash_bits(bit_planes, wides):
    h = torch.full(bit_planes[0].shape, 0x9E3779B9, dtype=torch.int64,
                   device=bit_planes[0].device)
    for b, wide in zip(bit_planes, wides):
        if wide:
            h = _mix32(h ^ (b & _M32))
            h = _mix32(h ^ ((b >> 32) & _M32))
        else:
            h = _mix32(h ^ b)
    return h


def _table_size(max_groups: int) -> int:
    size = 16
    while size < 2 * max_groups:
        size *= 2
    return size


def _gather(p, idx):
    """``p[idx]`` for any key plane (uint64 through its int64 view)."""
    return _as(_i64(p)[idx], p.dtype)


def sorted_key_runs(key_planes, n: int, dev, mask=None):
    """The n rows' stable lexicographic order by their key planes and
    where each key run starts in it.

    Returns (order int64[n]: secondary keys sorted first, primary last,
    then, given a ``mask``, masked rows moved to the end; is_new bool[n]:
    True where a sorted row's key differs from the row before it, False
    at 0).
    """
    planes = [_sortable(p) for p in key_planes]
    order = torch.arange(n, dtype=torch.int64, device=dev)
    for p in reversed(planes):
        order = order[torch.argsort(p[order], stable=True)]
    if mask is not None:  # as int8: there is no sort of bools
        order = order[torch.argsort((~mask[order]).to(torch.int8),
                                    stable=True)]
    is_new = torch.zeros(n, dtype=torch.bool, device=dev)
    for p in planes:
        sp = p[order]
        is_new[1:] |= sp[1:] != sp[:-1]
    return order, is_new


def dense_group_ids(key_planes, mask, max_groups: int):
    """Assign dense group ids by a multi-key stable sort.

    Args:
      key_planes: list of [n] tensors (a UINT128 key contributes two).
      mask: [n] bool; masked rows get id ``max_groups`` (the trash slot).
      max_groups: the group capacity G.

    Returns (gids int32[n] in [0, G) for valid rows and G for the rest,
    group_keys: list of [G] key planes, group_valid bool[G], n_groups:
    int32 device scalar, the true distinct count, which may exceed G:
    ``n_groups > max_groups`` is the overflow). Ids follow the keys'
    sorted order. Nothing here waits for the device.
    """
    n = mask.shape[0]
    dev = mask.device
    order, is_new = sorted_key_runs(key_planes, n, dev, mask)
    sorted_mask = mask[order]
    if key_planes:
        # A fill, not `is_new[0] = True`, which syncs on CUDA.
        is_new[:1].fill_(True)
    is_new &= sorted_mask

    sorted_gid = torch.cumsum(is_new, 0) - 1
    n_groups = is_new.sum().to(torch.int32)
    # Overflowing groups clamp into the last slot; masked rows go to G.
    sorted_gid_c = torch.where(
        sorted_mask, torch.clamp(sorted_gid, 0, max_groups - 1), max_groups
    )
    gids = torch.empty(n, dtype=torch.int64, device=dev)
    gids.scatter_(0, order, sorted_gid_c)

    # First occurrence (in row order) of each group -> its key values.
    # The JAX package takes a segment min of the row index. Here
    # sorted_gid_c ascends, so each group is one run of sorted positions
    # (found by binary search), and the stable sorts leave each group's
    # rows in row order: a run's first row is its least. Only the last
    # slot may hold several groups (overflow clamps them there), so its
    # least row is a masked min over its run. Same ids, no atomics.
    bounds = torch.searchsorted(
        sorted_gid_c,
        torch.arange(max_groups + 1, dtype=torch.int64, device=dev),
    )
    lo, hi = bounds[:-1], bounds[1:]
    group_valid = lo < hi
    first_idx = order[torch.clamp(lo, max=max(n - 1, 0))]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    in_last = (pos >= lo[-1]) & (pos < hi[-1])
    last_min = torch.where(in_last, order, n).amin(0, keepdim=True)
    first_idx = torch.cat([first_idx[:-1], last_min])
    safe_idx = torch.where(group_valid, first_idx, 0)
    group_keys = [_gather(p, safe_idx) for p in key_planes]
    return gids.to(torch.int32), group_keys, group_valid, n_groups


def dense_group_ids_hash(key_planes, mask, max_groups: int,
                         max_rounds: int = 32):
    """``dense_group_ids`` through a device-built open-addressing table.

    Same contract as ``dense_group_ids``, except that ids follow the
    table's (hash) order. Rows linear-probe a 2G-slot table: each round,
    rows whose candidate slot is free race to claim it (scatter-min on
    the row index), the winner publishes its key, and every row whose
    candidate slot now holds its exact key resolves. Rows unresolved
    after ``max_rounds`` report overflow (n_groups > max_groups) so the
    engine rebuckets larger.

    The JAX package runs the rounds in a device loop that stops when no
    row is active. Here the host asks the device whether any row is
    still active after rounds 1, 2, 4, 8, ... below ``max_rounds`` (one
    sync each: five per call at 32 rounds); a round with no active row
    changes nothing, so the answer is the JAX package's exactly.
    """
    n = mask.shape[0]
    dev = mask.device
    if not key_planes:
        # No-group aggregation: every valid row lands in slot 0 (the sort
        # form's degenerate behavior).
        gids = torch.where(mask, 0, max_groups).to(torch.int32)
        group_valid = torch.zeros(max_groups, dtype=torch.bool, device=dev)
        group_valid[0] = mask.any()
        return gids, [], group_valid, torch.zeros((), dtype=torch.int32,
                                                  device=dev)
    size = _table_size(max_groups)
    bit_planes = [_to_bits(p) for p in key_planes]
    wides = [_wide(p.dtype) for p in key_planes]
    base = _hash_bits(bit_planes, wides) & (size - 1)
    iota = torch.arange(n, dtype=torch.int64, device=dev)

    slot_bits = [torch.zeros(size + 1, dtype=torch.int64, device=dev)
                 for _ in bit_planes]
    occupied = torch.zeros(size + 1, dtype=torch.bool, device=dev)
    active = mask.clone()
    row_slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    r, check_at = 0, 1
    while r < max_rounds:
        cand = (base + r) & (size - 1)
        contender = active & ~occupied[cand]
        claim_idx = torch.where(contender, cand, size)
        claims = torch.full((size + 1,), n, dtype=torch.int64, device=dev)
        claims.scatter_reduce_(0, claim_idx, iota, "amin", include_self=True)
        winner = contender & (claims[cand] == iota)
        win_idx = torch.where(winner, cand, size)
        # Scalar fills, not item assignment: on CUDA `t[i] = True` copies
        # the scalar from the host and syncs.
        occupied.index_fill_(0, win_idx, True)
        occupied[size:].fill_(False)
        for sb, b in zip(slot_bits, bit_planes):
            sb[win_idx] = b
        # Resolve rows whose candidate slot now holds their exact key.
        match = active & occupied[cand]
        for sb, b in zip(slot_bits, bit_planes):
            match &= sb[cand] == b
        row_slot = torch.where(match, cand, row_slot)
        active &= ~match
        r += 1
        if r == check_at:
            check_at *= 2
            if r < max_rounds and not bool(active.any()):
                break
    probe_failed = active.any()

    occ = occupied[:size]
    rank = torch.cumsum(occ, 0) - 1
    n_occupied = occ.sum()
    n_groups = torch.where(probe_failed, max_groups + 1, n_occupied).to(
        torch.int32
    )
    # Row ids: the rank of the row's slot, clamped into [0, G) (ranks past
    # G land in the last slot, as in the sort form); masked and
    # unresolved rows get the trash slot G.
    resolved = mask & (row_slot >= 0)
    raw_gid = rank[torch.clamp(row_slot, 0, size - 1)]
    gids = torch.where(
        resolved, torch.clamp(raw_gid, 0, max_groups - 1), max_groups
    ).to(torch.int32)

    # Dense [G] key values from the occupied slots (rank < G).
    dense_idx = torch.where(occ & (rank < max_groups), rank, max_groups)
    group_keys = []
    for sb, p in zip(slot_bits, key_planes):
        dense = torch.zeros(max_groups + 1, dtype=torch.int64, device=dev)
        dense[dense_idx] = sb[:size]
        group_keys.append(_from_bits(dense[:max_groups], p.dtype))
    group_valid = torch.arange(max_groups, device=dev) < torch.clamp(
        n_occupied, max=max_groups
    )
    return gids, group_keys, group_valid, n_groups


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of a carry (a tensor or nested
    tuples of tensors) and the matching leaves of ``rest``."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            _tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)
        )
    return fn(tree, *rest)


def scatter_rows(arr, ids, valid, capacity: int, fill):
    """Scatter the [n]-leading rows of ``arr`` to slots ``ids`` (unique
    among the valid rows); other slots hold ``fill``."""
    a = _i64(arr)
    out = torch.full((capacity + 1,) + tuple(a.shape[1:]), fill,
                     dtype=a.dtype, device=a.device)
    out[torch.where(valid, ids.long(), capacity)] = a
    return _as(out[:capacity], arr.dtype)


def regroup_pair(keys_a, valid_a, keys_b, valid_b, max_groups: int):
    """A shared dense id space for two [G]-slot group states.

    Returns (ids_a, ids_b, merged_keys, merged_valid, n_groups): slot i
    of side A maps to merged slot ids_a[i], likewise for B;
    merged_keys/merged_valid describe the union. Carries are then
    aligned with ``scatter_carry`` and combined with the UDA's
    associative merge (merge(init, x) == x makes empty slots neutral).
    """
    cat_keys = [
        _as(torch.cat([_i64(a), _i64(b)]), a.dtype)
        for a, b in zip(keys_a, keys_b)
    ]
    cat_valid = torch.cat([valid_a, valid_b])
    ids, merged_keys, merged_valid, n_groups = dense_group_ids(
        cat_keys, cat_valid, max_groups
    )
    g = valid_a.shape[0]
    return ids[:g], ids[g:], merged_keys, merged_valid, n_groups


def scatter_carry(carry, ids, valid, capacity: int, init_carry):
    """Align a [G]-leading carry (a tensor or a tuple of them, such as a
    t-digest's [G, k] planes) onto merged slots; empty slots hold
    ``init_carry``'s values."""
    idx = torch.where(valid, ids.long(), capacity)

    def one(arr, init):
        a, i = _i64(arr), _i64(init)
        out = torch.cat([i, torch.zeros((1,) + tuple(a.shape[1:]),
                                        dtype=a.dtype, device=a.device)])
        out[idx] = a
        return _as(out[:capacity], arr.dtype)

    return _tree_map(one, carry, init_carry)
