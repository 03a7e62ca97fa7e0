"""Agent-mode bridge payloads and their merge: partial-state shipping.

A port of the JAX package's ``exec/bridge.py`` (reference parity: the
GRPCSinkNode/GRPCSourceNode pairs and the UDA ``Serialize`` /
``DeSerialize`` contract, ``src/carnot/exec/grpc_sink_node.h:54``,
``udf/udf.h:99-100``). A data agent ships the carry of its fragment
itself; the merge agent recompiles the same fragment and folds the
states through its associative merge.

The torch design:

- A data agent's group state leaves the card in ONE copy per fragment:
  every leaf of the state tree (``torch.utils._pytree``) is viewed as
  bytes and packed into one device buffer, copied to the host once and
  split back into numpy arrays (``state_to_host``).
- The merge agent prepares each payload on the host in numpy (a
  dense-domain state is expanded to explicit key planes and compacted to
  its live slots; string key ids are remapped into one canonical
  dictionary per column), puts it on its own card in one copy
  (``state_to_device``) and merges with the merge fragment's
  ``merge_states``: the sort form's ``regroup_pair`` / ``scatter_carry``.
  A merge whose live groups overflow ``max_groups`` doubles it, up to
  ``max_groups_limit``, and merges again from the intact states.
- UINT128 keys travel as numpy uint64 planes and come back through the
  int64 view (the card's torch lacks most uint64 kernels).
- An aggregate whose carry holds string ids (not a group key) cannot be
  realigned after the fact: the merge refuses it unless every agent's
  dictionary for that column is the same.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..config import get_flag
from ..types.batch import HostBatch, bucket_capacity
from ..types.dtypes import DataType, device_dtypes
from ..types.strings import NULL_ID, StringDictionary
from .fragment import (
    ColumnMeta,
    _bind_pre_stage,
    _split_chain,
    compile_fragment,
    unpack_dense_slots,
)
from .plan import AggOp
from .stream import (
    QueryError,
    _double_agg_groups,
    _Stream,
    _timed,
    _to_host_batch,
)

# Byte alignment of each leaf inside a packed state buffer: a slice at
# a multiple of 8 can be viewed as any element type.
_ALIGN = 8

_NP_OF_TORCH = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.uint64: np.uint64, torch.float32: np.float32,
    torch.float64: np.float64,
}
_TORCH_OF_NP = {np.dtype(v): k for k, v in _NP_OF_TORCH.items()}


@dataclass
class AggStatePayload:
    """Partial aggregate state shipped across a bridge: the carry tree
    (numpy leaves) plus what the merge agent needs to recompile the same
    fragment and realign string dictionary ids."""

    chain: tuple  # fragment ops [pre..., AggOp]
    input_relation: object  # Relation at the fragment's input
    input_dicts: dict  # {col: StringDictionary} at the fragment's input
    state: dict  # group-state tree, numpy leaves
    # A dense-domain state ships no key planes (the slot index IS the
    # packed key); the producing fragment's domains, offsets and strides
    # let the merge side expand them back to explicit keys.
    dense_domains: tuple = ()
    dense_offsets: tuple = ()
    dense_strides: tuple = ()


@dataclass
class RowsPayload:
    """Materialized rows shipped across a bridge (a row-gather bridge)."""

    batch: HostBatch


@dataclass
class _PendingAggBridge:
    """Aggregate-bridge payloads awaiting their finalize AggOp."""

    payloads: list  # list[AggStatePayload]


def _padded(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def state_to_host(state) -> dict:
    """A device state tree as numpy, in one device -> host copy."""
    leaves, spec = pytree.tree_flatten(state)
    if not leaves:
        return pytree.tree_unflatten([], spec)
    chunks, metas = [], []
    for leaf in leaves:
        flat = leaf.contiguous().reshape(-1)
        if flat.dtype == torch.uint64:
            flat = flat.view(torch.int64)
        raw = flat.view(torch.uint8)
        pad = _padded(raw.numel()) - raw.numel()
        chunks.append(raw)
        if pad:
            chunks.append(raw.new_zeros(pad))
        metas.append((_NP_OF_TORCH[leaf.dtype], tuple(leaf.shape),
                      raw.numel()))
    host = torch.cat(chunks).cpu().numpy()
    out, off = [], 0
    for np_dtype, shape, nbytes in metas:
        out.append(host[off:off + nbytes].view(np_dtype).reshape(shape))
        off += _padded(nbytes)
    return pytree.tree_unflatten(out, spec)


def state_to_device(state, device) -> dict:
    """A numpy state tree on ``device``, in one host -> device copy."""
    leaves, spec = pytree.tree_flatten(state)
    if not leaves:
        return pytree.tree_unflatten([], spec)
    chunks, metas = [], []
    for leaf in leaves:
        a = np.asarray(leaf)
        raw = np.ascontiguousarray(a.reshape(-1)).view(np.uint8)
        chunks.append(raw)
        pad = _padded(raw.size) - raw.size
        if pad:
            chunks.append(np.zeros(pad, dtype=np.uint8))
        metas.append((_TORCH_OF_NP[a.dtype], a.shape, raw.size))
    buf = torch.from_numpy(np.concatenate(chunks)).to(device)
    out, off = [], 0
    for t_dtype, shape, nbytes in metas:
        piece = buf[off:off + nbytes]
        if t_dtype == torch.uint64:
            t = piece.view(torch.int64).view(torch.uint64)
        else:
            t = piece.view(t_dtype)
        out.append(t.reshape(shape))
        off += _padded(nbytes)
    return pytree.tree_unflatten(out, spec)


def payload_nbytes(p) -> int:
    """The plane bytes one bridge payload moves (metadata and
    dictionaries excluded): feeds ``QueryResourceUsage.wire_bytes``."""
    if isinstance(p, RowsPayload):
        return int(sum(a.nbytes for ps in p.batch.cols.values() for a in ps))
    if isinstance(p, AggStatePayload):
        return int(sum(
            np.asarray(leaf).nbytes for leaf in pytree.tree_leaves(p.state)
        ))
    return 0


def bridge_payload(engine, res, stats, cancel=None):
    """A BridgeSink's payload: the partial aggregate state for a chain
    that aggregates, else the fragment's rows (GRPCSinkNode's two
    modes). A group overflow rebuckets before shipping: a payload never
    leaves with lost groups."""
    if isinstance(res, _Stream) and any(isinstance(o, AggOp) for o in res.chain):
        while True:
            frag = engine._compile(res)
            stats.new_fragment(res.chain, frag)
            state = engine._fold_agg_state(res, frag, stats, cancel)
            if not bool(state["overflow"]):
                break
            stats.rebuckets += 1
            res = _double_agg_groups(res)
        with _timed(stats, "materialize"):
            host_state = state_to_host(state)
        return AggStatePayload(
            chain=tuple(res.chain),
            input_relation=res.relation,
            input_dicts=dict(res.dicts),
            state=host_state,
            dense_domains=frag.dense_domains,
            dense_offsets=frag.dense_offsets,
            dense_strides=frag.dense_strides,
        )
    if isinstance(res, HostBatch):
        return RowsPayload(batch=res)
    return RowsPayload(batch=engine._run_fragment(res, stats, cancel))


def bind_bridge(payloads):
    """A BridgeSource's input: the union of row payloads, or the agg
    payloads pending their finalize AggOp."""
    from .joins import _union_host

    payloads = payloads if isinstance(payloads, list) else [payloads]
    if not payloads:
        raise QueryError("bridge received no payloads")
    if all(isinstance(p, RowsPayload) for p in payloads):
        return _union_host([p.batch for p in payloads])
    if all(isinstance(p, AggStatePayload) for p in payloads):
        return _PendingAggBridge(payloads)
    raise QueryError("mixed payload kinds on one bridge")


def _expand_dense_payload(p: AggStatePayload, group_rel, key_plane_index):
    """A dense-domain payload with explicit key planes (numpy), built
    with the producing fragment's unpack arithmetic."""
    if not p.dense_domains:
        return p
    g = len(p.state["valid"])
    planes = unpack_dense_slots(
        torch.arange(g, dtype=torch.int64),
        p.dense_domains,
        [group_rel.col_type(c) for c, _i in key_plane_index],
        p.dense_offsets,
        p.dense_strides,
    )
    return dataclasses.replace(
        p, state={**p.state, "keys": tuple(k.numpy() for k in planes)},
        dense_domains=(), dense_offsets=(), dense_strides=(),
    )


def _compact_payload(p: AggStatePayload) -> AggStatePayload:
    """An expanded payload cut to its live slots (padded to a power of
    two with neutral invalid slots): a dense state is domain-sized
    however few groups are live, and the merge must not inherit that
    capacity."""
    valid = np.asarray(p.state["valid"])
    g = len(valid)
    cap = bucket_capacity(max(int(valid.sum()), 1))
    if cap >= g:
        return p
    idx = np.nonzero(valid)[0]
    if len(idx) < cap:
        # Invalid slots hold the UDA's neutral carry, so any one of them
        # is safe padding.
        fill = int(np.nonzero(~valid)[0][0])
        idx = np.concatenate([idx, np.full(cap - len(idx), fill, np.int64)])

    def take(leaf):
        a = np.asarray(leaf)
        return a[idx] if a.ndim and a.shape[0] == g else a

    return dataclasses.replace(p, state={
        "keys": tuple(take(k) for k in p.state["keys"]),
        "valid": valid[idx],
        "carries": pytree.tree_map(take, p.state["carries"]),
        "overflow": p.state["overflow"],
    })


def _check_string_carries(frag, payloads) -> None:
    """Refuse string ids inside a carry across agents whose dictionaries
    for the source column differ: they cannot be realigned after the
    fact (the reference ships raw strings over GRPC instead)."""
    if not frag.string_carry_sources or len(payloads) < 2:
        return
    for out_name, src_cols in frag.string_carry_sources:
        for c in src_cols:
            d0 = payloads[0].input_dicts.get(c)
            s0 = list(d0.strings) if d0 is not None else None
            for p in payloads[1:]:
                d = p.input_dicts.get(c)
                same = d is d0 or (
                    d is not None and s0 is not None
                    and list(d.strings) == s0
                )
                if not same:
                    raise QueryError(
                        f"aggregate {out_name!r} carries string ids of "
                        f"column {c!r} across agents whose dictionaries "
                        "disagree; results would be garbage. Share one "
                        "dictionary or aggregate after merge."
                    )


def merge_agg_bridge(engine, pending: _PendingAggBridge, stats) -> HostBatch:
    """Merge the shipped partial states on ``engine``'s device and
    finalize. Each agent's string key ids are remapped into one
    canonical dictionary per group column first."""
    p0 = pending.payloads[0]
    pre0, agg0, _post0, _limit0 = _split_chain(list(p0.chain))
    # The group relation and key planes come from binding the pre-stage:
    # no compile is needed before the payload sizes are known.
    _, group_rel, _ = _bind_pre_stage(
        pre0, p0.input_relation, dict(p0.input_dicts), engine.registry
    )
    key_plane_index = tuple(
        (c, i)
        for c in agg0.group_cols
        for i in range(len(device_dtypes(group_rel.col_type(c))))
    )
    payloads = [
        _compact_payload(_expand_dense_payload(p, group_rel, key_plane_index))
        for p in pending.payloads
    ]
    # Merge at the largest payload capacity; an overflow of the union of
    # live groups grows it.
    g = max(
        [op.max_groups for p in payloads for op in p.chain
         if isinstance(op, AggOp)]
        + [len(p.state["valid"]) for p in payloads]
    )

    def merge_fragment(g):
        chain = [
            dataclasses.replace(op, max_groups=g) if isinstance(op, AggOp)
            else op
            for op in p0.chain
        ]
        # The states carry explicit key planes: no dense mode.
        return chain, compile_fragment(
            chain, p0.input_relation, dict(p0.input_dicts), engine.registry,
            engine.device, allow_dense=False,
        )

    chain, frag = merge_fragment(g)
    _check_string_carries(frag, payloads)
    canonical: dict[str, StringDictionary] = {}
    states = []
    for p in payloads:
        _, rel1, dicts1 = _bind_pre_stage(
            pre0, p.input_relation, dict(p.input_dicts), engine.registry
        )
        if tuple(rel1.items()) != tuple(group_rel.items()):
            raise QueryError(f"bridge schema mismatch: {rel1} vs {group_rel}")
        if bool(np.asarray(p.state["overflow"])):
            raise QueryError(
                "bridge payload arrived with group overflow; producing "
                "agent failed to rebucket"
            )
        keys = list(p.state["keys"])
        for pi, (c, i) in enumerate(key_plane_index):
            if group_rel.col_type(c) != DataType.STRING or i != 0:
                continue
            src = dicts1.get(c)
            if src is None:
                continue
            dst = canonical.setdefault(c, StringDictionary())
            remap = np.fromiter(
                (dst.get_or_add(s) for s in src.strings),
                dtype=np.int32, count=len(src),
            )
            ids = np.asarray(keys[pi])
            if len(remap) == 0:
                # An agent with no rows: every slot holds the null id.
                keys[pi] = np.full_like(ids, NULL_ID, dtype=np.int32)
            else:
                keys[pi] = np.where(
                    ids >= 0, remap[np.clip(ids, 0, None)], NULL_ID
                ).astype(np.int32)
        states.append(
            state_to_device({**p.state, "keys": tuple(keys)}, engine.device)
        )
    while True:
        stats.new_fragment(chain, frag)
        with _timed(stats, "compute"):
            acc = frag.init_state()
            for s in states:
                acc = frag.merge_states(acc, s)
        with _timed(stats, "finalize"):
            cols, valid, overflow = frag.finalize(acc)
            overflowed = bool(overflow)
        if not overflowed:
            break
        limit = get_flag("max_groups_limit")
        if g * 2 > limit:
            raise QueryError(
                f"group-by overflow merging bridge states at "
                f"max_groups={g}; rebucketing past the {limit} cap "
                "refused (PIXIE_TPU_MAX_GROUPS_LIMIT)"
            )
        g *= 2
        stats.rebuckets += 1
        chain, frag = merge_fragment(g)
    meta = [
        ColumnMeta(m.name, m.dtype, dict=canonical[m.name])
        if m.name in canonical else m
        for m in frag.out_meta
    ]
    with _timed(stats, "materialize"):
        out = _to_host_batch(meta, cols, valid)
    stats.fragments[-1].rows_out = out.length
    return out
