"""Stream and result primitives shared by the engine's execution paths.

A port of the part of the JAX package's ``exec/stream.py`` that the
single-engine path needs: the query errors, the ``_Stream`` unit of
deferred work (a table source plus the chain of fragment ops so far, and
the side tables of its fused lookup joins), the rebucket step (``_double_agg_groups``), the stage timer and
attribution fence (``_timed``, ``_block_if``), and the host-batch
assembly helpers.

Reference parity: the exec-side RowBatch plumbing around Carnot's
ExecNode chain (``src/carnot/exec/exec_node.h``); here a chain becomes
one window fold instead of a node-per-op push loop.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..config import get_flag
from ..types.batch import HostBatch, gather_rows
from ..types.dtypes import DataType, host_dtypes
from ..types.relation import Relation
from ..types.strings import StringDictionary
from .plan import AggOp, MemorySourceOp


class QueryError(Exception):
    pass


class QueryCancelled(QueryError):
    """Raised mid-stream when a query's cancel handle fires (the
    ExecState::keep_running abort path, ``src/carnot/exec/exec_state.h``)."""


@dataclass
class _Stream:
    """A source (the tablets of a table, or a host batch that an earlier
    fragment materialized) plus the chain of fragment ops so far.
    ``side`` holds the query-constant side tables the chain's fused
    lookup joins gather from (device tensors, keyed by reserved names),
    put on the engine's device once per query."""

    relation: Relation
    dicts: dict
    chain: list
    source: object  # list[Table] | HostBatch
    source_op: Optional[MemorySourceOp] = None
    side: dict = field(default_factory=dict)

    def extend(self, op) -> "_Stream":
        return _Stream(
            self.relation, self.dicts, self.chain + [op], self.source,
            self.source_op, dict(self.side),
        )


def _chain_out_relation(stream: _Stream, registry):
    """(relation, dicts) after a stream's pre-stage chain, or None if the
    chain does not bind (the caller falls back to the generic path)."""
    from .fragment import _bind_pre_stage

    try:
        _, rel, dicts = _bind_pre_stage(
            list(stream.chain), stream.relation, dict(stream.dicts), registry
        )
    except Exception:
        return None
    return rel, dicts


def _stream_col_stats(stream: _Stream):
    """Merged per-column (min, max) bounds across the source tablets
    (None when the source is a host batch)."""
    if not isinstance(stream.source, list):
        return None
    merged: dict | None = None
    for t in stream.source:
        ts = t.col_stats
        if not ts:
            continue  # empty tablet: contributes no rows
        if merged is None:
            merged = dict(ts)
        else:
            merged = {
                c: (min(merged[c][0], ts[c][0]), max(merged[c][1], ts[c][1]))
                for c in merged.keys() & ts.keys()
            }
    return merged or None


def _double_agg_groups(stream: _Stream) -> _Stream:
    """The stream with its AggOp's max_groups doubled (a rebucket).
    Raises QueryError past the ``max_groups_limit`` flag."""
    limit = get_flag("max_groups_limit")
    chain = []
    doubled = False
    for op in stream.chain:
        if isinstance(op, AggOp) and not doubled:
            g2 = op.max_groups * 2
            if g2 > limit:
                raise QueryError(
                    f"group-by overflow at max_groups={op.max_groups}; "
                    f"rebucketing past the {limit} cap refused "
                    "(PIXIE_TPU_MAX_GROUPS_LIMIT)"
                )
            chain.append(dataclasses.replace(op, max_groups=g2))
            doubled = True
        else:
            chain.append(op)
    if not doubled:
        raise AssertionError("no AggOp in overflowing chain")
    return _Stream(stream.relation, stream.dicts, chain, stream.source,
                   stream.source_op, dict(stream.side))


@contextlib.contextmanager
def _timed(stats, stage: str):
    """Stage timer: adds the host seconds spent inside it to ``stats``
    under ``stage``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats.add(stage, time.perf_counter() - t0)


def _block_if(stats, device: torch.device) -> None:
    """Wait for the device under an attribution run only.

    A default query has ``stats.sync`` False: stage times still land,
    but the card is never fenced per window, so the prefetch overlap
    survives (the JAX package's no-forced-sync contract). An attribution
    run (``sync=True``) fences the card so each stage's host time covers
    its device work."""
    if stats.sync and device.type == "cuda":
        torch.cuda.synchronize(device)


# -- host-batch assembly ------------------------------------------------------
def _to_host_batch(meta_list, cols, valid, limit=None) -> HostBatch:
    """The rows of ``cols`` where ``valid`` holds (the first ``limit`` of
    them when given), as a host batch. The rows are gathered on the
    device, so only they cross to the host; a uint64 plane (UINT128) is
    gathered through its int64 view and viewed back on the host."""
    idx = torch.nonzero(valid).flatten()
    if limit is not None:
        idx = idx[:limit]
    out_cols: dict = {}
    dicts: dict = {}
    rel_items = []
    for m in meta_list:
        if m.struct_fields is not None:
            planes = cols[m.name][0].index_select(0, idx).cpu().numpy()
            d = StringDictionary()
            ids = np.fromiter(
                (
                    d.get_or_add(json.dumps({
                        f: round(float(v), 6) for f, v in zip(m.struct_fields, row)
                    }))
                    for row in planes
                ),
                dtype=np.int32,
                count=len(planes),
            )
            out_cols[m.name] = (ids,)
            dicts[m.name] = d
            rel_items.append((m.name, DataType.STRING))
            continue
        out_cols[m.name] = tuple(
            gather_rows(p, idx).astype(h, copy=False)
            for p, h in zip(cols[m.name], host_dtypes(m.dtype))
        )
        if m.dict is not None:
            dicts[m.name] = m.dict
        rel_items.append((m.name, m.dtype))
    return HostBatch(
        relation=Relation(rel_items), cols=out_cols, length=len(idx), dicts=dicts
    )


def _empty_host_batch(relation, dicts=None) -> HostBatch:
    cols = {
        n: tuple(np.empty(0, dtype=h) for h in host_dtypes(t))
        for n, t in relation.items()
    }
    return HostBatch(relation=relation, cols=cols, length=0, dicts=dict(dicts or {}))


def _concat_host(pieces, relation) -> HostBatch:
    nonempty = [p for p in pieces if p.length > 0]
    if not nonempty:
        dicts = pieces[0].dicts if pieces else {}
        return _empty_host_batch(relation, dicts)
    pieces = nonempty
    first = pieces[0]
    if len(pieces) == 1:
        return first
    cols = {
        n: tuple(
            np.concatenate([p.cols[n][i] for p in pieces])
            for i in range(len(first.cols[n]))
        )
        for n in first.relation.column_names
    }
    return HostBatch(
        relation=first.relation,
        cols=cols,
        length=sum(p.length for p in pieces),
        dicts=first.dicts,
    )


def _apply_limit(hb: HostBatch, limit) -> HostBatch:
    if limit is None or hb.length <= limit:
        return hb
    return HostBatch(
        relation=hb.relation,
        cols={n: tuple(p[:limit] for p in ps) for n, ps in hb.cols.items()},
        length=limit,
        dicts=hb.dicts,
    )
