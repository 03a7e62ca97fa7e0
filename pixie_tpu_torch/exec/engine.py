"""Query engine: PxL script -> plan -> windowed fold on the device.

A port of the single-engine main path of the JAX package's
``exec/engine.py`` (``Engine.execute_query``): compile the script, read
the source table's windows from the table store, copy each window to the
device, fold it into the fragment's group state, and finalize the state
into a host ``HostBatch``. Windows run serially.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
without a card it raises rather than carrying on on the CPU. The result
cache, views, the window pipeline, joins, unions, the native CPU fold and
streaming are later slices of the port.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..config import get_flag
from ..types.batch import HostBatch, bucket_capacity
from ..types.dtypes import DataType, host_dtypes
from ..types.relation import Relation
from ..types.strings import StringDictionary
from ..udf.registry import Registry, default_registry
from .fragment import compile_fragment
from .plan import (
    AggOp,
    ColumnRef,
    FilterOp,
    LimitOp,
    MapOp,
    MemorySourceOp,
    ResultSinkOp,
)


class QueryError(Exception):
    pass


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` (the current card) unless the caller
    names another. Raises when CUDA is asked for and there is none."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "engine on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclass
class _Stream:
    """A table source plus the chain of fragment ops accumulated so far."""

    relation: Relation
    dicts: dict
    chain: list
    tables: list
    source_op: MemorySourceOp

    def extend(self, op) -> "_Stream":
        return _Stream(
            self.relation, self.dicts, self.chain + [op], self.tables,
            self.source_op,
        )


def _stream_col_stats(stream: _Stream):
    """Merged per-column (min, max) bounds across the source tablets."""
    merged: dict | None = None
    for t in stream.tables:
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


def _to_host_batch(meta_list, cols, valid) -> HostBatch:
    idx = torch.nonzero(valid).flatten().cpu().numpy()
    out_cols: dict = {}
    dicts: dict = {}
    rel_items = []
    for m in meta_list:
        if m.struct_fields is not None:
            planes = cols[m.name][0].cpu().numpy()[idx]  # [rows, k] floats
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
            p.cpu().numpy()[idx].astype(h)
            for p, h in zip(cols[m.name], host_dtypes(m.dtype))
        )
        if m.dict is not None:
            dicts[m.name] = m.dict
        rel_items.append((m.name, m.dtype))
    return HostBatch(
        relation=Relation(rel_items), cols=out_cols, length=len(idx), dicts=dicts
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


@dataclass
class QueryStats:
    """Where one query's time went, on the host clock. Each window's
    device work is synchronised before the next window is read, so
    ``read_s`` (window reads from the table store), ``stage_s`` (padding
    and the host -> device copy) and ``fold_s`` (filter, maps and UDA
    folds) do not overlap."""

    rows: int = 0
    windows: int = 0
    read_s: float = 0.0
    stage_s: float = 0.0
    fold_s: float = 0.0
    finalize_s: float = 0.0
    fragments: list = field(default_factory=list)  # CompiledFragment per run


class Engine:
    """Owns tables + registry; executes PxL scripts on one device."""

    def __init__(self, registry: Registry | None = None,
                 window_rows: int | None = None, device=None):
        from ..table_store import TableStore

        self.device = resolve_device(device)
        self.registry = registry or default_registry()
        self.table_store = TableStore()
        self.window_rows = int(window_rows or get_flag("window_rows"))
        self.last_stats: Optional[QueryStats] = None

    @property
    def tables(self) -> dict:
        """{name: default-tablet (or first) Table} view over the store."""
        out = {}
        for n in self.table_store.table_names():
            t = self.table_store.get_table(n)
            if t is None:
                tablets = self.table_store.tablets(n)
                t = tablets[0] if tablets else None
            out[n] = t
        return out

    def create_table(self, name: str, relation: Relation | None = None,
                     max_bytes: int = -1):
        return self.table_store.add_table(name, relation, max_bytes=max_bytes)

    def append_data(self, name: str, data, time_cols=("time_",)):
        return self.table_store.append_data(name, data, time_cols=time_cols)

    def execute_query(self, query: str, now_ns: int = 0,
                      max_output_rows: int = 10_000) -> dict:
        """Compile a PxL script and execute it. Returns {output name:
        HostBatch}; ``last_stats`` says where the time went."""
        from ..planner import CompilerState, compile_pxl

        state = CompilerState(
            schemas={n: t.relation for n, t in self.tables.items()},
            registry=self.registry,
            now_ns=now_ns,
            max_output_rows=max_output_rows,
        )
        compiled = compile_pxl(query, state)
        self.last_stats = QueryStats()
        return self._execute_plan(compiled.plan, self.last_stats)

    def _execute_plan(self, plan, stats: QueryStats) -> dict:
        results: dict = {}
        outputs: dict = {}
        for nid in plan.topo_order():
            node = plan.nodes[nid]
            op = node.op
            if isinstance(op, MemorySourceOp):
                tablets = self.table_store.tablets(op.table)
                if not tablets:
                    raise QueryError(f"no table named {op.table!r}")
                base = next((t for t in tablets if len(t.relation)), tablets[0])
                chain = []
                if op.columns is not None:
                    chain.append(
                        MapOp(exprs=tuple((c, ColumnRef(c)) for c in op.columns))
                    )
                results[nid] = _Stream(
                    base.relation, dict(base.dicts), chain, tablets, op
                )
            elif isinstance(op, (MapOp, FilterOp, AggOp, LimitOp)):
                st = results[node.inputs[0]]
                if (st.chain and isinstance(st.chain[-1], LimitOp)) or (
                    isinstance(op, AggOp)
                    and any(isinstance(o, AggOp) for o in st.chain)
                ):
                    raise NotImplementedError(
                        "plans of several fragments are not in this slice "
                        "of the port"
                    )
                results[nid] = st.extend(op)
            elif isinstance(op, ResultSinkOp):
                outputs[op.name] = self._run_fragment(
                    results[node.inputs[0]], stats
                )
            else:
                raise NotImplementedError(
                    f"{type(op).__name__} is not in this slice of the port"
                )
        return outputs

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_fragment(self, stream: _Stream, stats: QueryStats) -> HostBatch:
        frag = compile_fragment(
            stream.chain, stream.relation, stream.dicts, self.registry,
            self.device, col_stats=_stream_col_stats(stream),
        )
        stats.fragments.append(frag)
        sop = stream.source_op
        state = frag.init_state()
        for t in stream.tables:
            windows = t.scan(sop.start_time, sop.stop_time,
                             window_rows=self.window_rows, cols=sop.columns)
            while True:
                t0 = time.perf_counter()
                hb = next(windows, None)
                if hb is None:
                    break
                t1 = time.perf_counter()
                cap = max(bucket_capacity(self.window_rows),
                          bucket_capacity(hb.length))
                db = hb.to_device(cap, self.device)
                self._sync()
                t2 = time.perf_counter()
                state = frag.merge_states(state, frag.window_state(db.cols, db.valid))
                self._sync()
                stats.read_s += t1 - t0
                stats.stage_s += t2 - t1
                stats.fold_s += time.perf_counter() - t2
                stats.rows += hb.length
                stats.windows += 1
        t0 = time.perf_counter()
        out_cols, valid, overflow = frag.finalize(state)
        if bool(overflow):
            raise QueryError(
                "rows escaped the group keys' dense domain (rows appended "
                "while the query ran); run the query again"
            )
        out = _to_host_batch(frag.out_meta, out_cols, valid)
        stats.finalize_s += time.perf_counter() - t0
        return _apply_limit(out, frag.limit)
