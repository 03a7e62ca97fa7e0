"""Fragment compiler: a linear operator chain -> one window fold.

A port of the dense-domain path of the JAX package's ``exec/fragment.py``.
A chain {Map/Filter -> Agg -> Map/Filter -> Limit} becomes:

- ``window_state(cols, valid)``: runs the filter and maps over one staged
  window, packs each row's group keys into a dense slot id and folds the
  window into a fresh [G]-slot group state;
- ``merge_states(a, b)``: the slot-aligned associative merge;
- ``finalize(state)``: UDA finalize + post-agg ops -> output columns.

PyTorch runs eagerly, so there is no compile cache. Group keys whose
domain is not known statically (the sort/hash regroup of the JAX
package's ``ops/groupby.py``) and chains without an aggregate are a
later slice of the port.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..config import get_flag
from ..ops.dense_fold import MAX_SLOTS, dense_fold
from ..types.dtypes import DataType, device_dtypes
from ..types.relation import Relation
from ..udf.registry import Registry
from ..udf.udf import UDADef, apply_cast
from .expr import BindError, bind_expr
from .plan import AggOp, ColumnRef, FilterOp, FuncCall, LimitOp, Literal, MapOp

# Integer-typed key columns that qualify for stats-derived dense domains.
_INT_KEY_TYPES = (DataType.INT64, DataType.TIME64NS)


@dataclass
class ColumnMeta:
    """Host-side metadata for one output column."""

    name: str
    dtype: DataType
    dict: object = None  # StringDictionary for STRING columns
    struct_fields: Optional[tuple] = None  # sketch JSON struct (quantiles)


@dataclass
class CompiledFragment:
    relation: Relation  # output relation
    out_meta: list  # list[ColumnMeta] incl. struct columns
    init_state: object  # () -> group state
    window_state: object  # (cols, valid) -> per-window group state
    merge_states: object  # (state_a, state_b) -> merged state
    finalize: object  # state -> (cols, valid, overflow)
    limit: Optional[int] = None  # host-enforced row cap
    # True when the aggregates fold through the dense_fold kernel.
    uses_dense_fold: bool = False


def _struct_key(x):
    """Canonical hashable form of a plan-op / expr tree."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _struct_key(getattr(x, f.name)) for f in dataclasses.fields(x)
        )
    if isinstance(x, (list, tuple)):
        return tuple(_struct_key(v) for v in x)
    return x


def _full_plane(v, dtype: DataType, valid):
    """A [n] plane from a bound value: tensors broadcast to the window,
    Python scalars (literals) fill a new plane of the type's dtype."""
    if isinstance(v, torch.Tensor):
        return torch.broadcast_to(v, valid.shape)
    return torch.full(
        valid.shape, v, dtype=device_dtypes(dtype)[0], device=valid.device
    )


def _bind_pre_stage(ops, relation, dicts, registry):
    """Bind leading Map/Filter ops; returns (apply_fn, relation, dicts)."""
    steps = []  # ("map", [(name, BoundExpr)]) | ("filter", BoundExpr)
    for op in ops:
        if isinstance(op, MapOp):
            bound = [(name, bind_expr(e, relation, dicts, registry)) for name, e in op.exprs]
            steps.append(("map", bound))
            relation = Relation([(n, b.dtype) for n, b in bound])
            dicts = {n: b.dict for n, b in bound if b.dict is not None}
        elif isinstance(op, FilterOp):
            b = bind_expr(op.predicate, relation, dicts, registry)
            if b.dtype != DataType.BOOLEAN:
                raise BindError(f"filter predicate has type {b.dtype}, want BOOLEAN")
            steps.append(("filter", b))
        else:
            raise NotImplementedError(
                f"{type(op).__name__} in a fragment is not in this slice of "
                "the port"
            )

    def apply(cols, valid):
        for kind, payload in steps:
            if kind == "map":
                new_cols = {}
                for name, b in payload:
                    v = b.fn(cols)
                    planes = v if isinstance(v, tuple) else (v,)
                    new_cols[name] = tuple(
                        _full_plane(p, b.dtype, valid) for p in planes
                    )
                cols = new_cols
            else:
                valid = valid & _full_plane(payload.fn(cols), DataType.BOOLEAN, valid)
        return cols, valid

    return apply, relation, dicts


def _split_chain(ops):
    """[pre(map/filter)...] [agg]? [post(map/filter)...] [limit at end]?"""
    pre, agg, post, limit = [], None, [], None
    for i, op in enumerate(ops):
        if isinstance(op, LimitOp):
            if i != len(ops) - 1:
                raise BindError("LimitOp must terminate a fragment")
            limit = op.n
        elif isinstance(op, AggOp):
            if agg is not None:
                raise BindError("multiple aggregates in one fragment")
            agg = op
        elif agg is None:
            pre.append(op)
        else:
            post.append(op)
    return pre, agg, post, limit


def _expr_stats(e, stats):
    """(min, max, stride) bounds of an integer expression, or None.

    Interval + stride arithmetic over affine expressions: +/-/*-by-literal
    keep the lattice. The invariant maintained is "every value ≡ min (mod
    stride)", which is exactly what the dense packing needs: code =
    (v - min) // stride is exact. Constants carry stride 0 (gcd
    identity). The JAX package also bounds ``bin(t, d)``, which this
    slice of the port does not register."""
    if isinstance(e, ColumnRef):
        s = stats.get(e.name)
        if s is None:
            return None
        return (int(s[0]), int(s[1]), int(s[2]) if len(s) > 2 else 1)
    if isinstance(e, Literal):
        v = e.value
        if isinstance(v, bool) or not isinstance(v, int):
            return None
        return (v, v, 0)
    if not isinstance(e, FuncCall):
        return None
    args = [_expr_stats(a, stats) for a in e.args]
    if any(a is None for a in args):
        return None
    if e.name in ("add", "subtract") and len(args) == 2:
        (la, ha, sa), (lb, hb, sb) = args
        st = math.gcd(sa, sb)
        if e.name == "add":
            return (la + lb, ha + hb, st)
        return (la - hb, ha - lb, st)
    if e.name == "multiply" and len(args) == 2:
        (la, ha, sa), (lb, hb, sb) = args
        const = None
        var = None
        if lb == hb:
            const, var = lb, (la, ha, sa)
        elif la == ha:
            const, var = la, (lb, hb, sb)
        if const is None or const <= 0:
            return None
        lo, hi, st = var
        return (lo * const, hi * const, st * const)
    return None


def _propagate_stats(ops, stats):
    """Carry input-column (min, max[, stride]) bounds through leading
    Map/Filter ops; filters narrow, so bounds stay valid."""
    if not stats:
        return stats
    for op in ops:
        if isinstance(op, MapOp):
            nxt = {}
            for name, e in op.exprs:
                s = _expr_stats(e, stats)
                if s is not None and s[2] != 0:
                    nxt[name] = s
            stats = nxt
    return stats


# Stats bounds round outward to this grain so ordinary appends (which
# nudge a column's min/max) do not change the compiled domain.
_STATS_Q = 4096


def _round_stat_bounds(lo: int, hi: int, stride: int = 1) -> tuple:
    """Round bounds outward to the _STATS_Q grain IN STRIDE STEPS, so the
    rounded lo keeps the values' residue class."""
    if stride <= 1:
        return (lo - lo % _STATS_Q, hi - hi % _STATS_Q + _STATS_Q - 1, 1)
    lo_r = lo - ((lo // stride) % _STATS_Q) * stride
    hi_r = hi + (_STATS_Q - 1 - (hi // stride) % _STATS_Q) * stride
    return (lo_r, hi_r, stride)


def _static_key_domains(rel1, dicts1, group_cols, col_stats=None):
    """Per-column (domain size, value offset, value stride) triples, or
    None when any column's domain is not known at compile time.

    Dictionary-encoded STRING columns have ``len(dict) + 1`` codes (ids
    plus NULL_ID), BOOLEANs two; integer/time keys are dense when the
    table's append-time min/max stats bound them. Float keys have no
    dense form.
    """
    doms = []
    for c in group_cols:
        dt = rel1.col_type(c)
        if dt == DataType.STRING and dicts1.get(c) is not None:
            doms.append((len(dicts1[c]) + 1, 0, 1))  # last slot = NULL_ID
        elif dt == DataType.BOOLEAN:
            doms.append((2, 0, 1))
        elif dt in _INT_KEY_TYPES and col_stats and c in col_stats:
            lo, hi, stride = _round_stat_bounds(*col_stats[c])
            if hi - lo + 1 <= 0:
                return None
            doms.append(((hi - lo) // stride + 1, lo, stride))
        else:
            return None
    return doms


def unpack_dense_slots(iota, doms, col_types, offsets, strides):
    """Dense slot indices -> per-group-col key planes."""
    planes = []
    pack = 1
    for d in doms:
        pack *= d
    for dt, dom, off, st in zip(col_types, doms, offsets, strides):
        pack //= dom
        code = (iota // pack) % dom
        if dt == DataType.BOOLEAN:
            planes.append(code.to(torch.bool))
        elif dt in _INT_KEY_TYPES:
            planes.append((code * st + off).to(torch.int64))
        else:  # STRING: last sub-slot decodes back to NULL_ID (-1)
            planes.append(torch.where(code == dom - 1, -1, code).to(torch.int32))
    return planes


def compile_fragment(ops, input_relation, input_dicts, registry: Registry,
                     device, col_stats=None) -> CompiledFragment:
    pre, agg, post, limit = _split_chain(list(ops))
    apply_pre, rel1, dicts1 = _bind_pre_stage(pre, input_relation, dict(input_dicts), registry)
    if agg is None:
        raise NotImplementedError(
            "chains without an aggregate are not in this slice of the port"
        )
    return _compile_agg(
        agg, post, limit, apply_pre, rel1, dicts1, registry, device,
        col_stats=_propagate_stats(pre, col_stats),
    )


def _compile_agg(agg: AggOp, post, limit, apply_pre, rel1, dicts1, registry,
                 device, col_stats=None):
    for c in agg.group_cols:
        if not rel1.has_column(c):
            raise BindError(f"group column {c!r} not in {rel1}")

    # Static dense key domain: the PACKED CODE of the group columns is the
    # group id — no per-window sort or hash, and state merges are
    # slot-aligned. A single integer key gets the larger domain budget.
    doms = (
        _static_key_domains(rel1, dicts1, list(agg.group_cols), col_stats)
        if agg.group_cols else None
    )
    g = None
    if doms is not None:
        total = math.prod(d for d, _off, _st in doms)
        has_int = any(off or rel1.col_type(c) in _INT_KEY_TYPES
                      for (_d, off, _st), c in zip(doms, agg.group_cols))
        limit_slots = (
            get_flag("int_dense_domain_limit")
            if has_int and len(agg.group_cols) == 1
            else get_flag("dense_domain_limit")
        )
        if total <= limit_slots:
            g = total
    if g is None:
        raise NotImplementedError(
            "group-by keys without a static dense domain (the sort/hash "
            "regroup) are a later slice of the port"
        )
    # Per-group-col domain sizes (the packed key IS the group id);
    # offsets shift stats-derived integer keys to zero base and strides
    # scale step-indexed codes (binned time keys).
    dense_domains = tuple(d for d, _off, _st in doms)
    dense_offsets = tuple(off for _d, off, _st in doms)
    dense_strides = tuple(st for _d, _off, st in doms)

    # Bind aggregate input expressions and resolve UDAs.
    aggs_bound = []  # (AggExpr, UDADef, [BoundExpr], [cast pairs])
    for ae in agg.aggs:
        arg_bound = [bind_expr(a, rel1, dicts1, registry) for a in ae.args]
        uda: UDADef = registry.get_uda(ae.uda_name, [b.dtype for b in arg_bound])
        casts = list(zip([b.dtype for b in arg_bound], uda.arg_types))
        aggs_bound.append((ae, uda, arg_bound, casts))

    group_cols = list(agg.group_cols)
    key_plane_index = []  # (col, plane_i) per key plane
    for c in group_cols:
        for i in range(len(device_dtypes(rel1.col_type(c)))):
            key_plane_index.append((c, i))

    def init_state():
        return {
            "valid": torch.zeros(g, dtype=torch.bool, device=device),
            "carries": {ae.out_name: uda.init(g, device) for ae, uda, _, _ in aggs_bound},
            "overflow": torch.zeros((), dtype=torch.bool, device=device),
        }

    def dense_slot_ids(cols, valid):
        """Packed key code per row + out-of-domain flag.

        slot = sum(code_i * stride_i); NULL_ID (-1) string codes land in
        each column's last sub-slot and masked rows in the trash slot g.
        A row whose integer key escaped the compile-time [min, max] (an
        append racing the query) goes to the trash slot and raises the
        overflow flag.
        """
        slot = None
        oob = None
        for (c, _i), dom, off, st in zip(
            key_plane_index, dense_domains, dense_offsets, dense_strides
        ):
            p = cols[c][0]
            if rel1.col_type(c) in _INT_KEY_TYPES:
                raw = p - off
                if st > 1:
                    out = (raw < 0) | (raw >= dom * st) | (raw % st != 0)
                    raw = raw // st
                else:
                    out = (raw < 0) | (raw >= dom)
                oob = out if oob is None else (oob | out)
                code = torch.clamp(raw, 0, dom - 1).to(torch.int32)
            else:
                p = p.to(torch.int32)
                code = torch.clamp(torch.where(p < 0, dom - 1, p), 0, dom - 1)
            slot = code if slot is None else slot * dom + code
        if oob is None:
            oob_any = torch.zeros((), dtype=torch.bool, device=valid.device)
            keep = valid
        else:
            oob = oob & valid
            oob_any = oob.any()
            keep = valid & ~oob
        return torch.where(keep, slot, g).to(torch.int32), oob_any

    def dense_key_planes():
        """The [g] key planes, reconstructed from the slot index."""
        return unpack_dense_slots(
            torch.arange(g, dtype=torch.int64, device=device),
            dense_domains,
            [rel1.col_type(c) for c, _i in key_plane_index],
            dense_offsets,
            dense_strides,
        )

    # The dense fold kernel (ops/dense_fold.py) serves count and FLOAT64
    # sum/mean/max/min at g <= 2048: the JAX package's admission rule for
    # its Pallas kernel, so both packages take the same route.
    uses_dense_fold = g <= MAX_SLOTS and all(
        ae.uda_name == "count"
        or (
            ae.uda_name in ("sum", "mean", "max", "min")
            and len(arg_bound) == 1
            and casts[0][1] == DataType.FLOAT64
        )
        for ae, _uda, arg_bound, casts in aggs_bound
    )

    def dense_fold_carries(gids, cols, valid):
        """Per-agg carries via dense_fold; returns (carries, valid_w)."""
        g_pad = -(-g // 128) * 128
        # Trash rows must match no kernel slot, the pad range included.
        gids_p = torch.where(gids >= g, g_pad, gids)
        need_min = any(ae.uda_name == "min" for ae, _u, _b, _c in aggs_bound)
        # One kernel pass per distinct argument expression: sum, mean and
        # max over the same column share a single sweep.
        folds: dict = {}

        def fold_for(a):
            cnt, s, mx, mn = dense_fold(gids_p, a, g_pad, want_min=need_min)
            return cnt[:g], s[:g], mx[:g], (mn[:g] if mn is not None else None)

        carries_w = {}
        cnt_shared = None
        for ae, uda, arg_bound, casts in aggs_bound:
            if ae.uda_name == "count":
                continue
            fkey = (_struct_key(ae.args), casts[0])
            if fkey not in folds:
                a = apply_cast(arg_bound[0].fn(cols), *casts[0])
                folds[fkey] = fold_for(
                    _full_plane(a, DataType.FLOAT64, valid).contiguous()
                )
            cnt, s, mx, mn = folds[fkey]
            cnt_shared = cnt
            init_leaf = uda.init(g, device)
            if ae.uda_name == "sum":
                carries_w[ae.out_name] = s.to(init_leaf.dtype)
            elif ae.uda_name == "mean":
                carries_w[ae.out_name] = (
                    s.to(init_leaf[0].dtype), cnt.to(init_leaf[1].dtype),
                )
            else:  # max/min: empty slots keep the UDA's neutral fill
                ext = mx if ae.uda_name == "max" else mn
                carries_w[ae.out_name] = torch.where(
                    cnt > 0, ext.to(init_leaf.dtype), init_leaf
                )
        if cnt_shared is None:
            # count-only aggregation: one kernel pass over a zero column.
            cnt_shared = fold_for(
                torch.zeros(valid.shape, dtype=torch.float32, device=valid.device)
            )[0]
        for ae, uda, _b, _c in aggs_bound:
            if ae.uda_name == "count":
                carries_w[ae.out_name] = cnt_shared.to(uda.init(g, device).dtype)
        return carries_w, cnt_shared > 0

    def window_state(cols, valid):
        """Fold one window of rows into a fresh [G]-slot group state."""
        cols, valid = apply_pre(cols, valid)
        gids, oob = dense_slot_ids(cols, valid)
        if uses_dense_fold:
            carries_w, valid_w = dense_fold_carries(gids, cols, valid)
            return {"valid": valid_w, "carries": carries_w, "overflow": oob}
        carries_w = {}
        for ae, uda, arg_bound, casts in aggs_bound:
            args = [
                _full_plane(apply_cast(b.fn(cols), have, want), want, valid)
                for b, (have, want) in zip(arg_bound, casts)
            ]
            carries_w[ae.out_name] = uda.update(uda.init(g, device), gids, valid, *args)
        # A count aggregate's carry already says which slots saw rows.
        cnt_name = next(
            (ae.out_name for ae, _u, _b, _c in aggs_bound if ae.uda_name == "count"),
            None,
        )
        if cnt_name is not None:
            valid_w = carries_w[cnt_name] > 0
        else:
            seen = torch.zeros(g + 1, dtype=torch.bool, device=device)
            valid_w = seen.index_fill_(0, gids.long(), True)[:g]
        return {"valid": valid_w, "carries": carries_w, "overflow": oob}

    def merge_states(sa, sb):
        """Slot-aligned associative merge of two dense group states."""
        return {
            "valid": sa["valid"] | sb["valid"],
            "carries": {
                ae.out_name: uda.merge(
                    sa["carries"][ae.out_name], sb["carries"][ae.out_name]
                )
                for ae, uda, _, _ in aggs_bound
            },
            "overflow": sa["overflow"] | sb["overflow"],
        }

    # Output relation: group cols then agg outputs (struct sketches keep a
    # [G, k] plane; they are host-materialized and opaque to post ops).
    out_items = [(c, rel1.col_type(c)) for c in group_cols]
    out_meta = [
        ColumnMeta(name=c, dtype=rel1.col_type(c), dict=dicts1.get(c))
        for c in group_cols
    ]
    struct_cols = set()
    for ae, uda, arg_bound, _ in aggs_bound:
        out_items.append((ae.out_name, uda.return_type))
        if uda.struct_fields:
            struct_cols.add(ae.out_name)
            out_meta.append(
                ColumnMeta(
                    name=ae.out_name, dtype=uda.return_type,
                    struct_fields=uda.struct_fields,
                )
            )
        else:
            d = arg_bound[0].dict if (
                uda.return_type == DataType.STRING and arg_bound
            ) else None
            out_meta.append(ColumnMeta(name=ae.out_name, dtype=uda.return_type, dict=d))
    out_rel = Relation(out_items)

    # Bind post-agg ops against the non-struct view of the output. Post
    # filters keep all columns, so struct columns survive them; a post
    # MapOp is a full projection and cannot reference struct columns.
    post_rel = Relation([(n, t) for n, t in out_items if n not in struct_cols])
    post_dicts = {m.name: m.dict for m in out_meta if m.dict is not None}
    apply_post, post_rel_out, post_dicts_out = _bind_pre_stage(
        post, post_rel, post_dicts, registry
    )
    if post:
        final_meta = [
            ColumnMeta(n, post_rel_out.col_type(n), dict=post_dicts_out.get(n))
            for n in post_rel_out.column_names
        ]
        if not any(isinstance(op, MapOp) for op in post):
            final_meta += [m for m in out_meta if m.struct_fields is not None]
        out_rel = post_rel_out
    else:
        final_meta = out_meta

    def finalize(state):
        cols = {}
        for c, plane in zip(group_cols, dense_key_planes()):
            cols[c] = (plane,)
        for ae, uda, _, _ in aggs_bound:
            cols[ae.out_name] = (uda.finalize(state["carries"][ae.out_name]),)
        device_cols = {n: p for n, p in cols.items() if n not in struct_cols}
        device_cols, valid = apply_post(device_cols, state["valid"])
        for s in struct_cols:
            device_cols[s] = cols[s]
        return device_cols, valid, state["overflow"]

    return CompiledFragment(
        relation=out_rel,
        out_meta=final_meta,
        init_state=init_state,
        window_state=window_state,
        merge_states=merge_states,
        finalize=finalize,
        limit=limit,
        uses_dense_fold=uses_dense_fold,
    )
