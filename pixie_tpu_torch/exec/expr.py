"""Expression binder: Expr tree x Relation x dictionaries -> plane closure.

A port of the JAX package's ``exec/expr.py``. The tree is bound ONCE into
a closure over the window's column planes (torch tensors); literals stay
Python scalars, which torch broadcasts against a plane.

Binding rules:
- DEVICE UDFs: recursive bind, implicit casts from the lattice.
- HOST_DICT UDFs: the string argument's dictionary is transformed
  host-side at bind time; the device sees an int32 gather.
- STRING literals are encoded against the sibling argument's dictionary
  (equality filters on unseen literals become id==-1: always false).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..types.dtypes import DataType
from ..types.strings import NULL_ID, StringDictionary
from ..udf.registry import Registry
from ..udf.udf import Executor, apply_cast
from .plan import ColumnRef, Expr, FuncCall, Literal


class BindError(TypeError):
    pass


@dataclass
class BoundExpr:
    """fn(cols: dict[str, planes-tuple]) -> plane tensor or Python scalar."""

    fn: Callable
    dtype: DataType
    # For STRING-typed results: the dictionary its int32 ids refer to.
    dict: Optional[StringDictionary] = None


def _gather(table: np.ndarray, ids, null):
    """``table[ids]`` on the ids' device; ids < 0 give ``null``."""
    t = torch.from_numpy(table).to(ids.device)
    return torch.where(ids >= 0, t[torch.clamp(ids, min=0).long()], null)


def bind_expr(expr: Expr, relation, dicts, registry: Registry) -> BoundExpr:
    if isinstance(expr, ColumnRef):
        if not relation.has_column(expr.name):
            raise BindError(f"unknown column {expr.name!r} in {relation}")
        dt = relation.col_type(expr.name)
        name = expr.name
        if dt == DataType.UINT128:
            fn = lambda cols: cols[name]  # (hi, lo) tuple
        else:
            fn = lambda cols: cols[name][0]
        return BoundExpr(fn=fn, dtype=dt, dict=dicts.get(name))

    if isinstance(expr, Literal):
        if expr.dtype == DataType.STRING:
            # Encoded later, in FuncCall context (needs a sibling dict).
            raise BindError(
                f"string literal {expr.value!r} outside a function context"
            )
        val = expr.value
        return BoundExpr(fn=lambda cols: val, dtype=expr.dtype)

    if isinstance(expr, FuncCall):
        return _bind_func(expr, relation, dicts, registry)

    raise BindError(f"cannot bind expression {expr!r}")


def _bind_func(expr: FuncCall, relation, dicts, registry: Registry) -> BoundExpr:
    # Bind non-string-literal args first to learn types and dictionaries.
    bound: list = [None] * len(expr.args)
    str_literals: list = []
    for i, a in enumerate(expr.args):
        if isinstance(a, Literal) and a.dtype == DataType.STRING:
            str_literals.append(i)
        else:
            bound[i] = bind_expr(a, relation, dicts, registry)

    arg_types = [
        DataType.STRING if i in str_literals else bound[i].dtype
        for i in range(len(expr.args))
    ]
    udf = registry.get_scalar(expr.name, arg_types)

    if udf.executor == Executor.HOST_DICT:
        return _bind_host_dict(expr, udf, bound, str_literals)

    # ids from different dictionaries are not comparable — align every
    # STRING arg onto one shared dictionary (id-preserving union; later
    # args get a remap gather).
    sibling_dict = None
    for i, b in enumerate(bound):
        if b is None or b.dict is None:
            continue
        if sibling_dict is None:
            sibling_dict = b.dict
        elif b.dict is not sibling_dict:
            merged, _, remap = sibling_dict.union(b.dict)
            bound[i] = BoundExpr(
                fn=(lambda _f, _r: (
                    lambda cols: _gather(_r, _f(cols), NULL_ID)
                ))(b.fn, remap),
                dtype=DataType.STRING,
                dict=merged,
            )
            sibling_dict = merged

    # Encode string literals against the shared dictionary.
    for i in str_literals:
        lit = expr.args[i]
        if sibling_dict is None:
            raise BindError(
                f"string literal {lit.value!r} in {expr.name} has no sibling "
                "dictionary to encode against"
            )
        lit_id = sibling_dict.lookup(lit.value)
        bound[i] = BoundExpr(
            fn=(lambda _id: (lambda cols: _id))(lit_id),
            dtype=DataType.STRING,
            dict=sibling_dict,
        )

    casts = list(zip(arg_types, udf.arg_types))
    arg_fns = [b.fn for b in bound]
    fn_udf = udf.fn

    def fn(cols):
        vals = [apply_cast(f(cols), have, want) for f, (have, want) in zip(arg_fns, casts)]
        return fn_udf(*vals)

    out_dict = None
    if udf.return_type == DataType.STRING:
        out_dict = udf.out_dict if udf.out_dict is not None else sibling_dict
    return BoundExpr(fn=fn, dtype=udf.return_type, dict=out_dict)


def _bind_host_dict(expr, udf, bound, str_literals) -> BoundExpr:
    """Run the UDF over the dictionary host-side; device applies a gather."""
    d_i = udf.dict_arg
    if d_i in str_literals or bound[d_i] is None or bound[d_i].dict is None:
        raise BindError(
            f"{udf.name}: argument {d_i} must be a string column/expression "
            "with a dictionary"
        )
    src = bound[d_i]
    src_dict = src.dict

    # All other args must be literals (reference: these are Init() args of
    # the C++ UDFs — compile-time constants).
    literal_vals: dict[int, object] = {}
    for i, a in enumerate(expr.args):
        if i == d_i:
            continue
        if not isinstance(a, Literal):
            raise BindError(
                f"{udf.name}: argument {i} must be a literal (host-dict UDF)"
            )
        literal_vals[i] = a.value

    def call_one(s: str):
        args = [literal_vals.get(i) if i != d_i else s for i in range(len(expr.args))]
        return udf.fn(*args)

    src_fn = src.fn
    if udf.return_type == DataType.STRING:
        new_dict, remap = src_dict.transform(call_one)
        return BoundExpr(
            fn=lambda cols: _gather(remap, src_fn(cols), NULL_ID),
            dtype=DataType.STRING,
            dict=new_dict,
        )

    null_value, np_dt = {
        DataType.BOOLEAN: (False, np.bool_),
        DataType.INT64: (0, np.int64),
        DataType.FLOAT64: (float("nan"), np.float32),
        DataType.TIME64NS: (0, np.int64),
    }[udf.return_type]
    table = np.asarray([call_one(s) for s in src_dict.strings] + [null_value], dtype=np_dt)
    k = len(src_dict.strings)

    def fn(cols):
        ids = src_fn(cols)
        safe = torch.where((ids >= 0) & (ids < k), ids, k).long()
        return torch.from_numpy(table).to(ids.device)[safe]

    return BoundExpr(fn=fn, dtype=udf.return_type)
