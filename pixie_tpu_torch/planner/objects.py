"""Compile-time object model (QLObjects) for the PxL frontend.

Reference parity: ``src/carnot/planner/objects/`` — ``Dataframe``
(``dataframe.h:40``: merge/groupby/agg/head/drop/append + subscript
filter/projection), column expressions, and the metadata ``ctx`` accessor
(``planner/metadata/metadata_handler.h:72``).

The AST visitor evaluates PxL statements against these objects; dataframe
methods append operators to the exec ``Plan`` under construction and track
the resolved ``Relation`` (the reference defers typing to analyzer rules;
here schemas are known at compile time, so resolution is eager).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..exec.plan import (
    AggExpr,
    AggOp,
    ColumnRef,
    Expr,
    FilterOp,
    FuncCall,
    JoinOp,
    LimitOp,
    Literal,
    MapOp,
    MemorySourceOp,
    Plan,
    ResultSinkOp,
    UnionOp,
)
from ..types.dtypes import DataType
from ..types.relation import Relation
from ..udf.udf import SignatureError


class PxLError(Exception):
    """Compile error with source location when available."""

    def __init__(self, msg: str, lineno: Optional[int] = None):
        self.raw_msg = msg
        self.lineno = lineno
        super().__init__(f"line {lineno}: {msg}" if lineno else msg)


def infer_type(expr: Expr, relation: Relation, registry) -> DataType:
    """Resolve an expression's type against a relation (planner-side
    mirror of the exec binder; reference: resolver_types_rule)."""
    if isinstance(expr, ColumnRef):
        if not relation.has_column(expr.name):
            raise PxLError(f"column {expr.name!r} does not exist in {relation}")
        return relation.col_type(expr.name)
    if isinstance(expr, Literal):
        return expr.dtype
    if isinstance(expr, FuncCall):
        arg_types = [infer_type(a, relation, registry) for a in expr.args]
        try:
            return registry.get_scalar(expr.name, arg_types).return_type
        except SignatureError as e:
            raise PxLError(str(e))
    raise PxLError(f"cannot type expression {expr!r}")


def py_to_literal(value, lineno=None) -> Literal:
    if isinstance(value, Literal):
        return value
    if isinstance(value, bool):
        return Literal(value, DataType.BOOLEAN)
    if isinstance(value, int):
        return Literal(value, DataType.INT64)
    if isinstance(value, float):
        return Literal(value, DataType.FLOAT64)
    if isinstance(value, str):
        return Literal(value, DataType.STRING)
    raise PxLError(f"cannot use {type(value).__name__} value {value!r} in an "
                   "expression", lineno)


def as_expr(value) -> Expr:
    if isinstance(value, ColumnExpr):
        return value.expr
    if isinstance(value, Expr):
        return value
    return py_to_literal(value)


def _owner_df(*values):
    for v in values:
        if isinstance(v, ColumnExpr) and v.df is not None:
            return v.df
    return None


class ColumnExpr:
    """A lazily-built scalar expression over one dataframe's columns."""

    def __init__(self, expr: Expr, df: Optional["DataFrameObj"]):
        self.expr = expr
        self.df = df

    def __repr__(self):
        return f"ColumnExpr({self.expr!r})"

    def __bool__(self):
        raise PxLError(
            "a column expression has no compile-time truth value; use it in "
            "df[...] / assignments, or combine with 'and'/'or'"
        )

    def _bin(self, other, name, reverse=False):
        df = _owner_df(self, other)
        if isinstance(other, ColumnExpr) and other.df is not None and \
                self.df is not None and other.df is not self.df:
            raise PxLError(
                "cannot combine columns from two different dataframes; "
                "merge them first"
            )
        a, b = self.expr, as_expr(other)
        if reverse:
            a, b = b, a
        return ColumnExpr(FuncCall(name, (a, b)), df)

    def __add__(self, o):
        return self._bin(o, "add")

    def __radd__(self, o):
        return self._bin(o, "add", reverse=True)

    def __sub__(self, o):
        return self._bin(o, "subtract")

    def __rsub__(self, o):
        return self._bin(o, "subtract", reverse=True)

    def __mul__(self, o):
        return self._bin(o, "multiply")

    def __rmul__(self, o):
        return self._bin(o, "multiply", reverse=True)

    def __truediv__(self, o):
        return self._bin(o, "divide")

    def __rtruediv__(self, o):
        return self._bin(o, "divide", reverse=True)

    def __mod__(self, o):
        return self._bin(o, "modulo")

    def __pow__(self, o):
        return self._bin(o, "pow")

    def __eq__(self, o):  # noqa: A003 - PxL semantics, not identity
        return self._bin(o, "equal")

    def __ne__(self, o):
        return self._bin(o, "notEqual")

    def __lt__(self, o):
        return self._bin(o, "lessThan")

    def __le__(self, o):
        return self._bin(o, "lessThanEqual")

    def __gt__(self, o):
        return self._bin(o, "greaterThan")

    def __ge__(self, o):
        return self._bin(o, "greaterThanEqual")

    def __and__(self, o):
        return self._bin(o, "logicalAnd")

    def __rand__(self, o):
        return self._bin(o, "logicalAnd", reverse=True)

    def __or__(self, o):
        return self._bin(o, "logicalOr")

    def __ror__(self, o):
        return self._bin(o, "logicalOr", reverse=True)

    def __invert__(self):
        return ColumnExpr(FuncCall("logicalNot", (self.expr,)), self.df)

    def __neg__(self):
        return ColumnExpr(FuncCall("negate", (self.expr,)), self.df)

    __hash__ = None  # __eq__ builds expressions; not hashable


@dataclass(frozen=True)
class ScalarFuncMarker:
    """``px.floor``-style callable: builds a FuncCall when applied."""

    name: str

    def __call__(self, *args):
        df = _owner_df(*args)
        return ColumnExpr(FuncCall(self.name, tuple(as_expr(a) for a in args)), df)


@dataclass(frozen=True)
class AggFuncMarker:
    """``px.mean``-style marker used inside .agg(out=(col, px.mean)).

    Several names (count/mean/max/...) are also callable as scalar funcs
    in map context when the registry has a scalar overload.
    """

    name: str
    has_scalar: bool = False

    def __call__(self, *args):
        if not self.has_scalar:
            raise PxLError(
                f"px.{self.name} is an aggregate; use it inside "
                f".agg(out=('col', px.{self.name}))"
            )
        return ScalarFuncMarker(self.name)(*args)


DF_METHODS = frozenset({"groupby", "agg", "merge", "head", "drop", "append", "stream"})
DF_ATTRS = frozenset({"ctx", "columns"})


class DataFrameObj:
    """The PxL ``DataFrame`` object: lazy operator-DAG builder.

    Mutable by design: ``df.col = expr`` appends a Map operator and
    advances this object's plan node in place (matching PxL's pandas-like
    mutation semantics; reference ``objects/dataframe.cc``).
    """

    def __init__(self, builder: "PlanBuilder", node_id: int, relation: Relation):
        self.builder = builder
        self.node_id = node_id
        self.relation = relation

    # -- column access -------------------------------------------------------
    def col(self, name: str, lineno=None) -> ColumnExpr:
        if not self.relation.has_column(name):
            raise PxLError(
                f"column {name!r} does not exist; available: "
                f"{list(self.relation.column_names)}", lineno
            )
        return ColumnExpr(ColumnRef(name), self)

    def resolve_expr(self, value, what="expression", lineno=None) -> Expr:
        if isinstance(value, ColumnExpr):
            if value.df is not None and value.df is not self:
                raise PxLError(
                    f"{what} references columns of a different dataframe", lineno
                )
            return value.expr
        return as_expr(value)

    # -- operators -----------------------------------------------------------
    def _advance(self, op, relation, extra_inputs=()):
        nid = self.builder.plan.add(
            op, [self.node_id, *extra_inputs], relation=relation
        )
        return DataFrameObj(self.builder, nid, relation)

    def set_column(self, name: str, value, lineno=None):
        """df.name = value — Map keeping all columns, adding/replacing one."""
        expr = self.resolve_expr(value, what=f"assignment to {name!r}", lineno=lineno)
        dt = infer_type(expr, self.relation, self.builder.registry)
        exprs = []
        replaced = False
        for c, _t in self.relation.items():
            if c == name:
                exprs.append((name, expr))
                replaced = True
            else:
                exprs.append((c, ColumnRef(c)))
        if not replaced:
            exprs.append((name, expr))
        items = [(c, dt if c == name else self.relation.col_type(c))
                 for c, _ in exprs]
        new = self._advance(MapOp(exprs=tuple(exprs)), Relation(items))
        # In-place mutation: the variable keeps pointing at this object.
        self.node_id, self.relation = new.node_id, new.relation

    def project(self, names, lineno=None) -> "DataFrameObj":
        for n in names:
            if not isinstance(n, str):
                raise PxLError(f"projection list must contain column names, "
                               f"got {n!r}", lineno)
            if not self.relation.has_column(n):
                raise PxLError(f"column {n!r} does not exist in {self.relation}",
                               lineno)
        exprs = tuple((n, ColumnRef(n)) for n in names)
        rel = Relation([(n, self.relation.col_type(n)) for n in names])
        return self._advance(MapOp(exprs=exprs), rel)

    def filter(self, cond: ColumnExpr, lineno=None) -> "DataFrameObj":
        expr = self.resolve_expr(cond, what="filter predicate", lineno=lineno)
        dt = infer_type(expr, self.relation, self.builder.registry)
        if dt != DataType.BOOLEAN:
            raise PxLError(f"filter predicate has type {dt.name}, want BOOLEAN",
                           lineno)
        return self._advance(FilterOp(predicate=expr), self.relation)

    def head(self, n: int = 5, lineno=None) -> "DataFrameObj":
        if not isinstance(n, int) or n < 0:
            raise PxLError(f"head() expects a non-negative int, got {n!r}", lineno)
        return self._advance(LimitOp(n), self.relation)

    def drop(self, columns, lineno=None) -> "DataFrameObj":
        if isinstance(columns, str):
            columns = [columns]
        for c in columns:
            if not self.relation.has_column(c):
                raise PxLError(f"cannot drop missing column {c!r}", lineno)
        keep = [c for c in self.relation.column_names if c not in set(columns)]
        return self.project(keep, lineno)

    def groupby(self, by, lineno=None) -> "GroupbyObj":
        cols = [by] if isinstance(by, str) else list(by)
        for c in cols:
            if not isinstance(c, str) or not self.relation.has_column(c):
                raise PxLError(f"groupby column {c!r} does not exist", lineno)
        return GroupbyObj(self, tuple(cols))

    def agg(self, lineno=None, **kwargs) -> "DataFrameObj":
        return GroupbyObj(self, ()).agg(lineno=lineno, **kwargs)

    def merge(self, right, how="inner", left_on=None, right_on=None,
              suffixes=("", "_x"), lineno=None) -> "DataFrameObj":
        if not isinstance(right, DataFrameObj):
            raise PxLError("merge() right side must be a DataFrame", lineno)
        if right.builder is not self.builder:
            raise PxLError("cannot merge dataframes from different scripts", lineno)
        if left_on is None or right_on is None:
            raise PxLError("merge() requires left_on= and right_on=", lineno)
        lo = [left_on] if isinstance(left_on, str) else list(left_on)
        ro = [right_on] if isinstance(right_on, str) else list(right_on)
        if len(lo) != len(ro):
            raise PxLError("merge() left_on/right_on length mismatch", lineno)
        for c in lo:
            if not self.relation.has_column(c):
                raise PxLError(f"merge left_on column {c!r} missing", lineno)
        for c in ro:
            if not right.relation.has_column(c):
                raise PxLError(f"merge right_on column {c!r} missing", lineno)
        if how not in ("inner", "left", "right", "outer"):
            raise PxLError(
                f"merge how={how!r} unsupported "
                "(inner/left/right/outer)", lineno)
        suffixes = tuple(suffixes)
        if suffixes and suffixes[0] != "":
            raise PxLError("merge suffixes must keep the left side unsuffixed "
                           "(['', '_x'])", lineno)
        suffix = suffixes[1] if len(suffixes) > 1 else "_x"
        out_rel = self.relation.merge(
            right.relation.select(
                [c for c in right.relation.column_names if c not in set(ro)]
            ),
            suffix=suffix,
        )
        op = JoinOp(left_on=tuple(lo), right_on=tuple(ro), how=how, suffix=suffix)
        return self._advance(op, out_rel, extra_inputs=(right.node_id,))

    def append(self, other, lineno=None) -> "DataFrameObj":
        if not isinstance(other, DataFrameObj):
            raise PxLError("append() expects a DataFrame", lineno)
        if tuple(other.relation.column_names) != tuple(self.relation.column_names):
            raise PxLError(
                f"append() schema mismatch: {list(self.relation.column_names)} "
                f"vs {list(other.relation.column_names)}", lineno)
        return self._advance(UnionOp(), self.relation,
                             extra_inputs=(other.node_id,))

    def stream(self, lineno=None) -> "DataFrameObj":
        # Streaming is the engine's execution mode, not a plan property.
        return self

    @property
    def ctx(self) -> "CtxAccessor":
        return CtxAccessor(self)

    @property
    def columns(self):
        return list(self.relation.column_names)

    def __repr__(self):
        return f"DataFrame(node={self.node_id}, {self.relation})"


@dataclass
class GroupbyObj:
    df: DataFrameObj
    by: tuple

    def agg(self, lineno=None, **kwargs) -> DataFrameObj:
        if not kwargs:
            raise PxLError("agg() requires at least one out=('col', px.fn)",
                           lineno)
        aggs = []
        registry = self.df.builder.registry
        for out_name, spec in kwargs.items():
            if not (isinstance(spec, tuple) and len(spec) >= 2):
                raise PxLError(
                    f"agg {out_name}= must be a ('column', px.fn[, args...]) "
                    "tuple", lineno)
            col, fn, *extra = spec
            if isinstance(fn, ScalarFuncMarker):
                fn = AggFuncMarker(fn.name)
            if not isinstance(fn, AggFuncMarker):
                raise PxLError(
                    f"agg {out_name}=: second element must be a px aggregate "
                    f"function, got {fn!r}", lineno)
            if isinstance(col, str):
                arg = self.df.col(col, lineno).expr
            else:
                arg = self.df.resolve_expr(col, what=f"agg {out_name}", lineno=lineno)
            # Extra positional args for multi-arg UDAs, e.g.
            # out=('lat', px.kmeans, 2) (ml_ops.h KMeansUDA's k).
            args = [arg] + [
                self.df.resolve_expr(e, what=f"agg {out_name}", lineno=lineno)
                for e in extra
            ]
            arg_ts = [
                infer_type(a, self.df.relation, registry) for a in args
            ]
            try:
                uda = registry.get_uda(fn.name, arg_ts)
            except SignatureError as e:
                raise PxLError(str(e), lineno)
            aggs.append((AggExpr(out_name, fn.name, tuple(args)), uda.return_type))

        items = [(c, self.df.relation.col_type(c)) for c in self.by]
        items += [(ae.out_name, rt) for ae, rt in aggs]
        op = AggOp(
            group_cols=self.by,
            aggs=tuple(ae for ae, _ in aggs),
            max_groups=self.df.builder.max_groups,
        )
        return self.df._advance(op, Relation(items))


class CtxAccessor:
    """``df.ctx['service']`` — resolve k8s metadata to UDF calls.

    Reference: ``planner/metadata/metadata_handler.h:72`` maps metadata
    properties to ``upid_to_*`` UDFs keyed on the ``upid`` column.
    """

    def __init__(self, df: DataFrameObj):
        self.df = df

    def __getitem__(self, key: str) -> ColumnExpr:
        raise PxLError(
            f"df.ctx[{key!r}]: metadata is not in this slice of the port"
        )


@dataclass
class PlanBuilder:
    """Shared compile state: the plan under construction + schemas."""

    plan: Plan
    schemas: dict  # table name -> Relation
    registry: object
    max_groups: int = 4096
    sinks: list = field(default_factory=list)  # output names in display order
    n_exports: int = 0  # OTel export sinks (outputs without a name)
    n_table_sinks: int = 0  # table write-backs (px.to_table)

    def source(self, table: str, select=None, start_time=None, stop_time=None,
               lineno=None) -> DataFrameObj:
        if table not in self.schemas:
            raise PxLError(
                f"table {table!r} does not exist; available: "
                f"{sorted(self.schemas)}", lineno)
        rel = self.schemas[table]
        op = MemorySourceOp(table=table, columns=None,
                            start_time=start_time, stop_time=stop_time)
        nid = self.plan.add(op, [], relation=rel)
        df = DataFrameObj(self, nid, rel)
        if select is not None:
            df = df.project(list(select), lineno)
        return df

    def display(self, df: DataFrameObj, name: str = "output", lineno=None):
        if not isinstance(df, DataFrameObj):
            raise PxLError("px.display() expects a DataFrame", lineno)
        if name in self.sinks:
            raise PxLError(f"duplicate output table name {name!r}", lineno)
        self.plan.add(ResultSinkOp(name), [df.node_id])
        self.sinks.append(name)

    def to_table(self, df: DataFrameObj, name: str, lineno=None):
        """Write df back into the table store (MemorySink write-back)."""
        from ..exec.plan import TableSinkOp

        if not isinstance(df, DataFrameObj):
            raise PxLError("px.to_table() expects a DataFrame", lineno)
        if not isinstance(name, str) or not name:
            raise PxLError("px.to_table() needs a table name", lineno)
        self.plan.add(TableSinkOp(name), [df.node_id])
        self.n_table_sinks += 1
