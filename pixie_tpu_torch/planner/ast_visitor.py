"""PxL AST evaluator.

Reference parity: ``src/carnot/planner/compiler/ast_visitor.h:75``
(ASTVisitorImpl::ProcessModuleNode) — walks the Python AST and evaluates
module-level dataflow into QLObjects, never executing user code with the
host interpreter's semantics. PxL is Python-shaped but restricted: the
statement/expression whitelist below IS the language definition.

Scripts manipulate two kinds of values:
- host values (ints, strings, lists, ...) evaluated at compile time —
  loop bounds, window sizes, flags;
- deferred values (ColumnExpr, DataFrameObj) that build the operator DAG.
"""

from __future__ import annotations

import ast
import operator
from dataclasses import dataclass

from .objects import (
    ColumnExpr,
    DataFrameObj,
    DF_METHODS,
    PxLError,
    ScalarFuncMarker,
)
from .px_module import PxModule


class _ReturnSignal(Exception):
    def __init__(self, value):
        self.value = value


class Scope:
    """Lexical scope chain (VarTable analog, ``objects/var_table.h``)."""

    def __init__(self, parent=None):
        self.vars: dict = {}
        self.parent = parent

    def lookup(self, name: str):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        raise KeyError(name)

    def assign(self, name: str, value):
        self.vars[name] = value


@dataclass
class _DFMethod:
    """A dataframe/groupby method reference awaiting its call (the Call
    handler injects the source line number)."""

    df: object
    name: str


class PxFunc:
    """A PxL-defined function (vis-spec entry points are these)."""

    def __init__(self, name, args_ast, body, closure, visitor, doc=""):
        self.name = name
        self.args_ast = args_ast
        self.body = body
        self.closure = closure
        self.visitor = visitor
        self.doc = doc

    @property
    def arg_names(self):
        return [a.arg for a in self.args_ast.args]

    def __call__(self, *args, **kwargs):
        v = self.visitor
        scope = Scope(parent=self.closure)
        names = self.arg_names
        defaults = self.args_ast.defaults
        # rightmost defaults align with rightmost args
        default_map = {
            names[len(names) - len(defaults) + i]: v.eval(d, self.closure)
            for i, d in enumerate(defaults)
        }
        if len(args) > len(names):
            raise PxLError(f"{self.name}() takes {len(names)} arguments, "
                           f"{len(args)} given")
        bound = dict(zip(names, args))
        for k, val in kwargs.items():
            if k not in names:
                raise PxLError(f"{self.name}() got unexpected argument {k!r}")
            if k in bound:
                raise PxLError(f"{self.name}() got duplicate argument {k!r}")
            bound[k] = val
        for n in names:
            if n not in bound:
                if n not in default_map:
                    raise PxLError(f"{self.name}() missing argument {n!r}")
                bound[n] = default_map[n]
        scope.vars.update(bound)
        try:
            for stmt in self.body:
                v.exec_stmt(stmt, scope)
        except _ReturnSignal as r:
            return r.value
        return None


_BINOPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod,
    ast.Pow: operator.pow,
    # pandas-style boolean combinators on columns (host ints get Python's
    # bitwise semantics, same operators).
    ast.BitAnd: operator.and_,
    ast.BitOr: operator.or_,
    ast.BitXor: operator.xor,
}

_CMPOPS = {
    ast.Eq: operator.eq,
    ast.NotEq: operator.ne,
    ast.Lt: operator.lt,
    ast.LtE: operator.le,
    ast.Gt: operator.gt,
    ast.GtE: operator.ge,
}

_SAFE_BUILTINS = {
    "len": len, "range": range, "int": int, "float": float, "str": str,
    "bool": bool, "abs": abs, "min": min, "max": max, "round": round,
    "list": list, "dict": dict, "sorted": sorted, "enumerate": enumerate,
    "zip": zip, "sum": sum, "True": True, "False": False, "None": None,
}


class ASTVisitor:
    """Evaluates a PxL module against a PlanBuilder-backed ``px`` module."""

    def __init__(self, px: PxModule):
        self.px = px
        self.module_scope = Scope()
        self.funcs: dict[str, PxFunc] = {}

    # -- entry point ---------------------------------------------------------
    def run(self, tree: ast.Module):
        for stmt in tree.body:
            self.exec_stmt(stmt, self.module_scope)

    # -- statements ----------------------------------------------------------
    def exec_stmt(self, node, scope: Scope):
        try:
            method = getattr(self, f"_stmt_{type(node).__name__}", None)
            if method is None:
                raise PxLError(
                    f"PxL does not support {type(node).__name__} statements",
                    node.lineno,
                )
            method(node, scope)
        except PxLError:
            raise
        except _ReturnSignal:
            raise
        except Exception as e:  # surface evaluation errors with location
            raise PxLError(f"{type(e).__name__}: {e}", getattr(node, "lineno", None))

    def _stmt_Import(self, node, scope):
        for alias in node.names:
            if alias.name == "px":
                scope.assign(alias.asname or "px", self.px)
            elif alias.name == "pxtrace":
                raise PxLError(
                    "pxtrace is not in this slice of the port", node.lineno
                )
            else:
                raise PxLError(
                    f"cannot import {alias.name!r}; only 'px' and 'pxtrace' "
                    "are available",
                    node.lineno,
                )

    def _stmt_ImportFrom(self, node, scope):
        raise PxLError("'from ... import' is not supported; use 'import px'",
                       node.lineno)

    def _stmt_Expr(self, node, scope):
        if isinstance(node.value, ast.Constant) and isinstance(node.value.value, str):
            return  # docstring
        self.eval(node.value, scope)

    def _stmt_Pass(self, node, scope):
        pass

    def _stmt_Assign(self, node, scope):
        value = self.eval(node.value, scope)
        for target in node.targets:
            self._assign_target(target, value, scope)

    def _stmt_AnnAssign(self, node, scope):
        if node.value is None:
            return
        self._assign_target(node.target, self.eval(node.value, scope), scope)

    def _stmt_AugAssign(self, node, scope):
        cur = self.eval(_as_load(node.target), scope)
        op = _BINOPS.get(type(node.op))
        if op is None:
            raise PxLError(f"unsupported augmented assignment", node.lineno)
        self._assign_target(node.target, self._binop(op, cur,
                                                     self.eval(node.value, scope),
                                                     node.lineno), scope)

    def _assign_target(self, target, value, scope):
        if isinstance(target, ast.Name):
            scope.assign(target.id, value)
        elif isinstance(target, ast.Attribute):
            obj = self.eval(target.value, scope)
            if not isinstance(obj, DataFrameObj):
                raise PxLError("attribute assignment is only valid on "
                               "dataframes (df.col = expr)", target.lineno)
            obj.set_column(target.attr, value, target.lineno)
        elif isinstance(target, ast.Subscript):
            obj = self.eval(target.value, scope)
            key = self.eval(target.slice, scope)
            if isinstance(obj, DataFrameObj):
                if not isinstance(key, str):
                    raise PxLError("df[...] = expr requires a string column "
                                   "name", target.lineno)
                obj.set_column(key, value, target.lineno)
            else:
                obj[key] = value
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals = list(value)
            if len(vals) != len(target.elts):
                raise PxLError("unpacking length mismatch", target.lineno)
            for t, v in zip(target.elts, vals):
                self._assign_target(t, v, scope)
        else:
            raise PxLError(
                f"unsupported assignment target {type(target).__name__}",
                target.lineno,
            )

    def _stmt_FunctionDef(self, node, scope):
        doc = ast.get_docstring(node) or ""
        fn = PxFunc(node.name, node.args, node.body, scope, self, doc)
        for dec in reversed(node.decorator_list):
            wrapper = self.eval(dec, scope)
            if not callable(wrapper):
                raise PxLError(
                    f"decorator on {node.name!r} is not callable", node.lineno
                )
            fn = wrapper(fn)
        scope.assign(node.name, fn)
        if scope is self.module_scope and isinstance(fn, PxFunc):
            self.funcs[node.name] = fn

    def _stmt_Return(self, node, scope):
        raise _ReturnSignal(self.eval(node.value, scope) if node.value else None)

    def _stmt_If(self, node, scope):
        cond = self.eval(node.test, scope)
        body = node.body if _truthy(cond, node.lineno) else node.orelse
        for stmt in body:
            self.exec_stmt(stmt, scope)

    def _stmt_For(self, node, scope):
        it = self.eval(node.iter, scope)
        if isinstance(it, (ColumnExpr, DataFrameObj)):
            raise PxLError("cannot iterate over deferred column/dataframe "
                           "values; loops run at compile time", node.lineno)
        for item in it:
            self._assign_target(node.target, item, scope)
            for stmt in node.body:
                self.exec_stmt(stmt, scope)
        for stmt in node.orelse:
            self.exec_stmt(stmt, scope)

    # -- expressions ---------------------------------------------------------
    def eval(self, node, scope: Scope):
        method = getattr(self, f"_expr_{type(node).__name__}", None)
        if method is None:
            raise PxLError(
                f"PxL does not support {type(node).__name__} expressions",
                getattr(node, "lineno", None),
            )
        return method(node, scope)

    def _expr_Constant(self, node, scope):
        return node.value

    def _expr_Name(self, node, scope):
        try:
            return scope.lookup(node.id)
        except KeyError:
            if node.id in _SAFE_BUILTINS:
                return _SAFE_BUILTINS[node.id]
            raise PxLError(f"name {node.id!r} is not defined", node.lineno)

    def _expr_Attribute(self, node, scope):
        obj = self.eval(node.value, scope)
        attr = node.attr
        if isinstance(obj, DataFrameObj):
            if attr in DF_METHODS:
                return _DFMethod(obj, attr)
            if attr == "ctx":
                return obj.ctx
            if attr == "columns":
                return obj.columns
            return obj.col(attr, node.lineno)
        from .objects import GroupbyObj

        if isinstance(obj, GroupbyObj) and attr == "agg":
            return _DFMethod(obj, "agg")
        if isinstance(obj, PxModule):
            try:
                return getattr(obj, attr)
            except PxLError as e:
                raise PxLError(e.raw_msg, node.lineno)
        raise PxLError(
            f"cannot access attribute {attr!r} on {type(obj).__name__}",
            node.lineno,
        )

    def _expr_Subscript(self, node, scope):
        obj = self.eval(node.value, scope)
        if isinstance(node.slice, ast.Slice):
            if isinstance(obj, (DataFrameObj, ColumnExpr)):
                raise PxLError("slicing is not supported on dataframes; use "
                               "head(n)", node.lineno)
            lo = self.eval(node.slice.lower, scope) if node.slice.lower else None
            hi = self.eval(node.slice.upper, scope) if node.slice.upper else None
            st = self.eval(node.slice.step, scope) if node.slice.step else None
            return obj[slice(lo, hi, st)]
        key = self.eval(node.slice, scope)
        if isinstance(obj, DataFrameObj):
            if isinstance(key, str):
                return obj.col(key, node.lineno)
            if isinstance(key, (list, tuple)):
                return obj.project(list(key), node.lineno)
            if isinstance(key, ColumnExpr):
                return obj.filter(key, node.lineno)
            raise PxLError(
                f"df[...] expects a column name, a list of names, or a "
                f"boolean expression; got {type(key).__name__}", node.lineno)
        try:
            return obj[key]
        except PxLError as e:
            raise PxLError(e.raw_msg, node.lineno)

    def _expr_Call(self, node, scope):
        fn = self.eval(node.func, scope)
        args = [self.eval(a, scope) for a in node.args]
        kwargs = {}
        for kw in node.keywords:
            if kw.arg is None:
                raise PxLError("**kwargs expansion is not supported",
                               node.lineno)
            kwargs[kw.arg] = self.eval(kw.value, scope)
        try:
            if isinstance(fn, _DFMethod):
                return getattr(fn.df, fn.name)(*args, lineno=node.lineno,
                                               **kwargs)
            return fn(*args, **kwargs)
        except PxLError as e:
            if e.lineno is None:
                raise PxLError(e.raw_msg, node.lineno)
            raise
        except _ReturnSignal:
            raise
        except Exception as e:
            raise PxLError(f"{type(e).__name__}: {e}", node.lineno)

    def _binop(self, op, left, right, lineno):
        try:
            return op(left, right)
        except PxLError as e:
            raise PxLError(e.raw_msg, lineno)
        except TypeError as e:
            raise PxLError(str(e), lineno)

    def _expr_BinOp(self, node, scope):
        op = _BINOPS.get(type(node.op))
        if op is None:
            raise PxLError(
                f"unsupported operator {type(node.op).__name__}", node.lineno)
        left = self.eval(node.left, scope)
        right = self.eval(node.right, scope)
        if op is operator.floordiv and (
            isinstance(left, ColumnExpr) or isinstance(right, ColumnExpr)
        ):
            # a // b on columns: floor(divide(a, b))
            div = self._binop(operator.truediv, left, right, node.lineno)
            return ScalarFuncMarker("floor")(div)
        return self._binop(op, left, right, node.lineno)

    def _expr_Compare(self, node, scope):
        left = self.eval(node.left, scope)
        result = None
        for opnode, rnode in zip(node.ops, node.comparators):
            right = self.eval(rnode, scope)
            op = _CMPOPS.get(type(opnode))
            if op is None:
                raise PxLError(
                    f"unsupported comparison {type(opnode).__name__}",
                    node.lineno)
            term = self._binop(op, left, right, node.lineno)
            result = term if result is None else self._combine_bool(
                "logicalAnd", result, term, node.lineno)
            left = right
        return result

    def _combine_bool(self, name, a, b, lineno):
        if isinstance(a, ColumnExpr) or isinstance(b, ColumnExpr):
            return ScalarFuncMarker(name)(a, b)
        return (a and b) if name == "logicalAnd" else (a or b)

    def _expr_BoolOp(self, node, scope):
        is_and = isinstance(node.op, ast.And)
        result = None
        for v in node.values:
            val = self.eval(v, scope)
            if result is None:
                result = val
            else:
                result = self._combine_bool(
                    "logicalAnd" if is_and else "logicalOr", result, val,
                    node.lineno)
            # host short-circuit once the folded value is decided
            if not isinstance(result, ColumnExpr):
                if is_and and not _truthy(result, node.lineno):
                    return result
                if not is_and and _truthy(result, node.lineno):
                    return result
        return result

    def _expr_UnaryOp(self, node, scope):
        val = self.eval(node.operand, scope)
        if isinstance(node.op, ast.Not):
            if isinstance(val, ColumnExpr):
                return ~val
            return not val
        if isinstance(node.op, ast.USub):
            return -val
        if isinstance(node.op, ast.UAdd):
            return +val if not isinstance(val, ColumnExpr) else val
        if isinstance(node.op, ast.Invert):
            return ~val
        raise PxLError("unsupported unary operator", node.lineno)

    def _expr_IfExp(self, node, scope):
        cond = self.eval(node.test, scope)
        if isinstance(cond, ColumnExpr):
            return ScalarFuncMarker("select")(
                cond, self.eval(node.body, scope), self.eval(node.orelse, scope)
            )
        return (self.eval(node.body, scope) if _truthy(cond, node.lineno)
                else self.eval(node.orelse, scope))

    def _expr_List(self, node, scope):
        return [self.eval(e, scope) for e in node.elts]

    def _expr_Tuple(self, node, scope):
        return tuple(self.eval(e, scope) for e in node.elts)

    def _expr_Dict(self, node, scope):
        out = {}
        for k, v in zip(node.keys, node.values):
            if k is None:
                raise PxLError("**dict expansion is not supported", node.lineno)
            out[self.eval(k, scope)] = self.eval(v, scope)
        return out

    def _expr_JoinedStr(self, node, scope):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:  # FormattedValue
                val = self.eval(v.value, scope)
                if isinstance(val, (ColumnExpr, DataFrameObj)):
                    raise PxLError(
                        "f-strings cannot embed column expressions; use "
                        "string UDFs", node.lineno)
                parts.append(format(val, v.format_spec and
                                    self.eval(v.format_spec, scope) or ""))
        return "".join(parts)

    def _expr_ListComp(self, node, scope):
        if len(node.generators) != 1:
            raise PxLError("nested comprehensions are not supported",
                           node.lineno)
        gen = node.generators[0]
        it = self.eval(gen.iter, scope)
        out = []
        child = Scope(parent=scope)
        for item in it:
            self._assign_target(gen.target, item, child)
            if all(_truthy(self.eval(c, child), node.lineno)
                   for c in gen.ifs):
                out.append(self.eval(node.elt, child))
        return out

    def _expr_Lambda(self, node, scope):
        raise PxLError(
            "lambdas are not supported; use px.<func> expressions", node.lineno)


def _truthy(value, lineno) -> bool:
    if isinstance(value, ColumnExpr):
        raise PxLError(
            "column expressions have no compile-time truth value", lineno)
    if isinstance(value, DataFrameObj):
        raise PxLError("dataframes have no compile-time truth value", lineno)
    return bool(value)


def _as_load(node):
    import copy

    n = copy.copy(node)
    n.ctx = ast.Load()
    return n
