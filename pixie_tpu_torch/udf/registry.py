"""UDF/UDA registry keyed by name + argument types.

Reference parity: ``src/carnot/udf/registry.h:101`` (Registry with
RegisterOrDie / GetScalarUDF by name+types). Overload resolution applies
the implicit-cast lattice in ``udf.py``.
"""

from __future__ import annotations

from typing import Callable, Iterable

from ..types.dtypes import DataType
from .udf import Executor, ScalarUDFDef, SignatureError, UDADef, resolve_overload


class Registry:
    def __init__(self, name: str = "default"):
        self.name = name
        self._scalar: dict[str, list[ScalarUDFDef]] = {}
        self._uda: dict[str, list[UDADef]] = {}

    # -- registration --------------------------------------------------------
    def register_scalar(self, udf: ScalarUDFDef) -> None:
        for existing in self._scalar.setdefault(udf.name, []):
            if existing.arg_types == udf.arg_types:
                raise ValueError(
                    f"duplicate scalar UDF {udf.name!r} with arg types {udf.arg_types}"
                )
        self._scalar[udf.name].append(udf)

    def register_uda(self, uda: UDADef) -> None:
        for existing in self._uda.setdefault(uda.name, []):
            if existing.arg_types == uda.arg_types:
                raise ValueError(
                    f"duplicate UDA {uda.name!r} with arg types {uda.arg_types}"
                )
        self._uda[uda.name].append(uda)

    def scalar(
        self,
        name: str,
        arg_types: Iterable[DataType],
        return_type: DataType,
        fn: Callable,
        executor: Executor = Executor.DEVICE,
        dict_arg: int = 0,
        out_dict=None,
        doc: str = "",
        semantic_type: int = 1,
    ) -> ScalarUDFDef:
        udf = ScalarUDFDef(
            name=name,
            arg_types=tuple(arg_types),
            return_type=return_type,
            fn=fn,
            executor=executor,
            dict_arg=dict_arg,
            out_dict=out_dict,
            doc=doc,
            semantic_type=semantic_type,
        )
        self.register_scalar(udf)
        return udf

    def uda(
        self,
        name: str,
        arg_types: Iterable[DataType],
        return_type: DataType,
        *,
        init: Callable,
        update: Callable,
        merge: Callable,
        finalize: Callable,
        struct_fields: tuple[str, ...] | None = None,
        doc: str = "",
        semantic_type: int = 1,
    ) -> UDADef:
        d = UDADef(
            name=name,
            arg_types=tuple(arg_types),
            return_type=return_type,
            init=init,
            update=update,
            merge=merge,
            finalize=finalize,
            struct_fields=struct_fields,
            doc=doc,
            semantic_type=semantic_type,
        )
        self.register_uda(d)
        return d

    # -- lookup --------------------------------------------------------------
    def has_scalar(self, name: str) -> bool:
        return name in self._scalar

    def has_uda(self, name: str) -> bool:
        return name in self._uda

    def get_scalar(self, name: str, arg_types: Iterable[DataType]) -> ScalarUDFDef:
        if name not in self._scalar:
            raise SignatureError(f"no scalar UDF named {name!r}")
        return resolve_overload(self._scalar[name], tuple(arg_types))

    def get_uda(self, name: str, arg_types: Iterable[DataType]) -> UDADef:
        if name not in self._uda:
            raise SignatureError(f"no UDA named {name!r}")
        return resolve_overload(self._uda[name], tuple(arg_types))

    def scalar_names(self) -> list[str]:
        return sorted(self._scalar)

    def uda_names(self) -> list[str]:
        return sorted(self._uda)

    def scalar_overloads(self, name: str) -> list[ScalarUDFDef]:
        return list(self._scalar.get(name, []))

    def uda_overloads(self, name: str) -> list[UDADef]:
        return list(self._uda.get(name, []))

    def clone(self, name: str | None = None, exclude=()) -> "Registry":
        """Shallow copy (defs are frozen), optionally dropping some names —
        used to rebind state-backed funcs (metadata) without losing caller
        registrations."""
        out = Registry(name or self.name)
        ex = set(exclude)
        out._scalar = {n: list(v) for n, v in self._scalar.items() if n not in ex}
        out._uda = {n: list(v) for n, v in self._uda.items() if n not in ex}
        return out

    def docs(self) -> dict[str, str]:
        """name -> doc for every registered func (doc-extraction parity)."""
        out = {}
        for name, ovs in {**self._scalar, **self._uda}.items():
            out[name] = next((o.doc for o in ovs if o.doc), "")
        return out


_default_registry: Registry | None = None


def default_registry() -> Registry:
    """Process-wide registry with all builtins registered (lazily)."""
    global _default_registry
    if _default_registry is None:
        _default_registry = Registry("builtins")
        from .builtins import register_all

        register_all(_default_registry)
    return _default_registry
