"""``df.ctx['service']`` resolution: metadata property -> UDF call.

Reference parity: ``src/carnot/planner/metadata/metadata_handler.h:72`` +
the convert_metadata_rule analyzer pass — a ctx property becomes an
``upid_to_*`` function call on the table's UPID column. The mapping is
driven by UDF *semantic-type annotations* (``udf/type_inference.h``
analog): any registered UPID->STRING function whose return semantic
type names the property answers it, so engines that register custom
metadata functions get ctx resolution without touching this module.
"""

from __future__ import annotations

from ..exec.plan import ColumnRef, FuncCall
from ..planner.objects import ColumnExpr, PxLError
from ..types.dtypes import DataType
from ..types.semantic import CTX_KEYS, SemanticType

# id-valued ctx keys have no semantic type (they are opaque uids); they
# resolve by conventional function name.
_ID_CTX_FUNCS = {
    "pod_id": "upid_to_pod_id",
    "service_id": "upid_to_service_id",
    "container_id": "upid_to_container_id",
    "cmdline": "upid_to_cmdline",
    "cmd": "upid_to_cmdline",
}

_UPID_COLUMNS = ("upid", "upid_")


def _semantic_ctx_funcs(registry) -> dict[str, str]:
    """ctx key -> function name, derived from semantic annotations: a
    scalar UDF taking (UINT128) and returning a string with e.g.
    ST_SERVICE_NAME answers ctx['service'] / ctx['service_name'].

    The map depends only on the registry's contents; cache it on the
    registry object (registries are cloned, not mutated, when metadata
    rebinds — see Engine.set_metadata_state)."""
    cached = getattr(registry, "_ctx_funcs_cache", None)
    if cached is not None:
        return cached
    out: dict[str, str] = {}
    for fname in registry.scalar_names():
        for ov in registry.scalar_overloads(fname):
            if ov.arg_types != (DataType.UINT128,):
                continue
            try:
                st = SemanticType(ov.semantic_type)
            except ValueError:
                continue  # user-defined semantic value: no ctx mapping
            keys = CTX_KEYS.get(st)
            if not keys:
                continue
            for k in keys:
                out.setdefault(k, fname)
    registry._ctx_funcs_cache = out
    return out


def available_ctx_keys(registry) -> list[str]:
    return sorted(set(_ID_CTX_FUNCS) | set(_semantic_ctx_funcs(registry)))


def resolve_ctx(df, key: str) -> ColumnExpr:
    registry = df.builder.registry
    funcs = _semantic_ctx_funcs(registry)
    fname = funcs.get(key) or _ID_CTX_FUNCS.get(key)
    if fname is None:
        known = available_ctx_keys(registry)
        if key in (
            "pod", "pod_name", "service", "service_name", "namespace",
            "node", "node_name", "container", "container_name",
        ):
            raise PxLError(
                f"ctx[{key!r}]: metadata functions are not registered on "
                "this engine (no metadata state attached)"
            )
        raise PxLError(
            f"unknown metadata property ctx[{key!r}]; available: {known}"
        )
    upid_col = next(
        (c for c in _UPID_COLUMNS if df.relation.has_column(c)), None
    )
    if upid_col is None:
        raise PxLError(
            f"ctx[{key!r}] requires a 'upid' column in the table "
            f"(have: {list(df.relation.column_names)})"
        )
    if not registry.has_scalar(fname):
        raise PxLError(
            f"ctx[{key!r}]: metadata functions are not registered on this "
            "engine (no metadata state attached)"
        )
    return ColumnExpr(FuncCall(fname, (ColumnRef(upid_col),)), df)
