"""Cluster/engine introspection UDTFs.

Reference parity: ``src/vizier/funcs/md_udtfs/md_udtfs_impl.h`` —
``GetTables`` (:105), ``GetTableSchemas`` (:169), ``GetUDTFList`` (:337),
``GetUDFList`` (:429), ``GetUDAList`` (:490), debug table info (:554).
These run against the executing engine (ctx). A copy of the JAX
package's ``udf/builtins/introspection.py``; the service-level
``GetAgentStatus`` (:258) needs the agent runtime's bus, which the port
does not have yet.
"""

from __future__ import annotations

import json

from ...types.dtypes import DataType
from ..udtf import UDTFExecutor

S = DataType.STRING
I = DataType.INT64


def _get_tables(engine):
    names, rows, bts = [], [], []
    for name, t in sorted(engine.tables.items()):
        if t is None:
            continue
        st = t.stats()
        names.append(name)
        rows.append(st.num_rows)
        bts.append(st.bytes)
    return {"table_name": names, "num_rows": rows, "size_bytes": bts}


def _get_table_schemas(engine):
    tables, cols, types = [], [], []
    for name, t in sorted(engine.tables.items()):
        if t is None:
            continue
        for cname, dt in t.relation.items():
            tables.append(name)
            cols.append(cname)
            types.append(dt.name)
    return {"table_name": tables, "column_name": cols, "column_type": types}


def _get_udf_list(engine):
    names, sigs = [], []
    for n in engine.registry.scalar_names():
        for ov in engine.registry.scalar_overloads(n):
            names.append(n)
            sigs.append(
                json.dumps(
                    {
                        "args": [t.name for t in ov.arg_types],
                        "return": ov.return_type.name,
                        "executor": ov.executor.name,
                    }
                )
            )
    return {"name": names, "signature": sigs}


def _get_uda_list(engine):
    names, sigs = [], []
    for n in engine.registry.uda_names():
        for ov in engine.registry.uda_overloads(n):
            names.append(n)
            sigs.append(
                json.dumps(
                    {
                        "args": [t.name for t in ov.arg_types],
                        "return": ov.return_type.name,
                    }
                )
            )
    return {"name": names, "signature": sigs}


def _get_udtf_list(engine):
    names, execs, rels = [], [], []
    for n in engine.registry.udtf_names():
        d = engine.registry.get_udtf(n)
        names.append(n)
        execs.append(d.executor.name)
        rels.append(json.dumps([[c, t.name] for c, t in d.relation]))
    return {"name": names, "executor": execs, "relation": rels}


def _get_debug_table_info(engine):
    out = {
        k: []
        for k in (
            "table_name",
            "bytes",
            "hot_bytes",
            "cold_bytes",
            "hot_rows",
            "cold_rows",
            "cold_raw_bytes",
            "cold_demotions",
            "cold_evictions",
            "num_batches",
            "batches_expired",
            "compacted_batches",
            "min_time",
        )
    }
    for name, t in sorted(engine.tables.items()):
        if t is None:
            continue
        st = t.stats()
        out["table_name"].append(name)
        out["bytes"].append(st.bytes)
        out["hot_bytes"].append(st.hot_bytes)
        out["cold_bytes"].append(st.cold_bytes)
        out["hot_rows"].append(st.hot_rows)
        out["cold_rows"].append(st.cold_rows)
        out["cold_raw_bytes"].append(st.cold_raw_bytes)
        out["cold_demotions"].append(st.demotions)
        out["cold_evictions"].append(st.evictions)
        out["num_batches"].append(st.num_batches)
        out["batches_expired"].append(st.batches_expired)
        out["compacted_batches"].append(st.compacted_batches)
        out["min_time"].append(st.min_time)
    return out


def register_introspection(reg) -> None:
    reg.udtf(
        "GetTables",
        [("table_name", S), ("num_rows", I), ("size_bytes", I)],
        _get_tables,
        executor=UDTFExecutor.ALL_AGENTS,
        doc="Lists tables with row counts and byte sizes.",
    )
    reg.udtf(
        "GetTableSchemas",
        [("table_name", S), ("column_name", S), ("column_type", S)],
        _get_table_schemas,
        executor=UDTFExecutor.ALL_AGENTS,
        doc="Lists every column of every table.",
    )
    reg.udtf(
        "GetUDFList",
        [("name", S), ("signature", S)],
        _get_udf_list,
        doc="Lists registered scalar UDF overloads.",
    )
    reg.udtf(
        "GetUDAList",
        [("name", S), ("signature", S)],
        _get_uda_list,
        doc="Lists registered UDA overloads.",
    )
    reg.udtf(
        "GetUDTFList",
        [("name", S), ("executor", S), ("relation", S)],
        _get_udtf_list,
        doc="Lists registered UDTFs.",
    )
    reg.udtf(
        "GetVersion",
        [("key", S), ("value", S)],
        _get_version,
        doc="Build/version metadata of the executing process "
            "(reference Version UDTF / statusz surface).",
    )
    reg.udtf(
        "GetDebugTableInfo",
        [
            ("table_name", S),
            ("bytes", I),
            ("hot_bytes", I),
            ("cold_bytes", I),
            ("hot_rows", I),
            ("cold_rows", I),
            ("cold_raw_bytes", I),
            ("cold_demotions", I),
            ("cold_evictions", I),
            ("num_batches", I),
            ("batches_expired", I),
            ("compacted_batches", I),
            ("min_time", I),
        ],
        _get_debug_table_info,
        executor=UDTFExecutor.ALL_AGENTS,
        doc="Table-store internals per table (debug).",
    )


def _get_version(engine):
    from ... import version as _v

    info = _v.version_info()
    return {
        "key": list(info),
        "value": ["" if v is None else str(v) for v in info.values()],
    }
