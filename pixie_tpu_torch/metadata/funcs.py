"""Metadata UDFs: UPID/IP/entity-id -> k8s names, bound to a state snapshot.

Reference parity: ``src/carnot/funcs/metadata/`` — upid_to_pod_name,
upid_to_service_name, pod_id_to_*, ip_to_pod_id, etc.

A port of the JAX package's ``metadata/funcs.py``. The UPID family is a
DEVICE lookup: the host builds a bounded-probe hash table
(``ops/hashtable.py``) from the metadata snapshot, and the fragment
resolves UPIDs with a fixed number of gathers, emitting ids into an
entity-name dictionary (no per-row host callbacks, unlike the
reference's per-row C++ UDF calls). The table and the id maps go to the
device on the first window that reads them and stay there for the
snapshot's life: once per snapshot, never once per window. The
id-string family (pod_id_to_pod_name, ip_to_pod_id, ...) runs
HOST_DICT: once per distinct string, O(dictionary) not O(rows).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.hashtable import build_table, device_lookup
from ..types.strings import StringDictionary
from ..udf.udf import Executor, STRING, UINT128, device_constant
from .state import MetadataState

from ..types.semantic import SemanticType as ST

# upid_to_* attribute -> (snapshot_entries key, semantic type of result)
_UPID_ATTRS = {
    "upid_to_pod_id": ("pod_id", ST.ST_NONE),
    "upid_to_pod_name": ("pod_name", ST.ST_POD_NAME),
    "upid_to_namespace": ("namespace", ST.ST_NAMESPACE_NAME),
    "upid_to_node_name": ("node_name", ST.ST_NODE_NAME),
    "upid_to_service_id": ("service_id", ST.ST_NONE),
    "upid_to_service_name": ("service_name", ST.ST_SERVICE_NAME),
    "upid_to_container_id": ("container_id", ST.ST_NONE),
    "upid_to_container_name": ("container_name", ST.ST_CONTAINER_NAME),
    "upid_to_cmdline": ("cmdline", ST.ST_NONE),
}


_HOST_FUNC_NAMES = (
    "pod_id_to_pod_name", "pod_id_to_namespace", "pod_id_to_node_name",
    "pod_id_to_service_name", "pod_id_to_service_id",
    "service_id_to_service_name", "ip_to_pod_id", "pod_name_to_pod_id",
    "service_name_to_service_id",
)
METADATA_FUNC_NAMES = tuple(_UPID_ATTRS) + _HOST_FUNC_NAMES


def register_metadata_funcs(reg, state: MetadataState) -> None:
    """Register metadata UDFs bound to a snapshot of ``state``.

    Call again (on a fresh Registry) after metadata changes; the engine
    re-binds per query the way the reference hands each query a fresh
    AgentMetadataState snapshot.
    """
    snap = state.snapshot_entries()
    n = len(snap["hi"])
    his = np.asarray(snap["hi"], dtype=np.uint64)
    los = np.asarray(snap["lo"], dtype=np.uint64)
    table = build_table((his, los), np.arange(n, dtype=np.int32))

    for fname, (attr, st) in _UPID_ATTRS.items():
        d = StringDictionary()
        ids = np.asarray(d.encode(snap[attr] + [""]))  # [n+1]; n = miss -> ""

        def fn(upid, _tbl=table, _ids=device_constant(ids), _n=n):
            hi, lo = upid
            vals, found = device_lookup(_tbl, (hi, lo))
            return _ids(hi.device)[torch.where(found, vals, _n).long()]

        reg.scalar(
            fname, (UINT128,), STRING, fn, out_dict=d,
            doc=f"Resolve a UPID to its {attr.replace('_', ' ')} "
                "(empty string when unknown).",
            semantic_type=int(st),
        )

    # -- id/ip string translations (HOST_DICT: once per distinct value) ------
    pods, services = dict(state.pods), dict(state.services)
    ip_to_pod = dict(state.ip_to_pod)

    def _pod(pid):
        return pods.get(pid)

    host = dict(executor=Executor.HOST_DICT, dict_arg=0)
    reg.scalar("pod_id_to_pod_name", (STRING,), STRING,
               lambda s: p.qualified_name if (p := _pod(s)) else "", **host,
               doc="Pod UID to namespace/name.")
    reg.scalar("pod_id_to_namespace", (STRING,), STRING,
               lambda s: p.namespace if (p := _pod(s)) else "", **host)
    reg.scalar("pod_id_to_node_name", (STRING,), STRING,
               lambda s: p.node_name if (p := _pod(s)) else "", **host)
    reg.scalar(
        "pod_id_to_service_name", (STRING,), STRING,
        lambda s: (
            svc.qualified_name
            if (p := _pod(s)) and (svc := state.service_of_pod(p))
            else ""
        ),
        **host, doc="Pod UID to owning service namespace/name.",
    )
    reg.scalar(
        "pod_id_to_service_id", (STRING,), STRING,
        lambda s: (
            svc.uid
            if (p := _pod(s)) and (svc := state.service_of_pod(p))
            else ""
        ),
        **host,
    )
    reg.scalar("service_id_to_service_name", (STRING,), STRING,
               lambda s: v.qualified_name if (v := services.get(s)) else "",
               **host)
    reg.scalar("ip_to_pod_id", (STRING,), STRING,
               lambda s: ip_to_pod.get(s, ""), **host,
               doc="Cluster pod IP to pod UID (empty for external IPs).")
    reg.scalar(
        "pod_name_to_pod_id", (STRING,), STRING,
        lambda s: next(
            (p.uid for p in pods.values() if p.qualified_name == s), ""
        ),
        **host,
    )
    reg.scalar(
        "service_name_to_service_id", (STRING,), STRING,
        lambda s: next(
            (v.uid for v in services.values() if v.qualified_name == s), ""
        ),
        **host,
    )
