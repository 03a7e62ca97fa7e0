"""Semantic column types: what a value MEANS beyond its storage type.

Reference parity: the SemanticType enum
(``src/shared/types/typespb/types.proto:63-92``) and the
UDF semantic-inference machinery (``src/carnot/udf/type_inference.h``)
that threads e.g. ST_SERVICE_NAME through plans so metadata resolution
and UI formatting know a STRING column holds service names.

Here semantic types annotate UDF/UDA definitions directly (see
``udf.ScalarUDFDef.semantic_type``); the metadata resolver derives its
ctx-property mapping from them and docgen publishes them.
"""

from __future__ import annotations

import enum


class SemanticType(enum.IntEnum):
    """Mirrors the reference enum's names/values (types.proto:63)."""

    ST_UNSPECIFIED = 0
    ST_NONE = 1
    ST_TIME_NS = 2
    ST_AGENT_UID = 100
    ST_ASID = 101
    ST_UPID = 200
    ST_SERVICE_NAME = 300
    ST_POD_NAME = 400
    ST_POD_PHASE = 401
    ST_POD_STATUS = 402
    ST_NODE_NAME = 500
    ST_CONTAINER_NAME = 600
    ST_CONTAINER_STATE = 601
    ST_CONTAINER_STATUS = 602
    ST_NAMESPACE_NAME = 700
    ST_BYTES = 800
    ST_PERCENT = 900
    ST_DURATION_NS = 901
    ST_THROUGHPUT_PER_NS = 902
    ST_THROUGHPUT_BYTES_PER_NS = 903
    ST_QUANTILES = 1000
    ST_DURATION_NS_QUANTILES = 1001
    ST_IP_ADDRESS = 1100
    ST_PORT = 1200
    ST_HTTP_REQ_METHOD = 1300
    ST_HTTP_RESP_STATUS = 1400
    ST_HTTP_RESP_MESSAGE = 1500
    ST_SCRIPT_REFERENCE = 3000


#: Semantic type -> df.ctx[...] property keys it answers (the
#: convert_metadata_rule mapping, driven by annotations instead of a
#: hardcoded handler list).
CTX_KEYS: dict[SemanticType, tuple[str, ...]] = {
    SemanticType.ST_POD_NAME: ("pod", "pod_name"),
    SemanticType.ST_SERVICE_NAME: ("service", "service_name"),
    SemanticType.ST_NODE_NAME: ("node", "node_name"),
    SemanticType.ST_NAMESPACE_NAME: ("namespace",),
    SemanticType.ST_CONTAINER_NAME: ("container", "container_name"),
}
