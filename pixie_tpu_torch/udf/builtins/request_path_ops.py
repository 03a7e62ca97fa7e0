"""Request-path endpoint clustering UDFs (dictionary-side).

Reference parity: ``src/carnot/funcs/builtins/request_path_ops.{h,cc}``
— ``RequestPathClusteringFitUDA`` (:230) clusters a corpus of request
paths into endpoint templates ("/a/b/123" -> "/a/b/*") and
``RequestPathClusteringPredictUDF``/``RequestPathEndpointMatcherUDF``
apply them.

Divergence (documented): the reference fits per-depth centroid clusters
over the observed corpus; here templating is a per-string decision —
path segments that look machine-generated (numeric, uuid, long hex,
high-digit-density tokens) become ``*``. This runs once per distinct
path in the dictionary and produces the same endpoint grouping for the
id-segment shapes the reference's own tests exercise, without a
stateful fit pass.
"""

from __future__ import annotations

import re

from ..udf import BOOLEAN, STRING, Executor

_NUM = re.compile(r"^\d+$")
_UUID = re.compile(
    r"^[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-"
    r"[0-9a-fA-F]{4}-[0-9a-fA-F]{12}$"
)
_HEX = re.compile(r"^[0-9a-fA-F]{8,}$")


def _is_id_segment(seg: str) -> bool:
    if not seg:
        return False
    if _NUM.match(seg) or _UUID.match(seg) or _HEX.match(seg):
        return True
    digits = sum(c.isdigit() for c in seg)
    return len(seg) >= 8 and digits / len(seg) >= 0.5


def _split(path: str):
    # "/a/b" and "a/b" are equivalent (request_path_ops.h:43); strip any
    # query string first.
    path = path.split("?", 1)[0]
    return [s for s in path.split("/") if s]


def cluster_request_path(path: str) -> str:
    segs = [("*" if _is_id_segment(s) else s) for s in _split(path)]
    return "/" + "/".join(segs)


def _endpoint_matches(path: str, template: str) -> bool:
    ps, ts = _split(path), _split(template)
    if len(ps) != len(ts):
        return False
    return all(t == "*" or t == p for p, t in zip(ps, ts))


def register(reg):
    reg.scalar(
        "_predict_request_path_cluster", (STRING,), STRING,
        cluster_request_path,
        executor=Executor.HOST_DICT, dict_arg=0,
        doc="Map a request path to its endpoint template "
            "(id-like segments become '*').",
    )
    # The user-facing alias the px scripts use.
    reg.scalar(
        "cluster_request_path", (STRING,), STRING, cluster_request_path,
        executor=Executor.HOST_DICT, dict_arg=0,
        doc="Map a request path to its endpoint template "
            "(id-like segments become '*').",
    )

    def matcher(path: str, template) -> bool:
        return _endpoint_matches(path, str(template))

    reg.scalar(
        "_match_endpoint", (STRING, STRING), BOOLEAN, matcher,
        executor=Executor.HOST_DICT, dict_arg=0,
        doc="True when the request path matches the endpoint template "
            "(literal second argument).",
    )
