"""OTel export: result batches -> OTLP-shaped payloads.

Reference parity: ``src/carnot/exec/otel_export_sink_node.{h,cc}``
(``:40``) converts RowBatches into OpenTelemetry metrics and spans and
ships them over OTLP gRPC; the planner side is the ``px.otel`` module
(``planner/objects/otel.h:35``, here ``planner/otel_module.py``). A
port of the JAX package's ``exec/otel.py``: the five data classes (which
the wire's type table names), ``batch_to_otlp`` (the OTLP JSON encoding:
ResourceMetrics / ResourceSpans dicts, the same shapes as the JAX
package's), ``OTLPHttpExporter`` (OTLP/HTTP over stdlib ``urllib``) and
``ExportError``.

The sink runs on the host over the query's folded result: the engine
materializes the sink's input once (one readback from the card) and
``batch_to_otlp`` reads the host batch, its STRING columns decoded from
their dictionary ids. The engine's own query traces (``exec/trace.py``)
take the same path: ``QueryTrace.to_otlp()`` builds a ResourceSpans
payload with ``_attr_kvs`` and the ``Tracer`` pushes it through
``OTLPHttpExporter`` when the ``trace_export_url`` flag is set.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class OTelEndpointConfig:
    url: str = ""
    headers: tuple = ()  # tuple[(k, v)]
    insecure: bool = False


@dataclass(frozen=True)
class OTelMetricGauge:
    name: str
    value_column: str
    attributes: tuple = ()  # tuple[(attr name, column name)]
    unit: str = ""
    description: str = ""


@dataclass(frozen=True)
class OTelMetricSummary:
    """Quantile summary metric: columns per quantile point."""

    name: str
    count_column: str
    quantile_columns: tuple = ()  # tuple[(q float, column name)]
    attributes: tuple = ()
    unit: str = ""
    description: str = ""


@dataclass(frozen=True)
class OTelSpan:
    name: str  # literal name or (when name_is_column) a column
    start_time_column: str = "time_"
    end_time_column: str = "end_time"
    attributes: tuple = ()
    name_is_column: bool = False


@dataclass(frozen=True)
class OTelDataSpec:
    endpoint: OTelEndpointConfig = field(default_factory=OTelEndpointConfig)
    resource: tuple = ()  # tuple[(attr, literal str or ("column", name))]
    data: tuple = ()  # tuple[Gauge | Summary | Span]

    def referenced_columns(self) -> set:
        cols = set()
        for _a, v in self.resource:
            if isinstance(v, tuple) and v[0] == "column":
                cols.add(v[1])
        for d in self.data:
            if isinstance(d, OTelMetricGauge):
                cols.add(d.value_column)
            elif isinstance(d, OTelMetricSummary):
                cols.add(d.count_column)
                cols.update(c for _q, c in d.quantile_columns)
            elif isinstance(d, OTelSpan):
                cols.update({d.start_time_column, d.end_time_column})
                if d.name_is_column:
                    cols.add(d.name)
            cols.update(c for _a, c in getattr(d, "attributes", ()))
        return cols


def _attr_kvs(pairs):
    return [
        {"key": k, "value": {"stringValue": str(v)}} for k, v in pairs
    ]


def batch_to_otlp(hb, spec: OTelDataSpec) -> dict:
    """One HostBatch -> {'resourceMetrics': [...], 'resourceSpans': [...]}.

    Rows are split by their resource-attribute values — one
    ResourceMetrics/ResourceSpans entry per distinct resource, as the
    reference sink does (otel_export_sink_node.cc groups by resource).
    """
    d = hb.to_pydict()
    n = hb.length

    res_cols = [
        v[1]
        for _a, v in spec.resource
        if isinstance(v, tuple) and v[0] == "column"
    ]
    groups: dict[tuple, list[int]] = {}
    for i in range(n):
        groups.setdefault(tuple(d[c][i] for c in res_cols), []).append(i)
    if not groups and not res_cols:
        # No rows: one resource of literal attributes with empty points,
        # as the JAX package emits. With a column attribute there is no
        # resource to name, and no payload (the JAX package raises
        # StopIteration there).
        groups[()] = []

    def resource_attrs(key: tuple):
        out, it = [], iter(key)
        for attr, v in spec.resource:
            if isinstance(v, tuple) and v[0] == "column":
                out.append((attr, next(it)))
            else:
                out.append((attr, v))
        return _attr_kvs(out)

    payload: dict = {}
    for key, rows in groups.items():
        gauges, summaries, spans = [], [], []
        for item in spec.data:
            if isinstance(item, OTelMetricGauge):
                pts = [
                    {
                        "timeUnixNano": int(d["time_"][i]) if "time_" in d else 0,
                        "asDouble": float(d[item.value_column][i]),
                        "attributes": _attr_kvs(
                            (a, d[c][i]) for a, c in item.attributes
                        ),
                    }
                    for i in rows
                ]
                gauges.append(
                    {
                        "name": item.name,
                        "unit": item.unit,
                        "description": item.description,
                        "gauge": {"dataPoints": pts},
                    }
                )
            elif isinstance(item, OTelMetricSummary):
                pts = [
                    {
                        "timeUnixNano": int(d["time_"][i]) if "time_" in d else 0,
                        "count": int(d[item.count_column][i]),
                        "quantileValues": [
                            {"quantile": q, "value": float(d[c][i])}
                            for q, c in item.quantile_columns
                        ],
                        "attributes": _attr_kvs(
                            (a, d[c][i]) for a, c in item.attributes
                        ),
                    }
                    for i in rows
                ]
                summaries.append(
                    {
                        "name": item.name,
                        "unit": item.unit,
                        "description": item.description,
                        "summary": {"dataPoints": pts},
                    }
                )
            elif isinstance(item, OTelSpan):
                for i in rows:
                    spans.append(
                        {
                            "name": (
                                str(d[item.name][i])
                                if item.name_is_column
                                else item.name
                            ),
                            "startTimeUnixNano": int(d[item.start_time_column][i]),
                            "endTimeUnixNano": int(d[item.end_time_column][i]),
                            "attributes": _attr_kvs(
                                (a, d[c][i]) for a, c in item.attributes
                            ),
                        }
                    )
        metrics = gauges + summaries
        if metrics:
            payload.setdefault("resourceMetrics", []).append(
                {
                    "resource": {"attributes": resource_attrs(key)},
                    "scopeMetrics": [{"metrics": metrics}],
                }
            )
        if spans:
            payload.setdefault("resourceSpans", []).append(
                {
                    "resource": {"attributes": resource_attrs(key)},
                    "scopeSpans": [{"spans": spans}],
                }
            )
    return payload


class OTLPHttpExporter:
    """Push OTLP-JSON payloads over HTTP (stdlib urllib; no grpc in env).

    Reference transport parity: ``otel_export_sink_node.cc`` ships the
    same payloads over OTLP gRPC with retries; OTLP/HTTP is the spec's
    sibling encoding (POST /v1/metrics, /v1/traces). Bind an instance as
    an engine's ``export_otel`` to turn collected exports into pushes.
    """

    def __init__(self, base_url: str, headers=(), timeout_s: float = 5.0,
                 max_retries: int = 2):
        self.base_url = base_url.rstrip("/")
        self.headers = tuple(headers)
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.pushed = 0
        self.errors = 0

    def __call__(self, payload: dict, endpoint=None) -> None:
        url = self.base_url
        if endpoint is not None and getattr(endpoint, "url", ""):
            url = endpoint.url.rstrip("/")
        jobs = []
        if payload.get("resourceMetrics"):
            jobs.append((url + "/v1/metrics",
                         {"resourceMetrics": payload["resourceMetrics"]}))
        if payload.get("resourceSpans"):
            jobs.append((url + "/v1/traces",
                         {"resourceSpans": payload["resourceSpans"]}))
        for u, body in jobs:
            self._post(u, body, endpoint)

    def _post(self, url: str, body: dict, endpoint) -> None:
        import json as _json
        import time as _time
        import urllib.error
        import urllib.request

        data = _json.dumps(body).encode()
        headers = {"Content-Type": "application/json"}
        headers.update(dict(self.headers))
        if endpoint is not None:
            headers.update(dict(getattr(endpoint, "headers", ()) or ()))
        last = None
        for attempt in range(self.max_retries + 1):
            req = urllib.request.Request(url, data=data, headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s):
                    self.pushed += 1
                    return
            except urllib.error.HTTPError as e:
                last = e
                if e.code not in (429,) and e.code < 500:
                    break  # 4xx (auth, bad request): retrying cannot help
                if attempt < self.max_retries:
                    _time.sleep(min(0.2 * (2 ** attempt), 2.0))
            except (urllib.error.URLError, OSError) as e:
                last = e
                if attempt < self.max_retries:
                    _time.sleep(min(0.2 * (2 ** attempt), 2.0))
        self.errors += 1
        raise ExportError(f"OTLP push to {url} failed: {last}")


class ExportError(Exception):
    pass
