"""The ``px.otel`` namespace: export configuration objects.

Reference parity: ``src/carnot/planner/objects/otel.h:35`` (OTelModule:
``px.otel.Data``, ``px.otel.metric.Gauge/Summary``,
``px.otel.trace.Span``, ``px.otel.Endpoint``) consumed by
``px.export(df, ...)`` (``exporter.h``).
"""

from __future__ import annotations

from ..exec.otel import (
    OTelDataSpec,
    OTelEndpointConfig,
    OTelMetricGauge,
    OTelMetricSummary,
    OTelSpan,
)
from ..exec.plan import ColumnRef
from .objects import ColumnExpr, PxLError


def _colname(v, what: str):
    if isinstance(v, ColumnExpr) and isinstance(v.expr, ColumnRef):
        return v.expr.name
    if isinstance(v, str):
        return v
    raise PxLError(
        f"{what} must be a plain dataframe column (df.col), got {v!r}"
    )


def _attr_pairs(attributes, what: str):
    return tuple(
        (k, _colname(v, f"{what} attribute {k!r}"))
        for k, v in (attributes or {}).items()
    )


class _MetricNamespace:
    def Gauge(self, name, value, attributes=None, unit="", description=""):
        return OTelMetricGauge(
            name=name,
            value_column=_colname(value, "Gauge value"),
            attributes=_attr_pairs(attributes, "Gauge"),
            unit=unit,
            description=description,
        )

    def Summary(
        self,
        name,
        count,
        quantile_values=None,
        attributes=None,
        unit="",
        description="",
    ):
        return OTelMetricSummary(
            name=name,
            count_column=_colname(count, "Summary count"),
            quantile_columns=tuple(
                (float(q), _colname(c, f"Summary quantile {q}"))
                for q, c in (quantile_values or {}).items()
            ),
            attributes=_attr_pairs(attributes, "Summary"),
            unit=unit,
            description=description,
        )


class _TraceNamespace:
    def Span(self, name, start_time, end_time, attributes=None):
        name_is_col = isinstance(name, ColumnExpr)
        return OTelSpan(
            name=_colname(name, "Span name") if name_is_col else str(name),
            start_time_column=_colname(start_time, "Span start_time"),
            end_time_column=_colname(end_time, "Span end_time"),
            attributes=_attr_pairs(attributes, "Span"),
            name_is_column=name_is_col,
        )


class OTelModule:
    def __init__(self):
        self.metric = _MetricNamespace()
        self.trace = _TraceNamespace()

    def Endpoint(self, url="", headers=None, insecure=False):
        return OTelEndpointConfig(
            url=url,
            headers=tuple(sorted((headers or {}).items())),
            insecure=insecure,
        )

    def Data(self, endpoint=None, resource=None, data=None):
        res = []
        for k, v in (resource or {}).items():
            if isinstance(v, ColumnExpr):
                res.append((k, ("column", _colname(v, f"resource {k!r}"))))
            else:
                res.append((k, str(v)))
        return OTelDataSpec(
            endpoint=endpoint or OTelEndpointConfig(),
            resource=tuple(res),
            data=tuple(data or ()),
        )
