"""OTel export specs: what ``px.otel`` compiles into.

Reference parity: ``src/carnot/exec/otel_export_sink_node.{h,cc}``
(``:40``) and the planner's ``px.otel`` module
(``planner/objects/otel.h:35``). A copy of the five data classes of the
JAX package's ``exec/otel.py``, which the wire's type table names; the
OTLP conversion (``batch_to_otlp``) and the exporter are a later slice.
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
