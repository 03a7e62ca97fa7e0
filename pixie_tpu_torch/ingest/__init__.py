"""Ingest edge: source connectors feeding the table store.

Reference parity: ``src/stirling`` core. A copy of the JAX package's
``ingest/`` collector surface: the ``SourceConnector`` lifecycle,
per-source ``DataTable`` buffers, the sampling/push ``FrequencyManager``
poll loop, ``RegisterDataPushCallback`` semantics, the synthetic
``seq_gen`` source, the procfs sources, the self-sampling profiler
(``profiler.py``), the replay generator and the canonical schemas
(``schemas.py``), the dynamic tracepoint connector (``dynamic.py``) and
the capture tap (``tap.py``) with its eleven protocol stitchers
(``*_parser.py``).
"""

from .core import DataTable, FrequencyManager, SourceConnector
from .collector import Collector
from .connectors import (
    NetworkStatsConnector,
    PIDRuntimeConnector,
    ProcExitConnector,
    ProcStatConnector,
    ProcessStatsConnector,
    SeqGenConnector,
    StirlingErrorConnector,
)
from .replay import gen_http_events, replay_into

__all__ = [
    "Collector",
    "DataTable",
    "FrequencyManager",
    "NetworkStatsConnector",
    "PIDRuntimeConnector",
    "ProcExitConnector",
    "ProcStatConnector",
    "ProcessStatsConnector",
    "SeqGenConnector",
    "StirlingErrorConnector",
    "gen_http_events",
    "replay_into",
]
