"""Sketch UDAs: t-digest quantiles and HLL count-distinct.

Reference parity: ``src/carnot/funcs/builtins/math_sketches.h:34``
(QuantilesUDA over tdigest; finalize emits JSON {p01,...,p99}). The
digest is ``ops/tdigest.py``; finalize yields [G, 7] floats that the host
materializes to JSON, or the planner fuses ``pluck_float64(quantiles(x),
'p99')`` into a direct ``_quantile_p99`` UDA. ``count_distinct`` is
the HyperLogLog of ``ops/hll.py``: [G, 1024] int32 registers, merged by
elementwise max.
"""

from __future__ import annotations

import torch

from ...ops import tdigest
from ...ops.hll import hll_estimate, hll_init, hll_update
from ..udf import FLOAT64, INT64, STRING

QUANTILE_FIELDS = ("p01", "p10", "p25", "p50", "p75", "p90", "p99")
QUANTILE_POINTS = (0.01, 0.10, 0.25, 0.50, 0.75, 0.90, 0.99)


def register(reg):
    reg.uda(
        "quantiles",
        (FLOAT64,),
        STRING,
        init=tdigest.digest_init,
        update=tdigest.digest_update,
        merge=tdigest.digest_merge,
        finalize=lambda c: tdigest.digest_quantile(c, QUANTILE_POINTS),
        struct_fields=QUANTILE_FIELDS,
        doc="Approximate quantiles of the group via a mergeable t-digest.",
        semantic_type=1000,  # SemanticType.ST_QUANTILES (types.proto:84)
    )
    for field, point in zip(QUANTILE_FIELDS, QUANTILE_POINTS):
        reg.uda(
            f"_quantile_{field}",
            (FLOAT64,),
            FLOAT64,
            init=tdigest.digest_init,
            update=tdigest.digest_update,
            merge=tdigest.digest_merge,
            finalize=lambda c, _p=point: tdigest.digest_quantile(c, (_p,))[:, 0],
            doc=f"Approximate {field} of the group via t-digest.",
        )

    for dt in (INT64, STRING):
        reg.uda(
            "count_distinct",
            (dt,),
            INT64,
            init=hll_init,
            update=hll_update,
            merge=torch.maximum,
            finalize=hll_estimate,
            doc="Approximate distinct count via a mergeable HyperLogLog sketch.",
        )
