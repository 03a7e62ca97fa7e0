"""ML UDAs: streaming k-means and reservoir sampling.

Reference parity: ``src/carnot/funcs/builtins/ml_ops.h`` — ``KMeansUDA``
(:88: coreset update/merge, finalize runs kmeans and emits the centroids
as a string) and ``ReservoirSampleUDA`` (:145: uniform sample with
count-weighted merge). The transformer/sentencepiece UDFs (:52,:68) wrap
a TFLite model pool and stay out of scope.

A port of the JAX package's ``udf/builtins/ml_ops.py``. The carries are
bottom-k priority sketches (``ops/ml.py``) with associative merges.
"""

from __future__ import annotations

import torch

from ...ops import ml
from ..udf import FLOAT64, INT64, STRING

KMEANS_K_MAX = 8
KMEANS_FIELDS = tuple(f"c{i}" for i in range(KMEANS_K_MAX))
CORESET_CAPACITY = 256


def _kmeans_init(g, device):
    res = ml.reservoir_init(g, CORESET_CAPACITY, device=device)
    return (*res, torch.zeros((g,), dtype=torch.int32, device=device))  # + k


def _kmeans_update(carry, gids, mask, values, k):
    *res, k_carry = carry
    g = k_carry.shape[0]
    res = ml.reservoir_update(tuple(res), gids, mask, values)
    k_upd = torch.zeros(g + 1, dtype=torch.int32, device=k_carry.device)
    k_upd.scatter_reduce_(
        0, torch.where(mask, gids.to(torch.int64), g),
        torch.where(mask, k, 0).to(torch.int32), "amax",
    )
    return (*res, torch.maximum(k_carry, k_upd[:-1]))


def _kmeans_merge(a, b):
    *ra, ka = a
    *rb, kb = b
    return (*ml.reservoir_merge(tuple(ra), tuple(rb)), torch.maximum(ka, kb))


def _kmeans_finalize(carry):
    vals, prio, _count, k = carry
    k = torch.clamp(k, 1, KMEANS_K_MAX)
    return ml.kmeans_groups(vals, prio < ml._EMPTY, KMEANS_K_MAX, k)


def register(reg):
    reg.uda(
        "kmeans",
        (FLOAT64, INT64),
        STRING,
        init=_kmeans_init,
        update=_kmeans_update,
        merge=_kmeans_merge,
        finalize=_kmeans_finalize,
        struct_fields=KMEANS_FIELDS,
        doc=(
            "Streaming 1-D k-means over the group: kmeans(value, k). "
            f"Centroids beyond k (max {KMEANS_K_MAX}) are NaN; the carry "
            "is a mergeable bottom-k coreset."
        ),
    )
    # Samples must be bit-exact elements of the data: each overload keeps
    # a reservoir of a full-precision dtype.
    for dt, tdt, empty in (
        (FLOAT64, torch.float64, torch.nan),
        (INT64, torch.int64, 0),
    ):
        reg.uda(
            "reservoir_sample",
            (dt,),
            dt,
            init=lambda g, device, _t=tdt: ml.reservoir_init(g, 1, _t, device),
            update=ml.reservoir_update,
            merge=ml.reservoir_merge,
            finalize=lambda c, _e=empty: torch.where(
                c[1][:, 0] < ml._EMPTY, c[0][:, 0], _e
            ),
            doc="Uniform random sample of one group element (mergeable).",
        )
