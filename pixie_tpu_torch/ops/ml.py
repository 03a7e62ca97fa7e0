"""ML exec primitives: k-means and mergeable uniform samples (coresets).

Reference parity: ``src/carnot/exec/ml/`` — Eigen kmeans (``kmeans.h:32``)
with kmeans++ init, streaming coresets (``coreset.h``), sampling
(``sampling.h``), consumed by ``funcs/builtins/ml_ops.h`` (KMeansUDA
:88, ReservoirSampleUDA :145).

A port of the JAX package's ``ops/ml.py``. The mergeable uniform sample
is a **bottom-k priority sketch**: every row draws a deterministic
pseudo-random priority (a hash of its value bits and window position)
and each group keeps the k lowest-priority rows. Bottom-k unions are
associative, so the same sketch serves window folds and merges.
K-means then runs on the per-group sample on the device (vectorized
Lloyd over [G, C] samples).

The priority hash is uint32 arithmetic, done here in int64 lanes masked
to 32 bits (uint32 shifts and multiplies are patchy in torch on CUDA);
the bits are the JAX package's. The group lexsort is two stable sorts,
and ``lax.top_k(-p, c)`` is ``torch.topk(largest=False)``, whose order
among equal priorities may differ from XLA's.
"""

from __future__ import annotations

import numpy as np
import torch

_EMPTY = float(np.float32(np.inf))  # priority of an empty reservoir slot
_U32 = 0xFFFFFFFF


def row_priorities(values: torch.Tensor, salt: int = 0x9E3779B9) -> torch.Tensor:
    """Deterministic pseudo-random priority per row in [0, 1).

    splitmix-style integer hash of the value bits xor'd with the row's
    window position. Rows at the same position with the same value in
    different windows collide; for sampling telemetry streams the bias
    is negligible.
    """
    if values.dtype.is_floating_point:
        bits = values.to(torch.float32).view(torch.int32).to(torch.int64) & _U32
    else:
        u = values.to(torch.int64)
        bits = (u ^ ((u >> 32) & _U32)) & _U32
    idx = torch.arange(bits.shape[-1], dtype=torch.int64, device=bits.device)
    x = bits ^ ((idx * 0x85EBCA6B) & _U32) ^ salt
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _U32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _U32
    x = x ^ (x >> 16)
    return x.to(torch.float32) / 2.0**32


# -- bottom-k reservoir (per-group, mergeable) -------------------------------
def reservoir_init(num_groups: int, capacity: int, dtype=torch.float32,
                   device=None):
    """``dtype`` is the sampled values' dtype: int64 samples stay int64
    (a sample must be an element of the data, bit-exactly)."""
    return (
        torch.zeros((num_groups, capacity), dtype=dtype, device=device),
        torch.full((num_groups, capacity), _EMPTY, dtype=torch.float32,
                   device=device),
        torch.zeros((num_groups,), dtype=torch.float32, device=device),
    )


def _batch_to_reservoir(values, prio, group_ids, mask, num_groups, capacity,
                        dtype):
    """Scatter a window's rows into a fresh [G, C] bottom-k reservoir."""
    n = values.shape[-1]
    g, c = num_groups, capacity
    dev = values.device
    gid = torch.where(mask, group_ids.to(torch.int64), g)
    # Lexsort (gid, prio): a stable sort of gid after a sort of prio.
    p_masked = torch.where(mask, prio, _EMPTY)
    order1 = torch.sort(p_masked, stable=True).indices
    order2 = torch.sort(gid[order1], stable=True).indices
    order = order1[order2]
    gs = gid[order]
    vs = values.to(dtype)[order]
    ps = p_masked[order]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    is_first = torch.ones(n, dtype=torch.bool, device=dev)
    is_first[1:] = gs[1:] != gs[:-1]
    seg_start = torch.cummax(torch.where(is_first, pos, 0), dim=0).values
    rank = pos - seg_start
    slot = torch.where((gs < g) & (rank < c), gs * c + rank, g * c)
    out_v = torch.zeros(g * c + 1, dtype=dtype, device=dev)
    out_v[slot] = vs
    out_p = torch.full((g * c + 1,), _EMPTY, dtype=torch.float32, device=dev)
    out_p[slot] = ps
    counts = torch.zeros(g + 1, dtype=torch.float64, device=dev)
    counts.index_add_(0, gid, mask.to(torch.float64))
    return (
        out_v[:-1].view(g, c),
        out_p[:-1].view(g, c),
        counts[:-1].to(torch.float32),
    )


def reservoir_merge(a, b):
    """Associative bottom-k union of two reservoirs."""
    va, pa, ca = a
    vb, pb, cb = b
    v = torch.cat([va, vb], dim=-1)
    p = torch.cat([pa, pb], dim=-1)
    top, idx = torch.topk(p, va.shape[-1], dim=-1, largest=False, sorted=True)
    return torch.gather(v, -1, idx), top, ca + cb


def reservoir_update(carry, group_ids, mask, values):
    g, c = carry[0].shape
    fresh = _batch_to_reservoir(
        values, row_priorities(values), group_ids, mask, g, c, carry[0].dtype
    )
    return reservoir_merge(carry, fresh)


# -- 1-D weighted k-means over per-group samples -----------------------------
_BIG = float(np.float32(3.4e38))


def kmeans_groups(samples, sample_mask, k_max: int, k, iters: int = 16):
    """Lloyd iterations per group on [G, C] sample values.

    ``k`` is a [G] tensor (or an int) of cluster counts <= k_max;
    centroids beyond k come back NaN. Init = evenly-spaced sample
    quantiles (the 1-D stand-in for kmeans++: spread over the range).
    """
    g, c = samples.shape
    dev = samples.device
    k_arr = torch.as_tensor(k, dtype=torch.int32, device=dev).expand(g)
    s_sorted = torch.sort(torch.where(sample_mask, samples, _BIG), dim=-1).values
    n_valid = sample_mask.sum(dim=-1)
    # Initial centroids: quantile positions j/k over the valid prefix.
    j = torch.arange(k_max, dtype=torch.float32, device=dev)
    pos = torch.clamp(
        ((j[None, :] + 0.5) / torch.clamp(k_arr[:, None], min=1))
        * torch.clamp(n_valid[:, None] - 1, min=0),
        0, c - 1,
    ).to(torch.int64)
    cent = torch.gather(s_sorted, -1, pos)  # [G, k_max]
    kmask = j[None, :] < k_arr[:, None]
    w = sample_mask.to(torch.float32)[:, :, None]
    for _ in range(iters):
        d = torch.abs(samples[:, :, None] - cent[:, None, :])  # [G, C, K]
        d = torch.where(kmask[:, None, :], d, _BIG)
        assign = torch.argmin(d, dim=-1)  # [G, C]
        onehot = torch.nn.functional.one_hot(assign, k_max).to(torch.float32) * w
        wsum = onehot.sum(dim=1)  # [G, K]
        vsum = (onehot * samples[:, :, None]).sum(dim=1)
        cent = torch.where(wsum > 0, vsum / torch.clamp(wsum, min=1e-30), cent)
    cent = torch.sort(torch.where(kmask, cent, torch.nan), dim=-1).values
    return torch.where(kmask & (n_valid[:, None] > 0), cent, torch.nan)


# -- standalone multi-dim kmeans (library API, kmeans.h parity) --------------
def kmeans_fit(points, k: int, iters: int = 32, weights=None):
    """Weighted Lloyd k-means on [N, D] points; returns [k, D] centroids
    in float64 (the JAX package's x64 arithmetic).

    kmeans++-style init: greedy farthest-point seeding from the weighted
    mean (deterministic: no RNG state).
    """
    points = torch.as_tensor(points).to(torch.float64)
    n, d = points.shape
    dev = points.device
    w = (
        torch.ones(n, dtype=torch.float64, device=dev) if weights is None
        else torch.as_tensor(weights, device=dev).to(torch.float32)
        .to(torch.float64)
    )
    cent = torch.zeros((k, d), dtype=torch.float64, device=dev)
    cent[0] = (points * w[:, None]).sum(dim=0) / w.sum()
    ks = torch.arange(k, device=dev)
    for i in range(1, k):
        d2 = torch.min(
            ((points[:, None, :] - cent[None, :, :]) ** 2).sum(dim=-1)
            + torch.where(ks[None, :] < i, 0.0, _BIG),
            dim=-1,
        ).values
        cent[i] = points[torch.argmax(d2 * w)]
    for _ in range(iters):
        d2 = ((points[:, None, :] - cent[None, :, :]) ** 2).sum(dim=-1)
        assign = torch.argmin(d2, dim=-1)
        onehot = torch.nn.functional.one_hot(assign, k).to(torch.float64) * w[:, None]
        wsum = onehot.sum(dim=0)
        vsum = onehot.T @ points
        cent = torch.where(
            wsum[:, None] > 0, vsum / torch.clamp(wsum[:, None], min=1e-30), cent
        )
    return cent
