"""Batched t-digest quantile sketch over [num_groups, K] centroid arrays.

Reference parity: ``src/carnot/funcs/builtins/math_sketches.h:34``
(QuantilesUDA). A port of the JAX package's ``ops/tdigest.py``: each
window is histogram-binned by value (the f32 bit pattern made
order-monotone; its top bits pick one of B bins per group), the
value-ordered histogram is re-binned through the t-digest k1 scale
function down to K centroids, and two digests merge by concatenating
their centroids and re-compressing. The histogram fold is
``ops/hist_fold.py``.

The carry is (means f32[G, K], weights f32[G, K]).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .hist_fold import hist_fold

DEFAULT_K = 128


def _knorm(q):
    """t-digest k1 scale normalized to [0, 1): concentrates bins at tails."""
    q = torch.clamp(q, 0.0, 1.0)
    return torch.asin(2.0 * q - 1.0) / math.pi + 0.5


def digest_init(num_groups: int, device, k: int = DEFAULT_K):
    return (
        torch.zeros((num_groups, k), dtype=torch.float32, device=device),
        torch.zeros((num_groups, k), dtype=torch.float32, device=device),
    )


def _sorted_by_mean(means, weights):
    """Centroids sorted by mean within each group, empty slots last."""
    sort_key = torch.where(weights > 0, means, torch.inf)
    order = torch.sort(sort_key, dim=-1, stable=True).indices
    return torch.gather(means, -1, order), torch.gather(weights, -1, order)


def _compress(means, weights, k: int, ordered: bool = False):
    """Re-bin [G, M] centroids to [G, k] by cumulative-weight position.

    ``ordered=True`` asserts the centroids are already ascending by mean
    within each group (histogram bins are, by construction) and skips the
    sort — empty (w==0) slots may then be interleaved; they carry no
    weight, land in the trash segment, and don't perturb ``cumw``.
    """
    g, m = means.shape
    if ordered:
        means_s, weights_s = means, weights
    else:
        means_s, weights_s = _sorted_by_mean(means, weights)

    total = torch.sum(weights_s, dim=-1, keepdim=True)
    cumw = torch.cumsum(weights_s, dim=-1)
    qmid = torch.where(total > 0, (cumw - weights_s * 0.5) / total, 0.0)
    bins = torch.clamp(
        torch.floor(_knorm(qmid) * k).to(torch.int64), 0, k - 1
    )
    gid = torch.arange(g, device=means.device)[:, None].expand(g, m)
    # Every slot adds into its own group's bin, the empty ones (weight 0,
    # so weight and mass 0) too. The JAX package sends empty slots to one
    # trash bin instead; on the card that serialises the atomics of every
    # empty slot on one address (2^25 histogram bins at 4096 groups),
    # while adding zeros changes no sum.
    flat = (gid * k + bins).reshape(-1)

    z = torch.zeros(g * k, dtype=torch.float32, device=means.device)
    new_w = z.clone().index_add_(0, flat, weights_s.reshape(-1))
    new_mw = z.index_add_(0, flat, (means_s * weights_s).reshape(-1))
    new_w = new_w.reshape(g, k)
    new_means = torch.where(
        new_w > 0, new_mw.reshape(g, k) / torch.clamp(new_w, min=1e-30), 0.0
    )
    return new_means, new_w


def digest_merge(a, b):
    """Associative merge of two [G, K] digests."""
    means = torch.cat([a[0], b[0]], dim=-1)
    weights = torch.cat([a[1], b[1]], dim=-1)
    return _compress(means, weights, a[0].shape[-1])


def _hist_bins(num_groups: int) -> int:
    """Histogram width B: 8192 bins (4 mantissa bits of resolution) until
    G x B passes 2^25 slots, then halving toward a floor of K."""
    b = 8192
    while b > DEFAULT_K and num_groups * b > (1 << 25):
        b //= 2
    return b


def batch_to_digest(values, group_ids, mask, num_groups: int,
                    k: int = DEFAULT_K):
    """Build a [G, K] digest from one batch of (value, group) rows.

    The histogram fold goes through ``hist_fold`` whatever G: on the card
    that is the atomic kernel, whose cost does not grow with the slot
    count. (The JAX package engages its TPU kernel only at G x B <= 2^15,
    because its one-hot sweep costs n x G x B multiply-adds.)
    """
    values = values.to(torch.float32)
    # The sketch is defined over FINITE values only.
    mask = mask & torch.isfinite(values)
    gids = torch.where(mask, group_ids.to(torch.int32), num_groups)
    b = _hist_bins(num_groups)
    shift = 32 - b.bit_length() + 1  # top log2(B) bits

    # Order-monotone u32 of the f32 bits, held in int64: an int32 view
    # would shift arithmetically and sign-extend.
    vb = values.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    vb = torch.where(values < 0, vb ^ 0xFFFFFFFF, vb | 0x80000000)
    bins = (vb >> shift).to(torch.int32)

    n_slots = num_groups * b
    flat = torch.where(
        mask & (gids < num_groups), gids * b + bins, n_slots
    ).to(torch.int32)
    w_f, mw_f = hist_fold(
        flat.contiguous(), torch.where(mask, values, 0.0).contiguous(),
        n_slots,
    )
    w = w_f.reshape(num_groups, b)
    mw = mw_f.reshape(num_groups, b)
    means = torch.where(w > 0, mw / torch.clamp(w, min=1e-30), 0.0)
    return _compress(means, w, k, ordered=True)


def digest_update(carry, group_ids, mask, values, *,
                  num_groups: int | None = None):
    """UDA update: fold a batch into the digest carry (``num_groups``
    bins the batch at another group count than the carry's)."""
    g, k = carry[0].shape
    g = g if num_groups is None else num_groups
    return digest_merge(carry, batch_to_digest(values, group_ids, mask, g, k))


def _interp_rows(x, xp, fp):
    """Row-wise ``jnp.interp``: clamps to fp[0] left of xp[0] and to
    fp[-1] right of xp[-1]; a zero-width interval takes its left value."""
    m = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, m - 1)
    xl, xr = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    fl, fr = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    dx = xr - xl
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(
        dx0, fl, fl + ((x - xl) / torch.where(dx0, 1.0, dx)) * (fr - fl)
    )
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    return torch.where(x > xp[:, -1:], fp[:, -1:], f)


def digest_quantile(carry, qs):
    """Estimate quantiles per group: [G, len(qs)] (NaN for empty groups).

    Linear interpolation of centroid means over cumulative-weight midpoints
    (the standard t-digest estimator).
    """
    means, weights = carry
    qs_arr = torch.tensor(qs, dtype=torch.float32, device=means.device)
    means_s, weights_s = _sorted_by_mean(means, weights)

    total = torch.sum(weights_s, dim=-1)
    cumw = torch.cumsum(weights_s, dim=-1)
    cmid = cumw - weights_s * 0.5

    # Fill empty (w==0, sorted to the end) slots so interp clamps to the
    # last real centroid instead of walking into garbage.
    filled_mean = torch.cummax(
        torch.where(weights_s > 0, means_s, -torch.inf), dim=1
    ).values
    filled_cmid = torch.where(weights_s > 0, cmid, total[:, None])
    out = _interp_rows(
        qs_arr[None, :] * total[:, None], filled_cmid.contiguous(),
        filled_mean,
    )
    return torch.where(total[:, None] > 0, out, torch.nan)
