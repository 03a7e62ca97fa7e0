"""Batched HyperLogLog count-distinct over [num_groups, M] register
rows, on the device and on the host.

A port of the JAX package's ``ops/hll.py``. The device half serves the
``count_distinct`` UDA: per-group int32 registers, segment-max updates
(one ``scatter_reduce_`` into [G*M + 1] slots, the last one the trash
slot of masked rows) and an elementwise-max merge. The numpy mirror is
what the table store's ingest sketches keep. Both use the same
splitmix64, the same rho and the same estimator constants, so their
registers are bit-identical to each other and to the JAX package's.

The card's PyTorch has no uint64 shift, mask or compare, so the device
hash runs on the int64 view of the bits (``hashtable.mix64``: logical
shifts are masked arithmetic shifts, multiplies wrap). Unlike the
hash table's key hash, splitmix64 adds its golden constant inside the
mixer, to the value itself. The leading-zero count is an exact
shift-based highest-bit search (no float log2: off by one at powers of
two would bias the estimator). The estimate sums ``exp2(-register)`` in
float32, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from .hashtable import _signed, mix64, shr64

DEFAULT_P = 10  # 2^10 = 1024 registers, ~3.25% relative error
_GOLDEN = 0x9E3779B97F4A7C15


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 of int64 lanes; the int64 view of the uint64 hash."""
    return mix64(x.to(torch.int64) + _signed(_GOLDEN))


def _hibit(w: torch.Tensor) -> torch.Tensor:
    """floor(log2(w)) for 0 < w < 2^63, exact, via 6 shift steps."""
    r = torch.zeros(w.shape, dtype=torch.int32, device=w.device)
    for s in (32, 16, 8, 4, 2, 1):
        m = w >> s
        take = m > 0
        r = r + take.to(torch.int32) * s
        w = torch.where(take, m, w)
    return r


def hll_init(num_groups: int, device, p: int = DEFAULT_P) -> torch.Tensor:
    return torch.zeros((num_groups, 1 << p), dtype=torch.int32, device=device)


def hll_update(registers, group_ids, mask, values, p: int = DEFAULT_P):
    """Fold a window's ``values`` into their groups' register rows."""
    g, m = registers.shape
    h = _splitmix64(values)
    idx = h & (m - 1)
    w = shr64(h, p)  # the 64 - p high bits, non-negative as int64
    rho = torch.where(w > 0, 64 - p - _hibit(w), 64 - p + 1).to(torch.int32)
    flat = torch.where(mask, group_ids.to(torch.int64) * m + idx, g * m)
    upd = torch.zeros(g * m + 1, dtype=torch.int32, device=registers.device)
    upd.scatter_reduce_(0, flat, torch.where(mask, rho, 0), "amax")
    return torch.maximum(registers, upd[:-1].view(g, m))


def hll_estimate(registers: torch.Tensor) -> torch.Tensor:
    """Per-group cardinality estimate [G] (int64), with small-range
    correction, in float32 (divisions as true divisions: torch turns a
    Python-scalar numerator into a reciprocal multiply)."""
    g, m = registers.shape
    alpha = 0.7213 / (1.0 + 1.079 / m)
    inv_sum = torch.sum(torch.exp2(-registers.to(torch.float32)), dim=-1)
    raw = torch.div(torch.full_like(inv_sum, alpha * m * m), inv_sum)
    zeros = torch.sum((registers == 0).to(torch.float32), dim=-1)
    linear = m * torch.log(
        torch.div(torch.full_like(zeros, m), torch.clamp(zeros, min=1.0))
    )
    est = torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)
    return torch.round(est).to(torch.int64)


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Numpy splitmix64 over uint64 lanes (wrapping arithmetic)."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint64, copy=False) + np.uint64(0x9E3779B97F4A7C15)
        z = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def hll_init_np(p: int = DEFAULT_P) -> np.ndarray:
    return np.zeros(1 << p, dtype=np.int32)


def hll_update_np(registers: np.ndarray, values: np.ndarray,
                  p: int = DEFAULT_P) -> np.ndarray:
    """Fold ``values`` (any integer dtype) into one register row in place."""
    m = len(registers)
    h = splitmix64_np(values.astype(np.int64, copy=False).view(np.uint64))
    idx = (h & np.uint64(m - 1)).astype(np.int64)
    w = h >> np.uint64(p)
    # rho = leading-zero rank of the remaining 64-p bits, exact.
    nz = w > 0
    hibit = np.zeros(len(w), dtype=np.int32)
    ww = w.copy()
    for s in (32, 16, 8, 4, 2, 1):
        m2 = ww >> np.uint64(s)
        take = m2 > 0
        hibit += take.astype(np.int32) * s
        ww = np.where(take, m2, ww)
    rho = np.where(nz, 64 - p - hibit, 64 - p + 1).astype(np.int32)
    np.maximum.at(registers, idx, rho)
    return registers


def hll_estimate_np(registers: np.ndarray) -> int:
    """Scalar estimate from one register row (alpha, small-range linear
    counting)."""
    m = len(registers)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    inv_sum = float(np.sum(np.exp2(-registers.astype(np.float64))))
    raw = alpha * m * m / inv_sum
    zeros = float(np.sum(registers == 0))
    if raw <= 2.5 * m and zeros > 0:
        return int(round(m * np.log(m / max(zeros, 1.0))))
    return int(round(raw))
