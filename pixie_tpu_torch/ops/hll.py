"""HyperLogLog register rows on the host: the numpy mirror that the
table store's ingest sketches keep.

A copy of the numpy half of the JAX package's ``ops/hll.py`` (the same
splitmix64, the same rho, the same estimator constants), so its
registers are bit-identical to the JAX package's for the same values.
The batched device HLL (the count-distinct UDA) is a later slice of the
port. The leading-zero count is an exact shift-based highest-bit search
(no float log2: off by one at powers of two would bias the estimator).
"""

from __future__ import annotations

import numpy as np

DEFAULT_P = 10  # 2^10 = 1024 registers, ~3.25% relative error


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
