"""The splitmix64 finalizer, on the host and on the device.

A port of the mixers of the JAX package's ``ops/hashtable.py``: the
radix-partitioned join hashes its build keys on the host
(``radix_partition_build``) and its probe keys on the device
(``radix_probe_join``), and a probe row finds its matches only if both
put the key in the same partition, so the two mixers agree bit for bit.

The device mixer works on the int64 view of the key bits (the card's
PyTorch has no uint64 shift, mask or compare): a logical shift right is
an arithmetic shift with the sign-extended bits masked off, the
multiplies wrap, and the two odd constants are written as their signed
int64 values. The host-built open-addressing table (``_hash_planes``,
``build_table``, ``device_lookup``) serves the metadata functions, a
later slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

_C1 = 0xBF58476D1CE4E5B9
_C2 = 0x94D049BB133111EB


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (wrapping uint64 arithmetic)."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(_C1)
        x ^= x >> np.uint64(27)
        x *= np.uint64(_C2)
        x ^= x >> np.uint64(31)
    return x


def _signed(c: int) -> int:
    """The int64 with the bits of the uint64 constant ``c``."""
    return c - (1 << 64) if c >= 1 << 63 else c


def shr64(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical shift right of int64 lanes read as uint64 (0 < s < 64)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """``_mix64`` on the device: int64 lanes in (the bits of the uint64
    keys), the int64 view of the mixed uint64 out."""
    if x.dtype == torch.uint64:
        x = x.view(torch.int64)
    x = x.to(torch.int64)
    x = x ^ shr64(x, 30)
    x = x * _signed(_C1)
    x = x ^ shr64(x, 27)
    x = x * _signed(_C2)
    return x ^ shr64(x, 31)
