"""The splitmix64 finalizer and a static open-addressing hash table:
host build, device lookup.

A port of the JAX package's ``ops/hashtable.py``. The radix-partitioned
join hashes its build keys on the host (``radix_partition_build``) and
its probe keys on the device (``radix_probe_join``), and a probe row
finds its matches only if both put the key in the same partition, so
the two mixers agree bit for bit.

The device mixer works on the int64 view of the key bits (the card's
PyTorch has no uint64 shift, mask or compare): a logical shift right is
an arithmetic shift with the sign-extended bits masked off, the
multiplies wrap, and the two odd constants are written as their signed
int64 values.

The table (reference: ``src/carnot/exec/row_tuple.h``
AbslRowTupleHashMap) is built on the host at a power-of-two size with a
*bounded* probe length (rebuilt larger until every key fits within
``max_probes`` slots), so the device lookup is a fixed number of
gathers and compares. Keys are tuples of uint64 planes (a UINT128 UPID
is (hi, lo)); values are int32 payload indices. The metadata functions
resolve UPIDs with it. Each key plane gets the golden constant added
before the mixer (``_hash_planes``), unlike splitmix64, which adds it
inside.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)

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


def _hash_planes(planes) -> np.ndarray:
    h = np.zeros(len(planes[0]), dtype=np.uint64)
    for p in planes:
        with np.errstate(over="ignore"):
            h = _mix64(h ^ (p.astype(np.uint64) + _GOLDEN))
    return h


@dataclass
class HashTable:
    """Host-built table; ``key_planes``/``values``/``occupied`` are dense
    [size] arrays, put on a device by ``on`` once and kept there."""

    key_planes: tuple  # tuple[np.ndarray[uint64]], one per key plane
    values: np.ndarray  # int32[size]
    occupied: np.ndarray  # bool[size]
    max_probes: int
    _device: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def size(self) -> int:
        return len(self.values)

    def on(self, device) -> tuple:
        """(int64 views of the key planes, values, occupied) on
        ``device``, copied there on the first call."""
        dev = torch.device(device)
        arrays = self._device.get(dev)
        if arrays is None:
            arrays = self._device[dev] = (
                tuple(torch.from_numpy(p.view(np.int64)).to(dev)
                      for p in self.key_planes),
                torch.from_numpy(self.values).to(dev),
                torch.from_numpy(self.occupied).to(dev),
            )
        return arrays


def build_table(key_planes, values, max_probes: int = 8) -> HashTable:
    """Insert (key -> value) pairs; grow until probe length <= max_probes.

    ``key_planes``: sequence of uint64 arrays (same length n).
    ``values``: int array [n]. Duplicate keys keep the LAST value
    (metadata updates overwrite earlier state).
    """
    planes = [np.asarray(p, dtype=np.uint64) for p in key_planes]
    values = np.asarray(values, dtype=np.int32)
    n = len(values)
    size = 16
    while size < 2 * max(n, 1):
        size *= 2

    while True:
        mask = np.uint64(size - 1)
        tbl_planes = [np.zeros(size, dtype=np.uint64) for _ in planes]
        tbl_vals = np.zeros(size, dtype=np.int32)
        occ = np.zeros(size, dtype=bool)
        h = (_hash_planes(planes) & mask).astype(np.int64) if n else np.zeros(0, np.int64)
        ok = True
        for i in range(n):
            slot = h[i]
            placed = False
            for _p in range(max_probes):
                s = (slot + _p) & (size - 1)
                if not occ[s]:
                    occ[s] = True
                    for tp, kp in zip(tbl_planes, planes):
                        tp[s] = kp[i]
                    tbl_vals[s] = values[i]
                    placed = True
                    break
                if all(tp[s] == kp[i] for tp, kp in zip(tbl_planes, planes)):
                    tbl_vals[s] = values[i]  # overwrite duplicate key
                    placed = True
                    break
            if not placed:
                ok = False
                break
        if ok:
            return HashTable(tuple(tbl_planes), tbl_vals, occ, max_probes)
        size *= 2


def device_lookup(table: HashTable, query_planes):
    """Vectorized exact lookup on the query planes' device: [n] keys ->
    (values int32[n], found bool[n]); a missing key gives -1.

    ``query_planes``: one tensor per key plane (uint64 or int64 bits).
    """
    dev = query_planes[0].device
    tbl_planes, tbl_vals, occ = table.on(dev)
    size = table.size
    qs = [q.view(torch.int64) if q.dtype == torch.uint64 else q.to(torch.int64)
          for q in query_planes]
    h = torch.zeros(qs[0].shape, dtype=torch.int64, device=dev)
    for q in qs:
        h = mix64(h ^ (q + _signed(int(_GOLDEN))))
    # [n, P] candidate slots; bounded probes -> static shapes.
    probes = torch.arange(table.max_probes, dtype=torch.int64, device=dev)
    slots = ((h & (size - 1))[:, None] + probes[None, :]) & (size - 1)
    match = occ[slots]
    for tp, q in zip(tbl_planes, qs):
        match = match & (tp[slots] == q[:, None])
    found = match.any(dim=1)
    first = torch.argmax(match.to(torch.int32), dim=1)
    vals = tbl_vals[torch.gather(slots, 1, first[:, None])[:, 0]]
    return torch.where(found, vals, -1), found
