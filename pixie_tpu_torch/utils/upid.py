"""UPID: the 128-bit unique process id joining traces to k8s metadata.

Reference parity: ``src/shared/upid`` — {ASID (agent), PID, process
start ticks} packed into a u128. Device columns carry it as (hi, lo)
uint64 planes (DataType.UINT128), and this class is the host-side
pack/unpack + formatting surface. A copy of the JAX package's
``utils/upid.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True, order=True)
class UPID:
    asid: int  # agent short id (u32)
    pid: int  # process id (u32)
    start_ts: int  # process start time in ticks (u64)

    # Packing: hi = (asid << 32) | pid, lo = start_ts (upid.h layout).
    @property
    def hi(self) -> int:
        return ((self.asid & 0xFFFFFFFF) << 32) | (self.pid & 0xFFFFFFFF)

    @property
    def lo(self) -> int:
        return self.start_ts & 0xFFFFFFFFFFFFFFFF

    def value(self) -> int:
        return (self.hi << 64) | self.lo

    @classmethod
    def from_parts(cls, hi: int, lo: int) -> "UPID":
        return cls(asid=(hi >> 32) & 0xFFFFFFFF, pid=hi & 0xFFFFFFFF, start_ts=lo)

    @classmethod
    def from_value(cls, v: int) -> "UPID":
        return cls.from_parts((v >> 64) & (2**64 - 1), v & (2**64 - 1))

    def __str__(self) -> str:
        return f"{self.asid}:{self.pid}:{self.start_ts}"

    @classmethod
    def parse(cls, s: str) -> "UPID":
        asid, pid, ts = s.split(":")
        return cls(int(asid), int(pid), int(ts))


def pack_planes(upids) -> tuple[np.ndarray, np.ndarray]:
    """[UPID] -> (hi, lo) uint64 planes, the device UINT128 layout."""
    hi = np.fromiter((u.hi for u in upids), dtype=np.uint64, count=len(upids))
    lo = np.fromiter((u.lo for u in upids), dtype=np.uint64, count=len(upids))
    return hi, lo


def unpack_planes(hi: np.ndarray, lo: np.ndarray) -> list[UPID]:
    return [UPID.from_parts(int(h), int(l)) for h, l in zip(hi, lo)]
