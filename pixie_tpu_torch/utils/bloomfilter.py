"""Bloom filter with serialization.

Reference parity: ``src/shared/bloomfilter`` — the metadata filter uses
it to advertise which agents own which metadata entities
(``metadata_filter.h``), shipped in agent registration/heartbeat protos.
Vectorized numpy double-hashing (Kirsch-Mitzenmacher) over a byte array.
"""

from __future__ import annotations

import hashlib
import json
import math

import numpy as np


class BloomFilter:
    def __init__(self, max_entries: int, error_rate: float = 0.01):
        if not 0 < error_rate < 1 or max_entries < 1:
            raise ValueError("need max_entries >= 1 and 0 < error_rate < 1")
        n_bits = int(-max_entries * math.log(error_rate) / (math.log(2) ** 2))
        self.n_bits = max(8, n_bits)
        self.n_hashes = max(1, round(self.n_bits / max_entries * math.log(2)))
        self.bits = np.zeros((self.n_bits + 7) // 8, dtype=np.uint8)
        self.max_entries = max_entries
        self.error_rate = error_rate

    def _positions(self, item: str) -> np.ndarray:
        d = hashlib.sha256(item.encode()).digest()
        h1 = int.from_bytes(d[:8], "little")
        h2 = int.from_bytes(d[8:16], "little") | 1
        i = np.arange(self.n_hashes, dtype=np.uint64)
        return (h1 + i * h2) % np.uint64(self.n_bits)

    def insert(self, item: str) -> None:
        pos = self._positions(item)
        np.bitwise_or.at(
            self.bits, (pos // 8).astype(np.int64), (1 << (pos % 8)).astype(np.uint8)
        )

    def contains(self, item: str) -> bool:
        pos = self._positions(item)
        return bool(
            np.all(self.bits[(pos // 8).astype(np.int64)] & (1 << (pos % 8)).astype(np.uint8))
        )

    # -- serialization (proto round-trip analog) -----------------------------
    def to_bytes(self) -> bytes:
        header = json.dumps(
            {
                "n_bits": self.n_bits,
                "n_hashes": self.n_hashes,
                "max_entries": self.max_entries,
                "error_rate": self.error_rate,
            }
        ).encode()
        return len(header).to_bytes(4, "little") + header + self.bits.tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "BloomFilter":
        hlen = int.from_bytes(data[:4], "little")
        meta = json.loads(data[4 : 4 + hlen])
        bf = cls.__new__(cls)
        bf.n_bits = meta["n_bits"]
        bf.n_hashes = meta["n_hashes"]
        bf.max_entries = meta["max_entries"]
        bf.error_rate = meta["error_rate"]
        bf.bits = np.frombuffer(data[4 + hlen :], dtype=np.uint8).copy()
        return bf
