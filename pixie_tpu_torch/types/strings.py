"""Dictionary encoding for STRING columns.

TPU-first design: strings never reach the device. At staging time each
string column is encoded into int32 dictionary ids; all device-side ops
(equality filters, group-by keys, join keys) are id ops. Host-side UDFs
(regex, json, normalization) transform the *dictionary*, not the rows —
a dictionary with K distinct values is transformed in O(K) instead of
O(rows).

Reference contrast: Carnot ships raw strings through Arrow StringArrays
and hashes them per-row in agg/join maps (``src/carnot/exec/row_tuple.h``).
"""

from __future__ import annotations

import hashlib
import struct
import threading
from typing import Iterable

import numpy as np

NULL_ID = -1


class StringDictionary:
    """Append-only string <-> int32 id mapping."""

    __slots__ = ("_str_to_id", "_strings", "_fp", "_fp_len", "_fp_digest",
                 "_fp_lock")

    def __init__(self, strings: Iterable[str] = ()):
        self._strings: list[str] = []
        self._str_to_id: dict[str, int] = {}
        # Incremental content fingerprint (content_key): hasher state,
        # how many strings it has absorbed, and the digest at that
        # length. Lazy — dictionaries that never cross a cache key pay
        # nothing. Per-dictionary lock: a first-call fingerprint of a
        # LARGE ingest dictionary hashes its whole string table, and a
        # process-wide lock would stall every other thread's compile
        # fast path behind that one dictionary.
        self._fp = None
        self._fp_len = 0
        self._fp_digest = b""
        self._fp_lock = threading.Lock()
        for s in strings:
            self.get_or_add(s)

    def content_key(self) -> tuple:
        """Content-addressed identity: ``(len, digest)`` over the
        ordered string table.

        The fragment cache (``exec/fragment.compile_fragment_cached``)
        keys dictionaries by THIS instead of ``id()``: bridge payloads
        that cross the wire decode into fresh ``StringDictionary``
        objects every query, so identity-keyed caching recompiled the
        merge tier's XLA programs on every distributed query — equal
        content must hit. Sound because the dictionary is append-only:
        two dictionaries with equal (ordered) content resolve every id
        and every compile-time ``lookup`` identically, and a dictionary
        that later GROWS simply produces a new key (its first
        ``len`` entries — all any cached fragment resolved against —
        are immutable). Amortized O(new strings): the hash state
        extends incrementally under the dictionary's own lock (a query
        thread can fingerprint while ingest appends on another).
        """
        with self._fp_lock:
            n = len(self._strings)
            if self._fp is None:
                self._fp = hashlib.blake2b(digest_size=16)
            if n > self._fp_len:
                h = self._fp
                for s in self._strings[self._fp_len:n]:
                    b = s.encode("utf-8", "surrogatepass")
                    # Length-prefixed: ("ab","c") never collides with
                    # ("a","bc").
                    h.update(struct.pack("<I", len(b)))
                    h.update(b)
                self._fp_len = n
                self._fp_digest = h.digest()
            elif not self._fp_digest and n == 0:
                self._fp_digest = self._fp.digest()
            return (n, self._fp_digest)

    def __len__(self) -> int:
        return len(self._strings)

    def get_or_add(self, s: str) -> int:
        sid = self._str_to_id.get(s)
        if sid is None:
            sid = len(self._strings)
            self._str_to_id[s] = sid
            self._strings.append(s)
        return sid

    def lookup(self, s: str) -> int:
        """Id for ``s`` or NULL_ID if unseen (for filter literals)."""
        return self._str_to_id.get(s, NULL_ID)

    def encode(self, values: Iterable[str]) -> np.ndarray:
        vals = list(values)
        return np.fromiter((self.get_or_add(v) for v in vals), dtype=np.int32, count=len(vals))

    def decode(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        table = np.empty(len(self._strings) + 1, dtype=object)
        table[:-1] = self._strings
        table[-1] = None  # slot for out-of-range / NULL_ID
        safe = np.where((ids >= 0) & (ids < len(self._strings)), ids, len(self._strings))
        return table[safe]

    def decode_one(self, sid: int) -> str | None:
        return self._strings[sid] if 0 <= sid < len(self._strings) else None

    @property
    def strings(self) -> list[str]:
        return self._strings

    def transform(self, fn) -> tuple["StringDictionary", np.ndarray]:
        """Host UDF escape hatch: apply ``fn`` to every distinct string.

        Returns (new_dict, remap) where ``remap[old_id] -> new_id``; device
        side applies the remap as a gather. O(K distinct), not O(rows).
        """
        new = StringDictionary()
        remap = np.empty(len(self._strings), dtype=np.int32)
        for i, s in enumerate(self._strings):
            remap[i] = new.get_or_add(fn(s))
        return new, remap

    def union(self, other: "StringDictionary") -> tuple["StringDictionary", np.ndarray, np.ndarray]:
        """Merged dict + id remaps for self and other (join/union alignment)."""
        merged = StringDictionary(self._strings)
        remap_self = np.arange(len(self._strings), dtype=np.int32)
        remap_other = np.fromiter(
            (merged.get_or_add(s) for s in other._strings),
            dtype=np.int32,
            count=len(other._strings),
        )
        return merged, remap_self, remap_other
