"""Shared utilities: the control-plane datastore, bloom filter and UPID,
and the ELF and DWARF readers (``elf.py``, ``dwarf.py``)."""

from .bloomfilter import BloomFilter
from .datastore import Datastore, MemoryDatastore, SqliteDatastore
from .upid import UPID

__all__ = [
    "BloomFilter",
    "Datastore",
    "MemoryDatastore",
    "SqliteDatastore",
    "UPID",
]
