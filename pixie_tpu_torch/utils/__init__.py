"""Shared utilities: the control-plane datastore and UPID."""

from .datastore import Datastore, MemoryDatastore, SqliteDatastore
from .upid import UPID

__all__ = ["Datastore", "MemoryDatastore", "SqliteDatastore", "UPID"]
