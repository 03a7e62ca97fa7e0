"""Hot/cold columnar table store (reference: ``src/table_store``)."""

from .table import Cursor, StartSpec, StopSpec, Table, TableStats
from .table_store import TableStore

__all__ = [
    "Cursor", "StartSpec", "StopSpec", "Table", "TableStats", "TableStore",
]
