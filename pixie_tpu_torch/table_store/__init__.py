from .table import Table
from .table_store import TableStore
