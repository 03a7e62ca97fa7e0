from .engine import Engine, QueryError
