"""Relation: an ordered (column name -> DataType) schema.

Reference parity: ``src/table_store/schema/relation.h:41`` — column
names + types, with semantic-type annotations deferred to the planner.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Mapping

from .dtypes import DataType


class Relation:
    """Immutable ordered schema."""

    __slots__ = ("_names", "_types", "_items")

    def __init__(self, columns: Mapping[str, DataType] | Iterable[tuple[str, DataType]] = ()):
        if isinstance(columns, Mapping):
            items = list(columns.items())
        else:
            items = list(columns)
        names = [n for n, _ in items]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in relation: {names}")
        self._names: tuple[str, ...] = tuple(names)
        self._types: dict[str, DataType] = {n: t for n, t in items}
        self._items: tuple | None = None  # items_tuple cache

    @property
    def column_names(self) -> tuple[str, ...]:
        return self._names

    def col_type(self, name: str) -> DataType:
        try:
            return self._types[name]
        except KeyError:
            raise KeyError(f"column {name!r} not in relation {self._names}") from None

    def has_column(self, name: str) -> bool:
        return name in self._types

    def col_index(self, name: str) -> int:
        return self._names.index(name)

    def items(self) -> Iterator[tuple[str, DataType]]:
        return iter((n, self._types[n]) for n in self._names)

    def items_tuple(self) -> tuple:
        """``tuple(self.items())``, computed once (the relation is
        immutable). Memo keys build one of these per table per compile
        (verify/bounds caches, fragment cache) — at ~20 canonical
        tables the rebuild was the dominant cost of a memo HIT."""
        if self._items is None:
            self._items = tuple((n, self._types[n]) for n in self._names)
        return self._items

    def select(self, names: Iterable[str]) -> "Relation":
        return Relation([(n, self.col_type(n)) for n in names])

    def add(self, name: str, dt: DataType) -> "Relation":
        if name in self._types:
            raise ValueError(f"column {name!r} already in relation")
        return Relation(list(self.items()) + [(name, dt)])

    def merge(self, other: "Relation", suffix: str = "_y") -> "Relation":
        """Concatenate schemas, suffixing collisions (join output naming)."""
        out = list(self.items())
        taken = set(self._names)
        for n, t in other.items():
            new_n = n
            while new_n in taken:
                new_n += suffix
            taken.add(new_n)
            out.append((new_n, t))
        return Relation(out)

    def __len__(self) -> int:
        return len(self._names)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Relation)
            and self._names == other._names
            and self._types == other._types
        )

    def __hash__(self) -> int:
        return hash(self.items_tuple())

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}:{t.name}" for n, t in self.items())
        return f"Relation[{inner}]"
