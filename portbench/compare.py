"""The comparison that decides whether one answer is right.

The program's rows arrive as JSON values. Each is read by its column's
type in the template file: an integer must be a JSON integer, a double a
JSON number with a fraction, a decimal decimal text (a float for a
decimal column is wrong, as it is in Trino's protocol), a date or a
varchar a string. Values are then equal
or not: there is no tolerance.

Rows are compared in ORDER BY order. Rows whose ORDER BY values tie may
come in any order, and where the LIMIT cuts through a tie, any of the
tied rows may fill it, as SQL allows.
"""

from __future__ import annotations

from collections import Counter
from decimal import Decimal, InvalidOperation
from typing import List, Optional, Sequence, Tuple


class _Bad:
    """A value of the wrong type; equal to nothing."""

    def __init__(self, raw):
        self.raw = raw

    def __eq__(self, other):
        return False

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return f"<wrong type {self.raw!r}>"


def canonical(value, sql_type: str):
    if value is None:
        return None
    if sql_type in ("bigint", "integer"):
        return value if type(value) is int else _Bad(value)
    if sql_type == "double":
        return value if type(value) is float else _Bad(value)
    if sql_type.startswith("decimal"):
        if type(value) is not str:
            return _Bad(value)
        try:
            return Decimal(value)
        except InvalidOperation:
            return _Bad(value)
    return value if type(value) is str else _Bad(value)


def _sort_key(row, positions, directions):
    return tuple(row[i] if d == "asc" else _Desc(row[i])
                 for i, d in zip(positions, directions))


class _Desc:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v


def differs(spec: dict, got: Sequence[Sequence],
            want: Sequence[Tuple]) -> Optional[str]:
    """None when `got` (the program's JSON rows) is a right answer, given
    the reference's rows `want` (canonical values, any order; for a
    LIMIT, the first rows and all their ties); else what is wrong."""
    names = [c for c, _ in spec["columns"]]
    types = [t for _, t in spec["columns"]]
    rows = []
    for r in got:
        if len(r) != len(types):
            return f"row {r!r} has {len(r)} values, not {len(types)}"
        rows.append(tuple(canonical(v, t) for v, t in zip(r, types)))
    positions = [names.index(c) for c, _ in spec["order_by"]]
    ordered = in_order(spec, want)
    limit = spec.get("limit")
    n = len(ordered) if limit is None else min(limit, len(ordered))
    if len(rows) != n:
        return f"{len(rows)} rows, want {n}"
    pos = 0
    for group in _ties(ordered, positions):
        take = min(len(group), n - pos)
        part = rows[pos:pos + take]
        extra = Counter(part) - Counter(group)
        if extra:
            return (f"rows {pos}..{pos + take - 1}: "
                    f"{list(extra)[:2]!r} not among {group[:2]!r}")
        pos += take
        if pos == n:
            break
    return None


def in_order(spec: dict, rows: Sequence[Tuple]) -> List[Tuple]:
    """Canonical rows sorted by the template's ORDER BY."""
    names = [c for c, _ in spec["columns"]]
    positions = [names.index(c) for c, _ in spec["order_by"]]
    directions = [d for _, d in spec["order_by"]]
    return sorted(rows, key=lambda r: _sort_key(r, positions, directions))


def _ties(ordered: List[Tuple], positions) -> List[List[Tuple]]:
    if not positions:
        return [list(ordered)] if ordered else []
    groups: List[List[Tuple]] = []
    for r in ordered:
        key = tuple(r[i] for i in positions)
        if groups and tuple(groups[-1][0][i] for i in positions) == key:
            groups[-1].append(r)
        else:
            groups.append([r])
    return groups


def as_sent(spec: dict, rows: Sequence[Tuple]) -> List[list]:
    """Canonical rows as the statement protocol sends a right answer:
    in ORDER BY order, cut at the LIMIT, each decimal as decimal text."""
    ordered = in_order(spec, rows)[:spec.get("limit") or None]
    return [[str(v) if isinstance(v, Decimal) else v for v in r]
            for r in ordered]
