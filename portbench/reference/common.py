"""What the plain references share: exact arithmetic, key lookups and
ORDER BY ... LIMIT with its ties.

A reference is ``answer(tables, params, arith) -> rows``: plain torch on
whatever device the tables are on, over the columns that the benchmark
generated (``gen/``). Its rows are tuples of canonical values: ``int``,
``str``, ``decimal.Decimal`` (exact), an ISO date as ``str``, or None.
Where the template has ORDER BY ... LIMIT n, a reference may return only
the first n rows in that order and every row tied with the n-th. It
imports nothing of the program under test.

``arith`` does the sums of scaled decimals. ``EXACT`` sums them as
int64, as the configuration states. The controls take each value as a
float in its own units, sum in that float, and round the sum half up to
the column's scale: ``FLOAT64``, the first step below exact decimals,
and ``FLOAT32``, the fast sum a card would take.
"""

from __future__ import annotations

import datetime
from decimal import Decimal
from typing import List, Sequence

import torch

EPOCH = datetime.date(1970, 1, 1)


def days(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - EPOCH).days


def iso(day: int) -> str:
    return (EPOCH + datetime.timedelta(days=int(day))).isoformat()


def add_months(iso_day: str, months: int) -> int:
    d = datetime.date.fromisoformat(iso_day)
    m = d.month - 1 + months
    return days(datetime.date(d.year + m // 12, m % 12 + 1,
                              d.day).isoformat())


def dec(scaled: int, scale: int) -> Decimal:
    return Decimal(int(scaled)).scaleb(-scale)


def code(table, column: str, value: str) -> int:
    """The code of `value` in a varchar column's pool, -1 if absent."""
    pool = table.pools[column]
    return pool.index(value) if value in pool else -1


def key_lut(keys: torch.Tensor, mask=None) -> torch.Tensor:
    """lut[key] = the row that holds `key` (among `mask`'s rows), else -1."""
    lut = torch.full((int(keys.max()) + 2,), -1, dtype=torch.int64,
                     device=keys.device)
    rows = torch.arange(keys.shape[0], device=keys.device)
    if mask is not None:
        keys, rows = keys[mask], rows[mask]
    lut[keys] = rows
    return lut


def lookup(lut: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """lut[keys], -1 for keys past its end."""
    inside = keys < lut.shape[0]
    return torch.where(inside, lut[torch.where(inside, keys, 0)], -1)


def top_with_ties(keys: Sequence[torch.Tensor], limit) -> torch.Tensor:
    """Row indices in ascending lexicographic order of `keys` (negate a
    key for descending): the first `limit` and every row tied with the
    limit-th, or all rows when `limit` is None."""
    n = keys[0].shape[0]
    order = torch.arange(n, device=keys[0].device)
    for k in reversed(keys):
        _, perm = torch.sort(k[order], stable=True)
        order = order[perm]
    if limit is None or n <= limit:
        return order
    last = [k[order[limit - 1]] for k in keys]
    tied = torch.ones(n, dtype=torch.bool, device=order.device)
    for k, v in zip(keys, last):
        tied &= k[order] == v
    tied[:limit] = True
    return order[:int(tied.nonzero().max()) + 1]


class _Exact:
    name = "exact"

    def group_sum(self, index: torch.Tensor, values: torch.Tensor,
                  groups: int, scale: int) -> torch.Tensor:
        out = torch.zeros(groups, dtype=torch.int64, device=values.device)
        return out.index_add_(0, index, values.to(torch.int64))

    def total(self, values: torch.Tensor, scale: int) -> int:
        return int(values.to(torch.int64).sum())


def _round_half_up(x: torch.Tensor, scale: int) -> torch.Tensor:
    y = x * (10 ** scale)
    return (torch.sign(y) * torch.floor(y.abs() + 0.5)).to(torch.int64)


class _Float:
    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.name = str(dtype).rsplit(".", 1)[1]

    def group_sum(self, index, values, groups, scale):
        out = torch.zeros(groups, dtype=self.dtype, device=values.device)
        out.index_add_(0, index, values.to(self.dtype) / 10 ** scale)
        return _round_half_up(out, scale)

    def total(self, values, scale):
        s = (values.to(self.dtype) / 10 ** scale).sum()
        return int(_round_half_up(s.reshape(1), scale)[0])


EXACT = _Exact()
FLOAT64 = _Float(torch.float64)
FLOAT32 = _Float(torch.float32)
ARITH = {a.name: a for a in (EXACT, FLOAT64, FLOAT32)}


def pick(pool: List[str], codes: torch.Tensor) -> List[str]:
    return [pool[int(c)] for c in codes.tolist()]
