"""What every generator returns: plain columns of one table.

A column is a 1-D torch tensor. A ``varchar`` column holds int32 codes
into its pool, a sorted list of strings; a ``decimal(p,s)`` column holds
the value times 10**s as int64; a ``date`` column holds days since
1970-01-01 as int32. Nothing here imports the program under test.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

EPOCH = datetime.date(1970, 1, 1)


def days(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - EPOCH).days


@dataclass
class Table:
    name: str
    columns: Dict[str, torch.Tensor]
    types: Dict[str, str]
    pools: Dict[str, List[str]] = field(default_factory=dict)
    primary_key: Tuple[str, ...] = ()

    @property
    def num_rows(self) -> int:
        return int(next(iter(self.columns.values())).shape[0])

    def to(self, device) -> "Table":
        return Table(self.name,
                     {k: v.to(device) for k, v in self.columns.items()},
                     self.types, self.pools, self.primary_key)


def keep_columns(table: Table, wanted) -> Table:
    """Keep only the wanted columns (all when `wanted` is None)."""
    if wanted is not None:
        for name in list(table.columns):
            if name not in wanted:
                del table.columns[name]
                table.types.pop(name)
                table.pools.pop(name, None)
    return table


def codes_of(values: List[str], pool: List[str], device) -> torch.Tensor:
    index = {s: i for i, s in enumerate(pool)}
    return torch.tensor([index[v] for v in values], dtype=torch.int32,
                        device=device)


def randint(gen: torch.Generator, lo: int, hi: int, n: int, device,
            dtype=torch.int64) -> torch.Tensor:
    """n integers uniform in [lo, hi), drawn on `device`."""
    return torch.randint(lo, hi, (n,), generator=gen, device=device,
                         dtype=dtype)


def word_pool(seed: int, n: int, words: int, lexicon: List[str]) -> list:
    """`n` distinct strings of `words` lexicon words, sorted; drawn with
    the seed on the host (the pool is small)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lex = np.array(lexicon)
    out = set()
    while len(out) < n:
        for row in rng.integers(0, len(lex), size=(n, words)):
            out.add(" ".join(lex[row]))
            if len(out) == n:
                break
    return sorted(out)
