"""Columnar batch format on torch tensors.

Counterpart of ``trino_tpu/batch.py``: the same fixed-capacity model
(Trino's ``Page`` of ``Block`` columns, spi/Page.java:31), held as
``torch.Tensor``s instead of JAX arrays.

- A :class:`Batch` has a fixed *capacity*; real rows are marked by a ``live``
  bool mask. Filtering ANDs into ``live``; compaction happens only where a
  row count is known.
- Every column carries a ``valid`` mask (SQL NULL). ``live`` and ``valid``
  are distinct: a live row may hold a NULL value.
- VARCHAR columns are int32 dictionary codes; string pools live host-side in
  the :class:`Schema` and never touch the device.

Capacities bucket exactly as the reference's do (``pad_capacity``,
``bucket_capacity``), so every capacity-dependent decision of the executor
matches. Every tensor lives on an explicit device: a batch is built on the
device its caller names, and operators keep their inputs' device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .types import DataType, TypeKind


# --------------------------------------------------------------------------
# Schema — host-side, hashable, holds dictionary pools
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    # String pool for VARCHAR columns (code -> string). Tuple for hashability.
    dictionary: Optional[tuple] = None


@dataclass(frozen=True)
class Schema:
    fields: tuple

    @staticmethod
    def of(*fields: Field) -> "Schema":
        return Schema(tuple(fields))

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(f"no column {name!r} in {self.names}")

    @property
    def names(self):
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        return self.fields[self.index_of(name)]


# --------------------------------------------------------------------------
# Column / Batch
# --------------------------------------------------------------------------

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (the engine's lane types only)."""
    return _NP_TO_TORCH[np.dtype(np_dtype)]


@dataclass
class Column:
    """One column: flat typed tensor + validity mask (Trino Block)."""

    data: torch.Tensor   # [capacity]
    valid: torch.Tensor  # [capacity] bool; False = SQL NULL

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


@dataclass
class Batch:
    """A fixed-capacity batch of columns (Trino Page).

    ``live[i]`` marks whether row i exists. All columns share capacity and
    device.
    """

    columns: tuple          # tuple[Column, ...]
    live: torch.Tensor      # [capacity] bool

    @property
    def capacity(self) -> int:
        return self.live.shape[0]

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, i: int) -> Column:
        return self.columns[i]

    @property
    def device(self) -> torch.device:
        return self.live.device

    def with_live(self, live: torch.Tensor) -> "Batch":
        return Batch(columns=self.columns, live=live)

    def select_columns(self, indices: Sequence[int]) -> "Batch":
        return Batch(columns=tuple(self.columns[i] for i in indices),
                     live=self.live)


# --------------------------------------------------------------------------
# Host <-> device conversion
# --------------------------------------------------------------------------

def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_capacity(n: int, multiple: int = 1024) -> int:
    """Bucket row counts (same rule as the reference, so capacities and
    the decisions keyed on them agree)."""
    return max(multiple, _round_up(n, multiple))


def bucket_capacity(n: int) -> int:
    """Coarse capacity bucket: the smallest of {2^k, 1.5*2^k} >= n."""
    n = max(1024, int(n))
    k = (n - 1).bit_length()
    if n <= 3 << (k - 2):          # 1.5 * 2^(k-1)
        return 3 << (k - 2)
    return 1 << k


def batch_from_numpy(arrays: Sequence[np.ndarray],
                     valids: Optional[Sequence[Optional[np.ndarray]]] = None,
                     capacity: Optional[int] = None,
                     pad_multiple: int = 1024, *,
                     device) -> Batch:
    """Build a Batch on `device` from host numpy columns, padding to
    capacity. Takes exactly what ``batch_to_numpy`` returns."""
    n = len(arrays[0]) if len(arrays) else 0
    for a in arrays:
        if len(a) != n:
            raise ValueError("ragged columns")
    cap = capacity if capacity is not None else pad_capacity(n, pad_multiple)
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} rows")
    cols = []
    for i, a in enumerate(arrays):
        a = np.asarray(a)
        data = np.zeros(cap, dtype=a.dtype)
        data[:n] = a
        v = np.zeros(cap, dtype=np.bool_)
        if valids is not None and valids[i] is not None:
            v[:n] = valids[i]
        else:
            v[:n] = True
        cols.append(Column(data=torch.from_numpy(data).to(device),
                           valid=torch.from_numpy(v).to(device)))
    live = np.zeros(cap, dtype=np.bool_)
    live[:n] = True
    return Batch(columns=tuple(cols), live=torch.from_numpy(live).to(device))


def batch_to_numpy(batch: Batch) -> tuple:
    """Compact live rows back to host numpy. Returns (arrays, valids)."""
    idx = torch.nonzero(batch.live).flatten()
    arrays, valids = [], []
    for col in batch.columns:
        arrays.append(col.data[idx].cpu().numpy())
        valids.append(col.valid[idx].cpu().numpy())
    return arrays, valids


def decode_column(field: Field, data: np.ndarray, valid: np.ndarray) -> list:
    """Render a host column to Python values (strings via dictionary,
    decimals via scale). Used at the client boundary only."""
    import datetime
    epoch = datetime.date(1970, 1, 1)
    out = []
    kind = field.dtype.kind
    for x, v in zip(data, valid):
        if not v:
            out.append(None)
        elif kind is TypeKind.VARCHAR:
            out.append(field.dictionary[int(x)])
        elif kind is TypeKind.DECIMAL:
            # exact: unscaled int64 may exceed 2^53, so float division
            # would corrupt low digits
            from decimal import Decimal
            out.append(Decimal(int(x)).scaleb(-field.dtype.scale))
        elif kind is TypeKind.DOUBLE:
            out.append(float(x))
        elif kind is TypeKind.BOOLEAN:
            out.append(bool(x))
        elif kind is TypeKind.DATE:
            out.append((epoch + datetime.timedelta(days=int(x))).isoformat())
        elif kind is TypeKind.TIMESTAMP:
            base = datetime.datetime(1970, 1, 1)
            out.append((base + datetime.timedelta(
                microseconds=int(x))).isoformat(sep=" "))
        else:
            out.append(int(x))
    return out
