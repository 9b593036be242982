"""Set operations on torch tensors.

Counterpart of the reference's set-op lowering (``remap_codes``,
``concat_batches`` and ``run_setop_host`` in trino_tpu/exec/executor.py;
Trino's UnionNode, IntersectNode and ExceptNode). UNION ALL is one concat
per column. The reference runs UNION, INTERSECT [ALL] and EXCEPT [ALL] as
a Python loop over row tuples on the host; here they run on the device
with the loop's semantics:

- rows compare with NULLs equal (NULL data normalised away);
- ``-0.0`` equals ``0.0``, and the first occurrence's value is kept;
- NaN never equals NaN (the reference's tuples hold a new float object
  per row, so NaN rows never deduplicate);
- the _ALL variants compare a left row's occurrence number within its
  group with the right side's count of that row;
- the output order is the reference's: first occurrences, left rows
  before right rows.

One stable lexicographic sort of both sides' live rows gives the groups;
selection reads back in original row order.
"""

from __future__ import annotations

import torch

from ..batch import Batch, Column, pad_capacity
from .join import lex_sort_perm

SETOPS = ("union", "union_all", "intersect", "intersect_all", "except",
          "except_all")


def remap_codes(batch: Batch, remaps) -> Batch:
    """Translate dictionary codes through per-column LUTs (the merged
    set-op pools). One gather per remapped column."""
    if all(r is None for r in remaps):
        return batch
    cols = []
    for col, rm in zip(batch.columns, remaps):
        if rm is None:
            cols.append(col)
        else:
            lut = torch.tensor(rm, dtype=torch.int32, device=batch.device)
            idx = col.data.to(torch.int64).clamp(0, max(len(rm) - 1, 0))
            cols.append(Column(lut[idx], col.valid))
    return Batch(tuple(cols), batch.live)


def concat_batches(a: Batch, b: Batch) -> Batch:
    """UNION ALL: columnwise concatenation (capacity is the sum, so no row
    can drop)."""
    cols = tuple(
        Column(torch.cat([ca.data, cb.data]), torch.cat([ca.valid, cb.valid]))
        for ca, cb in zip(a.columns, b.columns))
    return Batch(cols, torch.cat([a.live, b.live]))


def setop_rows(op: str, left: Batch, right: Batch) -> Batch:
    """UNION (distinct), INTERSECT [ALL], EXCEPT [ALL] of two type-aligned
    batches whose dictionary codes already share one pool. Output columns
    take the left side's dtypes; capacity is pad_capacity(rows)."""
    if op not in SETOPS or op == "union_all":
        raise ValueError(f"bad set operation {op!r}")
    dev = left.device
    if not left.columns:
        # the reference reads no rows from a zero-column batch
        return Batch((), torch.zeros(pad_capacity(0), dtype=torch.bool,
                                     device=dev))
    li = torch.nonzero(left.live).flatten()
    ri = torch.nonzero(right.live).flatten()
    n_left = li.shape[0]
    n = n_left + ri.shape[0]
    out_data, keys = [], []
    for cl, cr in zip(left.columns, right.columns):
        dt = torch.promote_types(cl.data.dtype, cr.data.dtype)
        valid = torch.cat([cl.valid[li], cr.valid[ri]])
        data = torch.cat([cl.data[li].to(dt), cr.data[ri].to(dt)])
        data = torch.where(valid, data, torch.zeros((), dtype=dt,
                                                    device=dev))
        out_data.append((data.to(cl.data.dtype), valid))
        key = data
        if dt.is_floating_point:
            key = torch.where(data == 0, torch.zeros((), dtype=dt,
                                                     device=dev), data)
        keys.extend((valid, key))
    rows = _selected_rows(op, keys, n_left, n) if n else li
    m = rows.shape[0]
    cap = pad_capacity(m)
    cols = []
    for data, valid in out_data:
        d = torch.zeros(cap, dtype=data.dtype, device=dev)
        v = torch.zeros(cap, dtype=torch.bool, device=dev)
        d[:m] = data[rows]
        v[:m] = valid[rows]
        cols.append(Column(d, v))
    return Batch(tuple(cols), torch.arange(cap, device=dev) < m)


def _selected_rows(op: str, keys: list, n_left: int, n: int):
    """Indices (ascending) of the rows `op` keeps among the n stacked
    rows, left rows first."""
    dev = keys[0].device
    perm = lex_sort_perm(keys)
    k = torch.arange(n, device=dev)
    boundary = k == 0
    for key in keys:
        ks = key[perm]
        boundary = boundary | (ks != torch.roll(ks, 1, 0))
    group_start = torch.cummax(torch.where(boundary, k, 0), 0).values
    gid_s = torch.cumsum(boundary.to(torch.int64), 0) - 1
    is_left_s = perm < n_left
    # the sort is stable and left rows come first, so a group's left rows
    # lead it in row order: a left row's occurrence number is its offset
    # from the group's first row
    occ_s = k - group_start
    rcount = torch.zeros(n, dtype=torch.int64, device=dev)
    rcount.scatter_add_(0, gid_s, (~is_left_s).to(torch.int64))
    rcount_s = rcount[gid_s]
    if op == "union":
        keep_s = boundary
    elif op == "intersect":
        keep_s = boundary & is_left_s & (rcount_s > 0)
    elif op == "except":
        keep_s = boundary & is_left_s & (rcount_s == 0)
    elif op == "intersect_all":
        keep_s = is_left_s & (occ_s < rcount_s)
    else:                                    # except_all
        keep_s = is_left_s & (occ_s >= rcount_s)
    keep = torch.zeros(n, dtype=torch.bool, device=dev)
    keep[perm] = keep_s
    return torch.nonzero(keep).flatten()
