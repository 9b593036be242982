"""Sort / TopN / Limit on torch tensors.

Counterpart of ``trino_tpu/ops/sort.py`` (OrderByOperator / TopNOperator).
The reference's multi-operand ``lax.sort`` becomes stable ``torch.sort``
passes from the least significant key (``ops.join.lex_sort_perm``), or one
packed int64 key (``sort_batch_packed``); ties keep input order.
"""

from __future__ import annotations

import torch

from ..batch import Batch, Column


def _sort_key_encoding(col: Column, ascending: bool, nulls_first: bool):
    """(null_rank, data) whose ascending lexicographic order realizes the
    requested direction + null placement."""
    if nulls_first:
        null_rank = col.valid.to(torch.int8)
    else:
        null_rank = (~col.valid).to(torch.int8)
    # normalize NULL slots: garbage data must not order NULL rows
    data = torch.where(col.valid, col.data,
                       torch.zeros((), dtype=col.data.dtype,
                                   device=col.data.device))
    if not ascending:
        if data.dtype == torch.bool:
            data = ~data
        elif data.dtype.is_floating_point:
            data = -data
        else:
            data = torch.bitwise_not(data)   # order-reversing, overflow-safe
    return null_rank, data


def sort_batch(batch: Batch, keys: tuple, limit) -> Batch:
    """keys: tuple of (col_index, ascending, nulls_first). Dead rows sort
    last; an optional limit marks only the first `limit` rows live."""
    from .join import lex_sort_perm
    n = batch.capacity
    operands = [(~batch.live).to(torch.int8)]
    for (idx, asc, nf) in keys:
        nr, data = _sort_key_encoding(batch.columns[idx], asc, nf)
        operands.append(nr)
        operands.append(data)
    perm = lex_sort_perm(operands)
    cols = tuple(Column(data=c.data[perm], valid=c.valid[perm])
                 for c in batch.columns)
    live = batch.live[perm]
    if limit is not None:
        live = live & (torch.arange(n, device=batch.device) < int(limit))
    return Batch(columns=cols, live=live)


def sort_pack_plan(batch: Batch, keys: tuple, fetch=None):
    """Range-compress integer ORDER BY keys into one int64 (the
    aggregation kernels' measurement and layout)."""
    from .aggregate import key_pack_plan
    return key_pack_plan(batch, tuple(idx for idx, _, _ in keys),
                         fetch=fetch)


def sort_batch_packed(batch: Batch, kmins, keys: tuple, key_bits: tuple,
                      limit) -> Batch:
    """sort_batch via one packed int64 key (host `kmins`): rank within each
    key's field realizes ASC/DESC + null placement; dead rows pack to
    int64.max."""
    n = batch.capacity
    dev = batch.device
    packed = torch.zeros(n, dtype=torch.int64, device=dev)
    for j, ((idx, asc, nf), b) in enumerate(zip(keys, key_bits)):
        col = batch.columns[idx]
        span_max = (1 << b) - 1
        norm = col.data.to(torch.int64) - int(kmins[j]) + 1
        rank = norm if asc else (span_max - 1) - norm
        null_slot = 0 if nf else span_max
        rank = torch.where(col.valid, rank, null_slot)
        packed = (packed << b) | rank
    packed = torch.where(batch.live, packed, torch.iinfo(torch.int64).max)
    perm = torch.sort(packed, stable=True).indices
    out_n = n
    if limit is not None and int(limit) < n:
        # TopN: winners live in the prefix — slice before the gathers
        from ..batch import bucket_capacity
        out_n = min(n, max(1024, bucket_capacity(int(limit))))
        perm = perm[:out_n]
    cols = tuple(Column(data=c.data[perm], valid=c.valid[perm])
                 for c in batch.columns)
    live = batch.live[perm]
    if limit is not None:
        live = live & (torch.arange(out_n, device=dev) < int(limit))
    return Batch(columns=cols, live=live)


def limit_batch(batch: Batch, count: int) -> Batch:
    """Keep the first `count` live rows (in current order)."""
    rank = torch.cumsum(batch.live.to(torch.int64), 0) - 1
    return batch.with_live(batch.live & (rank < int(count)))
