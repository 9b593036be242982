"""Group-by aggregation on torch tensors.

Counterpart of ``trino_tpu/ops/aggregate.py`` (Trino's
HashAggregationOperator with GroupByHash's strategy choice). The same
strategies, picked by the same planner and executor rules:

- **direct** (small dense domains): mixed-radix group id, one masked
  reduction per (group, aggregate).
- **sort** (general keys): stable lexicographic sort, segment boundaries by
  adjacent difference, sums/counts by cumsum differencing, min/max by
  per-segment reduction; group keys read back through K1 (``ops/gather.py``)
  when the gather mode is on.
- **packed sort**: keys range-compressed into int64 words, LSD over words.
- **hash**: ``ops/hashtable.py`` (K3), dispatched by the executor.

All produce partial states (sum/count/min/max); AVG is (sum, count)
finalized in the post-projection.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..batch import Batch, Column

AGG_FUNCS = ("sum", "count", "count_star", "min", "max")

# direct strategy bound (the planner enforces the same bound)
MAX_DIRECT_GROUPS = 64

# partial-state merge function per aggregate (the reference keeps this in
# trino_tpu/exec/chunked.py; the planner's approx_distinct rewrite reads it)
MERGE_FUNC = {"sum": "sum", "count": "sum", "count_star": "sum",
              "min": "min", "max": "max"}


@dataclass(frozen=True)
class AggSpec:
    func: str                 # one of AGG_FUNCS
    arg_index: Optional[int]  # column in the input batch (None: count_star)
    distinct: bool = False    # sum/count DISTINCT (sort strategy only)

    def __post_init__(self):
        if self.func not in AGG_FUNCS or \
                (self.arg_index is None) != (self.func == "count_star") or \
                (self.distinct and self.func not in ("sum", "count")):
            raise ValueError(f"bad aggregate {self}")


def _is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Sum accumulator: int64 for integer lanes, the float type itself."""
    return dtype if dtype.is_floating_point else torch.int64


# the reference's float cumsum is XLA's blocked scan with this block size
CUMSUM_BLOCK = 16


def cumsum_like_reference(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along dim 0, with the reference's float rounding.

    XLA's CPU backend computes ``jnp.cumsum`` as a blocked scan: a
    sequential running sum inside each block of 16 (the tail padded with
    zeros), the same scan applied recursively over the block totals, and
    each block's carry added to its elements as ``inner + carry``. Float
    inputs follow that order here, with the in-block sums written as
    explicit column adds, so the CPU and CUDA give the same bits. Integer
    inputs take ``torch.cumsum``: exact in any order."""
    if not x.dtype.is_floating_point:
        return torch.cumsum(x, 0)
    n = x.shape[0]
    if n <= 1:
        return x.clone()
    b = CUMSUM_BLOCK
    m = -(-n // b)
    if m * b != n:
        x = torch.cat([x, x.new_zeros(m * b - n)])
    v = x.reshape(m, b)
    cols = [v[:, 0]]
    for j in range(1, b):
        cols.append(cols[-1] + v[:, j])
    inner = torch.stack(cols, 1)
    if m > 1:
        carry = cumsum_like_reference(inner[:, b - 1].contiguous())
        inner[1:] = inner[1:] + carry[:-1, None]
    return inner.reshape(-1)[:n]


# ... and its float sum a recursive reduce-window of this size
SUM_WINDOW = 32


def sum_like_reference(x: torch.Tensor, shards: int = 1) -> torch.Tensor:
    """Sum of a 1-D tensor, with the reference's float rounding.

    XLA's CPU backend rewrites a ``jnp.sum`` longer than 32 into
    reduce-windows of 32 (stride 32, the zero padding split evenly
    before and after, the low half first), applied again to the window
    sums until at most 32 remain, then one reduce; each window and the
    final reduce add sequentially from 0. Float inputs follow that order
    here as explicit column adds; integer sums are exact in any order.

    ``shards > 1``: the sum of an array row-sharded over a mesh of that
    many devices, as GSPMD computes it: each contiguous block summed as
    above, then the block sums added in shard order (the all-reduce)."""
    if not x.dtype.is_floating_point:
        return x.sum()
    if shards > 1:
        parts = [sum_like_reference(b) for b in x.reshape(shards, -1)]
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc
    b = SUM_WINDOW
    while x.shape[0] > b:
        n = x.shape[0]
        m = -(-n // b)
        lo = (m * b - n) // 2
        if m * b != n:
            x = torch.cat([x.new_zeros(lo), x, x.new_zeros(m * b - n - lo)])
        v = x.reshape(m, b)
        acc = x.new_zeros(m)
        for j in range(b):
            acc = acc + v[:, j]
        x = acc
    acc = x.new_zeros(())
    for j in range(x.shape[0]):
        acc = acc + x[j]
    return acc


def _identity(func: str, dtype: torch.dtype):
    if func == "sum" or func.startswith("count"):
        return 0
    if dtype.is_floating_point:
        return float("inf") if func == "min" else float("-inf")
    if dtype == torch.bool:
        return func == "min"
    info = torch.iinfo(dtype)
    return info.max if func == "min" else info.min


def _full(n: int, value, dtype, device) -> torch.Tensor:
    return torch.full((n,), value, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# direct (dense small-domain) strategy — masked reductions
# --------------------------------------------------------------------------

def direct_group_aggregate(batch: Batch, key_indices: tuple,
                           domains: tuple, aggs: tuple) -> Batch:
    """Group by small-domain integer/dictionary keys; output has exactly
    prod(domains) rows, group g's keys decode as mixed-radix digits of g.
    Groups with no rows are not live."""
    dev = batch.device
    out_capacity = 1
    for d in domains:
        out_capacity *= d
    if out_capacity > MAX_DIRECT_GROUPS:
        raise ValueError("direct strategy domain too large")

    gid = torch.zeros(batch.capacity, dtype=torch.int32, device=dev)
    key_valid = torch.ones(batch.capacity, dtype=torch.bool, device=dev)
    for ki, d in zip(key_indices, domains):
        col = batch.columns[ki]
        gid = gid * d + col.data.to(torch.int32).clamp(0, d - 1)
        key_valid = key_valid & col.valid
    contributes = batch.live & key_valid

    group_masks = [contributes & (gid == g) for g in range(out_capacity)]
    group_count = torch.stack([m.sum(dtype=torch.int64)
                               for m in group_masks])
    group_live = group_count > 0

    out_cols = []
    g_idx = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    radix = out_capacity
    for ki, d in zip(key_indices, domains):
        radix //= d
        digit = (g_idx // radix) % d
        out_cols.append(Column(
            data=digit.to(batch.columns[ki].data.dtype), valid=group_live))

    for spec in aggs:
        if spec.func == "count_star":
            out_cols.append(Column(data=group_count, valid=group_live))
            continue
        col = batch.columns[spec.arg_index]
        data = col.data
        cnt = torch.stack([(m & col.valid).sum(dtype=torch.int64)
                           for m in group_masks])
        if spec.func == "count":
            out_cols.append(Column(data=cnt, valid=group_live))
            continue
        if spec.func == "sum":
            vals = data.to(_acc_dtype(data.dtype))
            state = torch.stack([
                sum_like_reference(torch.where(m & col.valid, vals, 0))
                for m in group_masks])
        else:
            ident = _identity(spec.func, data.dtype)
            red = torch.amin if spec.func == "min" else torch.amax
            state = torch.stack([
                red(torch.where(m & col.valid, data,
                                torch.tensor(ident, dtype=data.dtype,
                                             device=dev)))
                for m in group_masks])
        out_cols.append(Column(data=state, valid=group_live & (cnt > 0)))
    return Batch(columns=tuple(out_cols), live=group_live)


# --------------------------------------------------------------------------
# sort-based general strategy
# --------------------------------------------------------------------------

def _segment_reduce(vals: torch.Tensor, seg: torch.Tensor,
                    out_capacity: int, func: str, ident) -> torch.Tensor:
    """Per-segment min/max (the reference's segmented associative scan
    read at segment ends). `seg` is each sorted row's group id, groups at
    or past out_capacity go to a sink slot."""
    idx = seg.clamp(0, out_capacity)
    out = torch.full((out_capacity + 1,), ident, dtype=vals.dtype,
                     device=vals.device)
    out.scatter_reduce_(0, idx, vals, "amin" if func == "min" else "amax")
    return out[:out_capacity]


def sort_group_aggregate(batch: Batch, key_indices: tuple, aggs: tuple,
                         out_capacity: int,
                         gather_mode: str = "off") -> Batch:
    """Group by arbitrary key columns via lexicographic sort. Exact;
    groups past `out_capacity` are dropped (the executor grows and
    retries). NULL keys group together."""
    n = batch.capacity
    dev = batch.device
    keys = [(~batch.live).to(torch.int8)]
    for ki in key_indices:
        col = batch.columns[ki]
        keys.append((~col.valid).to(torch.int8))
        # NULL keys must form ONE group: normalize masked-out data
        keys.append(torch.where(col.valid, col.data,
                                torch.zeros((), dtype=col.data.dtype,
                                            device=dev)))
    n_group_ops = len(keys)
    distinct_cols = sorted({s.arg_index for s in aggs if s.distinct})
    distinct_pos = {}
    for di in distinct_cols:
        col = batch.columns[di]
        distinct_pos[di] = len(keys)
        keys.append((~col.valid).to(torch.int8))
        keys.append(col.data)
    from .join import lex_sort_perm
    perm = lex_sort_perm(keys)
    live_s = batch.live[perm]

    diff = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in keys[1:n_group_ops]:
        ks = k[perm]
        diff = diff | (ks != torch.roll(ks, 1, 0))
    first = torch.arange(n, device=dev) == 0
    boundary = live_s & (first | diff)

    distinct_fresh = {}
    for di in distinct_cols:
        p = distinct_pos[di]
        dvinv_s, ddata_s = keys[p][perm], keys[p + 1][perm]
        distinct_fresh[di] = boundary | \
            (ddata_s != torch.roll(ddata_s, 1, 0)) | \
            (dvinv_s != torch.roll(dvinv_s, 1, 0))
    return _grouped_reduce(batch, key_indices, aggs, out_capacity, perm,
                           live_s, boundary, distinct_fresh, gather_mode)


def _grouped_reduce(batch: Batch, key_indices: tuple, aggs: tuple,
                    out_capacity: int, perm, live_s, boundary,
                    distinct_fresh, gather_mode: str = "off") -> Batch:
    """Shared segment machinery for the sorted kernels. The group readback
    (representative row per group -> key columns) rides K1 when the gather
    mode is on."""
    from . import gather as k1
    n = batch.capacity
    dev = batch.device
    seg = torch.cumsum(boundary.to(torch.int64), 0) - 1   # 0-based group id
    num_groups = boundary.sum(dtype=torch.int64)

    g = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    group_live = g < num_groups
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    from .join import scatter_max_sunk
    start_lut = scatter_max_sunk(
        torch.zeros(out_capacity + 1, dtype=torch.int32, device=dev), seg,
        pos, boundary & (seg < out_capacity))
    start_c = start_lut[:out_capacity].clamp(0, n - 1).to(torch.int64)
    next_start = start_lut[(g + 1).clamp(0, out_capacity)].to(torch.int64)
    end_pos = torch.where(g + 1 < num_groups,
                          (next_start - 1).clamp(0, n - 1), n - 1)

    out_cols = []
    key_tables = []
    for ki in key_indices:
        key_tables.extend((batch.columns[ki].data,
                           batch.columns[ki].valid))
    if gather_mode != "off" and k1.supports_tables([perm] + key_tables):
        # the group gather: one launch resolves the representative row,
        # one more every key data/valid plane
        rep = k1.gather_columns([perm], start_c)[0]
        outs = k1.gather_columns(key_tables, rep) if key_tables else []
        for j, ki in enumerate(key_indices):
            out_cols.append(Column(data=outs[2 * j],
                                   valid=outs[2 * j + 1] & group_live))
    else:
        rep = perm[start_c]
        for ki in key_indices:
            col = batch.columns[ki]
            out_cols.append(Column(data=col.data[rep],
                                   valid=col.valid[rep] & group_live))

    def seg_total(values_sorted):
        cs = cumsum_like_reference(values_sorted)
        upto_end = cs[end_pos]
        before_start = torch.where(start_c > 0,
                                   cs[(start_c - 1).clamp(0, n - 1)],
                                   torch.zeros((), dtype=cs.dtype,
                                               device=dev))
        return torch.where(group_live, upto_end - before_start,
                           torch.zeros((), dtype=cs.dtype, device=dev))

    for spec in aggs:
        if spec.func == "count_star":
            cnt = seg_total(live_s.to(torch.int64))
            out_cols.append(Column(data=cnt, valid=group_live))
            continue
        col = batch.columns[spec.arg_index]
        data_s = col.data[perm]
        valid_s = col.valid[perm] & live_s
        if spec.distinct:
            marker = valid_s & distinct_fresh[spec.arg_index]
            if spec.func == "count":
                out_cols.append(Column(data=seg_total(
                    marker.to(torch.int64)), valid=group_live))
            else:  # sum distinct
                vals = torch.where(marker,
                                   data_s.to(_acc_dtype(col.data.dtype)), 0)
                cnt = seg_total(marker.to(torch.int64))
                out_cols.append(Column(data=seg_total(vals),
                                       valid=group_live & (cnt > 0)))
            continue
        cnt = seg_total(valid_s.to(torch.int64))
        if spec.func == "count":
            out_cols.append(Column(data=cnt, valid=group_live))
            continue
        if spec.func == "sum":
            vals = torch.where(valid_s,
                               data_s.to(_acc_dtype(col.data.dtype)), 0)
            state = seg_total(vals)
        else:
            ident = _identity(spec.func, col.data.dtype)
            vals = torch.where(valid_s, data_s,
                               torch.tensor(ident, dtype=data_s.dtype,
                                            device=dev))
            red = _segment_reduce(vals, seg, out_capacity, spec.func, ident)
            state = torch.where(group_live, red,
                                torch.tensor(ident, dtype=data_s.dtype,
                                             device=dev))
        out_cols.append(Column(data=state, valid=group_live & (cnt > 0)))
    return Batch(columns=tuple(out_cols), live=group_live)


# --------------------------------------------------------------------------
# packed sort strategy — range-compressed keys
# --------------------------------------------------------------------------

def key_pack_plan(batch: Batch, key_indices: tuple, fetch=None):
    """Per-key [min, max] (one fetch) -> packing layout: key i takes
    ceil(log2(span+3)) bits. Returns (kmins host array, bits) or None when
    the width exceeds 62 bits or a key isn't integer-typed."""
    plan = _measure_key_bits(batch, key_indices, fetch)
    if plan is None:
        return None
    kmins, bits = plan
    if sum(bits) > 62:
        return None
    return kmins, bits


def key_pack_plan_words(batch: Batch, key_indices: tuple, fetch=None,
                        max_words: int = 3):
    """key_pack_plan over up to `max_words` int64 words (keys assigned in
    order). Returns (kmins, bits, word_splits) or None."""
    plan = _measure_key_bits(batch, key_indices, fetch)
    if plan is None:
        return None
    kmins, bits = plan
    splits = []
    start, cur = 0, 0
    for i, b in enumerate(bits):
        if b > 62:
            return None
        if cur + b > 62:
            splits.append((start, i))
            start, cur = i, 0
        cur += b
    splits.append((start, len(bits)))
    if len(splits) > max_words:
        return None
    return kmins, bits, tuple(splits)


def _measure_key_bits(batch: Batch, key_indices: tuple, fetch=None):
    stats = []
    big = torch.iinfo(torch.int64)
    for ki in key_indices:
        col = batch.columns[ki]
        if not _is_integer(col.data.dtype):
            return None
        m = batch.live & col.valid
        data = col.data.to(torch.int64)
        stats.append(torch.where(m, data, big.max).min())
        stats.append(torch.where(m, data, big.min).max())
    vals = fetch(*stats) if fetch is not None else \
        torch.stack(stats).tolist()
    kmins, bits = [], []
    for i in range(len(key_indices)):
        lo, hi = int(vals[2 * i]), int(vals[2 * i + 1])
        if hi < lo:
            lo, hi = 0, 0
        kmins.append(lo)
        bits.append(max(2, int(hi - lo + 3).bit_length()))
    return np.asarray(kmins, dtype=np.int64), tuple(bits)


def packed_sort_group_aggregate(batch: Batch, kmins, key_indices: tuple,
                                key_bits: tuple, aggs: tuple,
                                out_capacity: int,
                                word_splits: tuple = None,
                                gather_mode: str = "off") -> Batch:
    """sort_group_aggregate with keys packed into int64 words (host
    `kmins`): stable sorts from the least significant word. Dead rows
    pack to int64.max. No DISTINCT."""
    n = batch.capacity
    dev = batch.device
    if word_splits is None:
        word_splits = ((0, len(key_indices)),)
    words = []
    for (s, e) in word_splits:
        w = torch.zeros(n, dtype=torch.int64, device=dev)
        for j in range(s, e):
            col = batch.columns[key_indices[j]]
            norm = col.data.to(torch.int64) - int(kmins[j]) + 1
            norm = torch.where(col.valid, norm, 0)      # NULL slot
            w = (w << key_bits[j]) | norm
        words.append(torch.where(batch.live, w, torch.iinfo(torch.int64).max))
    from .join import lex_sort_perm
    perm = lex_sort_perm(words)
    live_s = batch.live[perm]

    first = torch.arange(n, device=dev) == 0
    diff = torch.zeros(n, dtype=torch.bool, device=dev)
    for w in words:
        ws = w[perm]
        diff = diff | (ws != torch.roll(ws, 1, 0))
    boundary = live_s & (first | diff)
    return _grouped_reduce(batch, key_indices, aggs, out_capacity, perm,
                           live_s, boundary, {}, gather_mode)


# --------------------------------------------------------------------------
# global (ungrouped) aggregation
# --------------------------------------------------------------------------

def global_aggregate(batch: Batch, aggs: tuple) -> Batch:
    """No GROUP BY: one output row, always live."""
    dev = batch.device
    out_cols = []
    one = torch.ones(1, dtype=torch.bool, device=dev)
    for spec in aggs:
        if spec.func == "count_star":
            cnt = batch.live.sum(dtype=torch.int64)[None]
            out_cols.append(Column(data=cnt, valid=one))
            continue
        col = batch.columns[spec.arg_index]
        m = batch.live & col.valid
        cnt = m.sum(dtype=torch.int64)[None]
        if spec.func == "count":
            out_cols.append(Column(data=cnt, valid=one))
            continue
        if spec.func == "sum":
            state = sum_like_reference(torch.where(
                m, col.data.to(_acc_dtype(col.data.dtype)), 0))[None]
        else:
            ident = _identity(spec.func, col.data.dtype)
            red = torch.amin if spec.func == "min" else torch.amax
            state = red(torch.where(m, col.data,
                                    torch.tensor(ident, dtype=col.data.dtype,
                                                 device=dev)))[None]
        out_cols.append(Column(data=state, valid=cnt > 0))
    return Batch(columns=tuple(out_cols), live=one)


# --------------------------------------------------------------------------
# host-side finalizers
# --------------------------------------------------------------------------

def avg_decimal_finalize(sums, counts, xp=np):
    """Exact decimal AVG: round-half-away-from-zero of sum/count at the
    input scale. `xp` is numpy for host arrays or torch for tensors."""
    counts = xp.where(counts == 0, 1, counts)
    q = sums // counts
    rem = sums - q * counts
    neg = sums < 0
    q = xp.where(neg & (rem != 0), q + 1, q)
    rem = xp.where(neg, sums - q * counts, rem)
    up = (2 * xp.abs(rem) >= counts)
    up = up.astype(np.int64) if xp is np else up.to(torch.int64)
    return xp.where(neg, q - up, q + up)
