"""Window functions on torch tensors.

Counterpart of ``trino_tpu/ops/window.py`` (Trino's WindowOperator,
operator/WindowOperator.java:70). The same design: ONE lexicographic sort
by (partition keys, order keys) for the whole batch, then every function is
a combination of segment boundaries (adjacent differences on the sorted
keys), running sums, segmented min/max scans and per-row binary searches
for partition, peer and frame extents. Results return to the original row
order through the inverse permutation.

The reference's sort keeps tied rows in input order (XLA's sort on the CPU
is stable in practice); the port's ``lex_sort_perm`` is stable by
construction, so `row_number` and ROWS frames over ties agree. Running
sums over floats use ``cumsum_like_reference`` (the reference's blocked
scan order), so DOUBLE window sums carry the reference's bits; integer
sums and every min/max are exact in any order.

Frames (the planner maps SQL frames onto these):
- "partition":     the whole partition
- "range_running": RANGE UNBOUNDED PRECEDING..CURRENT ROW (with peers)
- "rows_running":  ROWS UNBOUNDED PRECEDING..CURRENT ROW
- "rows_bounded:p:f", "range_bounded:p:f": p PRECEDING .. f FOLLOWING
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..batch import Batch, Column
from .aggregate import cumsum_like_reference
from .join import lex_sort_perm
from .sort import _sort_key_encoding

RANKING = ("row_number", "rank", "dense_rank", "ntile")
VALUE_FUNCS = ("lead", "lag", "first_value", "last_value")
AGG_FUNCS = ("sum", "count", "count_star", "min", "max")
FRAMES = ("partition", "range_running", "rows_running")

_I64_MAX = (1 << 63) - 1


@dataclass(frozen=True)
class WinSpec:
    """One window function over the shared (partition, order) sort."""
    func: str                       # RANKING | VALUE_FUNCS | AGG_FUNCS
    arg_index: Optional[int] = None  # input column (None: row_number etc.)
    frame: str = "partition"        # FRAMES (aggregates/last_value only)
    offset: int = 1                 # lead/lag offset, ntile bucket count
    default: Optional[object] = None  # lead/lag default literal

    def __post_init__(self):
        if self.func not in RANKING + VALUE_FUNCS + AGG_FUNCS or not (
                self.frame in FRAMES or self.frame.startswith(
                    ("rows_bounded:", "range_bounded:"))):
            raise ValueError(f"bad window function {self}")


def _scan_max(vals: torch.Tensor) -> torch.Tensor:
    """Running maximum (propagates the latest boundary index forward)."""
    return torch.cummax(vals, 0).values


def _lower_bound(vals: torch.Tensor, lo0: torch.Tensor, hi0: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
    """Per-row vectorized binary search: first j in [lo0, hi0] with
    vals[j] >= target (vals non-decreasing on that range); hi0 + 1 when
    there is none. The RANGE-frame boundary finder."""
    n = vals.shape[0]
    lo, hi = lo0, hi0 + 1
    for _ in range(max(1, math.ceil(math.log2(n + 1)))):
        cont = lo < hi
        mid = (lo + hi) >> 1
        less = vals[mid.clamp(0, n - 1).to(torch.int64)] < target
        lo = torch.where(cont & less, mid + 1, lo)
        hi = torch.where(cont & ~less, mid, hi)
    return lo


def _segmented_scan(vals: torch.Tensor, boundary: torch.Tensor, op):
    """Inclusive segmented scan: position i holds the `op`-reduction of
    its segment's values up to i; boundary[i] starts a segment. Doubling
    steps (min/max are exact in any order, NaN included)."""
    n = vals.shape[0]
    v, f = vals, boundary
    d = 1
    while d < n:
        pv = torch.cat([v[:d], v[:-d]])
        pf = torch.cat([torch.ones(d, dtype=torch.bool, device=f.device),
                        f[:-d]])
        take = ~f
        take[:d] = False
        v = torch.where(take, op(pv, v), v)
        f = f | pf
        d <<= 1
    return v


def window_compute(batch: Batch, partition_keys: tuple, order_keys: tuple,
                   specs: tuple) -> Batch:
    """Append one column per spec, in the batch's ORIGINAL row order.

    partition_keys: column indices; NULLs form one partition (PARTITION BY
    treats NULLs as equal, like GROUP BY).
    order_keys: ((col_index, ascending, nulls_first), ...)."""
    n = batch.capacity
    dev = batch.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)

    operands = [(~batch.live).to(torch.int8)]      # dead rows sort last
    for ki in partition_keys:
        col = batch.columns[ki]
        operands.append((~col.valid).to(torch.int8))
        operands.append(torch.where(col.valid, col.data,
                                    torch.zeros((), dtype=col.data.dtype,
                                                device=dev)))
    n_part_ops = len(operands)
    for (ki, asc, nf) in order_keys:
        nr, data = _sort_key_encoding(batch.columns[ki], asc, nf)
        operands.append(nr)
        operands.append(data)
    perm = lex_sort_perm(operands)
    sorted_ops = [op[perm] for op in operands]
    live_s = batch.live[perm]
    invperm = torch.empty_like(perm)
    invperm[perm] = torch.arange(n, dtype=perm.dtype, device=dev)

    first = idx == 0
    part_diff = torch.zeros(n, dtype=torch.bool, device=dev)
    for op in sorted_ops[1:n_part_ops]:
        part_diff = part_diff | (op != torch.roll(op, 1, 0))
    part_boundary = live_s & (first | part_diff)
    order_diff = part_diff
    for op in sorted_ops[n_part_ops:]:
        order_diff = order_diff | (op != torch.roll(op, 1, 0))
    peer_boundary = live_s & (first | order_diff)

    big = n + 1
    seg = torch.cumsum(part_boundary.to(torch.int32), 0,
                       dtype=torch.int32) - 1
    seg = torch.where(live_s, seg, big)            # dead rows: own segment
    pid = torch.cumsum(peer_boundary.to(torch.int32), 0,
                       dtype=torch.int32) - 1
    pid = torch.where(live_s, pid, big)

    part_start = torch.searchsorted(seg, seg, side="left").to(torch.int32)
    part_end = (torch.searchsorted(seg, seg, side="right") - 1).to(
        torch.int32)
    peer_end = (torch.searchsorted(pid, pid, side="right") - 1).to(
        torch.int32)
    part_start = part_start.clamp(0, n - 1)
    part_end = part_end.clamp(0, n - 1)
    peer_end = peer_end.clamp(0, n - 1)
    ps_l = part_start.to(torch.int64)

    row0 = idx - part_start                        # 0-based position
    peer_cum = torch.cumsum(peer_boundary.to(torch.int64), 0)
    dense = peer_cum - peer_cum[ps_l] + 1           # dense_rank

    def frame_end(frame: str) -> torch.Tensor:
        if frame == "partition":
            return part_end
        if frame == "range_running":
            return peer_end
        return idx                                 # rows_running

    def peer_start():
        return _scan_max(torch.where(peer_boundary, idx, -1))

    out_cols = list(batch.columns)
    for spec in specs:
        f = spec.func
        if f == "row_number":
            col = Column((row0 + 1).to(torch.int64)[invperm], batch.live)
        elif f == "rank":
            # rank = index of the peer group's first row within partition
            data = (peer_start() - part_start + 1).to(torch.int64)
            col = Column(data[invperm], batch.live)
        elif f == "dense_rank":
            col = Column(dense[invperm], batch.live)
        elif f == "ntile":
            k = spec.offset
            size = part_end - part_start + 1
            base, rem = size // k, size % k
            fat = base + 1                         # first `rem` tiles
            in_fat = row0 < fat * rem
            tile = torch.where(
                in_fat, row0 // fat.clamp(min=1),
                rem + (row0 - fat * rem) // base.clamp(min=1))
            col = Column((tile + 1).to(torch.int64)[invperm], batch.live)
        elif f in ("lead", "lag"):
            src = batch.columns[spec.arg_index]
            data_s, valid_s = src.data[perm], src.valid[perm]
            off = spec.offset if f == "lead" else -spec.offset
            tgt = idx + off
            in_part = (tgt >= part_start) & (tgt <= part_end)
            tgt = tgt.clamp(0, n - 1).to(torch.int64)
            if spec.default is None:
                dval = torch.zeros((), dtype=src.data.dtype, device=dev)
                dvalid = False
            else:
                dval = torch.tensor(spec.default, dtype=src.data.dtype,
                                    device=dev)
                dvalid = True
            data = torch.where(in_part, data_s[tgt], dval)
            valid = torch.where(in_part, valid_s[tgt], dvalid) & live_s
            col = Column(data[invperm], valid[invperm] & batch.live)
        elif f == "first_value":
            src = batch.columns[spec.arg_index]
            data_s, valid_s = src.data[perm], src.valid[perm]
            col = Column(data_s[ps_l][invperm],
                         valid_s[ps_l][invperm] & batch.live)
        elif f == "last_value":
            src = batch.columns[spec.arg_index]
            data_s, valid_s = src.data[perm], src.valid[perm]
            end = frame_end(spec.frame).to(torch.int64)
            col = Column(data_s[end][invperm],
                         valid_s[end][invperm] & batch.live)
        else:
            col = _framed_aggregate(batch, spec, order_keys, perm, invperm,
                                    live_s, idx, part_start, part_end,
                                    peer_end, peer_boundary, part_boundary,
                                    frame_end, peer_start)
        out_cols.append(col)
    return Batch(columns=tuple(out_cols), live=batch.live)


def _framed_aggregate(batch, spec, order_keys, perm, invperm, live_s, idx,
                      part_start, part_end, peer_end, peer_boundary,
                      part_boundary, frame_end, peer_start) -> Column:
    """count/count_star/sum/min/max over the spec's frame."""
    n = batch.capacity
    dev = batch.device
    f = spec.func
    if spec.frame.startswith("rows_bounded:"):
        _, p_s, f_s = spec.frame.split(":")
        fstart = torch.maximum(part_start, idx - int(p_s))
        end = torch.minimum(part_end, idx + int(f_s))
        empty = end < fstart
        end = end.clamp(0, n - 1)
    elif spec.frame.startswith("range_bounded:"):
        # RANGE x PRECEDING .. y FOLLOWING: value offsets over the single
        # ORDER BY key, found by per-partition binary searches over the
        # sorted values; NULL-key rows frame their peer group
        _, p_s, f_s = spec.frame.split(":")
        prec, foll = int(p_s), int(f_s)
        unbounded_prec = prec >= (1 << 62)
        ki, asc, nf = order_keys[0]
        okey = batch.columns[ki]
        ovalid_s = okey.valid[perm]
        imax = _I64_MAX
        ov = okey.data[perm].to(torch.int64)
        ov = ov if asc else -ov
        # NULL keys sit in one block at the partition edge; a sentinel
        # keeps v monotone. Bound arithmetic saturates.
        v = torch.where(ovalid_s, ov, -imax if nf else imax)
        if unbounded_prec:
            lo_t = torch.full_like(v, -imax)
        else:
            lo_t = torch.where(v < -imax + prec, -imax, v - prec)
        hi_t = torch.where(v > imax - 1 - foll, imax - 1, v + foll)
        fstart = _lower_bound(v, part_start, idx, lo_t)
        end = _lower_bound(v, idx, part_end, hi_t + 1) - 1
        null_start = part_start if unbounded_prec else peer_start()
        fstart = torch.where(ovalid_s, fstart, null_start)
        end = torch.where(ovalid_s, end, peer_end)
        empty = end < fstart
        fstart = fstart.clamp(0, n - 1)
        end = end.clamp(0, n - 1)
    else:
        fstart = part_start
        end = frame_end(spec.frame)
        empty = torch.zeros(n, dtype=torch.bool, device=dev)
    before = torch.where(fstart > 0, (fstart - 1).clamp(0, n - 1),
                         0).to(torch.int64)
    end = end.to(torch.int64)

    def running_total(vals):
        cs = cumsum_like_reference(vals)
        zero = torch.zeros((), dtype=cs.dtype, device=dev)
        lo = torch.where(fstart > 0, cs[before], zero)
        return torch.where(empty, zero, cs[end] - lo)

    if f == "count_star":
        data = running_total(live_s.to(torch.int64))
        return Column(data[invperm], batch.live)
    src = batch.columns[spec.arg_index]
    data_s = src.data[perm]
    valid_s = src.valid[perm] & live_s
    cnt = running_total(valid_s.to(torch.int64))
    if f == "count":
        return Column(cnt[invperm], batch.live)
    if f == "sum":
        acc = src.data.dtype if src.data.dtype.is_floating_point \
            else torch.int64
        vals = torch.where(valid_s, data_s.to(acc),
                           torch.zeros((), dtype=acc, device=dev))
        data = running_total(vals)
        return Column(data[invperm], (cnt > 0)[invperm] & batch.live)
    # min / max: a running scan from the partition's first row, read at
    # the frame's end (the reference's associative scan)
    if data_s.dtype.is_floating_point:
        ident = float("inf") if f == "min" else float("-inf")
    else:
        info = torch.iinfo(data_s.dtype)
        ident = info.max if f == "min" else info.min
    op = torch.minimum if f == "min" else torch.maximum
    vals = torch.where(valid_s, data_s,
                       torch.tensor(ident, dtype=data_s.dtype, device=dev))
    scanned = _segmented_scan(vals, part_boundary, op)
    return Column(scanned[end][invperm], (cnt > 0)[invperm] & batch.live)
