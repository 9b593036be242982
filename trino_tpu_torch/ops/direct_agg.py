"""K5: the direct-aggregation arm's grouped sums, in one launch.

Counterpart of ``trino_tpu/ops/pallas_agg.py`` (TPU kernel ``_kernel``
launched by ``_mxu_sums``; public ``direct_group_aggregate_mxu``). The
executor's `mxu` arm of a direct aggregate (``Executor.use_mxu_agg``)
turns sum/count aggregates over a dense domain of at most MAX_GROUPS groups
into one pass: per row a group id and a few int64 value planes, summed per
group.

The TPU kernel split each int64 into int32 hi/lo planes and 12-bit limbs,
because the MXU multiplies floats: a one-hot f32 matmul summed the limbs
exactly, which made it exact for |value| < 2^59 (the reference's
documented domain). The port sums int64 directly with wrapping
arithmetic (``csrc/direct_agg.cu``), so it equals the TPU kernel on that
domain and equals ``ops.aggregate.direct_group_aggregate`` on every
input.

``direct_group_aggregate_mxu`` decides by the batch's device: CPU -> the
plain version (the reference wrapper's torch body over masked sums),
CUDA -> the kernel or raise. The kernel reads the batch's columns as they
lie and writes the output batch's columns into one allocation: one
allocation, one ctypes call and one launch per call.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..batch import Batch, Column
from .cuda_build import check, launch_on, library

# the reference's gates, kept so the executor makes the same choice
MAX_GROUPS = 16
MAX_AGGS = 8
MAX_PLANES = 1 + 2 * MAX_AGGS      # live count + per sum a value and a
                                   # validity-companion plane
# the kernel's limits past the reference's gates (csrc/direct_agg.cu)
MAX_KEYS = 16
MAX_CELLS = MAX_GROUPS * MAX_PLANES
KEY_WORDS, AGG_WORDS = 5, 6
# column codes the kernel reads: a signed integer's size, or a byte
CODES = {torch.int8: 1, torch.int16: 2, torch.int32: 4, torch.int64: 8,
         torch.uint8: 9, torch.bool: 9}
AGG_KINDS = {"count_star": 0, "count": 1, "sum": 2}


def supports(aggs, domains) -> bool:
    g = int(np.prod(domains)) if domains else 0
    if not (0 < g <= MAX_GROUPS and len(aggs) <= MAX_AGGS):
        return False
    return all(a.func in ("sum", "count", "count_star") and not a.distinct
               for a in aggs)


def group_sums_plain(gid: torch.Tensor, planes: torch.Tensor,
                     n_groups: int) -> torch.Tensor:
    """gid [n] int32 (`n_groups` = miss), planes [A, n] int64 ->
    [n_groups, A] int64: one masked wrapping sum per group."""
    return torch.stack([torch.where(gid == g, planes, 0).sum(dim=1)
                        for g in range(n_groups)])


def _groups(domains) -> int:
    n_groups = 1
    for d in domains:
        n_groups *= d
    return n_groups


def group_lanes(batch: Batch, key_indices: tuple, domains: tuple,
                aggs: tuple):
    """The reference wrapper's lanes in torch: gid [n] int32 (G = miss)
    and planes [A, n] int64 (the live count, per count one plane, per sum
    its value and its non-null count)."""
    n_groups = _groups(domains)
    cap = batch.capacity
    dev = batch.device

    gid = torch.zeros(cap, dtype=torch.int32, device=dev)
    key_valid = torch.ones(cap, dtype=torch.bool, device=dev)
    for ki, d in zip(key_indices, domains):
        col = batch.columns[ki]
        gid = gid * d + col.data.to(torch.int32).clamp(0, d - 1)
        key_valid = key_valid & col.valid
    contributes = batch.live & key_valid
    gid = torch.where(contributes, gid, n_groups)       # miss group

    # value planes: a leading live-count plane, one per aggregate, and a
    # validity companion (non-null contributor count) per sum
    planes = [contributes.to(torch.int64)]
    for spec in aggs:
        if spec.func == "count_star":
            planes.append(planes[0])
            continue
        col = batch.columns[spec.arg_index]
        m = contributes & col.valid
        if spec.func == "count":
            planes.append(m.to(torch.int64))
        else:
            planes.append(torch.where(m, col.data.to(torch.int64), 0))
            planes.append(m.to(torch.int64))
    return gid, torch.stack(planes)


def direct_group_aggregate_mxu_plain(batch: Batch, key_indices: tuple,
                                     domains: tuple, aggs: tuple) -> Batch:
    """Plain version: the reference wrapper's body in torch — the lanes,
    masked sums per group, the output columns."""
    n_groups = _groups(domains)
    dev = batch.device
    tot = group_sums_plain(*group_lanes(batch, key_indices, domains, aggs),
                           n_groups)

    group_live = tot[:, 0] > 0
    out_cols = []
    g_idx = torch.arange(n_groups, dtype=torch.int32, device=dev)
    radix = n_groups
    for ki, d in zip(key_indices, domains):
        radix //= d
        digit = (g_idx // radix) % d
        out_cols.append(Column(
            data=digit.to(batch.columns[ki].data.dtype), valid=group_live))
    plane = 1
    for spec in aggs:
        state = tot[:, plane]
        plane += 1
        if spec.func in ("count", "count_star"):
            out_cols.append(Column(data=state, valid=group_live))
        else:                                   # sum + its validity plane
            cnt = tot[:, plane]
            plane += 1
            out_cols.append(Column(data=state,
                                   valid=group_live & (cnt > 0)))
    return Batch(columns=tuple(out_cols), live=group_live)


def direct_group_aggregate_mxu(batch: Batch, key_indices: tuple,
                               domains: tuple, aggs: tuple) -> Batch:
    """Drop-in for ops.aggregate.direct_group_aggregate when supports()
    holds: same output layout (key digit columns, then aggregate
    states). A CPU batch runs the plain version; a CUDA batch runs K5 in
    one launch, or raises."""
    dev = batch.device
    if dev.type == "cpu":
        return direct_group_aggregate_mxu_plain(batch, key_indices,
                                                domains, aggs)
    if dev.type != "cuda":
        raise RuntimeError(f"direct_group_aggregate_mxu: no kernel for "
                           f"{dev}")
    return _launch(batch, key_indices, domains, aggs)


direct_group_aggregate_mxu.launches = 0


def output_layout(key_dtypes, funcs, n_groups: int):
    """Byte offsets of the output columns in K5's one allocation: the
    int64 states first, then each key's digits (8-byte aligned), then
    group_live and each sum's validity. Returns (key offsets, state
    offsets, sum-validity offsets (None for counts), group_live offset,
    total bytes)."""
    at = 8 * n_groups * len(funcs)
    state_offs = [8 * n_groups * j for j in range(len(funcs))]
    key_offs = []
    for dt in key_dtypes:
        key_offs.append(at)
        at += -(-n_groups * dt.itemsize // 8) * 8
    live_off = at
    at += n_groups
    valid_offs = []
    for f in funcs:
        if f == "sum":
            valid_offs.append(at)
            at += n_groups
        else:
            valid_offs.append(None)
    return key_offs, state_offs, valid_offs, live_off, at


def batch_from_output(out: torch.Tensor, key_dtypes, layout,
                      n_groups: int) -> Batch:
    """The output Batch as views of K5's one allocation `out` (uint8),
    laid out as `layout` (output_layout's) says."""
    key_offs, state_offs, valid_offs, live_off, _ = layout
    group_live = out[live_off:live_off + n_groups].view(torch.bool)
    cols = []
    for dt, off in zip(key_dtypes, key_offs):
        cols.append(Column(data=out[off:off + n_groups * dt.itemsize]
                           .view(dt),
                           valid=group_live))
    for off, voff in zip(state_offs, valid_offs):
        cols.append(Column(
            data=out[off:off + 8 * n_groups].view(torch.int64),
            valid=group_live if voff is None else
            out[voff:voff + n_groups].view(torch.bool)))
    return Batch(columns=tuple(cols), live=group_live)


_Words = ctypes.c_uint64 * (KEY_WORDS * MAX_KEYS + AGG_WORDS * MAX_AGGS + 1)
# per (device index, raw stream): MAX_CELLS accumulator words and a
# ticket, zero between calls (each launch leaves them zero); the stream's
# order keeps two calls from sharing them at once
_scratch = {}


def _scratch_for(dev, stream) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None:
        buf = torch.zeros(MAX_CELLS + 1, dtype=torch.int64, device=dev)
        _scratch[key] = buf
    return buf


def _column(t: torch.Tensor, n: int, dev, what: str) -> torch.Tensor:
    if t.shape != (n,) or t.device != dev:
        raise ValueError(f"direct_group_aggregate_mxu: {what} does not "
                         f"match the batch")
    return t if t.is_contiguous() else t.contiguous()


def _launch(batch: Batch, key_indices, domains, aggs) -> Batch:
    n_groups = _groups(domains)
    if not 1 <= n_groups <= MAX_GROUPS or len(aggs) > MAX_AGGS or \
            len(key_indices) > MAX_KEYS:
        raise ValueError(f"direct_group_aggregate_mxu: {n_groups} groups, "
                         f"{len(aggs)} aggregates, {len(key_indices)} keys "
                         f"is out of range")
    dev = batch.device
    n = batch.capacity
    live = _column(batch.live, n, dev, "live")
    words = _Words()
    held = [live]            # converted columns live across the call
    key_dtypes = []
    for k, (ki, d) in enumerate(zip(key_indices, domains)):
        col = batch.columns[ki]
        code = CODES.get(col.data.dtype)
        if code is None:
            raise ValueError(f"direct_group_aggregate_mxu: no key of "
                             f"{col.data.dtype}")
        data = _column(col.data, n, dev, "a key")
        valid = _column(col.valid, n, dev, "a key's validity")
        held += [data, valid]
        key_dtypes.append(col.data.dtype)
        w = KEY_WORDS * k
        words[w:w + 4] = [data.data_ptr(), valid.data_ptr(), code, d]
    funcs = []
    for j, spec in enumerate(aggs):
        if spec.func not in AGG_KINDS or spec.distinct:
            raise ValueError(f"direct_group_aggregate_mxu: no "
                             f"{spec.func} aggregate")
        funcs.append(spec.func)
        w = KEY_WORDS * MAX_KEYS + AGG_WORDS * j
        words[w] = AGG_KINDS[spec.func]
        if spec.func == "count_star":
            continue
        col = batch.columns[spec.arg_index]
        valid = _column(col.valid, n, dev, "an aggregate's validity")
        held.append(valid)
        words[w + 2] = valid.data_ptr()
        if spec.func == "sum":
            code = CODES.get(col.data.dtype)
            if code is None:
                raise ValueError(f"direct_group_aggregate_mxu: no sum of "
                                 f"{col.data.dtype}")
            data = _column(col.data, n, dev, "an aggregate")
            held.append(data)
            words[w + 1] = data.data_ptr()
            words[w + 3] = code
    layout = output_layout(key_dtypes, funcs, n_groups)
    key_offs, state_offs, valid_offs, live_off, total = layout
    for k, off in enumerate(key_offs):
        words[KEY_WORDS * k + 4] = off
    for j, (off, voff) in enumerate(zip(state_offs, valid_offs)):
        w = KEY_WORDS * MAX_KEYS + AGG_WORDS * j
        words[w + 4] = off
        words[w + 5] = 0 if voff is None else voff
    words[KEY_WORDS * MAX_KEYS + AGG_WORDS * MAX_AGGS] = live_off
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    with launch_on(dev) as stream:
        status = library("direct_agg").k5_direct_agg(
            live.data_ptr(), words, n, len(key_dtypes), len(funcs),
            n_groups, out.data_ptr(), _scratch_for(dev, stream).data_ptr(),
            stream)
        check(status, "K5 direct aggregate launch")
        direct_group_aggregate_mxu.launches += 1
    return batch_from_output(out, key_dtypes, layout, n_groups)
