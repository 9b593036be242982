"""K5: grouped sums for the direct-aggregation arm.

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

``group_sums`` decides by the tensors' device: CPU -> the plain masked
sums, CUDA -> the kernel or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..batch import Batch, Column
from .cuda_build import check, library, raw_stream

# the reference's gates, kept so the executor makes the same choice
MAX_GROUPS = 16
MAX_AGGS = 8
MAX_PLANES = 1 + 2 * MAX_AGGS      # live count + per sum a value and a
                                   # validity-companion plane


def supports(aggs, domains) -> bool:
    g = int(np.prod(domains)) if domains else 0
    if not (0 < g <= MAX_GROUPS and len(aggs) <= MAX_AGGS):
        return False
    return all(a.func in ("sum", "count", "count_star") and not a.distinct
               for a in aggs)


def group_sums_plain(gid: torch.Tensor, planes: torch.Tensor,
                     n_groups: int) -> torch.Tensor:
    """Plain version: one masked wrapping sum per group."""
    return torch.stack([torch.where(gid == g, planes, 0).sum(dim=1)
                        for g in range(n_groups)])


def group_sums(gid: torch.Tensor, planes: torch.Tensor,
               n_groups: int) -> torch.Tensor:
    """gid [n] int32 (`n_groups` = miss), planes [A, n] int64 ->
    [n_groups, A] int64 wrapping sums per group."""
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise ValueError("group_sums: gid must be a 1-D int32 tensor")
    if planes.dtype != torch.int64 or planes.dim() != 2 or \
            planes.shape[1] != gid.shape[0]:
        raise ValueError("group_sums: planes must be [A, n] int64")
    if not 1 <= n_groups <= MAX_GROUPS or \
            not 1 <= planes.shape[0] <= MAX_PLANES:
        raise ValueError(f"group_sums: {n_groups} groups x "
                         f"{planes.shape[0]} planes is out of range")
    dev = gid.device
    if planes.device != dev:
        raise ValueError("group_sums: inputs must share a device")
    if dev.type == "cpu":
        return group_sums_plain(gid, planes, n_groups)
    if dev.type != "cuda":
        raise RuntimeError(f"group_sums: no kernel for {dev}")
    return _launch(gid, planes, n_groups)


group_sums.launches = 0


def _launch(gid, planes, n_groups):
    fn = library("direct_agg").k5_group_sums
    gid = gid.contiguous()
    planes = planes.contiguous()
    a, n = planes.shape
    out = torch.empty((n_groups, a), dtype=torch.int64, device=gid.device)
    stream = raw_stream(gid.device)
    status = fn(gid.data_ptr(), planes.data_ptr(), n, a, n_groups,
                out.data_ptr(), stream)
    check(status, "K5 group sums launch")
    group_sums.launches += 1
    return out


def direct_group_aggregate_mxu(batch: Batch, key_indices: tuple,
                               domains: tuple, aggs: tuple) -> Batch:
    """Drop-in for ops.aggregate.direct_group_aggregate when supports()
    holds: same output layout (key digit columns, then aggregate
    states)."""
    n_groups = 1
    for d in domains:
        n_groups *= d
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
    tot = group_sums(gid, torch.stack(planes), n_groups)    # [G, planes]

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
