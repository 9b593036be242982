"""Collective exchange: the data plane of the single-controller mesh.

Reference mapping (SURVEY.md §2.7/§2.8):

- hash repartition (PartitionedOutputOperator -> partitioned OutputBuffer
  -> ExchangeOperator) ==> `repartition_by_key`: per-shard destination
  buckets, then `mesh.all_to_all`;
- broadcast build side (BroadcastOutputBuffer) ==> `mesh.replicate`;
- partial-aggregate merge at the stage boundary ==> `mesh.psum` and
  `mesh.all_gather` over the dense group-state tables.

Each function takes the per-shard values of a `shard_map` body as a list
(shard i at index i) and returns the list each shard holds afterwards.
The bucket layout is the reference's, row for row: every shard sorts its
rows by destination (stably) and sends fixed-capacity buckets, dead rows
riding along as padding, so the received capacity is n x the local one.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..batch import Batch, Column
from ..ops.aggregate import _identity
from ..ops.hashtable import _SM1, _shr_logical, _splitmix64
from .mesh import all_gather, all_to_all, psum


def _hash64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer (no golden-ratio increment) on int64 bit
    patterns: `_splitmix64` adds the increment first, so it is taken off
    here."""
    return _splitmix64(x.to(torch.int64) - _SM1)


def partition_of(key: torch.Tensor, n_parts: int) -> torch.Tensor:
    """hash(key) % n_parts with the hash read as UNSIGNED 64-bit: torch's
    int64 is signed, so the hash is split into its high and low 32-bit
    halves, each reduced on its own."""
    h = _hash64(key)
    hi = _shr_logical(h, 32) % n_parts
    lo = (h & 0xFFFFFFFF) % n_parts
    return ((hi * ((1 << 32) % n_parts) + lo) % n_parts).to(torch.int32)


def _buckets(batch: Batch, key_index: int, n_shards: int, me: int):
    """One shard's [n_shards, cap] buckets of every plane, in the
    order (columns' data and valid, then live)."""
    cap = batch.capacity
    dev = batch.device
    key = batch.columns[key_index]
    dest = torch.where(batch.live & key.valid,
                       partition_of(key.data, n_shards),
                       torch.full((cap,), me, dtype=torch.int32,
                                  device=dev))
    dest_sorted, order = torch.sort(dest, stable=True)
    ids = torch.arange(n_shards, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(dest_sorted, ids)
    ends = torch.searchsorted(dest_sorted, ids, right=True)
    src = starts[:, None] + torch.arange(cap, device=dev)[None, :]
    in_run = src < ends[:, None]
    src_c = order[src.clamp(0, cap - 1)]

    def bucket(x, fill):
        return torch.where(in_run, x[src_c], fill)
    planes = []
    for c in batch.columns:
        planes.append(bucket(c.data, torch.zeros((), dtype=c.data.dtype,
                                                 device=dev)))
        planes.append(bucket(c.valid, False))
    planes.append(bucket(batch.live, False))
    return planes


def repartition_by_key(shards: Sequence[Batch], key_index: int,
                       n_shards: int) -> List[Batch]:
    """Move every live row to shard hash(key) % n_shards. A dead row or a
    NULL key stays on its own shard as padding. Output capacity per shard
    = n_shards x the local capacity: shard i's rows are, in j order, the
    run shard j sorted for destination i, then zeros and False."""
    per_shard = [_buckets(b, key_index, n_shards, me)
                 for me, b in enumerate(shards)]
    n_planes = len(per_shard[0])
    received = [all_to_all([p[k] for p in per_shard])
                for k in range(n_planes)]
    out = []
    for i in range(len(shards)):
        flat = [received[k][i].reshape(-1) for k in range(n_planes)]
        cols = tuple(Column(flat[2 * j], flat[2 * j + 1])
                     for j in range(len(shards[0].columns)))
        out.append(Batch(columns=cols, live=flat[-1]))
    return out


def join_filter_bounds(builds: Sequence[Batch], build_keys: Tuple[int, ...]):
    """Global [min, max] per build key from ONE all_gather of each shard's
    (min, -max): min(-x) = -max(x), so one local reduce serves both.
    Returns (kmins, kmaxs) per shard, int64 tensors of len(build_keys)."""
    imax = torch.iinfo(torch.int64).max
    stats = []
    for b in builds:
        s = []
        for bk in build_keys:
            col = b.columns[bk]
            m = b.live & col.valid
            d = col.data.to(torch.int64)
            s.append(torch.where(m, d, imax).min())
            s.append(torch.where(m, -d, imax).min())
        stats.append(torch.stack(s))
    out = []
    for gathered in all_gather(stats):
        merged = gathered.min(dim=0).values
        out.append((merged[0::2], -merged[1::2]))
    return out


def apply_filter_bounds(probe: Batch, probe_keys: Tuple[int, ...],
                        kmins, kmaxs) -> Tuple[Batch, torch.Tensor]:
    """Prune one shard's probe rows whose key falls outside the build's
    [min, max]. Returns the filtered batch and the local pruned-row count.
    NULL keys stay live: join semantics drop them, not the filter."""
    keep = probe.live
    for j, pk in enumerate(probe_keys):
        col = probe.columns[pk]
        d = col.data.to(torch.int64)
        keep = keep & (~col.valid | ((d >= kmins[j]) & (d <= kmaxs[j])))
    pruned = probe.live.sum(dtype=torch.int64) - keep.sum(dtype=torch.int64)
    return probe.with_live(keep), pruned


def merge_partial_states(partials: Sequence[Batch],
                         agg_funcs: Tuple[str, ...],
                         n_keys: int) -> List[Batch]:
    """Merge per-shard dense aggregate tables (direct strategy) into the
    final table, the same on every shard: sums and counts psum (shard 0
    first), min and max all_gather then reduce locally; a state is valid
    where any shard's is, and the keys' validity is the merged `live`."""
    ncols = len(partials[0].columns)
    merged_cols = [None] * ncols
    for i in range(n_keys, ncols):
        func = agg_funcs[i - n_keys]
        cols = [p.columns[i] for p in partials]
        if func in ("sum", "count", "count_star"):
            data = psum([c.data for c in cols])
        elif func in ("min", "max"):
            ident = _identity(func, cols[0].data.dtype)
            masked = [torch.where(c.valid, c.data, ident) for c in cols]
            red = torch.amin if func == "min" else torch.amax
            data = [red(g, dim=0) for g in all_gather(masked)]
        else:
            raise ValueError(func)
        valid = [v > 0 for v in psum([c.valid.to(torch.int32)
                                      for c in cols])]
        merged_cols[i] = (data, valid)
    live = [v > 0 for v in psum([p.live.to(torch.int32) for p in partials])]
    out = []
    for s, p in enumerate(partials):
        cols = [Column(p.columns[k].data, live[s]) for k in range(n_keys)]
        cols += [Column(merged_cols[i][0][s], merged_cols[i][1][s])
                 for i in range(n_keys, ncols)]
        out.append(Batch(columns=tuple(cols), live=live[s]))
    return out


def psum_scalar(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """A per-shard count summed over the mesh (shard 0's copy)."""
    return psum(list(xs))[0]
