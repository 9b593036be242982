"""Distributed stage programs: whole plan fragments over the mesh.

Reference: a Trino PlanFragment runs as N tasks exchanging pages; the
reference makes a fragment ONE `shard_map` program (scan shards play the
tasks, collectives the exchanges). Here a program is the same body
written as per-shard phases between collectives: each phase runs on
every shard in shard order, each collective is a function of
`exchange.py` / `mesh.py` over the list of shards. Each function here
returns a callable over GLOBAL batches (row-sharded with
`mesh.shard_rows`, a broadcast side replicated), with the reference's
return tuple:
replicated outputs come back once (shard 0's copy), row-sharded outputs
concatenated in shard order. The partitioned join, the one stage the
MeshExecutor runs, also takes a side already sharded (a list of shard
batches, as a `ShardedBatch` holds them) and leaves its output sharded.
"""

from __future__ import annotations

import torch

from ..batch import Batch
from ..ops.aggregate import direct_group_aggregate
from ..ops.join import join_unique_build
from ..ops.project import apply_filter, project
from .exchange import (apply_filter_bounds, join_filter_bounds,
                       merge_partial_states, psum_scalar, repartition_by_key)
from .mesh import concat_rows, replicate, shard_rows


def _shards(batch, mesh) -> list:
    """A side's shard batches: a list as it is, a global batch cut into
    `shard_rows`' blocks."""
    return list(batch) if isinstance(batch, (list, tuple)) else \
        shard_rows(batch, mesh)


def sharded_agg_step(mesh, filter_expr, pre_exprs, key_indices: tuple,
                     domains: tuple, aggs: tuple):
    """Distributed GROUP BY (q1 shape): per-shard filter/project/partial
    dense aggregate, then the collective merge (no key exchange: every
    shard shares the group-id space)."""
    agg_funcs = tuple(a.func for a in aggs)
    n_keys = len(key_indices)

    def step(batch: Batch) -> Batch:
        partials = []
        for local in shard_rows(batch, mesh):
            if filter_expr is not None:
                local = apply_filter(local, filter_expr)
            if pre_exprs is not None:
                local = project(local, pre_exprs)
            partials.append(direct_group_aggregate(local, key_indices,
                                                   domains, aggs))
        return merge_partial_states(partials, agg_funcs, n_keys)[0]
    return step


def sharded_join_agg_step(mesh, n_shards: int, probe_filter,
                          probe_key: int, build_filter, build_key: int,
                          post_exprs, agg_keys: tuple, domains: tuple,
                          aggs: tuple):
    """Distributed equi-join + aggregation (q3/q5 shape): both sides
    filtered and hash-repartitioned, co-partitioned unique-build joins,
    post-project, partial dense aggregate, merge. Returns (merged,
    total_dups): a duplicate build key drops join rows, so the caller
    checks total_dups == 0."""
    agg_funcs = tuple(a.func for a in aggs)
    n_keys = len(agg_keys)

    def step(probe: Batch, build: Batch):
        probes, builds = shard_rows(probe, mesh), shard_rows(build, mesh)
        if probe_filter is not None:
            probes = [apply_filter(p, probe_filter) for p in probes]
        if build_filter is not None:
            builds = [apply_filter(b, build_filter) for b in builds]
        probes = repartition_by_key(probes, probe_key, n_shards)
        builds = repartition_by_key(builds, build_key, n_shards)
        partials, dups = [], []
        for p, b in zip(probes, builds):
            joined, dup = join_unique_build(p, b, (probe_key,),
                                            (build_key,), "inner")
            if post_exprs is not None:
                joined = project(joined, post_exprs)
            partials.append(direct_group_aggregate(joined, agg_keys,
                                                   domains, aggs))
            dups.append(dup)
        return (merge_partial_states(partials, agg_funcs, n_keys)[0],
                psum_scalar(dups))
    return step


def broadcast_join_step(mesh, probe_filter, probe_keys: tuple,
                        build_keys: tuple, post_exprs):
    """Broadcast-build join (the REPLICATED distribution): the build is
    replicated, the probe stays sharded, no exchange; the output stays
    row-sharded."""

    def step(probe: Batch, build: Batch) -> Batch:
        outs = []
        for p, b in zip(shard_rows(probe, mesh), replicate(build, mesh)):
            if probe_filter is not None:
                p = apply_filter(p, probe_filter)
            joined, _dup = join_unique_build(p, b, probe_keys, build_keys,
                                             "inner")
            if post_exprs is not None:
                joined = project(joined, post_exprs)
            outs.append(joined)
        return concat_rows(outs)
    return step


def partitioned_hash_join_step(mesh, n_shards: int, probe_keys: tuple,
                               build_keys: tuple, kind: str,
                               table_slots: int, gather_mode: str = "off",
                               dynamic_filter: bool = True):
    """Mesh-partitioned hybrid hash join (the PARTITIONED distribution):

    build shards --bounds--> ONE all_gather           [DynamicFilterSource]
    probe shards --prune---> all_to_all(hash(key))    [PartitionedOutput]
    build shards ----------> all_to_all(hash(key))    [+ExchangeOperator]
    -> per-shard hash build (K3, one launch a shard) + probe
       (ops/hashtable.shard_join): each shard owns 1/N of the key space.

    Each side is a global batch or its shards (a list, shard i on mesh
    device i, every shard of one capacity). Returns (the joined shards,
    a list in shard order, each on its shard's device; total_dup,
    total_escape, total_pruned), the totals as 0-d int64 tensors on the
    first shard's device; the caller checks dup (expansion join) and
    escape (a skewed partition overflowed its table)."""
    from ..ops.hashtable import shard_join

    def step(probe, build):
        probes, builds = _shards(probe, mesh), _shards(build, mesh)
        bounds = join_filter_bounds(builds, build_keys)
        pruned = []
        if dynamic_filter:
            for i, (kmins, kmaxs) in enumerate(bounds):
                probes[i], p = apply_filter_bounds(probes[i], probe_keys,
                                                   kmins, kmaxs)
                pruned.append(p)
        else:
            pruned = [torch.zeros((), dtype=torch.int64, device=p.device)
                      for p in probes]
        probes = repartition_by_key(probes, probe_keys[0], n_shards)
        builds = repartition_by_key(builds, build_keys[0], n_shards)
        outs, dups, escs = [], [], []
        for p, b in zip(probes, builds):
            joined, dup, esc = shard_join(p, b, probe_keys, build_keys,
                                          kind, table_slots, gather_mode)
            outs.append(joined)
            dups.append(dup)
            escs.append(esc)
        return outs, psum_scalar(dups), psum_scalar(escs), \
            psum_scalar(pruned)
    return step
