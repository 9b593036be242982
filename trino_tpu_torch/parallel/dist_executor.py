"""Distributed plan executor: any logical plan over the mesh.

Reference: the coordinator's planDistribution + worker task execution
(SqlQueryExecution.java:517, SURVEY.md §3.3). The reference keeps the
single global array program the local executor runs, lays scan batches
row-sharded over a JAX mesh and lets GSPMD run every operator on every
device, inserting the collectives; hand written `shard_map` stage
programs (stages.py) are the fast path for the partitioned join. Torch
has no GSPMD, so the port writes out what it would run per shard:

- a scan is split once into one block a shard, each on its shard's card
  (`mesh.split_rows`), and the scan cache keeps the split form: no card
  holds a second, global copy;
- filters and projections run on every shard, on its card; the output
  stays sharded (`mesh.ShardedBatch`);
- global and direct aggregates compute a partial per shard, on its card,
  merged on the first device by the stage boundary's collectives
  (`exchange.merge_partial_states`: integer sums and counts psum, float
  sums added in shard order, min and max gathered);
- the partitioned join takes its sides as they come (sharded, or cut
  into blocks when they arrive whole), builds one K3 table per shard on
  the shard's card and leaves its output sharded
  (`stages.partitioned_hash_join_step`);
- a broadcast join with a unique-key build over a dense key domain keeps
  the probe on its shards and replicates the build to every card, the
  dynamic filter's bounds from the build and its mask per shard;
- every other operator (sorts, hash and sort aggregates, K5 and star
  paths, windows, set operations, compactions of the generic kind, the
  expansion and escape paths of joins) takes its input through
  `gather_rows`, the all-gather onto the first device, counted in
  `ExecStats.mesh_gathers`, and runs there as on one device.

What GSPMD changes in the reference's results, the port keeps: a float
sum over a row-sharded layout (a scan's blocks through filters,
projections and dense probes; a partitioned join's output before it is
compacted) is per-shard partial sums added in shard order, which rounds
apart from the single-device sum; a compacted batch the reference sums
as one array, so an aggregate with a float sum over it gathers first
(`ShardedBatch.sum_by_shard`). Where the single-device operator
compacts the global batch, the shards compact each on its card and
`gather_rows` restores the global layout (`ShardedBatch.slots`), so
what a gathered operator reads is the batch the single device would
have built.

Join distribution (DetermineJoinDistributionType's choice, on the mesh):
the planner stamps JoinNode.distribution from build-size stats;
PARTITIONED joins hash-repartition both sides over the mesh, BROADCAST
joins take the per-shard probe above or gather. Skewed or duplicate-key
partitions degrade exactly like the single-device hybrid join (host
equi-join / expansion fallback).

Memory: the query's pool counts a sharded batch's bytes over every card
together. An all-gather costs a whole copy on the first device beside
the shards: `gather` reserves it in the pool, and it is freed when the
operator that gathered it returns (the query's result, gathered last,
at the next query), so a gathered input costs its bytes twice while its
consumer runs. A pool that cannot hold the copy fails the consumer,
which the spill tier (`Executor._spill_retry`) retries as it would on
one device, on gathered inputs. A card that runs out of memory under
one shard's work raises the allocator's error, which fails the query:
no tier spills one card's shard.

Scheduling note: one process drives the whole mesh; the coordinator /
worker HTTP runtime (server/) is the other distribution path.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..batch import Batch, Column, bucket_capacity
from ..catalog import Catalog
from ..exec.executor import Executor, _is_integer, compact_batch
from ..ops.aggregate import direct_group_aggregate, global_aggregate
from ..planner import logical as L
from .exchange import merge_partial_states
from .mesh import (Mesh, ShardedBatch, gather_rows, make_mesh,
                   pad_to_multiple, shard_rows, split_rows)

AnyBatch = Union[Batch, ShardedBatch]

# the functions whose partial states merge across shards
_MERGEABLE = ("sum", "count", "count_star", "min", "max")


def _integer_key(dtype: torch.dtype) -> bool:
    return _is_integer(dtype) and dtype != torch.bool


def _first(batch: AnyBatch) -> Batch:
    """A batch whose columns carry `batch`'s dtypes (shard 0 of a
    sharded one)."""
    return batch.first if isinstance(batch, ShardedBatch) else batch


def _key_pairs_integer(build: Batch, probe: AnyBatch, pairs) -> tuple:
    probe = _first(probe)
    return tuple((pk, bk) for pk, bk in pairs
                 if _integer_key(build.columns[bk].data.dtype)
                 and _integer_key(probe.columns[pk].data.dtype))


def _filter_bounds(build: Batch, build_keys: tuple) -> list:
    """(kmin, kmax) of each build key over its live, non-NULL rows."""
    out = []
    for bk_i in build_keys:
        bk = build.columns[bk_i]
        m = build.live & bk.valid
        info = torch.iinfo(bk.data.dtype)
        out.append((torch.where(m, bk.data, info.max).min(),
                    torch.where(m, bk.data, info.min).max()))
    return out


def _filter_keep(probe: Batch, probe_keys: tuple, bounds) -> torch.Tensor:
    """The live probe rows whose every key lies in the build's bounds.
    Unlike exchange.apply_filter_bounds, a NULL probe key is dropped
    here, as Executor.apply_dynamic_filter drops it."""
    keep = probe.live
    dev = probe.device
    for pk_i, (kmin, kmax) in zip(probe_keys, bounds):
        pk = probe.columns[pk_i]
        keep = keep & pk.valid & (pk.data >= kmin.to(dev)) & \
            (pk.data <= kmax.to(dev))
    return keep


class MeshExecutor(Executor):
    """Executor over a mesh: scans split over the shards' cards, the
    per-shard operators run there, the rest on the first device after an
    all-gather."""

    # repartitioning grows a side n_shards x during the exchange (the
    # static bucket layout); above this estimate the partitioned path
    # degrades to broadcast
    MESH_EXCHANGE_BUDGET_BYTES = 8 << 30

    def __init__(self, catalog: Catalog, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        super().__init__(catalog, self.mesh.devices[0])
        self.n_shards = self.mesh.size
        # bytes of the all-gathered copies the running operator holds
        self._gathered_bytes = 0
        # the session escape hatch (mesh_dynamic_filtering = off)
        self.mesh_dynamic_filtering = True

    def _decision_salt(self) -> tuple:
        # the pruned-row count flips with the filter hatch; dup/escape
        # totals depend on the shard fanout
        return super()._decision_salt() + (self.n_shards,
                                           self.mesh_dynamic_filtering)

    def _fence(self) -> None:
        for d in dict.fromkeys(self.mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- the row-sharded data plane ------------------------------------

    def run(self, node: L.PlanNode) -> Batch:
        """`node`'s output whole, on the first device: a sharded output is
        all-gathered (every caller of `run` reads all the rows)."""
        return self.gather(self.run_sharded(node))

    def run_sharded(self, node: L.PlanNode) -> AnyBatch:
        """`node`'s output as its operator leaves it: sharded where the
        operator runs per shard."""
        return Executor.run(self, node)

    def gather(self, batch: AnyBatch) -> Batch:
        """The all-gather of a sharded batch (counted), its copy reserved
        in the query's pool until the operator that gathered it returns;
        a whole batch as it is."""
        if not isinstance(batch, ShardedBatch):
            return batch
        from ..exec.memory import batch_bytes
        self.stats.mesh_gathers += 1
        whole = gather_rows(batch)
        b = batch_bytes(whole)
        self.pool.reserve(b)
        self._gathered_bytes += b
        return whole

    def _dispatch_timed(self, node: L.PlanNode) -> AnyBatch:
        # the copies this operator gathers live while it runs
        outer, self._gathered_bytes = self._gathered_bytes, 0
        try:
            return super()._dispatch_timed(node)
        finally:
            self.pool.free(self._gathered_bytes)
            self._gathered_bytes = outer

    def execute(self, root: L.OutputNode) -> Batch:
        # the last query's result, gathered outside any operator
        self.pool.free(self._gathered_bytes)
        self._gathered_bytes = 0
        return super().execute(root)

    def run_scan(self, node: L.ScanNode) -> AnyBatch:
        batch = super().run_scan(node)
        if isinstance(batch, ShardedBatch):
            return batch                       # the scan cache's split
        if batch.capacity % self.n_shards != 0:
            # odd capacity (the mesh size does not divide the 1024-row
            # buckets): pad with dead rows to the next shard multiple
            batch = pad_to_multiple(batch, self.n_shards * 8)
        sharded = split_rows(batch, self.mesh)
        key = self._scan_key(node)
        if key in self._scan_cache:
            self._scan_cache[key] = sharded    # keep the sharded placement
        return sharded

    @staticmethod
    def per_shard(batch: AnyBatch, fn) -> AnyBatch:
        return batch.map(fn) if isinstance(batch, ShardedBatch) else fn(batch)

    @staticmethod
    def _shard_capacity(batch: ShardedBatch, lives: List[int]) -> int:
        """The common capacity each shard compacts to."""
        return min(bucket_capacity(max(lives)), batch.first.capacity)

    def _compact_shards(self, batch: ShardedBatch, lives: List[int],
                        new_cap: Optional[int]) -> ShardedBatch:
        """Where the single device compacts the global batch to `new_cap`
        (`compact_capacity` over the shards' live counts; None: it keeps
        it), compact each shard on its card to one common capacity;
        `gather_rows` restores the global layout from the slots."""
        if new_cap is None:
            return batch
        per = self._shard_capacity(batch, lives)
        shards = [compact_batch(s, per) for s in batch.shards]
        return ShardedBatch(shards, slots=[s.live for s in shards],
                            capacity=new_cap)

    def maybe_compact(self, batch: AnyBatch, live: Optional[int] = None,
                      node: Optional[L.PlanNode] = None,
                      shrink: Optional[int] = None,
                      tag: str = "complive") -> AnyBatch:
        if not isinstance(batch, ShardedBatch):
            return super().maybe_compact(batch, live, node, shrink, tag)
        if batch.capacity < self.COMPACT_MIN_ROWS or self.chunk_mode:
            return batch
        lives = self.fetch_ints(node, tag + "s",
                                *[s.live.sum() for s in batch.shards])
        return self._compact_shards(batch, lives, self.compact_capacity(
            sum(lives), batch.capacity, shrink))

    # -- aggregates: partials per shard, merged ------------------------

    def run_aggregate(self, node: L.AggregateNode) -> Batch:
        child = self.run_sharded(node.child)
        return self.aggregate_batch(node, child, self.agg_specs(node))

    def aggregate_batch(self, node: L.AggregateNode, child: AnyBatch,
                        aggs) -> Batch:
        """A global or direct aggregate over a sharded batch: one partial
        per shard on its card, merged on the first device (the float sums
        in shard order: GSPMD's order over the scan's layout). Anything
        else gathers and runs as on one device."""
        if isinstance(child, ShardedBatch):
            if self._partials_per_shard(node, child, aggs):
                funcs = tuple(a.func for a in aggs)
                if node.strategy == "global":
                    self._note_strategy("AggregateNode", "global", "agg")
                    parts = [global_aggregate(s, aggs)
                             for s in child.shards]
                    return merge_partial_states(parts, funcs, 0)[0]
                self._note_strategy("AggregateNode", "direct", "agg")
                parts = [direct_group_aggregate(s, node.group_keys,
                                                node.key_domains, aggs)
                         for s in child.shards]
                return merge_partial_states(parts, funcs,
                                            len(node.group_keys))[0]
            child = self.gather(child)
        return super().aggregate_batch(node, child, aggs)

    def _partials_per_shard(self, node: L.AggregateNode,
                            child: ShardedBatch, aggs) -> bool:
        if node.strategy not in ("global", "direct"):
            return False
        if any(a.distinct or a.func not in _MERGEABLE for a in aggs):
            return False
        dtypes = [None if a.arg_index is None else
                  child.first.columns[a.arg_index].data.dtype for a in aggs]
        if any(a.func in ("min", "max") and t == torch.bool
               for a, t in zip(aggs, dtypes)):
            return False
        if node.strategy == "direct" and \
                self.use_mxu_agg(child.first, aggs, node.key_domains):
            return False                       # K5 reads the whole input
        if child.sum_by_shard:
            return True
        # a compacted batch: the reference sums a float over it as one
        # array, which partial sums do not reproduce
        return not any(a.func == "sum" and t.is_floating_point
                       for a, t in zip(aggs, dtypes))

    # -- dynamic filtering (batched) -----------------------------------

    def apply_dynamic_filter(self, node: L.JoinNode, probe: AnyBatch,
                             build: Batch) -> AnyBatch:
        """All of one join's dynamic-filter bounds, mask and pruned count
        in one pass (the reference's one-program form); a sharded probe
        is masked per shard, on its card."""
        if not (self.enable_dynamic_filtering and
                self.mesh_dynamic_filtering):
            return probe
        if node.kind in ("anti", "left", "mark") or node.null_aware:
            return probe
        pairs = _key_pairs_integer(build, probe,
                                   zip(node.left_keys, node.right_keys))
        if not pairs:
            return probe
        bounds = _filter_bounds(build, tuple(b for _, b in pairs))
        probe_keys = tuple(p for p, _ in pairs)
        shards = probe.shards if isinstance(probe, ShardedBatch) \
            else [probe]
        keeps = [_filter_keep(s, probe_keys, bounds) for s in shards]
        pruned = sum((s.live.sum(dtype=torch.int64) -
                      k.sum(dtype=torch.int64)).to(self.device)
                     for s, k in zip(shards, keeps))
        pruned = self.fetch_ints(node, "dfpruned", pruned)[0]
        if pruned:
            self._note_pruned(pruned)
        if isinstance(probe, ShardedBatch):
            probe = ShardedBatch([s.with_live(k)
                                  for s, k in zip(shards, keeps)],
                                 probe.sum_by_shard, probe.slots,
                                 probe.capacity)
        else:
            probe = probe.with_live(keeps[0])
        return self.maybe_compact(probe, node=node, shrink=4, tag="dflive")

    def _note_pruned(self, pruned: int) -> None:
        from ..metrics import DYNAMIC_FILTER_ROWS_PRUNED
        self.stats.dynamic_filter_rows_pruned += pruned
        DYNAMIC_FILTER_ROWS_PRUNED.inc(pruned)

    # -- join distribution (broadcast vs partitioned) ------------------

    def run_multijoin(self, node: L.MultiJoinNode) -> Batch:
        # the fused star kernel (K4) assumes one device holding every
        # build; on a mesh the pairwise ladder keeps the partitioned /
        # broadcast machinery per hop instead
        self._note_multijoin_degrade("mesh", len(node.dims))
        return self._run_multijoin_ladder(node)

    def run_join(self, node: L.JoinNode) -> AnyBatch:
        if self.stream_build_bytes:
            return super().run_join(node)      # the streamed build: whole
        probe = self.run_sharded(node.left)
        build = self.run_sharded(node.right)
        return self.join_batches(node, probe, build)

    def join_batches(self, node: L.JoinNode, probe: AnyBatch,
                     build: AnyBatch) -> AnyBatch:
        if len(node.left_keys) > 1:
            # multi-column keys are packed over the whole batch
            return super().join_batches(node, self.gather(probe),
                                        self.gather(build))
        return self._mesh_join(node, probe, build)

    def _run_join_inner(self, node: L.JoinNode, probe: Batch,
                        build: Batch) -> Batch:
        # the callers of the single-device hook (the star's ladder, the
        # packed keys) read whole batches
        return self.gather(self._mesh_join(node, probe, build))

    def _mesh_join(self, node: L.JoinNode, probe: AnyBatch,
                   build: AnyBatch) -> AnyBatch:
        mode = "partitioned" if self._partitioned_eligible(
            node, probe, build) else "broadcast"
        from ..metrics import JOIN_DISTRIBUTION_DECISIONS
        JOIN_DISTRIBUTION_DECISIONS.inc(mode=mode)
        self.strategy_decisions["JoinDistribution"] = mode
        if mode == "partitioned":
            out = self._mesh_partitioned_join(node, probe, build)
            if out is not None:
                return out
            # duplicate build keys: the replicated ladder below handles
            # it (expansion path included)
            self.strategy_decisions["JoinDistribution"] = "broadcast"
        if isinstance(probe, ShardedBatch) and self._probe_per_shard(node):
            return self._broadcast_join(node, probe, self.gather(build))
        return super()._run_join_inner(node, self.gather(probe),
                                       self.gather(build))

    def _partitioned_eligible(self, node: L.JoinNode, probe: AnyBatch,
                              build: AnyBatch) -> bool:
        """May this join hash-repartition over the mesh? The planner's
        stats gate asks for it (JoinNode.distribution); the executor also
        requires the shape the per-shard join supports. Everything else
        broadcasts."""
        if self.n_shards <= 1:
            return False
        if getattr(node, "distribution", "auto") != "partitioned":
            return False
        if node.kind != "inner" or node.residual is not None or \
                node.null_aware:
            return False
        if len(node.left_keys) != 1:
            # multi-key joins arrive single-keyed via the packed key
            # column; a genuinely multi-key shape cannot co-partition on
            # one hash
            return False
        if self.hash_mode() == "off":
            return False
        for side, keys in ((probe, node.left_keys),
                           (build, node.right_keys)):
            for k in keys:
                if not _integer_key(_first(side).columns[k].data.dtype):
                    return False
        n_cols = len(_first(probe).columns) + len(_first(build).columns) + 2
        est = (probe.capacity + build.capacity) * self.n_shards * \
            8 * n_cols
        return est <= self.MESH_EXCHANGE_BUDGET_BYTES

    def _sides(self, batch: AnyBatch):
        """(the shards, the global batch's capacity) of a join side; a
        side that arrived whole is padded and cut into blocks."""
        if isinstance(batch, ShardedBatch):
            return batch.shards, batch.capacity
        batch = pad_to_multiple(batch, self.n_shards)
        return shard_rows(batch, self.mesh), batch.capacity

    def _mesh_partitioned_join(self, node: L.JoinNode, probe: AnyBatch,
                               build: AnyBatch) -> Optional[AnyBatch]:
        """Hash-repartition both sides over the mesh (splitmix64 fanout,
        all_to_all) and run the hash join per shard, the dynamic-filter
        bounds inside the same program; the output stays sharded. None
        when the build broke the unique-key contract (the caller expands
        on the replicated path)."""
        from ..metrics import MESH_REPARTITION_BYTES
        from ..ops import hashtable as ht
        from .stages import partitioned_hash_join_step
        n = self.n_shards
        probes, probe_cap = self._sides(probe)
        builds, build_cap = self._sides(build)
        # per-shard table sized for the 1/N key slice with 2x slack:
        # heavier skew escapes at runtime and degrades below
        slots, _ = ht.join_table_slots(
            max(ht.MIN_TABLE_SLOTS, 2 * build_cap // n))
        df = bool(self.enable_dynamic_filtering and
                  self.mesh_dynamic_filtering)
        step = partitioned_hash_join_step(
            self.mesh, n, node.left_keys, node.right_keys, node.kind,
            slots, self.gather_mode(), dynamic_filter=df)
        outs, dup, esc, pruned = step(probes, builds)
        # exchange accounting (static estimate: each side moves its full
        # padded capacity once, data + valid + live planes)
        MESH_REPARTITION_BYTES.inc(
            probe_cap * (len(probes[0].columns) * 9 + 1) +
            build_cap * (len(builds[0].columns) * 9 + 1))
        self.stats.hash_join_calls += 1
        self.stats.mesh_partitioned_joins += 1
        # K3's escapes differ from run to run: fetched every run, never
        # replayed from the decision cache (Queue C 8)
        dup, esc, pruned = self.fetch_ints(
            None, f"meshjoin{slots}", dup, esc, pruned)
        if pruned:
            self._note_pruned(pruned)
        if esc > 0:
            # a skewed partition overflowed its shard table: the host
            # equi-join over the same splitmix64 fanout
            self.stats.hash_join_escapes += 1
            whole = (self.gather(ShardedBatch(probes)),
                     self.gather(ShardedBatch(builds)))
            host = self._partitioned_hash_join(node, *whole)
            if host is None:
                return None
            self._note_strategy("JoinNode", "hybrid-hash", "join")
            return host
        if dup > 0:
            return None
        self._note_strategy("JoinNode", "hybrid-hash", "join")
        # the output rides at n_shards x the probe's capacity (the
        # exchange's bucket layout): compact by the live counts
        lives = self.fetch_ints(node, "meshjoinlives",
                                *[o.live.sum() for o in outs])
        out = ShardedBatch(outs, sum_by_shard=True)
        return self._compact_shards(out, lives, self.compact_capacity(
            sum(lives), out.capacity))

    # -- the broadcast join, probe per shard ---------------------------

    def _probe_per_shard(self, node: L.JoinNode) -> bool:
        """The shape the per-shard broadcast join runs: an inner or left
        join with a unique-key build over a dense key domain."""
        return node.kind in ("inner", "left") and node.build_unique and \
            node.residual is None and not node.null_aware and \
            node.build_key_domain is not None and not self.chunk_mode

    def _broadcast_join(self, node: L.JoinNode, probe: ShardedBatch,
                        build: Batch) -> AnyBatch:
        """The build replicated to every card, the dynamic filter and the
        dense-LUT probe per shard, the single device's strategy rules on
        the global capacities. A sort-merge shape, a key outside the
        domain or a duplicate key gathers the probe and goes on as on one
        device."""
        probe = self.apply_dynamic_filter(node, probe, build)
        probe = self.maybe_compact(probe, node=node)
        if self.merge_join_ok(node, len(probe.first.columns),
                              len(build.columns),
                              probe.capacity + build.capacity):
            return self._join_pruned(node, self.gather(probe), build)
        from ..ops.join import (dense_join_compacted, dense_probe,
                                join_unique_build_dense)
        domain = node.build_key_domain
        gm = self.gather_mode()
        if gm != "off":
            self.stats.pallas_gather_calls += 1
        builds = {build.device: build}
        for d in probe.devices:
            if d not in builds:
                builds[d] = Batch(tuple(Column(c.data.to(d), c.valid.to(d))
                                        for c in build.columns),
                                  build.live.to(d))
        keys = (node.left_keys, node.right_keys)
        two_phase = self.dense_two_phase(node, probe.capacity)
        if two_phase:
            parts = [dense_probe(s, builds[s.device], *keys, domain, gm)
                     for s in probe.shards]
            vals = self.fetch_ints(node, f"jdense2s:{domain}",
                                   *[x for p in parts for x in p[2:]])
        else:
            parts = [join_unique_build_dense(s, builds[s.device], *keys,
                                             node.kind, domain, gm)
                     for s in probe.shards]
            vals = self.fetch_ints(node, f"jdenses:{domain}",
                                   *[x for o, dup, oob in parts
                                     for x in (dup, oob, o.live.sum())])
        fallback, new_cap = self.dense_verdict(node, probe.capacity, vals)
        if fallback == "domain":
            out = self._try_sparse_unique_join(node, self.gather(probe),
                                               build)
            if out is not None:
                return out
        if fallback is not None:
            self.stats.join_fallbacks += 1
            return self._join_expand(node, self.gather(probe), build)
        lives = list(vals[2::3])
        if two_phase and new_cap is not None:
            per = self._shard_capacity(probe, lives)
            outs = [dense_join_compacted(s, p[0], p[1], builds[s.device],
                                         *keys, per, gm)
                    for s, p in zip(probe.shards, parts)]
            return ShardedBatch(outs, slots=[o.live for o in outs],
                                capacity=new_cap)
        outs = [join_unique_build_dense(s, builds[s.device], *keys,
                                        node.kind, domain, gm)[0]
                for s in probe.shards] if two_phase else \
            [p[0] for p in parts]
        return self._compact_shards(
            ShardedBatch(outs, probe.sum_by_shard, probe.slots,
                         probe.capacity), lives, new_cap)
