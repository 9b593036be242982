"""Distributed plan executor: any logical plan over the mesh.

Reference: the coordinator's planDistribution + worker task execution
(SqlQueryExecution.java:517, SURVEY.md §3.3). The reference keeps the
single global array program the local executor runs, lays scan batches
row-sharded over a JAX mesh and lets GSPMD insert the collectives; hand
written `shard_map` stage programs (stages.py) are the fast path for the
partitioned join. Torch has no GSPMD, so here the generic operators run
on the controller's global tensor, on the mesh's first device, and the
partitioned join runs its per-shard phases and collectives over the
shards (parallel/stages.partitioned_hash_join_step).

What GSPMD changes in the reference's results, the port replays: a float
sum over a row-sharded batch (a global or direct aggregate over a scan,
through filters and projections, which keep the layout) is per-shard
partial sums added in shard order, which rounds apart from the
single-device sum. Such an aggregate sums in `n_shards` blocks here
(`row_shards`, ops/aggregate `shards=`); every other operator's input
is either replicated in the reference (a compaction, a sort, a
sort-merge join gathers it) or has no float sum.

Join distribution (DetermineJoinDistributionType's choice, on the mesh):
the planner stamps JoinNode.distribution from build-size stats;
BROADCAST joins run the replicated default path with the batched dynamic
filter below, PARTITIONED joins hash-repartition both sides over the mesh
and build one K3 table per shard (ops/hashtable.shard_join). Skewed or
duplicate-key partitions degrade exactly like the single-device hybrid
join (host equi-join / expansion fallback).

Scheduling note: one process drives the whole mesh; the coordinator /
worker HTTP runtime (server/) is the other distribution path.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..batch import Batch, bucket_capacity
from ..catalog import Catalog
from ..exec.executor import Executor, _is_integer, compact_batch
from ..planner import logical as L
from .mesh import Mesh, make_mesh, pad_to_multiple


def _integer_key(dtype: torch.dtype) -> bool:
    return _is_integer(dtype) and dtype != torch.bool


def _key_pairs_integer(build: Batch, probe: Batch, pairs) -> tuple:
    return tuple((pk, bk) for pk, bk in pairs
                 if _integer_key(build.columns[bk].data.dtype)
                 and _integer_key(probe.columns[pk].data.dtype))


def _batched_dynamic_filter(probe: Batch, build: Batch,
                            probe_keys: tuple, build_keys: tuple):
    """ALL of one join's dynamic-filter bounds, mask and pruned count in
    one pass (the reference's one-program form). Unlike
    exchange.apply_filter_bounds, a NULL probe key is dropped here, as
    Executor.apply_dynamic_filter drops it."""
    keep = probe.live
    for pk_i, bk_i in zip(probe_keys, build_keys):
        bk = build.columns[bk_i]
        m = build.live & bk.valid
        info = torch.iinfo(bk.data.dtype)
        kmin = torch.where(m, bk.data, info.max).min()
        kmax = torch.where(m, bk.data, info.min).max()
        pk = probe.columns[pk_i]
        keep = keep & pk.valid & (pk.data >= kmin) & (pk.data <= kmax)
    pruned = probe.live.sum(dtype=torch.int64) - keep.sum(dtype=torch.int64)
    return keep, pruned


class MeshExecutor(Executor):
    """Executor over a mesh: scans padded to a shard multiple, the
    partitioned join per shard with its collectives, the rest on the
    controller's global tensor."""

    # repartitioning grows a side n_shards x during the exchange (the
    # static bucket layout); above this estimate the partitioned path
    # degrades to broadcast
    MESH_EXCHANGE_BUDGET_BYTES = 8 << 30

    def __init__(self, catalog: Catalog, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        super().__init__(catalog, self.mesh.devices[0])
        self.n_shards = self.mesh.size
        # the session escape hatch (mesh_dynamic_filtering = off)
        self.mesh_dynamic_filtering = True
        # plan nodes whose output keeps a scan's row-sharded layout in
        # the reference (scan, then filters and projections): id ->
        # (node, capacity), for the current query
        self._row_sharded: dict = {}

    def _decision_salt(self) -> tuple:
        # the pruned-row count flips with the filter hatch; dup/escape
        # totals depend on the shard fanout
        return super()._decision_salt() + (self.n_shards,
                                           self.mesh_dynamic_filtering)

    def execute(self, root: L.OutputNode) -> Batch:
        self._row_sharded = {}
        return super().execute(root)

    def run_scan(self, node: L.ScanNode) -> Batch:
        batch = super().run_scan(node)
        if batch.capacity % self.n_shards != 0:
            # odd capacity (the mesh size does not divide the 1024-row
            # buckets): pad with dead rows to the next shard multiple
            batch = pad_to_multiple(batch, self.n_shards * 8)
        self._scan_cache[self._scan_key(node)] = batch
        return batch

    # -- the reference's row-sharded layout ----------------------------

    def dispatch(self, node: L.PlanNode) -> Batch:
        out = super().dispatch(node)
        if isinstance(node, L.ScanNode):
            self._row_sharded[id(node)] = (node, out.capacity)
        elif isinstance(node, (L.FilterNode, L.ProjectNode)):
            src = node.child
            while isinstance(src, (L.FilterNode, L.ProjectNode)):
                src = src.child
            rec = self._row_sharded.get(id(src))
            if rec is not None and rec[1] == out.capacity:
                self._row_sharded[id(node)] = (node, out.capacity)
        return out

    def row_shards(self, node: L.PlanNode, batch: Batch) -> int:
        rec = self._row_sharded.get(id(node))
        if rec is None or rec[1] != batch.capacity:
            return 1
        return self.n_shards

    # -- dynamic filtering (batched) -----------------------------------

    def apply_dynamic_filter(self, node: L.JoinNode, probe: Batch,
                             build: Batch) -> Batch:
        if not (self.enable_dynamic_filtering and
                self.mesh_dynamic_filtering):
            return probe
        if node.kind in ("anti", "left", "mark") or node.null_aware:
            return probe
        pairs = _key_pairs_integer(build, probe,
                                   zip(node.left_keys, node.right_keys))
        if not pairs:
            return probe
        keep, pruned = _batched_dynamic_filter(
            probe, build, tuple(p for p, _ in pairs),
            tuple(b for _, b in pairs))
        probe = probe.with_live(keep)
        pruned = self.fetch_ints(node, "dfpruned", pruned)[0]
        if pruned:
            self._note_pruned(pruned)
        if probe.capacity >= (1 << 16) and not self.chunk_mode:
            live = self.fetch_ints(node, "dflive", probe.live.sum())[0]
            new_cap = bucket_capacity(live)
            if new_cap * 4 <= probe.capacity:
                self.stats.dynamic_filter_compactions += 1
                probe = compact_batch(probe, new_cap)
        return probe

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

    def _run_join_inner(self, node: L.JoinNode, probe: Batch,
                        build: Batch) -> Batch:
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
        return super()._run_join_inner(node, probe, build)

    def _partitioned_eligible(self, node: L.JoinNode, probe: Batch,
                              build: Batch) -> bool:
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
                if not _integer_key(side.columns[k].data.dtype):
                    return False
        n_cols = len(probe.columns) + len(build.columns) + 2
        est = (probe.capacity + build.capacity) * self.n_shards * \
            8 * n_cols
        return est <= self.MESH_EXCHANGE_BUDGET_BYTES

    def _mesh_partitioned_join(self, node: L.JoinNode, probe: Batch,
                               build: Batch) -> Optional[Batch]:
        """Hash-repartition both sides over the mesh (splitmix64 fanout,
        all_to_all) and run the hash join per shard, the dynamic-filter
        bounds inside the same program. None when the build broke the
        unique-key contract (the caller expands on the replicated
        path)."""
        from ..metrics import MESH_REPARTITION_BYTES
        from ..ops import hashtable as ht
        from .stages import partitioned_hash_join_step
        n = self.n_shards
        probe = pad_to_multiple(probe, n)
        build = pad_to_multiple(build, n)
        # per-shard table sized for the 1/N key slice with 2x slack:
        # heavier skew escapes at runtime and degrades below
        slots, _ = ht.join_table_slots(
            max(ht.MIN_TABLE_SLOTS, 2 * build.capacity // n))
        df = bool(self.enable_dynamic_filtering and
                  self.mesh_dynamic_filtering)
        step = partitioned_hash_join_step(
            self.mesh, n, node.left_keys, node.right_keys, node.kind,
            slots, self.gather_mode(), dynamic_filter=df)
        out, dup, esc, pruned = step(probe, build)
        # exchange accounting (static estimate: each side moves its full
        # padded capacity once, data + valid + live planes)
        MESH_REPARTITION_BYTES.inc(
            probe.capacity * (len(probe.columns) * 9 + 1) +
            build.capacity * (len(build.columns) * 9 + 1))
        self.stats.hash_join_calls += 1
        self.stats.mesh_partitioned_joins += 1
        dup, esc, pruned = self.fetch_ints(
            node, f"meshjoin{slots}", dup, esc, pruned)
        if pruned:
            self._note_pruned(pruned)
        if esc > 0:
            # a skewed partition overflowed its shard table: the host
            # equi-join over the same splitmix64 fanout
            self.stats.hash_join_escapes += 1
            host = self._partitioned_hash_join(node, probe, build)
            if host is None:
                return None
            self._note_strategy("JoinNode", "hybrid-hash", "join")
            return host
        if dup > 0:
            return None
        self._note_strategy("JoinNode", "hybrid-hash", "join")
        # the output rides at n_shards x the probe's capacity (the
        # exchange's bucket layout): compact by the live count
        live = self.fetch_ints(node, "meshjoinlive", out.live.sum())[0]
        return self.maybe_compact(out, live=live)
