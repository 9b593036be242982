"""Single-device plan executor on torch tensors.

Counterpart of ``trino_tpu/exec/executor.py`` (the worker-side stack:
LocalExecutionPlanner + Driver). A plan node maps to torch operations on
fixed-capacity batches on one device; the names, decision rules and
`_note_strategy` verdicts are the reference's, so the same plan takes the
same strategies and any difference in results is a fault here.

What this slice runs: scans (with the scan cache and zone-map pruning),
filter/project, global/direct/sort/packed-sort/hash aggregation (K3 via
``ops/hashtable.py``), inner/left unique-build and expansion joins
(dense-LUT, sort-merge, sorted, hybrid hash — K1 via ``ops/gather.py``),
sort/TopN/limit, values and uncorrelated scalar subqueries. Nodes and
options outside the slice raise NotImplementedError naming the ROADMAP
item that ports them: window, unnest, set operations, multiway joins,
mark/semi/anti joins, the chunked executor (`spill_chunk_rows`), streaming
builds and the host-spill tier.

The decision cache (runtime decision values keyed by plan structure) is
in memory only. `fetch_ints` is the one host sync point: one
``torch.stack(...).tolist()`` per call.
"""

from __future__ import annotations

import hashlib
import os
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import ir
from ..batch import (Batch, Column, batch_from_numpy, batch_to_numpy,
                     bucket_capacity, pad_capacity)
from ..catalog import Catalog
from ..ops.aggregate import (AggSpec, direct_group_aggregate,
                             global_aggregate, sort_group_aggregate)
from ..ops.join import (join_expand, join_unique_build,
                        join_unique_build_dense, join_unique_build_merge)
from ..ops.project import apply_filter, filter_project, filter_project_fused
from ..ops.sort import limit_batch, sort_batch
from ..planner import logical as L

# the reference's sort-shape gates, kept so strategy choices match
MAX_SORT_OPERANDS = 12
SORT_SMALL_ROWS = 1 << 19


@dataclass
class ExecStats:
    """Per-query execution counters (OperatorStats pyramid, minimal)."""
    scans: int = 0
    rows_scanned: int = 0
    join_fallbacks: int = 0
    join_expansion_retries: int = 0
    join_domain_fallbacks: int = 0   # dense-LUT stats were stale
    agg_capacity_retries: int = 0
    dynamic_filter_compactions: int = 0
    pallas_gather_calls: int = 0     # probe sites dispatched with the
                                     # gather kernel (K1) enabled
    hash_agg_calls: int = 0          # hash-table aggregations run (K3)
    hash_agg_escapes: int = 0        # escapes that radix-partitioned
    hash_join_calls: int = 0         # hybrid hash-join builds attempted
    hash_join_escapes: int = 0       # builds that overflowed the table
    scan_zones_pruned: int = 0       # zone-map row ranges skipped at scan
    scan_rows_pruned: int = 0        # rows those zones would have held


class QueryDeadlineError(RuntimeError):
    """query_max_run_time_s exceeded (QUERY_MAX_RUN_TIME's role)."""
    error_name = "QUERY_EXCEEDED_RUN_TIME"
    error_code = 4


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to trino_tpu_torch yet (ROADMAP: {item})")


def _subtree_scans(node: "L.PlanNode"):
    if isinstance(node, L.ScanNode):
        yield node
    for c in L.children(node):
        yield from _subtree_scans(c)


def _is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex


class Executor:
    def __init__(self, catalog: Catalog, device):
        self.catalog = catalog
        self.device = torch.device(device)
        self._scan_cache: "OrderedDict[tuple, Batch]" = OrderedDict()
        self._scalar_cache: Dict[object, object] = {}
        self.stats = ExecStats()
        self.profile = False           # EXPLAIN ANALYZE per-node timing
        self.node_stats: Dict[int, tuple] = {}   # id(node) -> (wall_s, rows)
        from .memory import MemoryPool, parse_bytes
        env_limit = os.environ.get("TRINO_TPU_QUERY_MAX_MEMORY")
        self.pool = MemoryPool(parse_bytes(env_limit) if env_limit
                               else (64 << 30))
        self._node_bytes: Dict[int, int] = {}
        # bounded-memory chunked executor (not ported: must stay None)
        self.spill_chunk_rows: Optional[int] = None
        # session-resolved kernel settings (auto/true/false); K4 and K5
        # are not ported, so multiway joins and mxu_agg resolve off
        self.enable_pallas_gather = "auto"
        self.enable_pallas_hash = "auto"
        self.hash_table_slots = 0      # 0 = size from stats; tests pin
        self.enable_multiway_join = "auto"
        self.strategy_decisions: Dict[str, str] = {}
        self.enable_dynamic_filtering = True
        self.enable_merge_join = True
        self.enable_zone_map_pruning = True
        from .zonemap import DEFAULT_ZONE_ROWS
        self.zone_map_rows = DEFAULT_ZONE_ROWS
        self.deadline: Optional[float] = None     # time.monotonic() cutoff
        self.scan_cache_max_bytes = 24 << 30      # LRU cap (device bytes)
        self._scan_cache_bytes: Dict[tuple, int] = {}
        self._scan_prune_info: Dict[tuple, str] = {}
        self.stream_build_bytes: Optional[int] = None
        # cross-run DECISION cache (in memory): data-dependent host
        # decisions of deterministic subtrees, keyed by structure
        self._decision_cache: Dict[tuple, tuple] = {}
        self._skey_memo: Dict[int, tuple] = {}

    # ------------------------------------------------------------------

    def check_cancel(self) -> None:
        """Deadline check between plan nodes."""
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise QueryDeadlineError("query exceeded query_max_run_time_s")

    def _scan_key(self, node) -> tuple:
        pruning = node.predicate is not None and self.enable_zone_map_pruning
        return (node.catalog, node.schema_name, node.table,
                node.column_indices,
                repr(node.predicate) if pruning else None)

    def execute(self, root: L.OutputNode) -> Batch:
        if not isinstance(root, L.OutputNode):
            raise TypeError("execute takes an OutputNode")
        self.strategy_decisions = {}
        for b in self._node_bytes.values():
            self.pool.free(b)
        self._node_bytes.clear()
        self._skey_memo.clear()
        if self.spill_chunk_rows:
            raise _not_ported("the chunked executor (spill_chunk_rows > 0)",
                              "K2 with the chunked executor")
        return self.run(root.child)

    def run(self, node: L.PlanNode) -> Batch:
        self.check_cancel()
        from .memory import batch_bytes
        out = self._dispatch_timed(node)
        # memory accounting: reserve this node's output, release the
        # children's. Over the limit this raises (the host-spill tier
        # that retries partition-wise is not ported).
        b = batch_bytes(out)
        self.pool.reserve(b)
        self._node_bytes[id(node)] = b
        for c in L.children(node):
            self.pool.free(self._node_bytes.pop(id(c), 0))
        return out

    def _dispatch_timed(self, node: L.PlanNode) -> Batch:
        if not self.profile:
            return self.dispatch(node)
        sync = torch.cuda.synchronize if self.device.type == "cuda" \
            else (lambda: None)
        sync()
        t0 = time.monotonic()
        out = self.dispatch(node)
        sync()
        self.node_stats[id(node)] = (time.monotonic() - t0,
                                     int(out.live.sum()))
        return out

    def build_structure_key(self, node: L.PlanNode) -> Optional[str]:
        """Decision-cache key for a DETERMINISTIC subtree: the wire-form
        hash, or None when any scan reads a mutable catalog."""
        scans = list(_subtree_scans(node))
        if not scans or any(s.catalog not in ("tpch", "tpcds", "bench")
                            for s in scans):
            return None
        from ..server import serde
        return hashlib.sha256(serde.dumps(node).encode()).hexdigest()

    def _decision_salt(self) -> tuple:
        """Session knobs that change runtime decision values for the same
        plan structure."""
        return (self.enable_dynamic_filtering, self.enable_merge_join,
                self.hash_mode() != "off", self.hash_table_slots)

    def fetch_ints(self, node, tag: str, *vals) -> tuple:
        """Fetch small device integers as host ints — through the decision
        cache when `node`'s subtree is deterministic. The sync point: one
        stack + tolist per call."""
        key = None
        if node is not None:
            skey = self.memo_structure_key(node)
            if skey is not None:
                key = (tag, skey, self._decision_salt())
                hit = self._decision_cache.get(key)
                if hit is not None:
                    return hit
        out = tuple(int(v) for v in torch.stack(
            [torch.as_tensor(v, device=self.device).to(torch.int64)
             for v in vals]).tolist())
        if key is not None:
            if len(self._decision_cache) >= 4096:
                self._decision_cache.clear()
            self._decision_cache[key] = out
        return out

    def memo_structure_key(self, node: L.PlanNode) -> Optional[str]:
        """build_structure_key with a per-execution memo (the node is held
        too so its id cannot be reused within the execution)."""
        nid = id(node)
        hit = self._skey_memo.get(nid)
        if hit is not None:
            return hit[1]
        skey = self.build_structure_key(node)
        self._skey_memo[nid] = (node, skey)
        return skey

    def dispatch(self, node: L.PlanNode) -> Batch:
        if isinstance(node, L.ScanNode):
            return self.run_scan(node)
        if isinstance(node, L.FilterNode):
            pred = self.fold_scalars(node.predicate)
            if isinstance(node.child, L.ProjectNode):
                child = self.run(node.child.child)
                return filter_project_fused(
                    child, self.fold_scalars_tuple(node.child.exprs), pred)
            return apply_filter(self.run(node.child), pred)
        if isinstance(node, L.ProjectNode):
            exprs = self.fold_scalars_tuple(node.exprs)
            if isinstance(node.child, L.FilterNode):
                child = self.run(node.child.child)
                return filter_project(
                    child, self.fold_scalars(node.child.predicate), exprs)
            return filter_project(self.run(node.child), None, exprs)
        if isinstance(node, L.AggregateNode):
            return self.run_aggregate(node)
        if isinstance(node, L.JoinNode):
            return self.run_join(node)
        if isinstance(node, L.SortNode):
            keys = tuple((k.index, k.ascending, k.nulls_first)
                         for k in node.keys)
            child = self.run(node.child)
            if keys and child.capacity > SORT_SMALL_ROWS:
                from ..ops.sort import sort_batch_packed, sort_pack_plan
                plan = sort_pack_plan(
                    child, keys,
                    fetch=lambda *v: self.fetch_ints(node, "sortpack", *v))
                if plan is not None:
                    kmins, bits = plan
                    return sort_batch_packed(child, kmins, keys, bits,
                                             node.limit)
            return sort_batch(child, keys, node.limit)
        if isinstance(node, L.LimitNode):
            return limit_batch(self.run(node.child), node.count)
        if isinstance(node, L.OutputNode):
            return self.run(node.child)
        if isinstance(node, L.ValuesNode):
            return self.run_values(node)
        if isinstance(node, L.MultiJoinNode):
            raise _not_ported("MultiJoinNode", "K4 with multiway joins")
        if isinstance(node, L.WindowNode):
            raise _not_ported("WindowNode", "window functions")
        if isinstance(node, L.UnnestNode):
            raise _not_ported("UnnestNode", "unnest")
        if isinstance(node, L.SetOpNode):
            raise _not_ported("SetOpNode", "set operations")
        raise _not_ported(type(node).__name__, "the remaining plan nodes")

    def run_values(self, node: L.ValuesNode) -> Batch:
        if node.arrays:
            return batch_from_numpy(list(node.arrays),
                                    valids=list(node.valids),
                                    device=self.device)
        # zero-column values (SELECT without FROM): live mask only
        cap = pad_capacity(node.num_rows)
        live = torch.zeros(cap, dtype=torch.bool, device=self.device)
        live[:node.num_rows] = True
        return Batch(columns=(), live=live)

    # ------------------------------------------------------------------

    def run_scan(self, node: L.ScanNode) -> Batch:
        if node.catalog == "system" or \
                node.schema_name == "information_schema":
            data = self.catalog.get_table(node.catalog, node.schema_name,
                                          node.table)
            arrays = [data.columns[i] for i in node.column_indices]
            valids = None if data.valids is None else \
                [data.valids[i] for i in node.column_indices]
            self.stats.scans += 1
            self.stats.rows_scanned += data.num_rows
            return batch_from_numpy(arrays, valids=valids,
                                    device=self.device)
        pruning = node.predicate is not None and self.enable_zone_map_pruning
        key = self._scan_key(node)
        hit = self._scan_cache.get(key)
        if hit is not None:
            self._scan_cache.move_to_end(key)     # LRU touch
            info = self._scan_prune_info.get(key)
            if info is not None:
                self.strategy_decisions[f"TableScan[{node.table}]"] = info
            return hit
        data = self.catalog.get_table(node.catalog, node.schema_name,
                                      node.table)
        arrays = [data.columns[i] for i in node.column_indices]
        valids = None
        if data.valids is not None:
            valids = [data.valids[i] for i in node.column_indices]
        if pruning:
            arrays, valids, kept_rows = self._prune_scan_rows(
                node, data, arrays, valids)
        else:
            kept_rows = data.num_rows
        batch = batch_from_numpy(arrays, valids=valids, device=self.device)
        self.stats.scans += 1
        self.stats.rows_scanned += kept_rows
        from .memory import batch_bytes
        b = batch_bytes(batch)
        total = sum(self._scan_cache_bytes.values())
        while self._scan_cache and total + b > self.scan_cache_max_bytes:
            old_key, _ = self._scan_cache.popitem(last=False)
            total -= self._scan_cache_bytes.pop(old_key, 0)
        self._scan_cache[key] = batch
        self._scan_cache_bytes[key] = b
        if pruning:
            dec = self.strategy_decisions.get(f"TableScan[{node.table}]")
            if dec is not None:
                self._scan_prune_info[key] = dec
        return batch

    def _prune_scan_rows(self, node: L.ScanNode, data, arrays, valids):
        """Drop row ranges the pushed predicate provably cannot match
        (zone maps); surviving ranges concatenate in order."""
        from . import zonemap
        zm = zonemap.zone_map_for(data, self.zone_map_rows)
        idx = zonemap.surviving_zone_indices(zm, node.predicate,
                                             node.column_indices)
        pruned = zm.num_zones - len(idx)
        if pruned == 0:
            return arrays, valids, data.num_rows
        ranges = []
        for i in idx:
            s, c = zm.starts[i], zm.counts[i]
            if ranges and ranges[-1][0] + ranges[-1][1] == s:
                ranges[-1][1] += c
            else:
                ranges.append([s, c])

        def take(a):
            a = np.asarray(a)
            if not ranges:
                return a[:0]
            if len(ranges) == 1:
                s, c = ranges[0]
                return a[s:s + c]
            return np.concatenate([a[s:s + c] for s, c in ranges])

        kept_rows = sum(c for _, c in ranges)
        arrays = [take(a) for a in arrays]
        if valids is not None:
            valids = [None if v is None else take(v) for v in valids]
        self.stats.scan_zones_pruned += pruned
        self.stats.scan_rows_pruned += data.num_rows - kept_rows
        self.strategy_decisions[f"TableScan[{node.table}]"] = \
            f"zone-pruned:{pruned}/{zm.num_zones}"
        return arrays, valids, kept_rows

    def run_aggregate(self, node: L.AggregateNode) -> Batch:
        aggs = tuple(AggSpec(
            a.func,
            a.arg.index if a.arg is not None else None,
            a.distinct)
            for a in node.aggs)
        child = self.run(node.child)
        return self.aggregate_batch(node, child, aggs)

    def gather_mode(self) -> str:
        """Resolved K1 mode: 'on' | 'off' (ops/gather.resolve_mode)."""
        from ..ops.gather import resolve_mode
        return resolve_mode(self.enable_pallas_gather)

    def hash_mode(self) -> str:
        """Resolved K3 mode: 'on' | 'off' (ops/hashtable.resolve_mode)."""
        from ..ops.hashtable import resolve_mode
        return resolve_mode(self.enable_pallas_hash)

    def multiway_mode(self) -> str:
        """K4 is not ported: always 'off'."""
        from ..ops.hashtable import resolve_multiway_mode
        return resolve_multiway_mode(self.enable_multiway_join)

    def _note_strategy(self, op: str, strategy: str, kind: str) -> None:
        """Record the strategy an operator actually ran with."""
        self.strategy_decisions[op] = strategy

    def _known_groups(self, node: L.AggregateNode) -> Optional[int]:
        """The group count a previous run of this aggregate measured
        (decision cache), or None."""
        skey = self.memo_structure_key(node)
        if skey is None:
            return None
        hit = self._decision_cache.get(("aggfinal", skey,
                                        self._decision_salt()))
        return None if hit is None else hit[0]

    def _record_groups(self, node: L.AggregateNode, n_groups: int) -> None:
        skey = self.memo_structure_key(node)
        if skey is not None:
            self._decision_cache[("aggfinal", skey,
                                  self._decision_salt())] = (n_groups,)

    def aggregate_batch(self, node: L.AggregateNode, child: Batch, aggs):
        """One partial aggregation (the PARTIAL step)."""
        if node.strategy == "global":
            self._note_strategy("AggregateNode", "global", "agg")
            return global_aggregate(child, aggs)
        if node.strategy == "direct":
            self._note_strategy("AggregateNode", "direct", "agg")
            return direct_group_aggregate(child, node.group_keys,
                                          node.key_domains, aggs)
        if node.strategy == "hash":
            out = self.hash_aggregate(node, child, aggs)
            if out is not None:
                return out
            # kernel off / keys unpackable / value shape unsupported:
            # the sort path below is the general fallback
        capacity = node.out_capacity
        known = self._known_groups(node)
        if known is not None:
            capacity = max(1024, bucket_capacity(known))
        pack = None
        wide_keys = 2 * len(node.group_keys) + 4 > MAX_SORT_OPERANDS
        if not any(a.distinct for a in aggs) and node.group_keys and \
                (child.capacity > SORT_SMALL_ROWS or wide_keys):
            from ..ops.aggregate import (key_pack_plan_words,
                                         packed_sort_group_aggregate)
            pack = key_pack_plan_words(
                child, node.group_keys,
                fetch=lambda *v: self.fetch_ints(node, "aggpack", *v))
        self._note_strategy("AggregateNode", "sort", "agg")
        gm = self.gather_mode()
        while True:
            if pack is not None:
                kmins, bits, splits = pack
                out = packed_sort_group_aggregate(
                    child, kmins, node.group_keys, bits, aggs, capacity,
                    splits, gm)
            else:
                out = sort_group_aggregate(child, node.group_keys, aggs,
                                           capacity, gm)
            n_groups = self.fetch_ints(node, f"agggroups{capacity}",
                                       out.live.sum())[0]
            if n_groups < capacity or capacity >= child.capacity:
                break
            capacity *= 4
            self.stats.agg_capacity_retries += 1
        self._record_groups(node, n_groups)
        if n_groups == 0 and not node.group_keys:
            # zero-key sort aggregation (global DISTINCT) over an empty
            # input: SQL still requires one output row
            plain = tuple(AggSpec(a.func, a.arg_index) for a in aggs)
            return global_aggregate(child, plain)
        return out

    # ---- hash aggregation (ops/hashtable.py, K3) ---------------------

    def hash_aggregate(self, node: L.AggregateNode, child: Batch,
                       aggs) -> Optional[Batch]:
        """Strategy 'hash': the hash-table kernel with the escape ->
        radix-partition -> re-enter chain, sized from the decision cache's
        measured group count on re-execution, the planner estimate first
        time. None = shape unsupported; the caller runs the sort path."""
        est = node.out_capacity
        known = self._known_groups(node)
        if known is not None:
            est = max(1, known)
        out = self.try_hash_group_agg(child, node.group_keys, aggs,
                                      est, node=node)
        if out is None:
            return None
        self._note_strategy("AggregateNode", "hash", "agg")
        return out

    def try_hash_group_agg(self, child: Batch, keys: tuple, aggs,
                           est_groups: int,
                           node=None) -> Optional[Batch]:
        """One hash aggregation: kernel first; on escape the batch
        radix-partitions by the splitmix64 partitioner and each partition
        re-enters the kernel. None = ineligible."""
        from ..ops import hashtable as ht
        if self.hash_mode() == "off" or not keys:
            return None
        if not ht.supports_aggs(child, aggs) or \
                any(a.distinct for a in aggs):
            return None
        from ..ops.aggregate import key_pack_plan
        pack = key_pack_plan(
            child, keys,
            fetch=(lambda *v: self.fetch_ints(node, "hashpack", *v))
            if node is not None else None)
        if pack is None:
            return None                  # unpackable keys: sort path
        kmins, bits = pack
        cap = ht.max_table_slots(aggs)
        if self.hash_table_slots:
            t = ht.MIN_TABLE_SLOTS
            while t * 2 <= min(self.hash_table_slots, cap):
                t *= 2
            slots, fits = t, True        # pinned size: escapes decide
        else:
            slots, fits = ht.pick_table_slots(max(1, int(est_groups)),
                                              aggs)
        self.stats.hash_agg_calls += 1
        if fits:
            out, esc, occ = ht.hash_group_aggregate(
                child, kmins, keys, bits, aggs, slots)
            esc_h, n_groups = self.fetch_ints(
                node, f"hashagg{slots}", esc, occ)
            if esc_h == 0:
                if node is not None:
                    self._record_groups(node, n_groups)
                return out
        self.stats.hash_agg_escapes += 1
        return self._partitioned_hash_agg(child, keys, aggs, kmins, bits,
                                          est_groups, slots)

    def _partitioned_hash_agg(self, child: Batch, keys: tuple, aggs,
                              kmins, bits: tuple, est_groups: int,
                              slots: int) -> Batch:
        """The escape path: radix-partition on the host with the
        splitmix64 partitioner (exec/spill._partition_ids); groups never
        straddle partitions, so per-partition results concatenate."""
        from ..ops import hashtable as ht
        from .spill import _partition_ids
        dev = self.device
        arrs, vals = batch_to_numpy(child)
        load = ht.LOAD_NUM / ht.LOAD_DEN
        want = max(2, -(-int(max(est_groups, 1)) //
                        max(1, int(slots * load))))
        count = 2
        while count < want and count < 256:
            count *= 2
        part = _partition_ids(arrs, vals, keys, count)
        outs: List[tuple] = []
        for p in range(count):
            m = part == p
            if not m.any():
                continue
            pb = batch_from_numpy([a[m] for a in arrs],
                                  valids=[v[m] for v in vals], device=dev)
            out, esc, _occ = ht.hash_group_aggregate(
                pb, kmins, keys, bits, aggs, slots)
            if int(esc) > 0:
                # still too many groups in this partition (skew): the
                # sort kernel finishes it — groups are disjoint anyway
                out = sort_group_aggregate(
                    pb, keys, aggs, bucket_capacity(int(m.sum())),
                    self.gather_mode())
            oa, ov = batch_to_numpy(out)
            if oa and len(oa[0]):
                outs.append((oa, ov))
        if not outs:
            empty = batch_from_numpy(
                [np.zeros(0, np.asarray(a).dtype) for a in arrs],
                valids=[np.zeros(0, np.bool_) for _ in arrs], device=dev)
            out, _e, _o = ht.hash_group_aggregate(
                empty, kmins, keys, bits, aggs, ht.MIN_TABLE_SLOTS)
            return out
        ncols = len(outs[0][0])
        return batch_from_numpy(
            [np.concatenate([o[0][j] for o in outs]) for j in range(ncols)],
            valids=[np.concatenate([o[1][j] for o in outs])
                    for j in range(ncols)], device=dev)

    # ---- uncorrelated scalar subqueries (fold to constants) ----------

    def fold_scalars(self, expr):
        """Replace ScalarSubqueryRef / InSubqueryRef with constants."""
        if expr is None:
            return None
        has_sub = any(isinstance(e, (ir.ScalarSubqueryRef,
                                     ir.InSubqueryRef))
                      for e in ir.walk(expr))
        if not has_sub:
            return expr

        def fn(e):
            if isinstance(e, ir.ScalarSubqueryRef):
                return ir.Literal(self.scalar_value(e), e.dtype)
            if isinstance(e, ir.InSubqueryRef):
                return self.fold_in_subquery(e)
            return None
        return ir.transform(expr, fn)

    def fold_in_subquery(self, ref: ir.InSubqueryRef) -> ir.Expr:
        """Execute the subquery and fold x IN (...) to an InList (varchar
        values mapped into the probe's dictionary, Kleene NULL when the
        subquery produced one)."""
        if ref not in self._scalar_cache:
            batch = self.run(ref.plan)
            arrays, valids = batch_to_numpy(batch)
            vals, has_null = [], False
            arg_t = ref.arg.dtype
            from ..types import TypeKind as TK
            for v, ok in zip(arrays[0], valids[0]):
                if not ok:
                    has_null = True
                    continue
                v = v.item() if hasattr(v, "item") else v
                if arg_t.kind is TK.VARCHAR:
                    s = ref.sub_field.dictionary[int(v)]
                    pool = ref.arg_field.dictionary if ref.arg_field \
                        else None
                    if pool is None or s not in pool:
                        continue            # absent: can never match
                    v = pool.index(s)
                vals.append(v)
            self._scalar_cache[ref] = (tuple(sorted(set(vals))), has_null)
        vals, has_null = self._scalar_cache[ref]
        folded: ir.Expr = ir.InList(
            ref.arg, tuple(ir.Literal(v, ref.arg.dtype) for v in vals))
        if has_null:
            from ..types import BOOLEAN
            folded = ir.Logical("or", (folded, ir.Literal(None, BOOLEAN)))
        return folded

    def fold_scalars_tuple(self, exprs):
        return tuple(self.fold_scalars(e) for e in exprs)

    def scalar_value(self, ref: ir.ScalarSubqueryRef):
        if ref not in self._scalar_cache:
            batch = self.run(ref.plan)
            arrays, valids = batch_to_numpy(batch)
            if len(arrays[0]) > 1:
                raise RuntimeError(
                    "scalar subquery returned more than one row")
            if len(arrays[0]) == 0 or not bool(valids[0][0]):
                val = None
            else:
                v = arrays[0][0]
                val = v.item() if hasattr(v, "item") else v
            self._scalar_cache[ref] = val
        return self._scalar_cache[ref]

    # compact when live rows fit in 1/SHRINK of capacity
    COMPACT_SHRINK = 2

    def maybe_compact(self, batch: Batch, live: Optional[int] = None,
                      node: Optional[L.PlanNode] = None) -> Batch:
        """Compact when live rows shrank enough (`live` from the caller's
        own sync when it has one)."""
        if live is None:
            if batch.capacity < (1 << 16):
                return batch          # too small for compaction to pay
            live = self.fetch_ints(node, "complive", batch.live.sum())[0]
        new_cap = bucket_capacity(live)
        if new_cap * self.COMPACT_SHRINK <= batch.capacity:
            self.stats.dynamic_filter_compactions += 1
            return compact_batch(batch, new_cap)
        return batch

    def run_join(self, node: L.JoinNode) -> Batch:
        probe = self.run(node.left)
        if self.stream_build_bytes:
            raise _not_ported("streaming builds (stream_build_min_kb)",
                              "K2 with the chunked executor")
        build = self.run(node.right)
        packed = self.pack_join_keys(probe, build, node.left_keys,
                                     node.right_keys, node=node)
        if packed is not None:
            probe2, build2, pk, bk = packed
            import dataclasses as _dc
            residual2 = node.residual
            if residual2 is not None:
                n_probe = len(probe.columns)

                def _shift(e):
                    if isinstance(e, ir.ColumnRef) and e.index >= n_probe:
                        return ir.ColumnRef(e.index + 1, e.dtype, e.name)
                    return None
                residual2 = ir.transform(node.residual, _shift)
            node2 = _dc.replace(node, left_keys=pk, right_keys=bk,
                                residual=residual2, build_key_domain=None)
            out = self._run_join_inner(node2, probe2, build2)
            return _strip_packed_columns(out, node, len(probe.columns),
                                         len(build.columns))
        return self._run_join_inner(node, probe, build)

    def pack_join_keys(self, probe: Batch, build: Batch, pkeys, bkeys,
                       node=None):
        """None when the fixed 32-bit packing is safe (<= 2 in-range
        columns); else (probe', build', probe_keys', build_keys') with one
        range-compressed key column appended to each side."""
        if len(pkeys) <= 1:
            return None
        if len(pkeys) == 2:
            stats = []
            for side, keys in ((build, bkeys), (probe, pkeys)):
                for ki in keys[1:]:
                    col = side.columns[ki]
                    m = side.live & col.valid
                    d = col.data.to(torch.int64)
                    stats.append(torch.where(m, d, 0).min())
                    stats.append(torch.where(m, d, 0).max())
            vals = self.fetch_ints(node, "jpack31", *stats)
            if all(0 <= int(vals[i]) and int(vals[i + 1]) < (1 << 31)
                   for i in range(0, len(vals), 2)):
                return None
        stats = []
        big = torch.iinfo(torch.int64)
        for side, keys in ((probe, pkeys), (build, bkeys)):
            for ki in keys:
                col = side.columns[ki]
                m = side.live & col.valid
                d = col.data.to(torch.int64)
                stats.append(torch.where(m, d, big.max).min())
                stats.append(torch.where(m, d, big.min).max())
        vals = self.fetch_ints(node, "jpack", *stats)
        k = len(pkeys)
        kmins, bits, total = [], [], 0
        for i in range(k):
            lo = min(int(vals[2 * i]), int(vals[2 * (k + i)]))
            hi = max(int(vals[2 * i + 1]), int(vals[2 * (k + i) + 1]))
            if hi < lo:
                lo, hi = 0, 0
            b = max(2, int(hi - lo + 3).bit_length())
            kmins.append(lo)
            bits.append(b)
            total += b
        if total > 62:
            raise RuntimeError(
                "multi-column join key spans exceed 62 packed bits")
        bits = tuple(bits)
        probe2 = _append_packed_key(probe, kmins, pkeys, bits)
        build2 = _append_packed_key(build, kmins, bkeys, bits)
        return (probe2, build2, (len(probe.columns),),
                (len(build.columns),))

    def _run_join_inner(self, node: L.JoinNode, probe: Batch,
                        build: Batch) -> Batch:
        if node.kind == "mark":
            raise _not_ported("mark joins", "semi/anti/mark joins")
        if node.kind in ("semi", "anti"):
            raise _not_ported(f"{node.kind} joins", "semi/anti/mark joins")
        if node.kind not in ("inner", "left"):
            raise _not_ported(f"{node.kind} joins",
                              "the remaining join kinds")
        probe = self.apply_dynamic_filter(node, probe, build)
        probe = self.maybe_compact(probe, node=node)
        domain = node.build_key_domain
        if node.build_unique:
            out = self.try_unique_join(node, probe, build, domain)
            if out is not None:
                return out
            # the planner's uniqueness proof was wrong — degrade
            self.stats.join_fallbacks += 1
        cap = probe.capacity
        while True:
            out, total, oob = join_expand(probe, build, node.left_keys,
                                          node.right_keys, node.kind,
                                          cap, domain)
            total, oob = self.fetch_ints(node, f"expand{cap}:{domain}",
                                         total, oob)
            if oob > 0:             # stale stats: keys escaped the domain
                domain = None
                self.stats.join_domain_fallbacks += 1
                continue
            if total <= cap:
                self._note_strategy("JoinNode", "expand", "join")
                return self.maybe_compact(out, live=total) \
                    if node.kind == "inner" else out
            cap = bucket_capacity(total)
            self.stats.join_expansion_retries += 1

    def try_unique_join(self, node: L.JoinNode, probe: Batch,
                        build: Batch, domain) -> Optional[Batch]:
        """Unique-build fast paths (sort-merge at small shapes, dense LUT,
        hybrid hash, sorted). None = the build had duplicate keys."""
        gm = self.gather_mode()
        if gm != "off":
            self.stats.pallas_gather_calls += 1
        n_sort_ops = 2 * (len(probe.columns) + len(build.columns)) + 4
        merge_ok = self.enable_merge_join and \
            n_sort_ops <= MAX_SORT_OPERANDS and \
            (probe.capacity + build.capacity) <= SORT_SMALL_ROWS
        if node.kind in ("inner", "left") and merge_ok and \
                len(probe.columns) <= 63 and len(build.columns) <= 63:
            out, dup = join_unique_build_merge(
                probe, build, node.left_keys, node.right_keys, node.kind)
            dup, live = self.fetch_ints(node, "jmerge", dup,
                                        out.live.sum())
            if dup == 0:
                self._note_strategy("JoinNode", "sort-merge", "join")
                return self.maybe_compact(out, live=live)
            return None
        if domain is not None:
            if node.kind == "inner" and probe.capacity > SORT_SMALL_ROWS:
                # two-phase: probe the LUT, then decide — a selective join
                # compacts matched rows before the payload gathers
                from ..ops.join import dense_join_compacted, dense_probe
                src, matched, dup, oob, live = dense_probe(
                    probe, build, node.left_keys, node.right_keys, domain,
                    gm)
                dup, oob, live = self.fetch_ints(
                    node, f"jdense2:{domain}", dup, oob, live)
                if oob == 0:
                    if dup != 0:
                        return None
                    self._note_strategy("JoinNode", "dense-lut", "join")
                    new_cap = bucket_capacity(live)
                    if new_cap * self.COMPACT_SHRINK <= probe.capacity:
                        self.stats.dynamic_filter_compactions += 1
                        return dense_join_compacted(
                            probe, src, matched, build, node.left_keys,
                            node.right_keys, new_cap, gm)
                    out, _dup2, _oob2 = join_unique_build_dense(
                        probe, build, node.left_keys, node.right_keys,
                        node.kind, domain, gm)
                    return out
                self.stats.join_domain_fallbacks += 1
            else:
                out, dup, oob = join_unique_build_dense(
                    probe, build, node.left_keys, node.right_keys,
                    node.kind, domain, gm)
                dup, oob, live = self.fetch_ints(
                    node, f"jdense:{domain}", dup, oob, out.live.sum())
                if oob == 0:
                    if dup != 0:
                        return None
                    self._note_strategy("JoinNode", "dense-lut", "join")
                    return self.maybe_compact(out, live=live)
                self.stats.join_domain_fallbacks += 1
        # sparse key domain: the hybrid hash join
        status, hout = self.try_hash_join(node, probe, build,
                                          allow_dup=False)
        if status == "ok":
            return hout
        if status == "dup":
            return None
        out, dup = join_unique_build(probe, build, node.left_keys,
                                     node.right_keys, node.kind)
        dup, live = self.fetch_ints(node, "jsorted", dup, out.live.sum())
        if dup == 0:
            self._note_strategy("JoinNode", "sorted", "join")
            return self.maybe_compact(out, live=live)
        return None

    def try_hash_join(self, node: L.JoinNode, probe: Batch,
                      build: Batch, allow_dup: bool):
        """Hybrid hash join (ops/hashtable.py): K3 builds key ->
        min(row_id), the probe walks chains with K1 gathers; a build past
        the table's load cap degrades partition-by-partition to the host
        equi-join. Returns (status, batch): 'ok' | 'dup' | 'skip'."""
        from ..ops import hashtable as ht
        if self.hash_mode() == "off" or \
                node.kind not in ("inner", "left", "semi", "anti") or \
                node.residual is not None or node.null_aware:
            return "skip", None
        for side, keys in ((probe, node.left_keys),
                           (build, node.right_keys)):
            for k in keys:
                if not _is_integer(side.columns[k].data.dtype):
                    return "skip", None
        slots, fits = ht.join_table_slots(build.capacity)
        if self.hash_table_slots:
            t = ht.MIN_TABLE_SLOTS
            while t * 2 <= min(self.hash_table_slots, ht.MAX_TABLE_SLOTS):
                t *= 2
            slots = t
            fits = t * ht.LOAD_NUM // ht.LOAD_DEN >= build.capacity
        self.stats.hash_join_calls += 1
        if fits:
            tkey, src, dup, esc = ht.build_join_table(
                build, node.right_keys, slots)
            dup_h, esc_h = self.fetch_ints(node, f"hashbuild{slots}",
                                           dup, esc)
            if esc_h == 0:
                if dup_h > 0 and not allow_dup:
                    return "dup", None
                out = ht.hash_join_probe(
                    probe, build, tkey, src, node.left_keys,
                    node.right_keys, node.kind, self.gather_mode())
                self._note_strategy("JoinNode", "hybrid-hash", "join")
                if node.kind == "inner":
                    live = self.fetch_ints(node, "hashjoinlive",
                                           out.live.sum())[0]
                    out = self.maybe_compact(out, live=live)
                return "ok", out
        self.stats.hash_join_escapes += 1
        out = self._partitioned_hash_join(node, probe, build)
        if out is None:
            return "skip", None
        self._note_strategy("JoinNode", "hybrid-hash", "join")
        return "ok", out

    def _partitioned_hash_join(self, node: L.JoinNode, probe: Batch,
                               build: Batch) -> Optional[Batch]:
        """Both sides radix-partition by the splitmix64 hash and each
        partition joins through the host equi-join (duplicates expand)."""
        from ..ops import hashtable as ht
        from .spill import _host_equi_join, _partition_ids
        dev = self.device
        parrs, pvalids = batch_to_numpy(probe)
        barrs, bvalids = batch_to_numpy(build)
        load_cap = ht.MAX_TABLE_SLOTS * ht.LOAD_NUM // ht.LOAD_DEN
        want = max(2, -(-len(barrs[0]) // load_cap)) if barrs else 2
        count = 2
        while count < want and count < 256:
            count *= 2
        part_p = _partition_ids(parrs, pvalids, node.left_keys, count)
        part_b = _partition_ids(barrs, bvalids, node.right_keys, count)
        outs: List[list] = []
        outs_v: List[list] = []
        for p in range(count):
            mp = part_p == p
            mb = part_b == p
            if not mp.any():
                continue
            arrs, vals = _host_equi_join(
                [a[mp] for a in parrs], [v[mp] for v in pvalids],
                [a[mb] for a in barrs], [v[mb] for v in bvalids],
                node.left_keys, node.right_keys, node.kind)
            if arrs and len(arrs[0]):
                outs.append(arrs)
                outs_v.append(vals)
        if not outs:
            srcs = list(probe.columns)
            if node.kind in ("inner", "left"):
                srcs += list(build.columns)
            out_arrs = [np.zeros(0, c.data.cpu().numpy().dtype)
                        for c in srcs]
            out_valids = [np.zeros(0, np.bool_) for _ in srcs]
            return batch_from_numpy(out_arrs, valids=out_valids, device=dev)
        ncols = len(outs[0])
        return batch_from_numpy(
            [np.concatenate([o[j] for o in outs]) for j in range(ncols)],
            valids=[np.concatenate([o[j] for o in outs_v])
                    for j in range(ncols)], device=dev)

    def apply_dynamic_filter(self, node: L.JoinNode, probe: Batch,
                             build: Batch) -> Batch:
        """Dynamic filtering: the build side's key range prunes probe rows
        (a live-mask AND), compacting when it kills most of the probe."""
        if not self.enable_dynamic_filtering:
            return probe
        if node.kind in ("anti", "left", "mark") or node.null_aware:
            return probe
        for pk_i, bk_i in zip(node.left_keys, node.right_keys):
            bk = build.columns[bk_i]
            if not _is_integer(bk.data.dtype) or bk.data.dtype == torch.bool:
                continue
            m = build.live & bk.valid
            info = torch.iinfo(bk.data.dtype)
            kmin = torch.where(m, bk.data, info.max).min()
            kmax = torch.where(m, bk.data, info.min).max()
            pk = probe.columns[pk_i]
            keep = pk.valid & (pk.data >= kmin) & (pk.data <= kmax)
            probe = probe.with_live(probe.live & keep)
        if probe.capacity >= (1 << 16):
            live = self.fetch_ints(node, "dflive", probe.live.sum())[0]
            new_cap = bucket_capacity(live)
            if new_cap * 4 <= probe.capacity:
                self.stats.dynamic_filter_compactions += 1
                probe = compact_batch(probe, new_cap)
        return probe

    def result_to_host(self, root: L.OutputNode, batch: Batch):
        """Compact + return (names, columns, valids) on the host."""
        probe_floor = (1 << 13) if self.memo_structure_key(root) \
            is not None else (1 << 16)
        if batch.columns and batch.capacity >= probe_floor:
            live = self.fetch_ints(root, "resultlive", batch.live.sum())[0]
            new_cap = bucket_capacity(live)
            if new_cap * 2 <= batch.capacity:
                batch = compact_batch(batch, new_cap)
        arrays, valids = batch_to_numpy(batch)
        return list(root.names), arrays, valids


def explain_strategy_lines(root: L.PlanNode, executor) -> List[str]:
    """EXPLAIN's `agg strategy:` / `join strategy:` verdict lines (the
    reference's rendering; after EXPLAIN ANALYZE the executed strategy is
    appended where it differs from the prediction)."""
    lines: List[str] = []
    hash_on = executor.hash_mode() != "off"
    multiway_on = executor.multiway_mode() != "off"
    max_dims = int(getattr(executor, "multiway_max_dims", 5))
    ran = executor.strategy_decisions

    def verdict(predicted: str, op: str) -> str:
        actual = ran.get(op)
        if actual is not None and actual != predicted.split(" ")[0]:
            return f"{predicted} [ran: {actual}]"
        return predicted

    def walk(node: L.PlanNode, spine: bool = False) -> None:
        if isinstance(node, L.AggregateNode) and \
                node.strategy != "global":
            if node.strategy == "direct":
                g = 1
                for d in node.key_domains:
                    g *= d
                pred = f"direct ({g} groups)"
            elif node.strategy == "hash":
                pred = (f"hash (est {node.out_capacity} groups)"
                        if hash_on else
                        f"hash (est {node.out_capacity} groups; "
                        f"kernel off -> sort)")
            else:
                pred = f"sort (est {node.out_capacity} groups)"
            lines.append("agg strategy: " + verdict(pred, "AggregateNode"))
        elif isinstance(node, L.JoinNode):
            if not spine:
                sv = L.star_verdict(node, max_dims)
                if sv is not None:
                    lines.append("multiway star: " + sv)
            if node.build_key_domain is not None and node.build_unique:
                pred = f"dense-lut (domain {node.build_key_domain})"
            elif not node.build_unique:
                pred = "expand"
            elif hash_on:
                pred = "hybrid-hash"
            else:
                pred = "sort-merge"
            lines.append("join strategy: " + verdict(pred, "JoinNode"))
            dist = getattr(node, "distribution", "auto")
            lines.append("join distribution: "
                         + verdict(dist, "JoinDistribution"))
        elif isinstance(node, L.MultiJoinNode):
            kk = len(node.dims)
            pred = f"multiway[k={kk}]" if multiway_on else \
                f"multiway[k={kk}] (kernel off -> ladder)"
            lines.append("join strategy: " + verdict(pred, "MultiJoinNode"))
            lines.append("join distribution: "
                         + verdict(node.distribution, "JoinDistribution"))
        if isinstance(node, L.JoinNode):
            walk(node.left, spine=True)
            walk(node.right)
        elif isinstance(node, L.FilterNode):
            walk(node.child, spine=spine)
        else:
            for c in L.children(node):
                walk(c)

    walk(root)
    return lines


def compact_batch(batch: Batch, new_capacity: int) -> Batch:
    """Move live rows (in order) into a smaller-capacity batch: a stable
    sort of deadness, then per-column gathers. Caller guarantees
    new_capacity >= live count."""
    idx = torch.sort((~batch.live).to(torch.uint8),
                     stable=True).indices[:new_capacity]
    cols = tuple(Column(c.data[idx], c.valid[idx]) for c in batch.columns)
    return Batch(cols, batch.live[idx])


def _append_packed_key(batch: Batch, kmins, keys: tuple,
                       bits: tuple) -> Batch:
    """Append one int64 column packing the key columns by shared range
    compression (host `kmins`); valid = AND of the key validities."""
    packed = torch.zeros(batch.capacity, dtype=torch.int64,
                         device=batch.device)
    valid = torch.ones(batch.capacity, dtype=torch.bool,
                       device=batch.device)
    for j, (ki, b) in enumerate(zip(keys, bits)):
        col = batch.columns[ki]
        norm = col.data.to(torch.int64) - int(kmins[j]) + 1
        packed = (packed << b) | torch.where(col.valid, norm, 0)
        valid = valid & col.valid
    return Batch(batch.columns + (Column(packed, valid),), batch.live)


def _strip_packed_columns(out: Batch, node: L.JoinNode, n_probe: int,
                          n_build: int) -> Batch:
    """Remove the appended key columns so the output matches
    node.output (inner/left: probe + packed_p + build + packed_b)."""
    cols = list(out.columns)
    del cols[n_probe + 1 + n_build]
    del cols[n_probe]
    return Batch(tuple(cols), out.live)
