"""Single-device plan executor on torch tensors.

Counterpart of ``trino_tpu/exec/executor.py`` (the worker-side stack:
LocalExecutionPlanner + Driver). A plan node maps to torch operations on
fixed-capacity batches on one device; the names, decision rules and
`_note_strategy` verdicts are the reference's, so the same plan takes the
same strategies and any difference in results is a fault here.

What the port runs: scans (with the scan cache and zone-map pruning),
filter/project, global/direct/sort/packed-sort/hash aggregation (K3 via
``ops/hashtable.py``; the direct arm's `mxu` variant is K5 via
``ops/direct_agg.py``), inner/left unique-build and expansion joins
(dense-LUT, sort-merge, sorted, hybrid hash — K1 via ``ops/gather.py``),
semi/anti/mark joins (the same probes, membership semantics, and the
residual expansion ``ops/join.join_mark``), fused multiway star joins (K4
via ``ops/hashtable.multiway_probe``, with the reference's degrades back
to the pairwise ladder), set operations (``ops/setops.py``), window
functions (``ops/window.py``), unnest, sort/TopN/limit, values and
uncorrelated scalar subqueries; chunked execution (`spill_chunk_rows`,
``exec/chunked.py``: fused per-chunk programs whose adapted windowed
probes are K2, the fact-column cache, the chunk-mode LUT caches here) and
streaming builds (`stream_build_min_kb`). Scans read a file connector's
pruned decode when the predicate allows (`_scan_table_data`); writes run
in the session, and `invalidate_scan_cache` drops every cached copy of a
table after one. Plan nodes outside the port (remote sources, the
distributed write stage) raise NotImplementedError naming the ROADMAP
item that ports them.

Memory pressure (``exec/memory.py``, ``exec/spill.py``): every node's
output is reserved in the query's pool; a join, star, aggregation or
sort whose reservation does not fit retries partition-wise through the
host-spill tier (`_spill_retry`), unless `enable_spill` is off or the
low-memory killer has ruled (`request_kill`).

The kernel gates (`auto` for K1, K3, K4 and K5) model the TPU's decision
on every device, so the port takes the same strategies on the CPU as the
reference does on a TPU.

The decision cache (runtime decision values keyed by plan structure)
persists to ``decisions_torch.pkl`` under the data cache's root, so a
fresh process replays a previous run's decisions (the reference's
``decisions.pkl`` holds values of another shape and is never read).
`fetch_ints` is the host sync point: one ``torch.cat(...).tolist()`` per
call, none in chunk mode's loop.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import ir
from ..batch import (Batch, Column, batch_from_numpy, batch_to_numpy,
                     bucket_capacity, pad_capacity)
from ..catalog import Catalog
from ..ops.aggregate import (AggSpec, direct_group_aggregate,
                             global_aggregate, sort_group_aggregate)
from ..ops.join import (join_expand, join_mark, join_unique_build,
                        join_unique_build_dense, join_unique_build_merge)
from ..ops.project import apply_filter, filter_project, filter_project_fused
from ..ops.sort import limit_batch, sort_batch
from ..planner import logical as L
from ..planner.fragmenter import _subtree_nodes
from ..server import serde
from .profiler import RECORDER

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
    jit_compiles: int = 0            # kernel libraries built by this
                                     # executor's launches (nvcc)
    pallas_gather_calls: int = 0     # probe sites dispatched with the
                                     # gather kernel (K1) enabled
    hash_agg_calls: int = 0          # hash-table aggregations run (K3)
    hash_agg_escapes: int = 0        # escapes that radix-partitioned
    hash_join_calls: int = 0         # hybrid hash-join builds attempted
    hash_join_escapes: int = 0       # builds that overflowed the table
    mesh_partitioned_joins: int = 0  # joins hash-repartitioned over the
                                     # mesh (parallel/dist_executor.py)
    mesh_gathers: int = 0            # row-sharded batches all-gathered
                                     # onto the mesh's first device
    dynamic_filter_rows_pruned: int = 0   # probe rows cut by build-side
                                          # bounds before the join ran
    scan_zones_pruned: int = 0       # zone-map row ranges skipped at scan
    scan_rows_pruned: int = 0        # rows those zones would have held
    mxu_agg_calls: int = 0           # direct aggregates run through K5
    multijoin_fused_probes: int = 0  # fused multiway star passes run (K4)
    multijoin_degrades: int = 0      # star dimensions degraded back to
                                     # the pairwise ladder
    # per degrade reason (kernel_off/vmem/dup/escape/dtype): the
    # reference's trino_tpu_multijoin_degrades_total{reason} family
    multijoin_degrade_reasons: Dict[str, int] = field(default_factory=dict)
    # the chunked driver (exec/chunked.py)
    agg_spill_chunks: int = 0        # chunks streamed (driver and builds)
    fact_cache_chunks: int = 0       # chunks sliced from the fact cache
    chunk_lut_joins: int = 0         # sync-free reused-LUT probes
    fused_chunk_pipelines: int = 0   # whole-chunk-path fused programs
    escaped_window_reruns: int = 0   # adapted fused runs whose window or
                                     # compaction guess failed (plain rerun)
    compaction_overflows: int = 0    # in-program compaction capacity hit
    spilled_joins: int = 0           # joins retried through host-spill
                                     # radix partitioning (exec/spill.py)
    spilled_aggregations: int = 0    # aggregations/partial states spilled
    spilled_sorts: int = 0           # sorts retried on host (TopN under
                                     # pressure)
    decision_hits: int = 0           # fetch_ints answered by the
                                     # decision cache (no device sync)
    scan_chunks_skipped: int = 0     # chunks skipped whole by zone maps
    scan_prefetched_chunks: int = 0  # chunks served from the prefetch
                                     # pipeline's staging
    scan_prefetch_stalls: int = 0    # consumer waits on an unstaged chunk
    streamed_build_joins: int = 0    # joins whose build streamed (LUT)
    # connector-side pruned decodes (Parquet row groups, ORC stripes)
    pruned_decodes: int = 0          # scans served by get_table_pruned
    pruned_groups_skipped: int = 0   # row groups + stripes never decoded
    pruned_decode_fallbacks: int = 0  # pruned decodes that raised: the
                                      # scan fell back to the full decode


class QueryDeadlineError(RuntimeError):
    """query_max_run_time_s exceeded (QUERY_MAX_RUN_TIME's role)."""
    error_name = "QUERY_EXCEEDED_RUN_TIME"
    error_code = 4


class QueryTerminatedError(RuntimeError):
    """request_cancel() asked the running query to stop; the executor
    raises this at the next cooperative check point (plan-node, chunk,
    spill-partition, or prefetch boundary). Carries USER_CANCELED
    taxonomy."""
    error_name = "USER_CANCELED"
    error_code = 2


# serializes ExecStats -> metrics snapshot diffs across threads
_FLUSH_LOCK = threading.Lock()


def _subtree_scans(node: "L.PlanNode"):
    if isinstance(node, L.ScanNode):
        yield node
    for c in L.children(node):
        yield from _subtree_scans(c)


def _int_words(t: torch.Tensor) -> torch.Tensor:
    """`t` flattened, as int32 or int64 (concatenation promotes a mix of
    the two to int64 exactly); other dtypes are cast to int64."""
    t = t.reshape(-1)
    if t.dtype == torch.int64 or t.dtype == torch.int32:
        return t
    return t.to(torch.int64)


def _is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex


class _DigestEncoder(serde._Encoder):
    """The wire encoder for structure digests: a plan node other than
    `root` encodes as its own digest, a long tuple of JSON values (a
    string pool) as the digest of its JSON."""

    def __init__(self, executor, root):
        super().__init__()
        self.executor, self.root = executor, root

    def enc(self, obj):
        if type(obj) is tuple and len(obj) >= 256:
            # every node's output fields carry their pools
            pool = self.executor._pool_digest(obj)
            if pool is not None:
                return {"$pool": pool}
        if isinstance(obj, L.PlanNode) and obj is not self.root:
            return {"$plan": self.executor._structure_digest(obj)}
        return super().enc(obj)


def _in_values(ref: ir.InSubqueryRef, col: np.ndarray,
               valid: np.ndarray) -> tuple:
    """(sorted distinct non-NULL values as Python values, whether a NULL
    came) of an IN subquery's column; varchar codes are mapped into the
    probe's dictionary, and a string absent from it is dropped (it can
    never match)."""
    from ..types import TypeKind as TK
    valid = valid.astype(np.bool_)
    if ref.arg.dtype.kind is not TK.VARCHAR and (
            np.issubdtype(col.dtype, np.integer) or col.dtype == np.bool_):
        return tuple(np.unique(col[valid]).tolist()), not valid.all()
    vals = []
    for v in col[valid]:
        v = v.item() if hasattr(v, "item") else v
        if ref.arg.dtype.kind is TK.VARCHAR:
            s = ref.sub_field.dictionary[int(v)]
            pool = ref.arg_field.dictionary if ref.arg_field else None
            if pool is None or s not in pool:
                continue
            v = pool.index(s)
        vals.append(v)
    return tuple(sorted(set(vals))), not valid.all()


class Executor:
    def __init__(self, catalog: Catalog, device):
        self.catalog = catalog
        self.device = torch.device(device)
        self._scan_cache: "OrderedDict[tuple, Batch]" = OrderedDict()
        self._scalar_cache: Dict[object, object] = {}
        self.stats = ExecStats()
        self.profile = False           # fenced per-node timing
        # id(node) -> (wall_s, rows, device_s, host_s, compile_s)
        self.node_stats: Dict[int, tuple] = {}
        from .memory import MemoryPool, parse_bytes
        env_limit = os.environ.get("TRINO_TPU_QUERY_MAX_MEMORY")
        self.pool = MemoryPool(parse_bytes(env_limit) if env_limit
                               else (64 << 30))
        self._node_bytes: Dict[int, int] = {}
        # host-spill survival chain (exec/spill.py): when a join/agg/sort
        # reservation cannot fit even after revocation, the operator
        # retries partition-wise through the host/disk tier
        self.enable_spill = True
        self.spill_partitions = 8
        self.spill_force_disk = False     # tests/chaos: all spills to disk
        self.spiller = None               # lazy HostSpiller
        self._kill_reason: Optional[str] = None    # low-memory killer
        self._cancel_reason: Optional[str] = None  # request_cancel()
        self._cancel_tag: Optional[str] = None     # ... for this query
        # bounded-memory chunked executor (exec/chunked.py); None = off
        self.spill_chunk_rows: Optional[int] = None
        # chunked-driver prefetch pipeline depth: how many decoded chunks
        # may sit ahead of the device (0 = the serial loop)
        self.prefetch_depth = 2
        self.prewarm_chunks = False
        # the fused chunk program's in-program compaction from a previous
        # run's measurements: off, as in the reference (windowed packed
        # probes, K2, always adapt)
        self.enable_adapt_compact = False
        # a seeded fault injector for executor-side worker threads (the
        # prefetch worker calls maybe_fail("SCAN_PREFETCH", ...)); None
        # outside tests
        self.failure_injector = None
        # chunked-mode build results keyed by structural plan hash; they
        # persist across queries for deterministic sources and hold
        # REVOCABLE "build-cache" reservations until evicted
        self._build_cache: Dict[str, Batch] = {}
        self._build_cache_bytes: Dict[str, int] = {}
        # chunk mode: inside the chunked loop joins build and validate
        # their LUT once per pinned build and then probe sync-free;
        # compaction (which needs a row count) is skipped
        self.chunk_mode = False
        self._chunk_lut_cache: Dict[tuple, object] = {}
        # cross-run caches of the fused chunk pipeline: per-chunk programs
        # keyed by plan structure, validated LUTs by (build, domain)
        self._fused_cache: Dict[object, object] = {}
        self._lut_cache: Dict[tuple, object] = {}
        # device-resident narrowed fact columns (exec/device_cache.py)
        from .device_cache import FactTableCache
        self.fact_cache = FactTableCache()
        self.enable_fact_cache = True
        self._revocation_handle = self.pool.register_revocation(
            self._revoke_caches, tag="executor-caches")
        # session-resolved kernel settings (auto/true/false)
        self.enable_pallas_gather = "auto"
        self.enable_pallas_hash = "auto"
        self.hash_table_slots = 0      # 0 = size from stats; tests pin
        # K5 (ops/direct_agg.py): "auto" takes it for direct aggregates
        # of at least MXU_AGG_MIN_GROUPS groups; "true"/"false" force
        self.enable_mxu_agg = "auto"
        # K4 (ops/hashtable.multiway_probe): the planner consults its own
        # copy of the property when it fuses a star; this one gates the
        # executor's kernel-vs-ladder choice
        self.enable_multiway_join = "auto"
        self.multiway_max_dims = 5
        # the fused pass's table budget in KiB, in the reference's bytes
        # (dims are shed largest-first to the pairwise path until the
        # stack fits)
        self.multiway_vmem_kb = 8192
        self._no_decisions = 0         # >0: bypass the decision cache
        # substitutions: id(plan node) -> precomputed Batch (the children a
        # star already ran, the chunked driver's pinned builds, chunks and
        # merged partials)
        self._subst: Dict[int, Batch] = {}
        # ids of substitutions whose data the structure key does not
        # describe (a streamed chunk): decisions under them never cache
        self._subst_opaque: set = set()
        self.chunk_spans: Dict[str, object] = {}
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
        # cross-run DECISION cache: data-dependent host decisions of
        # deterministic subtrees, keyed by structure. It persists to disk
        # (keys are sha256 wire-form hashes, stable across processes), so
        # a fresh process replays a previous run's decisions
        self._decision_cache: Dict[tuple, tuple] = {}
        self._decision_dirty = False
        self._decision_loaded = False
        self._skey_memo: Dict[int, tuple] = {}
        self._digest_memo: Dict[int, tuple] = {}

    # ------------------------------------------------------------------

    def _revoke_caches(self, target_bytes: int) -> int:
        """Revocation callback: evict cached build batches (revocable
        reservations) until the target is met. Evicted builds re-run on
        next use — correctness never depends on the cache."""
        freed = 0
        for key in list(self._build_cache):
            if freed >= target_bytes:
                break
            self._build_cache.pop(key, None)
            b = self._build_cache_bytes.pop(key, 0)
            self.pool.free_revocable(b, tag="build-cache")
            freed += b
        return freed

    def request_kill(self, reason: str) -> None:
        """The low-memory killer's hook: the next plan-node boundary
        raises MemoryKilledError (surfaced as QUERY_EXCEEDED_MEMORY)."""
        self._kill_reason = reason

    def request_cancel(self, reason: str, tag: Optional[str] = None) -> None:
        """Cancellation's hook: the next cooperative check point raises
        QueryTerminatedError. `tag` names the query it is meant for (the
        pool's current tag while that query runs)."""
        self._cancel_reason = reason
        self._cancel_tag = tag

    def check_cancel(self) -> None:
        """Cooperative kill/cancel/deadline check, called between plan
        nodes (run()), between driver chunks (exec/chunked.py), between
        spill partitions (exec/spill.py), and by the prefetch pipeline."""
        if self._kill_reason is not None:
            from .memory import MemoryKilledError
            raise MemoryKilledError(self._kill_reason)
        if self._cancel_reason is not None:
            if self._cancel_tag in (None, self.pool._current_tag):
                raise QueryTerminatedError(self._cancel_reason)
            # meant for a query that is no longer running here: a
            # distributed query runs no plan on this executor before its
            # final stage, so its cancel can land after its attempt ended
            self._cancel_reason = self._cancel_tag = None
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise QueryDeadlineError("query exceeded query_max_run_time_s")

    @contextlib.contextmanager
    def no_decisions(self):
        """Bypass the cross-run decision cache inside the block: a star's
        degraded hop and the spill paths run a plan node over batches its
        structure key does not describe (a synthesized join, one
        partition's rows), so cached counts would poison replay."""
        self._no_decisions += 1
        try:
            yield
        finally:
            self._no_decisions -= 1

    def _scan_key(self, node) -> tuple:
        pruning = node.predicate is not None and self.enable_zone_map_pruning
        return (node.catalog, node.schema_name, node.table,
                node.column_indices,
                repr(node.predicate) if pruning else None)

    def invalidate_scan_cache(self) -> None:
        """Drop cached scans AND their byte accounting together, the prune
        verdicts, the device-resident fact columns (they alias the same
        tables) and the decision cache — after any write to a table."""
        self._scan_cache.clear()
        self._scan_cache_bytes.clear()
        self._scan_prune_info.clear()
        self.fact_cache.invalidate()
        # decision values never cache for mutable catalogs, but clearing
        # costs nothing and removes any doubt after DML
        self._decision_cache.clear()

    def device_cache_bytes(self) -> int:
        """Device bytes held across statements: cached scans, cached
        builds and the fact-column cache."""
        return (sum(self._scan_cache_bytes.values()) +
                sum(self._build_cache_bytes.values()) +
                self.fact_cache.total_bytes())

    def release_device_caches(self) -> int:
        """Drop every cross-statement device cache and return the bytes
        released; later statements rebuild what they use. A coordinator
        killed in-process calls this: a dead process frees its card
        memory, while a statement still in flight keeps only the tensors
        it holds itself."""
        freed = self.device_cache_bytes()
        self.invalidate_scan_cache()
        self._revoke_caches(sum(self._build_cache_bytes.values()) + 1)
        return freed

    def flush_metrics(self) -> None:
        """Mirror ExecStats deltas since the last flush into the process
        metrics registry (trino_tpu_exec_events_total{event=...}).
        ExecStats stays the cumulative in-object view; the registry gets
        increments. Guarded by its own lock, never the query's."""
        import dataclasses

        from ..metrics import EXEC_EVENTS, OPERATOR_ROWS
        with _FLUSH_LOCK:
            cur = {k: v for k, v in dataclasses.asdict(self.stats).items()
                   if isinstance(v, int)}
            prev = getattr(self, "_stats_flushed", {})
            for k, v in cur.items():
                d = v - prev.get(k, 0)
                if d:
                    EXEC_EVENTS.inc(d, event=k)
            d = cur["rows_scanned"] - prev.get("rows_scanned", 0)
            if d:
                OPERATOR_ROWS.inc(d, operator="scan")
            self._stats_flushed = cur

    def execute(self, root: L.OutputNode) -> Batch:
        if not isinstance(root, L.OutputNode):
            raise TypeError("execute takes an OutputNode")
        RECORDER.bind_stats(self.stats)
        self._kill_reason = None
        self._cancel_reason = None
        self.strategy_decisions = {}
        for b in self._node_bytes.values():
            self.pool.free(b)
        self._node_bytes.clear()
        self._subst.clear()
        self._subst_opaque.clear()
        self._skey_memo.clear()
        self._digest_memo.clear()
        try:
            if self.spill_chunk_rows:
                from .chunked import execute_chunked
                out = execute_chunked(self, root)
                if out is not None:
                    return out
            return self.run(root.child)
        finally:
            self.save_decisions()

    def run(self, node: L.PlanNode) -> Batch:
        # bind this executor's stats to the dispatch thread, so a kernel
        # library built inside the dispatch counts in its jit_compiles
        RECORDER.bind_stats(self.stats)
        sub = self._subst.get(id(node))
        if sub is not None:
            return sub
        self.check_cancel()
        from .memory import (ExceededMemoryLimitError, MemoryKilledError,
                             batch_bytes)
        try:
            out = self._dispatch_timed(node)
            b = batch_bytes(out)
            self.pool.reserve(b)
        except MemoryKilledError:
            raise                         # the killer's verdict is final
        except ExceededMemoryLimitError:
            # memory-pressure survival: joins, aggregations and sorts
            # retry through the host-spill radix partitioner; anything
            # else fails cleanly as QUERY_EXCEEDED_MEMORY
            out = self._spill_retry(node)
            b = batch_bytes(out)
            self.pool.reserve(b)
        # memory accounting: reserve this node's output, release the
        # children's (their batches die once the parent has consumed them)
        self._node_bytes[id(node)] = b
        for c in L.children(node):
            if id(c) in self._subst:
                continue
            self.pool.free(self._node_bytes.pop(id(c), 0))
        return out

    def _spill_retry(self, node: L.PlanNode) -> Batch:
        """Retry a memory-failed Join/MultiJoin/Aggregate/Sort
        partition-wise through the host-spill tier (exec/spill.py). The
        innermost failing operator spills first; if its shape is
        unsupported, the original error propagates so an enclosing
        operator (or the query boundary) handles it."""
        if not self.enable_spill or \
                not isinstance(node, (L.JoinNode, L.MultiJoinNode,
                                      L.AggregateNode, L.SortNode)):
            raise
        # drop this subtree's partial reservations from the failed
        # attempt; the spill path re-executes the children bounded
        self.release_path_reservations(node, keep=self._subst)
        from .spill import spill_aggregate, spill_join, spill_sort
        if isinstance(node, L.MultiJoinNode):
            # the spill tier partitions pairwise joins: reconstruct the
            # exact ladder the star fused and spill its top hop
            self._note_multijoin_degrade("spill", len(node.dims))
            out = spill_join(self, L.multijoin_to_ladder(node))
        elif isinstance(node, L.JoinNode):
            out = spill_join(self, node)
        elif isinstance(node, L.AggregateNode):
            out = spill_aggregate(self, node)
        else:
            out = spill_sort(self, node)
        if out is None:
            raise
        return out

    def _fence(self) -> None:
        """Wait until the card has finished the work queued so far: the
        profiled dispatch's fence (a no-op on the CPU, where torch runs
        synchronously)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dispatch_timed(self, node: L.PlanNode) -> Batch:
        """Dispatch `node`, timed. With `profile` on, each operator is
        fenced before and after, and node_stats[id(node)] = (wall, rows,
        device, host, compile) in seconds, inclusive of its children:
        device is the time blocked on the closing fence, compile the
        compile recorder's seconds on this thread during the dispatch (a
        kernel library built by its first launch, ops/cuda_build.py),
        host the rest; the three sum to wall exactly. Card work that the
        dispatch itself waits for (a `.item()`, `.tolist()` or `.cpu()`
        inside it, e.g. `fetch_ints`) lands in host, as the reference's
        fetches inside a dispatch do. With `profile` off nothing fences."""
        op = type(node).__name__
        if not self.profile:
            # always-on operator metrics: host dispatch wall only (the
            # card's work stays asynchronous)
            from ..metrics import OPERATOR_DISPATCHES, OPERATOR_WALL_MS
            t0 = time.monotonic()
            out = self.dispatch(node)
            OPERATOR_DISPATCHES.inc(operator=op)
            OPERATOR_WALL_MS.inc((time.monotonic() - t0) * 1000,
                                 operator=op)
            return out
        from ..metrics import (OPERATOR_COMPILE_MS, OPERATOR_DEVICE_MS,
                               OPERATOR_ROWS)
        self._fence()
        c0 = RECORDER.thread_compile_seconds()
        t0 = time.monotonic()
        out = self.dispatch(node)
        t1 = time.monotonic()
        self._fence()
        t2 = time.monotonic()
        compile_s = min(max(RECORDER.thread_compile_seconds() - c0, 0.0),
                        t1 - t0)
        device_s = t2 - t1
        host_s = (t1 - t0) - compile_s
        rows = sum(int(b.live.sum()) for b in getattr(out, "shards", (out,)))
        self.node_stats[id(node)] = (t2 - t0, rows, device_s, host_s,
                                     compile_s)
        OPERATOR_ROWS.inc(rows, operator=op)
        OPERATOR_DEVICE_MS.inc(device_s * 1000, operator=op)
        if compile_s:
            OPERATOR_COMPILE_MS.inc(compile_s * 1000, operator=op)
        return out

    def build_structure_key(self, node: L.PlanNode) -> Optional[str]:
        """Decision-cache key for a DETERMINISTIC subtree: the wire-form
        hash, or None when any scan reads a mutable catalog."""
        scans = list(_subtree_scans(node))
        if not scans or any(s.catalog not in ("tpch", "tpcds", "bench")
                            for s in scans):
            return None
        return self._structure_digest(node)

    def _structure_digest(self, node: L.PlanNode) -> str:
        """SHA-256 of `node`'s wire form (server/serde) with every other
        plan node in it, child or subquery, replaced by its own digest,
        memoised for the execution: a subtree is encoded once, not once
        for each ancestor (a folded IN list of 270,000 literals was
        encoded 190 times in TPC-DS q14)."""
        hit = self._digest_memo.get(id(node))
        if hit is not None:
            return hit[1]
        enc = _DigestEncoder(self, node)
        root = enc.enc(node)
        digest = hashlib.sha256(json.dumps(
            {"v": 1, "slots": enc.slots, "root": root}).encode()).hexdigest()
        # the node is held so that its id is not reused while memoised
        self._digest_memo[id(node)] = (node, digest)
        return digest

    def _pool_digest(self, pool: tuple) -> Optional[str]:
        """SHA-256 of a long tuple's JSON, memoised for the execution;
        None when it holds other than JSON values."""
        hit = self._digest_memo.get(id(pool))
        if hit is None:
            try:
                text = json.dumps(pool)
            except TypeError:
                text = None
            hit = (pool, text and hashlib.sha256(text.encode()).hexdigest())
            self._digest_memo[id(pool)] = hit
        return hit[1]

    def _decision_salt(self) -> tuple:
        """Session knobs that change runtime decision values for the same
        plan structure."""
        return (self.enable_dynamic_filtering, self.enable_merge_join,
                str(self.enable_mxu_agg), bool(self.stream_build_bytes),
                self.spill_chunk_rows, self.hash_mode() != "off",
                self.hash_table_slots, self.multiway_mode() != "off",
                self.multiway_vmem_kb)

    # the port's own file: its fetch_ints values are shaped differently
    # from the reference's (a tensor gives all of its elements), and
    # replaying the reference's counts would hide a fault of the port
    _DECISION_CACHE_FILE = "decisions_torch.pkl"

    def _decision_path(self) -> Optional[str]:
        if os.environ.get("TRINO_TPU_DECISION_CACHE") == "0":
            return None
        from ..connectors.diskcache import cache_root
        return os.path.join(cache_root(), self._DECISION_CACHE_FILE)

    def _load_decisions(self) -> None:
        """Merge the on-disk decision cache in (once per executor).
        Entries exist only for immutable generator catalogs, so merging
        stale files is safe; corruption just means a cold start."""
        self._decision_loaded = True
        path = self._decision_path()
        if path is None or not os.path.isfile(path):
            return
        import pickle
        try:
            with open(path, "rb") as f:
                disk = pickle.load(f)
            for k, v in disk.items():
                self._decision_cache.setdefault(k, v)
        except Exception:
            pass

    # on-disk entry cap: this session's entries always survive; older
    # disk entries backfill up to the cap so the file can't grow without
    # bound across workloads
    _DECISION_FILE_MAX = 65536

    def save_decisions(self) -> None:
        """Persist new decision values (atomic tmp+rename; merge with
        any concurrent writer's file first). The dirty flag clears only
        after a successful write so transient disk failures retry."""
        if not self._decision_dirty:
            return
        path = self._decision_path()
        if path is None:
            self._decision_dirty = False
            return
        import pickle
        try:
            merged = dict(self._decision_cache)
            if os.path.isfile(path):
                with open(path, "rb") as f:
                    for k, v in pickle.load(f).items():
                        if len(merged) >= self._DECISION_FILE_MAX:
                            break
                        merged.setdefault(k, v)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(merged, f)
            os.replace(tmp, path)
            self._decision_dirty = False
        except Exception:
            pass

    def decision(self, key: tuple):
        """The decision cache's value for `key`, or None; the file on disk
        is merged in on the first lookup."""
        if not self._decision_loaded:
            self._load_decisions()
        return self._decision_cache.get(key)

    def record_decision(self, key: tuple, value: tuple) -> None:
        """Record a decision value; `execute()` saves it to disk if it is
        new (a steady run that measures the same value writes nothing)."""
        if self._decision_cache.get(key) != value:
            self._decision_cache[key] = value
            self._decision_dirty = True

    def drop_decision(self, key: tuple) -> None:
        """Forget a stale decision value, on disk too at the next save."""
        if self._decision_cache.pop(key, None) is not None:
            self._decision_dirty = True

    def decisions_cacheable(self, node) -> bool:
        """May `node`'s runtime decision values go through the decision
        cache? Chunk mode bypasses (the driver chunk differs per
        iteration), and so does an opaque substitution anywhere in the
        subtree (a streamed chunk carries data the structure key does not
        describe). Structure-faithful substitutions (pinned deterministic
        builds, merged partials) do not bypass."""
        if self.chunk_mode or self._no_decisions:
            return False
        if not self._subst_opaque:
            return True
        return not any(id(n) in self._subst_opaque
                       for n in _subtree_nodes(node))

    def fetch_ints(self, node, tag: str, *vals) -> tuple:
        """Fetch small device integers as host ints — through the decision
        cache when `node`'s subtree is deterministic. A tensor value gives
        all of its elements, in order. The sync point: one cat + tolist
        per call."""
        key = None
        if node is not None and self.decisions_cacheable(node):
            skey = self.memo_structure_key(node)
            if skey is not None:
                key = (tag, skey, self._decision_salt())
                hit = self.decision(key)
                if hit is not None:
                    self.stats.decision_hits += 1
                    return hit
        out = tuple(int(v) for v in torch.cat(
            [_int_words(torch.as_tensor(v, device=self.device))
             for v in vals]).tolist())
        if key is not None:
            if len(self._decision_cache) >= 4096:
                self._decision_cache.clear()
            self.record_decision(key, out)
        return out

    def run_cached_build(self, node: L.PlanNode) -> Batch:
        """Execute a chunked-mode build subtree with a cross-run cache
        keyed by the subtree's wire-form hash, so a re-planned but
        structurally identical build reuses the pinned device batch. Only
        deterministic generator catalogs take part."""
        key = self.build_structure_key(node)
        if key is None:
            return self.run(node)
        hit = self._build_cache.get(key)
        if hit is not None:
            return hit
        out = self.run(node)
        if len(self._build_cache) >= 8:      # bounded: drop eldest
            old = next(iter(self._build_cache))
            self._build_cache.pop(old)
            self.pool.free_revocable(
                self._build_cache_bytes.pop(old, 0), tag="build-cache")
        # move the reservation run() made from the per-query ledger to the
        # cache's REVOCABLE ledger: the batch outlives the query, so the
        # pool keeps counting it until eviction, as spillable bytes
        from .memory import batch_bytes
        b = self._node_bytes.pop(id(node), None)
        if b is not None:
            self.pool.free(b)
        else:
            b = batch_bytes(out)
        self.pool.reserve_revocable(b, tag="build-cache")
        self._build_cache[key] = out
        self._build_cache_bytes[key] = b
        return out

    def release_all_reservations(self) -> None:
        """Free every per-node reservation (a caller that runs plan nodes
        without execute()'s per-query cleanup would otherwise leak their
        bytes and starve later queries under a small pool)."""
        for b in self._node_bytes.values():
            self.pool.free(b)
        self._node_bytes.clear()

    def release_path_reservations(self, node: L.PlanNode, keep) -> None:
        """Free the reservations of `node`'s subtree (chunked mode: the
        per-chunk path recomputes these nodes next iteration). Nodes in
        `keep` (pinned substitutions) stay reserved."""
        if id(node) not in keep:
            self.pool.free(self._node_bytes.pop(id(node), 0))
            for c in L.children(node):
                self.release_path_reservations(c, keep)

    def enter_chunk_mode(self) -> None:
        self.chunk_mode = True

    def exit_chunk_mode(self) -> None:
        self.chunk_mode = False
        self._chunk_lut_cache.clear()

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

    def run_sharded(self, node: L.PlanNode) -> Batch:
        """`node`'s output as its operator leaves it: on one device, what
        `run` returns (the mesh keeps a row-sharded output sharded)."""
        return self.run(node)

    @staticmethod
    def per_shard(batch: Batch, fn) -> Batch:
        """`fn` over a batch (the mesh applies it to every shard)."""
        return fn(batch)

    def dispatch(self, node: L.PlanNode) -> Batch:
        if isinstance(node, L.ScanNode):
            return self.run_scan(node)
        if isinstance(node, L.FilterNode):
            pred = self.fold_scalars(node.predicate)
            if isinstance(node.child, L.ProjectNode):
                child = self.run_sharded(node.child.child)
                exprs = self.fold_scalars_tuple(node.child.exprs)
                return self.per_shard(
                    child, lambda b: filter_project_fused(b, exprs, pred))
            return self.per_shard(self.run_sharded(node.child),
                                  lambda b: apply_filter(b, pred))
        if isinstance(node, L.ProjectNode):
            exprs = self.fold_scalars_tuple(node.exprs)
            if isinstance(node.child, L.FilterNode):
                child = self.run_sharded(node.child.child)
                pred = self.fold_scalars(node.child.predicate)
                return self.per_shard(
                    child, lambda b: filter_project(b, pred, exprs))
            return self.per_shard(self.run_sharded(node.child),
                                  lambda b: filter_project(b, None, exprs))
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
            return self.run_multijoin(node)
        if isinstance(node, L.WindowNode):
            return self.run_window(node)
        if isinstance(node, L.UnnestNode):
            return self.run_unnest(node)
        if isinstance(node, L.SetOpNode):
            return self.run_setop(node)
        raise NotImplementedError(type(node).__name__)

    def run_window(self, node: L.WindowNode) -> Batch:
        from ..ops.window import WinSpec, window_compute
        child = self.run(node.child)
        keys = tuple((k.index, k.ascending, k.nulls_first)
                     for k in node.order_by)
        specs = tuple(WinSpec(s.func, s.arg, s.frame, s.offset, s.default)
                      for s in node.specs)
        return window_compute(child, node.partition_by, keys, specs)

    def run_unnest(self, node: L.UnnestNode) -> Batch:
        """UNNEST expansion (operator/unnest/UnnestOperator.java:42):
        repeat each live row once per element of its array. Arrays are
        pool ids, so the expansion is a host-edge transform like the other
        pool operations: flat offsets per pool, rows gathered through
        np.repeat."""
        child = self.run(node.child)
        arrays, valids = batch_to_numpy(child)
        ids = arrays[node.array_col]
        id_valid = valids[node.array_col]
        pool = node.array_pool
        lengths = np.array([len(t) for t in pool], dtype=np.int64)
        flat = [v for t in pool for v in t]
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        reps = np.where(id_valid, lengths[ids], 0)   # NULL array: 0 rows
        row_idx = np.repeat(np.arange(len(ids)), reps)
        within = np.arange(len(row_idx)) - np.repeat(
            np.cumsum(reps) - reps, reps)
        elem_pos = offsets[ids[row_idx]] + within
        elem_vals = [flat[int(p)] for p in elem_pos]
        elem_valid = np.array([v is not None for v in elem_vals],
                              dtype=np.bool_)
        t = node.element_dtype
        from ..types import TypeKind as TK
        if t.kind is TK.VARCHAR:
            index = {s: i for i, s in enumerate(node.element_pool or ())}
            elem = np.array([index.get(v, 0) for v in elem_vals],
                            dtype=np.int32)
        else:
            elem = np.array([v if v is not None else 0
                             for v in elem_vals], dtype=t.np_dtype)
        out_arrays = [a[row_idx] for a in arrays] + [elem]
        out_valids = [v[row_idx] for v in valids] + [elem_valid]
        if node.ordinality:
            out_arrays.append((within + 1).astype(np.int64))
            out_valids.append(np.ones(len(row_idx), dtype=np.bool_))
        return batch_from_numpy(out_arrays, valids=out_valids,
                                device=self.device)

    def run_setop(self, node: L.SetOpNode) -> Batch:
        """UNION ALL concatenates; the other set operations run on the
        device with the reference's host-loop semantics and row order
        (ops/setops.py)."""
        from ..ops.setops import concat_batches, remap_codes, setop_rows
        left = remap_codes(self.run(node.left), node.left_remaps)
        right = remap_codes(self.run(node.right), node.right_remaps)
        if node.op == "union_all":
            return concat_batches(left, right)
        return setop_rows(node.op, left, right)

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
        data = self._scan_table_data(node, pruning)
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

    def _scan_table_data(self, node: L.ScanNode, pruning: bool):
        """Fetch the table, preferring a connector-side pruned decode
        (ORC stripe / Parquet row-group skipping) when the scan carries a
        pushed predicate, the connector supports it, and the full table
        is not already decoded in its cache. Dictionary-encoded scan
        columns disqualify the pruned path: a pruned decode rebuilds
        string pools from surviving rows only, and those codes would
        not line up with the dictionaries the plan was analyzed against.
        A pruned decode that raises falls back to the full decode (the
        reference's semantics), counted in `pruned_decode_fallbacks`."""
        if pruning:
            try:
                conn = self.catalog.connector(node.catalog)
            except KeyError:
                conn = None
            if conn is not None and \
                    hasattr(conn, "get_table_pruned") and \
                    (node.schema_name, node.table) not in \
                    getattr(conn, "_cache", {}) and \
                    all(node.table_schema.fields[i].dictionary is None
                        for i in node.column_indices):
                from .zonemap import column_ranges
                ranges = column_ranges(node.predicate, node.column_indices,
                                       node.table_schema)
                if ranges:
                    try:
                        data = conn.get_table_pruned(
                            node.schema_name, node.table, ranges)
                    except Exception:    # noqa: BLE001 — the full decode
                        self.stats.pruned_decode_fallbacks += 1
                    else:
                        self.stats.pruned_decodes += 1
                        self.stats.pruned_groups_skipped += \
                            getattr(data, "skipped_row_groups", 0) + \
                            getattr(data, "skipped_stripes", 0)
                        return data
        return self.catalog.get_table(node.catalog, node.schema_name,
                                      node.table)

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
        from ..metrics import SCAN_ZONES_PRUNED
        SCAN_ZONES_PRUNED.inc(pruned)
        self.strategy_decisions[f"TableScan[{node.table}]"] = \
            f"zone-pruned:{pruned}/{zm.num_zones}"
        return arrays, valids, kept_rows

    @staticmethod
    def agg_specs(node: L.AggregateNode) -> tuple:
        return tuple(AggSpec(
            a.func,
            a.arg.index if a.arg is not None else None,
            a.distinct)
            for a in node.aggs)

    def run_aggregate(self, node: L.AggregateNode) -> Batch:
        child = self.run(node.child)
        return self.aggregate_batch(node, child, self.agg_specs(node))

    def gather_mode(self) -> str:
        """Resolved K1 mode: 'on' | 'off' (ops/gather.resolve_mode)."""
        from ..ops.gather import resolve_mode
        return resolve_mode(self.enable_pallas_gather)

    def hash_mode(self) -> str:
        """Resolved K3 mode: 'on' | 'off' (ops/hashtable.resolve_mode)."""
        from ..ops.hashtable import resolve_mode
        return resolve_mode(self.enable_pallas_hash)

    def multiway_mode(self) -> str:
        """Resolved K4 mode: 'on' | 'off'
        (ops/hashtable.resolve_multiway_mode)."""
        from ..ops.hashtable import resolve_multiway_mode
        return resolve_multiway_mode(self.enable_multiway_join)

    def merge_group_aggregate(self, node: L.AggregateNode, merged: Batch,
                              merge_aggs, capacity: int) -> Batch:
        """FINAL merge of grouped partial states (keys at 0..n_keys-1,
        mergeable states after): the hash-partial merge when the
        operator's gate picked hash and the batch qualifies, the sort
        merge otherwise — shared by the chunked driver's PartialState and
        the partial pages."""
        n_keys = len(node.group_keys)
        if node.strategy == "hash":
            out = self.try_hash_group_agg(merged, tuple(range(n_keys)),
                                          merge_aggs, capacity)
            if out is not None:
                return out
        return sort_group_aggregate(merged, tuple(range(n_keys)),
                                    merge_aggs, capacity, self.gather_mode())

    def _note_multijoin_degrade(self, reason: str,
                                count: int = 1) -> None:
        """Count star dimensions degraded back to the pairwise ladder,
        per reason (kernel_off/vmem/dup/escape/dtype)."""
        self.stats.multijoin_degrades += count
        reasons = self.stats.multijoin_degrade_reasons
        reasons[reason] = reasons.get(reason, 0) + count
        from ..metrics import MULTIJOIN_DEGRADES
        MULTIJOIN_DEGRADES.inc(count, reason=reason)

    def _note_strategy(self, op: str, strategy: str, kind: str) -> None:
        """Record the strategy an operator actually ran with: the
        per-query EXPLAIN/operator_stats surface plus the
        {agg,join}_strategy_decisions counter families."""
        self.strategy_decisions[op] = strategy
        from ..metrics import (AGG_STRATEGY_DECISIONS,
                               JOIN_STRATEGY_DECISIONS)
        if kind == "agg":
            AGG_STRATEGY_DECISIONS.inc(strategy=strategy)
        else:
            JOIN_STRATEGY_DECISIONS.inc(strategy=strategy)

    # the reference's auto gate for K5: direct aggregates of at least this
    # many groups (its crossover was measured on a TPU; the port keeps
    # the rule so both take the same strategy, not for the number)
    MXU_AGG_MIN_GROUPS = 12

    def use_mxu_agg(self, child: Batch, aggs, domains) -> bool:
        """K5 (ops/direct_agg.py) for a direct aggregate: sum/count over
        integer columns on a small dense domain. `mxu_agg` = auto takes it
        for G >= MXU_AGG_MIN_GROUPS, true whenever it applies, false
        never. The reference also requires a TPU backend; the port models
        the TPU's decision on every device."""
        setting = str(self.enable_mxu_agg).lower()
        if setting in ("false", "0"):
            return False
        from ..ops.direct_agg import supports
        if not supports(aggs, domains):
            return False
        for a in aggs:
            if a.arg_index is None:
                continue
            dt = child.columns[a.arg_index].data.dtype
            if not _is_integer(dt) or dt == torch.bool:
                return False
        if setting in ("true", "1"):
            return True
        g = 1
        for d in domains:
            g *= d
        return g >= self.MXU_AGG_MIN_GROUPS

    def _known_groups(self, node: L.AggregateNode) -> Optional[int]:
        """The group count a previous run of this aggregate measured
        (decision cache), or None."""
        if not self.decisions_cacheable(node):
            return None
        skey = self.memo_structure_key(node)
        if skey is None:
            return None
        hit = self.decision(("aggfinal", skey, self._decision_salt()))
        return None if hit is None else hit[0]

    def _record_groups(self, node: L.AggregateNode, n_groups: int) -> None:
        if not self.decisions_cacheable(node):
            return
        skey = self.memo_structure_key(node)
        if skey is not None:
            self.record_decision(("aggfinal", skey, self._decision_salt()),
                                 (n_groups,))

    def aggregate_batch(self, node: L.AggregateNode, child: Batch, aggs):
        """One partial aggregation (the PARTIAL step)."""
        if node.strategy == "global":
            self._note_strategy("AggregateNode", "global", "agg")
            return global_aggregate(child, aggs)
        if node.strategy == "direct":
            if self.use_mxu_agg(child, aggs, node.key_domains):
                from ..ops.direct_agg import direct_group_aggregate_mxu
                self.stats.mxu_agg_calls += 1
                self._note_strategy("AggregateNode", "mxu", "agg")
                return direct_group_aggregate_mxu(
                    child, node.group_keys, node.key_domains, aggs)
            self._note_strategy("AggregateNode", "direct", "agg")
            return direct_group_aggregate(
                child, node.group_keys, node.key_domains, aggs)
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
            # never replayed from the decision cache: which rows K3's
            # parallel insert escapes differs from run to run, and a
            # replayed 0 would drop this run's escaped rows (Queue C 8)
            esc_h, n_groups = self.fetch_ints(
                None, f"hashagg{slots}", esc, occ)
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
        """The escape path: radix-partition on the device with the
        splitmix64 partitioner (exec/spill.partition_ids, bit for bit the
        host tier's), then aggregate every partition in ONE K3 launch over
        [count, T] tables (partitions in groups when their tables pass
        MAX_LAUNCH_TABLE_BYTES), read every partition's escape and
        occupancy counters in one fetch, and compact the occupied slots of
        the clean partitions on the device. Groups never straddle
        partitions, so the partitions' groups concatenate; a partition
        that still escaped (skew) finishes on the sort kernel."""
        from ..ops import hashtable as ht
        from .spill import partition_ids
        load = ht.LOAD_NUM / ht.LOAD_DEN
        want = max(2, -(-int(max(est_groups, 1)) //
                        max(1, int(slots * load))))
        count = 2
        while count < want and count < 256:
            count *= 2
        pid = partition_ids(child, keys, count)
        _layout, ns, _nv = ht.agg_layout(aggs)
        per_launch = max(1, ht.MAX_LAUNCH_TABLE_BYTES //
                         ht.table_bytes(slots, ns))
        pieces, escaped = [], []
        for g0 in range(0, count, per_launch):
            g = min(per_launch, count - g0)
            if g == count:
                live, tid = child.live, pid.to(torch.int32)
            else:
                live = child.live & (pid >= g0) & (pid < g0 + g)
                tid = (pid - g0).to(torch.int32)
            tkey, st, counters = ht.hash_group_aggregate_tables(
                child, kmins, keys, bits, aggs, slots, g, tid, live)
            vals = self.fetch_ints(None, "partagg", counters)
            esc = [p for p in range(g) if vals[2 * p] > 0]
            n = sum(vals[2 * p + 1] for p in range(g) if p not in esc)
            occupied = tkey != ht.EMPTY_KEY
            if esc:
                occupied[esc] = False
                escaped.extend(g0 + p for p in esc)
            idx = torch.nonzero(occupied.reshape(-1)).flatten()
            pieces.append((n, tkey.reshape(-1)[idx],
                           st.reshape(ns, tkey.numel())[:, idx]))
        total = sum(p[0] for p in pieces)
        cap = pad_capacity(total)
        out_key = torch.full((cap,), ht.EMPTY_KEY, dtype=torch.int64,
                             device=self.device)
        out_st = torch.zeros((ns, cap), dtype=torch.int64,
                             device=self.device)
        at = 0
        for n, pk, ps in pieces:
            out_key[at:at + n] = pk
            out_st[:, at:at + n] = ps
            at += n
        out = ht.group_rows(child, out_key, out_st, keys, bits, kmins, aggs)
        if not escaped:
            return out
        # still too many groups in a partition (skew): the sort kernel
        # finishes it — groups are disjoint across partitions anyway
        outs = [batch_to_numpy(out)]
        for p in escaped:
            pb = child.with_live(child.live & (pid == p))
            rows = self.fetch_ints(None, "partrows", pb.live.sum())[0]
            outs.append(batch_to_numpy(sort_group_aggregate(
                pb, keys, aggs, bucket_capacity(rows), self.gather_mode())))
        return batch_from_numpy(
            [np.concatenate([o[0][j] for o in outs])
             for j in range(len(outs[0][0]))],
            valids=[np.concatenate([o[1][j] for o in outs])
                    for j in range(len(outs[0][0]))], device=self.device)

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
            arrays, valids = batch_to_numpy(self.run(ref.plan))
            self._scalar_cache[ref] = _in_values(ref, arrays[0], valids[0])
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

    # compact when live rows fit in 1/SHRINK of capacity, from this many
    # rows (a row count costs a sync; below it compaction does not pay)
    COMPACT_SHRINK = 2
    COMPACT_MIN_ROWS = 1 << 16

    def compact_capacity(self, live: int, capacity: int,
                         shrink: Optional[int] = None) -> Optional[int]:
        """The capacity a batch of `capacity` rows, `live` of them live,
        compacts to when they fit in 1/`shrink` of it (default
        COMPACT_SHRINK; counted as a compaction), else None."""
        new_cap = bucket_capacity(live)
        if new_cap * (shrink or self.COMPACT_SHRINK) > capacity:
            return None
        self.stats.dynamic_filter_compactions += 1
        return new_cap

    def maybe_compact(self, batch: Batch, live: Optional[int] = None,
                      node: Optional[L.PlanNode] = None,
                      shrink: Optional[int] = None,
                      tag: str = "complive") -> Batch:
        """Compact when live rows shrank enough (`live` from the caller's
        own sync when it has one; else fetched under `tag`)."""
        if live is None:
            if batch.capacity < self.COMPACT_MIN_ROWS:
                return batch          # too small for compaction to pay
            if self.chunk_mode:
                return batch          # the chunked loop stays sync-free
            live = self.fetch_ints(node, tag, batch.live.sum())[0]
        new_cap = self.compact_capacity(live, batch.capacity, shrink)
        return batch if new_cap is None else compact_batch(batch, new_cap)

    def run_join(self, node: L.JoinNode) -> Batch:
        probe = self.run(node.left)
        # oversized build sides stream chunk-wise into the dense LUT
        # instead of materializing on the device (the decision must
        # precede running the build child)
        if self.stream_build_bytes:
            est = self._estimate_build_bytes(node.right)
            if est is not None and est > self.stream_build_bytes:
                from .chunked import streaming_build_join
                out = streaming_build_join(self, node, probe)
                if out is not None:
                    return out
        build = self.run(node.right)
        return self.join_batches(node, probe, build)

    def join_batches(self, node: L.JoinNode, probe: Batch,
                     build: Batch) -> Batch:
        """The join of its two sides' batches (multi-column keys packed
        into one where 32 bits do not hold them)."""
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

    def _estimate_build_bytes(self, node: L.PlanNode) -> Optional[int]:
        """Size of a Scan/Filter(Scan) build side, for the streaming
        decision (the shape streaming_build_join supports)."""
        scan = node.child if isinstance(node, L.FilterNode) else node
        if not isinstance(scan, L.ScanNode):
            return None
        try:
            rows = self.catalog.get_table(scan.catalog, scan.schema_name,
                                          scan.table).num_rows
        except Exception:        # noqa: BLE001 — stats probe only
            return None
        return rows * max(1, len(scan.column_indices)) * 8

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
        probe = self.apply_dynamic_filter(node, probe, build)
        if node.kind == "mark":
            return self.run_mark_join(node, probe, build)
        if node.kind in ("semi", "anti"):
            return self.run_membership_join(node, probe, build)
        probe = self.maybe_compact(probe, node=node)
        return self._join_pruned(node, probe, build)

    def _join_pruned(self, node: L.JoinNode, probe: Batch,
                     build: Batch) -> Batch:
        """An inner or left join after the dynamic filter and the probe's
        compaction: a unique-build path, else the expansion."""
        if node.build_unique:
            out = self.try_unique_join(node, probe, build,
                                       node.build_key_domain)
            if out is not None:
                return out
            # the planner's uniqueness proof was wrong — degrade
            self.stats.join_fallbacks += 1
        return self._join_expand(node, probe, build)

    def _join_expand(self, node: L.JoinNode, probe: Batch,
                     build: Batch) -> Batch:
        """The expansion join: output capacity grown until every match
        fits."""
        domain = node.build_key_domain
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

    def merge_join_ok(self, node: L.JoinNode, n_probe_cols: int,
                      n_build_cols: int, rows: int) -> bool:
        """Does a unique-build join of this shape take the sort-merge path
        (small shapes: few sort operands, `rows` of both sides)?"""
        n_sort_ops = 2 * (n_probe_cols + n_build_cols) + 4
        return node.kind in ("inner", "left") and self.enable_merge_join \
            and n_sort_ops <= MAX_SORT_OPERANDS and rows <= SORT_SMALL_ROWS \
            and n_probe_cols <= 63 and n_build_cols <= 63

    def try_unique_join(self, node: L.JoinNode, probe: Batch,
                        build: Batch, domain) -> Optional[Batch]:
        """Unique-build fast paths (sort-merge at small shapes, dense LUT,
        hybrid hash, sorted). None = the build had duplicate keys."""
        # chunk mode: build and validate the dense LUT once per pinned
        # build, then probe every chunk sync-free (_chunk_lut_join)
        if self.chunk_mode and domain is not None and \
                node.kind in ("inner", "left"):
            out = self._chunk_lut_join(node, probe, build, domain)
            if out is not None:
                return out
        gm = self.gather_mode()
        if gm != "off":
            self.stats.pallas_gather_calls += 1
        if self.merge_join_ok(node, len(probe.columns), len(build.columns),
                              probe.capacity + build.capacity):
            out, dup = join_unique_build_merge(
                probe, build, node.left_keys, node.right_keys, node.kind)
            dup, live = self.fetch_ints(node, "jmerge", dup,
                                        out.live.sum())
            if dup == 0:
                self._note_strategy("JoinNode", "sort-merge", "join")
                return self.maybe_compact(out, live=live)
            return None
        if domain is not None:
            from ..ops.join import dense_join_compacted, dense_probe
            keys = (node.left_keys, node.right_keys)
            two_phase = self.dense_two_phase(node, probe.capacity)
            if two_phase:
                src, matched, dup, oob, live = dense_probe(
                    probe, build, *keys, domain, gm)
                vals = self.fetch_ints(node, f"jdense2:{domain}", dup, oob,
                                       live)
            else:
                out, dup, oob = join_unique_build_dense(
                    probe, build, *keys, node.kind, domain, gm)
                vals = self.fetch_ints(node, f"jdense:{domain}", dup, oob,
                                       out.live.sum())
            fallback, new_cap = self.dense_verdict(node, probe.capacity,
                                                   vals)
            if fallback == "dup":
                return None
            if fallback is None:
                if not two_phase:
                    return out if new_cap is None else \
                        compact_batch(out, new_cap)
                if new_cap is not None:
                    return dense_join_compacted(probe, src, matched, build,
                                                *keys, new_cap, gm)
                return join_unique_build_dense(probe, build, *keys,
                                               node.kind, domain, gm)[0]
        return self._try_sparse_unique_join(node, probe, build)

    @staticmethod
    def dense_two_phase(node: L.JoinNode, capacity: int) -> bool:
        """Does the dense-LUT join probe first and gather after? An inner
        join over a large probe: a selective one compacts its matched rows
        before the payload gathers."""
        return node.kind == "inner" and capacity > SORT_SMALL_ROWS

    def dense_verdict(self, node: L.JoinNode, capacity: int, vals) -> tuple:
        """The dense-LUT join's next step from its fetched counts, `vals`
        = (dup, oob, live) of each shard (one on a single device) over a
        probe of `capacity` rows: ("domain", None) when a key fell outside
        the domain (counted), ("dup", None) when the build had a duplicate
        key, else (None, the capacity to compact the output to or None)."""
        if sum(vals[1::3]) > 0:
            self.stats.join_domain_fallbacks += 1
            return "domain", None
        if sum(vals[0::3]) > 0:
            return "dup", None
        self._note_strategy("JoinNode", "dense-lut", "join")
        return None, self.compact_capacity(sum(vals[2::3]), capacity)

    def _try_sparse_unique_join(self, node: L.JoinNode, probe: Batch,
                                build: Batch) -> Optional[Batch]:
        """A unique-build join whose keys have no dense domain: the
        hybrid hash join, else the sorted join. None = the build had
        duplicate keys."""
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

    def run_mark_join(self, node: L.JoinNode, probe: Batch,
                      build: Batch) -> Batch:
        """EXISTS truth as an appended boolean column (JoinNode.Type.MARK):
        every probe row survives; the mark powers disjunctive EXISTS
        filters downstream. Build duplicates are irrelevant (membership
        semantics)."""
        domain = node.build_key_domain
        if node.residual is None:
            out = None
            if domain is not None:
                dout, _dup, oob = join_unique_build_dense(
                    probe, build, node.left_keys, node.right_keys,
                    "semi", domain, self.gather_mode())
                if self.fetch_ints(node, f"markoob:{domain}",
                                   oob)[0] == 0:
                    out = dout
                else:
                    self.stats.join_domain_fallbacks += 1
            if out is None:
                out, _dup = join_unique_build(
                    probe, build, node.left_keys, node.right_keys, "semi")
            mark = out.live          # live & matched
        else:
            mark = probe.live & self._residual_mark(node, probe, build,
                                                    "markexp")
        return Batch(probe.columns +
                     (Column(mark, torch.ones_like(mark)),), probe.live)

    def _residual_mark(self, node: L.JoinNode, probe: Batch, build: Batch,
                       tag: str) -> torch.Tensor:
        """join_mark with the reference's grow-and-retry loop: the pair
        capacity grows to the bucket of the measured pair count, and keys
        outside a stale domain rerun without it."""
        residual = self.fold_scalars(node.residual)
        domain = node.build_key_domain
        cap = probe.capacity
        while True:
            mark, total, oob = join_mark(probe, build, node.left_keys,
                                         node.right_keys, residual, cap,
                                         domain)
            total, oob = self.fetch_ints(node, f"{tag}{cap}:{domain}",
                                         total, oob)
            if oob > 0:
                domain = None
                self.stats.join_domain_fallbacks += 1
                continue
            if total <= cap:
                return mark
            cap = bucket_capacity(total)
            self.stats.join_expansion_retries += 1

    def run_membership_join(self, node: L.JoinNode, probe: Batch,
                            build: Batch) -> Batch:
        """semi/anti joins. Build duplicates are irrelevant (membership);
        residuals go through the mark-join expansion."""
        if node.null_aware:
            # NOT IN: any NULL in the subquery output -> no row can pass
            bk = build.columns[node.right_keys[0]]
            if self.fetch_ints(node, "nullaware",
                               (build.live & ~bk.valid).any())[0]:
                return probe.with_live(torch.zeros_like(probe.live))
        domain = node.build_key_domain
        if node.residual is None:
            if domain is not None:
                out, _dup, oob = join_unique_build_dense(
                    probe, build, node.left_keys, node.right_keys,
                    node.kind, domain, self.gather_mode())
                if self.fetch_ints(node, f"memoob:{domain}",
                                   oob)[0] == 0:
                    self._note_strategy("JoinNode", "dense-lut", "join")
                    return out
                self.stats.join_domain_fallbacks += 1
            # membership joins tolerate duplicate build keys (the hash
            # table keeps one row per key, which IS the semantics)
            status, hout = self.try_hash_join(node, probe, build,
                                              allow_dup=True)
            if status == "ok":
                return hout
            out, _dup = join_unique_build(probe, build, node.left_keys,
                                          node.right_keys, node.kind)
            self._note_strategy("JoinNode", "sorted", "join")
            return out
        mark = self._residual_mark(node, probe, build, "memexp")
        live = probe.live & (mark if node.kind == "semi" else ~mark)
        return probe.with_live(live)

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
            # chunk mode: build and validate once per pinned build, probe
            # every chunk sync-free (the dense LUT's caching policy)
            ckey = (id(node), "hash", slots)
            rec = self._chunk_lut_cache.get(ckey) if self.chunk_mode \
                else None
            if rec is None:
                tkey, src, dup, esc = ht.build_join_table(
                    build, node.right_keys, slots)
                # K3's escapes, fetched every run (Queue C 8)
                dup_h, esc_h = self.fetch_ints(None, f"hashbuild{slots}",
                                               dup, esc)
                rec = (tkey, src, dup_h, esc_h)
                if self.chunk_mode:
                    self._chunk_lut_cache[ckey] = rec
            tkey, src, dup_h, esc_h = rec
            if esc_h == 0:
                if dup_h > 0 and not allow_dup:
                    return "dup", None
                out = ht.hash_join_probe(
                    probe, build, tkey, src, node.left_keys,
                    node.right_keys, node.kind, self.gather_mode())
                self._note_strategy("JoinNode", "hybrid-hash", "join")
                if node.kind == "inner" and not self.chunk_mode:
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
        partition joins as the host equi-join does (duplicates expand),
        on the device (exec/spill.partitioned_equi_join)."""
        from ..ops import hashtable as ht
        from .spill import partitioned_equi_join
        load_cap = ht.MAX_TABLE_SLOTS * ht.LOAD_NUM // ht.LOAD_DEN
        live = int(build.live.sum()) if build.columns else 0
        want = max(2, -(-live // load_cap))
        count = 2
        while count < want and count < 256:
            count *= 2
        return partitioned_equi_join(probe, build, node.left_keys,
                                     node.right_keys, node.kind, count)

    def _chunk_lut_join(self, node: L.JoinNode, probe: Batch,
                        build: Batch, domain: int) -> Optional[Batch]:
        """Chunk-mode unique-build join: the dense LUT is built and
        dup/oob-validated once per pinned build side (one fetch), cached
        for the chunked loop, and every later probe chunk joins sync-free
        at probe capacity (no compaction). None = validation failed (the
        caller takes the general fallbacks) or the shape does not apply."""
        if len(probe.columns) > 63 or len(build.columns) > 63:
            return None
        key = (id(node), domain)
        rec = self._chunk_lut_cache.get(key)
        if rec is None:
            from ..ops.join import dense_build_lut
            lut, dup, oob = dense_build_lut(build, node.right_keys, domain)
            dup, oob = (int(v) for v in torch.stack(
                (dup.to(torch.int64), oob)).tolist())
            rec = lut if dup == 0 and oob == 0 else False
            self._chunk_lut_cache[key] = rec
            if rec is False:
                self.stats.join_domain_fallbacks += oob > 0
        if rec is False:
            return None
        from ..ops.join import dense_join_with_lut
        self.stats.chunk_lut_joins += 1
        return dense_join_with_lut(probe, build, rec, node.left_keys,
                                   node.right_keys, node.kind,
                                   self.gather_mode())

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
        # the chunked loop skips the row-count sync (the range mask above
        # still applies; only compaction needs the count)
        return self.maybe_compact(probe, node=node, shrink=4, tag="dflive")

    # ------------------------------------------------------------------
    # fused multiway star join (MultiJoinNode, K4)
    # ------------------------------------------------------------------

    def run_multijoin(self, node: L.MultiJoinNode) -> Batch:
        """Lower a MultiJoinNode to the fused single-pass probe
        (ops/hashtable.multiway_probe), degrading DIMENSION-BY-DIMENSION
        to the pairwise path whenever a dim's table overflows the
        `multiway_vmem_kb` budget, its build keys turn out duplicated, or
        its insert escaped — and wholesale to the reconstructed ladder
        when the kernel is off or fewer than two dims survive. Every
        output is bit-exact vs `multijoin_to_ladder`'s pairwise ladder:
        fused dims ride the same payload-gather machinery the dense/hash
        joins use, and column order is restored to ladder order at the
        end. The fact side is authoritative (never flipped to build).

        Chunk mode caches the validated dimension tables per node, as
        the probe reads them, so each streamed fact chunk probes sync-free
        like the pairwise dense-LUT path."""
        from ..ops import hashtable as ht
        if self.multiway_mode() == "off":
            self._note_multijoin_degrade("kernel_off", len(node.dims))
            return self._run_multijoin_ladder(node)
        fact = self.run(node.fact)
        dims = [self.run(d) for d in node.dims]
        k = len(dims)
        ckey = (id(node), "multiway")
        rec = self._chunk_lut_cache.get(ckey) if self.chunk_mode else None
        if rec is None:
            rec = self._multijoin_tables(node, fact, dims)
            if self.chunk_mode:
                self._chunk_lut_cache[ckey] = rec
        fused, degraded_dims = rec
        if fused is None or len(fused[0]) < 2:
            # nothing left worth a fused pass: run the whole ladder over
            # the already-materialised children
            return self._run_multijoin_ladder(node, fact, dims)
        fused_dims, tkey, src = fused
        found, _miss = ht.multiway_probe(
            fact, tkey, src, tuple(node.fact_keys[d] for d in fused_dims))
        from ..metrics import (JOIN_STRATEGY_DECISIONS,
                               MULTIJOIN_FUSED_PROBES)
        self.stats.multijoin_fused_probes += 1
        MULTIJOIN_FUSED_PROBES.inc()
        self.strategy_decisions["MultiJoinNode"] = \
            f"multiway[k={len(fused_dims)}]"
        JOIN_STRATEGY_DECISIONS.inc(strategy="multiway")
        # payload assembly: fused dims first (their found rows align to
        # fact rows), then each degraded dim through the pairwise path;
        # unique-build hops are commutative live-mask ANDs and dup
        # expansions keep their relative order, so the row sequence
        # matches the ladder's
        from ..ops.join import _combined_key, _gather_build_payload
        gm = self.gather_mode()
        acc = fact
        acc_out = list(node.fact.output)
        col_ranges: Dict[int, tuple] = {}
        pos = len(fact.columns)
        for i, d in enumerate(fused_dims):
            matched = found[i] >= 0
            pk, _pk_valid = _combined_key(fact, node.fact_keys[d])
            src_c = found[i].clamp(0, dims[d].capacity - 1)
            acc = _gather_build_payload(acc, dims[d], src_c, matched, pk,
                                        node.dim_keys[d], "inner", gm)
            col_ranges[d] = (pos, len(dims[d].columns))
            acc_out.extend(node.dims[d].output)
            pos += len(dims[d].columns)
        for d in degraded_dims:
            # chunk mode keeps the synthesized hop alive across chunks so
            # its id stays stable: the pairwise LUT/hash caches key on
            # id(node), and a per-chunk temporary could both miss every
            # chunk and alias a dead node's reused id
            jkey = (id(node), "mjpair", d)
            j = self._chunk_lut_cache.get(jkey) if self.chunk_mode \
                else None
            if j is None:
                j = L.JoinNode(
                    "inner", node.fact, node.dims[d], node.fact_keys[d],
                    node.dim_keys[d], None, True,
                    tuple(acc_out) + tuple(node.dims[d].output),
                    distribution=node.distribution,
                    build_key_domain=node.dim_domains[d])
                if self.chunk_mode:
                    self._chunk_lut_cache[jkey] = j
            # the accumulated batch differs from what the structure key
            # describes (fused columns ride along): no cached decisions
            with self.no_decisions():
                acc = self._run_join_inner(j, acc, dims[d])
            col_ranges[d] = (pos, len(dims[d].columns))
            acc_out.extend(node.dims[d].output)
            pos += len(dims[d].columns)
        perm = list(range(len(fact.columns)))
        for d in range(k):
            start, ln = col_ranges[d]
            perm.extend(range(start, start + ln))
        if perm != list(range(len(acc.columns))):
            acc = Batch(tuple(acc.columns[i] for i in perm), acc.live)
        if not self.chunk_mode and not degraded_dims:
            acc = self.maybe_compact(acc, node=node)
        return acc

    def _multijoin_tables(self, node: L.MultiJoinNode, fact: Batch,
                          dims: list):
        """Size, build (one K3 launch) and validate the star's dimension
        tables; returns (fused, degraded dims in order), fused = (dims in
        order, their tables tkey/src [k, T]) or None."""
        from ..ops import hashtable as ht
        degraded: Dict[int, str] = {}
        sized = []
        for d in range(len(dims)):
            ok_dtype = all(
                _is_integer(side.columns[ki].data.dtype)
                for side, keys in ((fact, node.fact_keys[d]),
                                   (dims[d], node.dim_keys[d]))
                for ki in keys)
            if not ok_dtype:
                degraded[d] = "dtype"
                continue
            slots, fits = ht.join_table_slots(dims[d].capacity)
            if self.hash_table_slots:
                t = ht.MIN_TABLE_SLOTS
                while t * 2 <= min(self.hash_table_slots,
                                   ht.MAX_TABLE_SLOTS):
                    t *= 2
                slots = t
                fits = t * ht.LOAD_NUM // ht.LOAD_DEN >= dims[d].capacity
            if not fits:
                degraded[d] = "vmem"
                continue
            sized.append((d, slots))
        # all tables share ONE slot count (a rectangular stack); shed the
        # largest dims until the stack fits the budget
        budget = self.multiway_vmem_kb << 10
        while sized and ht.multiway_table_bytes(
                len(sized), max(s for _, s in sized)) > budget:
            drop = max(sized, key=lambda x: x[1])
            sized.remove(drop)
            degraded[drop[0]] = "vmem"
        fused = None
        if len(sized) >= 2:
            table_slots = max(s for _, s in sized)
            tkey, src, dup, esc = ht.build_join_tables(
                [dims[d] for d, _s in sized],
                [node.dim_keys[d] for d, _s in sized], table_slots)
            # ONE fused validation fetch for all k builds, every run:
            # K3's escapes differ from run to run, and a replayed verdict
            # could fuse a dimension whose table lost a key (Queue C 8)
            vals = self.fetch_ints(None, f"mjbuild{table_slots}", dup, esc)
            m = len(sized)
            keep = []
            for i, (d, _s) in enumerate(sized):
                if vals[i] > 0:
                    degraded[d] = "dup"
                elif vals[m + i] > 0:
                    degraded[d] = "escape"
                else:
                    keep.append(i)
            if 2 <= len(keep) < m:
                # the surviving dims' tables, interleaved again
                pairs = torch.stack((tkey[keep], src[keep]), -1)
                tkey, src = pairs[..., 0], pairs[..., 1]
            fused = ([sized[i][0] for i in keep], tkey, src)
        for _d, reason in sorted(degraded.items()):
            self._note_multijoin_degrade(reason)
        return fused, sorted(degraded)

    def _run_multijoin_ladder(self, node: L.MultiJoinNode,
                              fact: Optional[Batch] = None,
                              dims: Optional[list] = None) -> Batch:
        """Full degrade: execute the exact pairwise ladder the star
        fused. Already-run children are substituted in so they are not
        recomputed; chunk mode caches the ladder per node so the pairwise
        LUT/hash caches stay keyed on stable node ids."""
        from ..metrics import JOIN_STRATEGY_DECISIONS
        self.strategy_decisions["MultiJoinNode"] = "ladder"
        JOIN_STRATEGY_DECISIONS.inc(strategy="ladder")
        lkey = (id(node), "mjladder")
        ladder = self._chunk_lut_cache.get(lkey) if self.chunk_mode \
            else None
        if ladder is None:
            ladder = L.multijoin_to_ladder(node)
            if self.chunk_mode:
                self._chunk_lut_cache[lkey] = ladder
        temp = []
        try:
            if fact is not None:
                for child, batch in zip((node.fact,) + node.dims,
                                        [fact] + list(dims)):
                    if id(child) not in self._subst:
                        self._subst[id(child)] = batch
                        temp.append(id(child))
            out = self.run(ladder)
        finally:
            for i in temp:
                self._subst.pop(i, None)
        # the outer run() re-reserves this result under the
        # MultiJoinNode's own id; drop the ladder-top ledger entry so the
        # bytes are not double-counted
        self.pool.free(self._node_bytes.pop(id(ladder), 0))
        return out

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
        # decisions taken here (resultlive) come after execute()'s save:
        # persist them too
        self.save_decisions()
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
    node.output (inner/left: probe + packed_p + build + packed_b; mark:
    probe + packed_p + mark; semi/anti: probe + packed_p)."""
    cols = list(out.columns)
    if node.kind in ("inner", "left"):
        del cols[n_probe + 1 + n_build]
    del cols[n_probe]
    return Batch(tuple(cols), out.live)
