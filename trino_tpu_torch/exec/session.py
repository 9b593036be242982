"""Session: the user-facing entry — SQL text in, rows out, on torch.

Counterpart of ``trino_tpu/exec/session.py`` (DispatchManager ->
SqlQueryExecution collapsed to parse -> plan -> execute -> decode). The
session properties keep the reference's names and defaults; the planner,
optimizer and parser are this package's copies of the reference's, so
both packages build the same plan for the same SQL.

``Session(device=None)`` runs on ``cuda`` and raises when CUDA is missing,
unless the caller passes ``device="cpu"`` (the CPU tests do). There is no
silent CPU path.

Kernel settings follow the TPU's rules on every device:
``enable_pallas_gather`` (K1), ``enable_pallas_hash`` (K3) and
``enable_multiway_join`` (K4: the planner fuses star joins, the executor
probes them in one pass) resolve ``auto`` to on, and ``false`` takes each
call site's non-kernel path; ``mxu_agg`` (K5) takes direct aggregates of
at least 12 groups under ``auto``, every supported one under ``true``,
none under ``false``. So on the CPU the port's plans under ``auto`` are
the reference's TPU plans, not its CPU plans.

``SET SESSION spill_chunk_rows = N`` runs the chunked driver
(exec/chunked.py): the largest scan streams in N-row chunks, from the
fact-column cache on the device, with the dimension LUTs pinned; a
query's second run adapts its packed joins to windowed probes (K2) from
the first run's measured key spans. ``stream_build_min_kb`` streams
Scan/Filter(Scan) build sides above that size through the dense LUT.

Writes are the reference's: CREATE TABLE (and AS SELECT), INSERT, DROP
TABLE, UPDATE, DELETE and MERGE on the memory connector (the CSV,
Parquet and ORC connectors take CREATE, INSERT and DROP), and EXPLAIN of
a write. A write's source query runs on the session's device and comes
back to the host as raw codes (`query_to_columns`); every stored change
makes a new table object and drops the executor's cached scans, fact
columns and decisions (`Executor.invalidate_scan_cache`).
``distributed = true`` swaps in a ``parallel.MeshExecutor`` over every
card of the session's device type (one shard on the CPU), as the
reference swaps in its mesh executor.

``query_max_memory_mb`` bounds each query's pool; a join, aggregation or
sort over it spills partition-wise to host RAM and disk
(``TRINO_TPU_SPILL_DIR``) unless ``spill_enabled`` is false, and then
the query raises ExceededMemoryLimitError. Every statement ends by
flushing the executor's counters into the process metrics registry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..batch import decode_column, Field
from ..catalog import Catalog, default_catalog
from ..planner.logical import OutputNode, explain_text
from ..planner.optimizer import prune_plan
from ..planner.planner import Planner
from ..sql import ast_nodes as A
from ..sql.parser import parse
from ..types import TypeKind
from .executor import Executor


@dataclass
class QueryResult:
    column_names: List[str]
    rows: List[tuple]
    elapsed_s: float = 0.0
    stats: Optional[object] = None

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return len(self.rows)


# session properties (SystemSessionProperties.java:61's role); each entry:
# name -> (default, parser)
def _bool(v):
    return str(v).lower() in ("true", "1")


def _default_query_max_memory_mb() -> int:
    """TRINO_TPU_QUERY_MAX_MEMORY (bytes, B/kB/MB/GB suffixes) overrides
    the 64 GiB per-query default for every session in the process."""
    import os
    env = os.environ.get("TRINO_TPU_QUERY_MAX_MEMORY")
    if env:
        from .memory import parse_bytes
        return max(1, parse_bytes(env) >> 20)
    return 64 << 10


SESSION_PROPERTY_DEFAULTS = {
    "distributed": (False, _bool),
    "query_max_rows": (10_000_000, int),
    # per-query memory limit (memory/MemoryPool reserve path)
    "query_max_memory_mb": (_default_query_max_memory_mb(), int),
    # bounded-memory aggregation chunk size, 0 = off (spill analog)
    "spill_chunk_rows": (0, int),
    # host-spill survival chain (exec/spill.py): joins/aggregations whose
    # working set exceeds the pool retry partition-wise through host
    # RAM/disk instead of failing
    "spill_enabled": (True, _bool),
    "spill_partitions": (8, int),
    # Pallas MXU one-pass aggregation kernel (ops/pallas_agg.py): auto
    # picks it in its measured win region (direct aggregates with
    # G >= Executor.MXU_AGG_MIN_GROUPS on TPU); true/false force
    "mxu_agg": ("auto", lambda v: str(v).lower()),
    # Pallas tiled-gather probe kernel (ops/pallas_gather.py): auto =
    # on for TPU backends; true forces it (interpret mode on CPU, the
    # tier-1 test path); false = jnp.take everywhere
    "enable_pallas_gather": ("auto", lambda v: str(v).lower()),
    # Pallas VMEM hash-table kernel (ops/pallas_hash.py): hash
    # aggregation + hybrid hash join; same auto/true/false contract as
    # the tiled gather (true = interpret mode on CPU, the tier-1 path)
    "enable_pallas_hash": ("auto", lambda v: str(v).lower()),
    # hash-agg table size in slots (0 = size from the group estimate;
    # tests pin it small to exercise the overflow->partition escape)
    "hash_table_slots": (0, int),
    # fused multiway star join (ops/pallas_hash.multiway_probe): the
    # planner's star detector emits MultiJoinNode and the executor
    # probes every dimension table in one Pallas pass; same
    # auto/true/false contract as the other Pallas kernels (true =
    # interpret mode on CPU, the tier-1 path)
    "enable_multiway_join": ("auto", lambda v: str(v).lower()),
    # star-detector cap on fused dimensions per MultiJoinNode
    "multiway_max_dims": (5, int),
    # resident-table VMEM budget for the fused pass, in KiB; dims are
    # shed largest-first to the pairwise ladder until the stack fits
    # (tests pin it tiny to prove the overflow degrade bit-exact)
    "multiway_vmem_kb": (8192, int),
    # planner hash-vs-sort gate: auto applies the rows-per-group rule,
    # force always picks hash for grouped aggregates, off never does
    "hash_agg_mode": ("auto", lambda v: str(v).lower()),
    # auto mode thresholds: hash needs at least this many estimated
    # groups AND at most this many estimated rows per group
    "hash_agg_min_groups": (8192, int),
    "hash_agg_max_rows_per_group": (64, int),
    # dense 'direct' aggregation bound (GroupByHash strategy choice);
    # capped by the kernel's compile-bound MAX_DIRECT_GROUPS
    "direct_agg_max_groups": (64, int),
    # join distribution (SystemSessionProperties JOIN_DISTRIBUTION_TYPE):
    # AUTO picks by estimated build bytes against the threshold
    "join_distribution_type": ("auto", lambda v: str(v).lower()),
    "broadcast_join_threshold_mb": (32, int),
    # wall-clock budget; exceeded -> QueryDeadlineError (QUERY_MAX_RUN_TIME)
    "query_max_run_time_s": (0.0, float),
    # admission-queue budget (query.max-queued-time's role): a query
    # still QUEUED past this is rejected with a retryable
    # QUERY_EXCEEDED_QUEUED_TIME instead of waiting forever (0 = off)
    "query_max_queued_time_s": (0.0, float),
    # build-side min/max pruning of probe scans (ENABLE_DYNAMIC_FILTERING)
    "dynamic_filtering": (True, _bool),
    # escape hatch for the batched mesh filter collectives; the old
    # mid-execution rendezvous deadlock (q77) is gone by construction,
    # this only exists to isolate regressions
    "mesh_dynamic_filtering": (True, _bool),
    # gather-free sort-merge unique join at small shapes (compile-cost
    # gated regardless; this disables it outright)
    "merge_join": (True, _bool),
    # device bytes the scan cache may pin before LRU eviction
    "scan_cache_max_mb": (24 << 10, int),
    # zone-map scan pruning (exec/zonemap.py): skip decoding row ranges
    # the pushed-down predicate provably cannot match. Conservative-only;
    # the residual filter always re-runs, so off is bit-exact with on
    "enable_zone_map_pruning": (True, _bool),
    # zone granularity in rows (split-level pruning quantum)
    "zone_map_rows": (65536, int),
    # chunked-driver prefetch pipeline: how many decoded+staged chunks
    # may run ahead of the device (0 = today's serial loop, exactly)
    "prefetch_depth": (2, int),
    # chunked-driver compile warm: overlap the fused program's XLA compile
    # with chunk-0 decode via a discarded zero-row call (exec/prewarm.py
    # turns this on cluster-wide when TRINO_TPU_PREWARM is set)
    "prewarm_chunks": (False, _bool),
    # distributed runtime knobs (execution/scheduler tier)
    "split_rows": (250_000, int),
    "task_retries": (2, int),
    # distributed write fan-out (0 = one write task per active worker)
    "write_partitions": (0, int),
    # straggler hedging: a task past max(hedge_min_s, hedge_multiplier *
    # median drain time of its round) is speculatively re-dispatched to
    # a survivor; first success wins. multiplier <= 0 disables.
    "hedge_multiplier": (4.0, float),
    "hedge_min_s": (2.0, float),
    # per-query retry/hedge amplification cap: extra task attempts past
    # this fail the query (retries) or are declined (hedges) instead of
    # multiplying load on a struggling cluster
    "task_amplification_budget": (16, int),
    # control-plane retry backoff (server/retrypolicy.py: exponential +
    # decorrelated jitter) between task-retry rounds
    "retry_backoff_base_s": (0.05, float),
    "retry_backoff_max_s": (2.0, float),
    # error instead of silent local fallback when the cluster declines a
    # query (the round-4 verdict's "silently local" complaint)
    "require_distributed": (False, _bool),
    # build sides estimated above this stream chunk-wise through the
    # dense LUT with host-side payload gathers (spill tier v2; 0 = off)
    "stream_build_min_kb": (0, int),
    # distributed tracing (utils/tracing.py): when on, every query runs
    # under a propagating tracer — coordinator + worker spans stitch into
    # one trace served at GET /v1/query/{id}/trace
    "enable_tracing": (False, _bool),
    # device-time profiling (Executor._dispatch_timed): fence every
    # operator dispatch with torch.cuda.synchronize, splitting per-operator
    # wall into device/host/compile components in node_stats / operator
    # metrics / the execute span / EXPLAIN ANALYZE. Costs two device syncs
    # per plan node — forced during (distributed) EXPLAIN ANALYZE
    "enable_profiling": (False, _bool),
    # --- high-concurrency serving layer (server/serving.py) ---
    # logical-plan cache keyed by the normalized-SQL plan fingerprint:
    # repeated statements skip parse/plan entirely
    "enable_plan_cache": (True, _bool),
    # coordinator result cache for FINISHED pages (catalog-version
    # invalidated; volatile/system scans never cache). Opt-in: cached
    # pages skip execution, which fault-injection/chaos runs must see
    "enable_result_cache": (False, _bool),
    # micro-batching: concurrent same-shape point queries coalesce into
    # one dispatch behind a short gather window
    "enable_microbatch": (False, _bool),
    "microbatch_window_ms": (4.0, float),
    # cost-based CPU/TPU co-routing (exec/router.py): auto routes by
    # history baseline + scan-row estimates; host/device force a target
    "routing_mode": ("auto", lambda v: str(v).lower()),
    # auto mode: plans scanning at most this many estimated rows run on
    # the host numpy path (no device dispatch, no exec lock)
    "router_host_max_rows": (200_000, int),
    # auto mode: fingerprints whose history median latency is under this
    # run on the host regardless of the row estimate
    "router_host_latency_ms": (30.0, float),
}


def resolve_device(device=None) -> torch.device:
    """`None` means the card: CUDA must be available. The CPU is taken
    only when the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("trino_tpu_torch: CUDA is not available; "
                               "pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class Session:
    def __init__(self, catalog: Optional[Catalog] = None,
                 default_cat: str = "tpch", default_schema: str = "tiny",
                 device=None):
        self.device = resolve_device(device)
        self.catalog = catalog or default_catalog()
        self.default_cat = default_cat
        self.default_schema = default_schema
        self.executor = Executor(self.catalog, self.device)
        self.properties = {k: v for k, (v, _) in
                           SESSION_PROPERTY_DEFAULTS.items()}
        from ..utils.tracing import NOOP
        self.tracer = NOOP          # swap for utils.tracing.Tracer()

    def planner(self) -> Planner:
        return Planner(self.catalog, self.default_cat, self.default_schema,
                       properties=self.properties)

    def plan(self, sql: str):
        stmt = parse(sql)
        if isinstance(stmt, (A.Query, A.SetOp, A.Values)):
            return stmt, self.planner().plan_query(stmt)
        return stmt, None

    def execute(self, sql: str) -> QueryResult:
        t0 = time.monotonic()
        stmt = parse(sql)
        if isinstance(stmt, (A.Query, A.SetOp, A.Values)):
            return self.execute_query(stmt, t0)
        if isinstance(stmt, A.Explain):
            return self.execute_explain(stmt, t0)
        if isinstance(stmt, (A.ShowTables, A.ShowCatalogs, A.ShowSchemas,
                             A.ShowSession, A.ShowColumns)):
            return self.execute_show(stmt, t0)
        if isinstance(stmt, A.SetSession):
            return self.execute_set_session(stmt, t0)
        if isinstance(stmt, (A.Update, A.Delete, A.MergeInto)):
            return self.execute_dml(stmt, t0)
        if isinstance(stmt, (A.CreateTable, A.DropTable, A.InsertInto)):
            return self.execute_ddl(stmt, t0)
        raise NotImplementedError(type(stmt).__name__)

    def _apply_executor_properties(self, t0: float) -> None:
        """Push session properties into the executor for this query."""
        ex = self.executor
        ex.pool.set_limit(self.properties["query_max_memory_mb"] << 20)
        ex.enable_dynamic_filtering = self.properties["dynamic_filtering"]
        ex.mesh_dynamic_filtering = \
            self.properties["mesh_dynamic_filtering"]
        ex.enable_merge_join = self.properties["merge_join"]
        ex.scan_cache_max_bytes = \
            self.properties["scan_cache_max_mb"] << 20
        ex.enable_zone_map_pruning = \
            self.properties["enable_zone_map_pruning"]
        ex.zone_map_rows = max(1, self.properties["zone_map_rows"])
        ex.enable_spill = self.properties["spill_enabled"]
        ex.spill_partitions = self.properties["spill_partitions"]
        ex.prefetch_depth = max(0, self.properties["prefetch_depth"])
        ex.prewarm_chunks = self.properties["prewarm_chunks"]
        max_s = self.properties["query_max_run_time_s"]
        ex.deadline = (t0 + max_s) if max_s else None
        kb = self.properties["stream_build_min_kb"]
        ex.stream_build_bytes = (kb << 10) if kb else None
        ex.enable_pallas_gather = self.properties["enable_pallas_gather"]
        ex.enable_pallas_hash = self.properties["enable_pallas_hash"]
        ex.hash_table_slots = self.properties["hash_table_slots"]
        ex.enable_multiway_join = self.properties["enable_multiway_join"]
        ex.multiway_max_dims = max(2, self.properties["multiway_max_dims"])
        ex.multiway_vmem_kb = max(1, self.properties["multiway_vmem_kb"])
        ex.enable_mxu_agg = self.properties["mxu_agg"]
        ex.profile = self.properties["enable_profiling"]
        if ex.profile:
            ex.node_stats = {}

    def execute_query(self, stmt, t0) -> QueryResult:
        with self.tracer.span("plan"):
            rel = self.planner().plan_query(stmt)
        root = rel.node
        if not isinstance(root, OutputNode):
            raise TypeError("planner did not return an OutputNode")
        with self.tracer.span("optimize"):
            root = prune_plan(root)
        return self.execute_planned(rel, root, t0)

    def execute_planned(self, rel, root, t0) -> QueryResult:
        """Execute an already planned + pruned query."""
        self._apply_executor_properties(t0)
        with self.tracer.span("execute") as sp:
            batch = self.executor.execute(root)
            names, arrays, valids = self.executor.result_to_host(root,
                                                                 batch)
            if sp is not None and self.executor.profile:
                ns = [v for v in self.executor.node_stats.values()
                      if len(v) >= 5]
                sp.attributes["profiled"] = True
                sp.attributes["deviceMs"] = round(
                    sum(v[2] for v in ns) * 1000, 3)
                sp.attributes["hostMs"] = round(
                    sum(v[3] for v in ns) * 1000, 3)
                sp.attributes["compileMs"] = round(
                    sum(v[4] for v in ns) * 1000, 3)
        with self.tracer.span("decode", rows=len(arrays[0])
                              if arrays else 0):
            rows = self.decode_rows(rel, arrays, valids)
        self.executor.flush_metrics()
        return QueryResult(names, rows, time.monotonic() - t0,
                           self.executor.stats)

    def execute_explain(self, stmt: A.Explain, t0) -> QueryResult:
        planner = self.planner()
        # EXPLAIN over a write statement plans its source query and
        # renders it under TableCommit/TableWriter wrapper nodes
        wstmt = None
        query = stmt.query
        if isinstance(query, (A.InsertInto, A.CreateTable)):
            if getattr(query, "query", None) is None:
                raise ValueError("EXPLAIN of CREATE TABLE without AS "
                                 "SELECT is not supported")
            wstmt = query
            query = query.query
        rel = planner.plan_query(query)
        root = prune_plan(rel.node)

        def estimate(node) -> str:
            try:
                est = planner.estimate_rows(node)
            except Exception:   # noqa: BLE001 — EXPLAIN must never fail
                return ""       # on an estimate
            extra = ""
            from ..planner.logical import JoinNode
            if isinstance(node, JoinNode) and node.distribution != "auto":
                extra = f", {node.distribution.upper()}"
            return f"{{rows: {est:,.0f}{extra}}}"

        annotate = estimate
        self._apply_executor_properties(t0)
        if stmt.analyze and wstmt is not None:
            # ANALYZE of a write really writes; the plan stays
            # estimate-annotated
            wres = self.execute_ddl(wstmt, t0)
            written = wres.rows[0][0] if wres.rows else 0
            text = explain_text(root, annotate=annotate)
            rows = self._write_wrapper(wstmt) + \
                [(f"    {line}",) for line in text.split("\n")]
            rows.append((f"write: 1 partitions, 1 staged, 0 deduped, "
                         f"{written} rows",))
            return QueryResult(["query plan"], rows,
                               time.monotonic() - t0)
        if stmt.analyze:
            saved = self.executor.profile
            self.executor.profile = True
            self.executor.node_stats = {}
            try:
                self.executor.execute(root)
            finally:
                self.executor.profile = saved
            stats = self.executor.node_stats

            def annotate(node):
                s = stats.get(id(node))
                est = estimate(node)
                if s is None:
                    return est
                if len(s) >= 5:
                    # fenced profiling splits the wall into components
                    # (device + host + compile sum to wall exactly)
                    return (f"[{s[0] * 1000:.2f}ms (device "
                            f"{s[2] * 1000:.2f} + host {s[3] * 1000:.2f}"
                            f" + compile {s[4] * 1000:.2f}), "
                            f"{s[1]} rows] {est}")
                return f"[{s[0] * 1000:.2f}ms, {s[1]} rows] {est}"
        text = explain_text(root, annotate=annotate)
        rows = [(line,) for line in text.split("\n")]
        if wstmt is not None:
            rows = self._write_wrapper(wstmt) + \
                [(f"    {r[0]}",) for r in rows]
        from .executor import explain_strategy_lines
        for line in explain_strategy_lines(rel.node, self.executor):
            rows.append((line,))
        if stmt.analyze:
            for op, dec in sorted(self.executor.strategy_decisions.items()):
                if not op.startswith("TableScan["):
                    continue
                kind, _, frac = dec.partition(":")
                pruned, _, total = frac.partition("/")
                unit = "zones" if kind == "zone-pruned" else "chunks"
                rows.append((f"scan {op[10:-1]}: {total} {unit}, "
                             f"{pruned} pruned by zone maps",))
        # the host/device verdict (exec/router.py): what the serving
        # layer would do with this plan, and why
        from .router import decide_route
        dec = decide_route(planner, root, self.properties,
                           history=getattr(self, "history_store", None))
        rows.append((f"routing: {dec.target} ({dec.reason})",))
        return QueryResult(["query plan"], rows, time.monotonic() - t0)

    def execute_show(self, stmt, t0) -> QueryResult:
        el = time.monotonic() - t0
        if isinstance(stmt, A.ShowTables):
            cat = stmt.catalog or self.default_cat
            sch = stmt.schema or self.default_schema
            names = self.catalog.connector(cat).table_names(sch)
            return QueryResult(["table"], [(n,) for n in names], el)
        if isinstance(stmt, A.ShowCatalogs):
            return QueryResult(
                ["catalog"],
                [(n,) for n in sorted(self.catalog._connectors)], el)
        if isinstance(stmt, A.ShowSchemas):
            cat = stmt.catalog or self.default_cat
            names = self.catalog.connector(cat).schema_names()
            return QueryResult(["schema"], [(n,) for n in names], el)
        if isinstance(stmt, A.ShowSession):
            rows = [(k, str(self.properties[k]),
                     str(SESSION_PROPERTY_DEFAULTS[k][0]))
                    for k in sorted(self.properties)]
            return QueryResult(["name", "value", "default"], rows, el)
        cat, sch, tbl = self.resolve_table(stmt.table)
        data = self.catalog.get_table(cat, sch, tbl)
        rows = [(f.name, str(f.dtype)) for f in data.schema]
        return QueryResult(["column", "type"], rows, el)

    def execute_set_session(self, stmt: A.SetSession, t0) -> QueryResult:
        if stmt.name not in SESSION_PROPERTY_DEFAULTS:
            raise KeyError(f"unknown session property {stmt.name!r}")
        _, parser = SESSION_PROPERTY_DEFAULTS[stmt.name]
        raw = getattr(stmt.value, "value", getattr(stmt.value, "text",
                                                   None))
        if raw is None and hasattr(stmt.value, "parts"):
            raw = ".".join(stmt.value.parts)
        self.properties[stmt.name] = parser(raw)
        if stmt.name == "distributed":
            self.set_distributed(self.properties["distributed"])
        elif stmt.name == "query_max_memory_mb":
            self.executor.pool.set_limit(self.properties[stmt.name] << 20)
        elif stmt.name == "spill_chunk_rows":
            self.executor.spill_chunk_rows = \
                self.properties[stmt.name] or None
        elif stmt.name == "enable_tracing":
            from ..utils.tracing import NOOP, Tracer
            self.tracer = Tracer() if self.properties[stmt.name] else NOOP
        return QueryResult(["result"], [("SET SESSION",)],
                           time.monotonic() - t0)

    def set_distributed(self, on: bool) -> None:
        """Swap the executor: the mesh over every card of the session's
        device type (one shard on the CPU; a device with an index names
        its one card), or the single-device one. On the mesh each scan is
        split into one block a card, the per-shard operators run on each
        card and the rest on the first after an all-gather
        (parallel/dist_executor.py)."""
        if on:
            from ..parallel.dist_executor import MeshExecutor
            from ..parallel.mesh import make_mesh
            if not isinstance(self.executor, MeshExecutor):
                self.executor = MeshExecutor(
                    self.catalog, make_mesh(device=self.device))
        elif type(self.executor) is not Executor:
            self.executor = Executor(self.catalog, self.device)

    def resolve_table(self, parts):
        parts = tuple(p.lower() for p in parts)
        if len(parts) == 3:
            return parts
        if len(parts) == 2:
            return self.default_cat, parts[0], parts[1]
        return self.default_cat, self.default_schema, parts[0]

    def _write_wrapper(self, wstmt) -> List[tuple]:
        """EXPLAIN's TableCommit/TableWriter rows over a write's plan."""
        cat, sch, tbl = self.resolve_table(wstmt.table)
        return [(f"TableCommit[{cat}.{sch}.{tbl}]",),
                (f"  TableWriter[{cat}.{sch}.{tbl}]",)]

    def _written(self) -> None:
        """A stored table changed: bump the catalog version and drop every
        cached copy of table data the executor holds."""
        self.catalog.bump_version()
        self.executor.invalidate_scan_cache()

    def execute_ddl(self, stmt, t0) -> QueryResult:
        from ..batch import Schema
        from ..connectors.tpch.datagen import TableData
        from ..planner.analyzer import parse_type

        if isinstance(stmt, A.DropTable):
            cat, sch, tbl = self.resolve_table(stmt.table)
            self.catalog.connector(cat).drop_table(sch, tbl,
                                                   stmt.if_exists)
            self.catalog.bump_version()
            # a fresh executor (no cached scans, builds or decisions) on
            # the session's device; the properties pushed per query reach
            # it on the next statement, the chunk size here
            self.executor = type(self.executor)(self.catalog, self.device)
            self.executor.spill_chunk_rows = \
                self.properties["spill_chunk_rows"] or None
            return QueryResult(["result"], [("DROP TABLE",)],
                               time.monotonic() - t0)

        if isinstance(stmt, A.CreateTable):
            cat, sch, tbl = self.resolve_table(stmt.table)
            conn = self.catalog.connector(cat)
            if stmt.query is not None:     # CTAS
                fields, arrays, valids = self.query_to_columns(stmt.query)
                data = TableData(tbl, Schema(tuple(fields)), arrays,
                                 valids=valids)
                conn.create_table(sch, tbl, data, stmt.if_not_exists)
                self.catalog.bump_version()
                return QueryResult(["rows"], [(data.num_rows,)],
                                   time.monotonic() - t0)
            fields = [Field(name, parse_type(tn))
                      for name, tn in stmt.columns]
            arrays = [np.zeros(0, dtype=f.dtype.np_dtype) for f in fields]
            fields = [Field(f.name, f.dtype, dictionary=()
                            if f.dtype.kind is TypeKind.VARCHAR else None)
                      for f in fields]
            conn.create_table(sch, tbl,
                              TableData(tbl, Schema(tuple(fields)),
                                        arrays),
                              stmt.if_not_exists)
            self.catalog.bump_version()
            return QueryResult(["result"], [("CREATE TABLE",)],
                               time.monotonic() - t0)

        # INSERT INTO
        cat, sch, tbl = self.resolve_table(stmt.table)
        fields, arrays, valids = self.query_to_columns(stmt.query)
        n = self.catalog.connector(cat).insert(sch, tbl, arrays, valids,
                                               fields)
        self._written()
        return QueryResult(["rows"], [(n,)], time.monotonic() - t0)

    # ---- UPDATE / DELETE / MERGE (row-id + delete-mask scheme) ----------

    def _register_shadow(self, conn, sch: str, tbl: str) -> str:
        """Copy of the target with a hidden $rowid column, registered
        under a reserved name: mutations are planned as ordinary queries
        over it (the merge row-change paradigm routes rows by target row
        id, MergeWriterOperator.java)."""
        from ..batch import Schema
        from ..connectors.tpch.datagen import TableData
        from ..types import BIGINT
        t = conn.get_table(sch, tbl)
        cols = list(t.columns) + [np.arange(t.num_rows, dtype=np.int64)]
        valids = None if t.valids is None else list(t.valids) + [None]
        fields = tuple(t.schema.fields) + (Field("$rowid", BIGINT),)
        shadow = f"{tbl}$dml"
        conn.drop_table(sch, shadow, if_exists=True)
        conn.create_table(sch, shadow,
                          TableData(tbl, Schema(fields), cols,
                                    valids=valids))
        return shadow

    def _dml_conn(self, cat: str):
        conn = self.catalog.connector(cat)
        if not hasattr(conn, "delete_rows"):
            from ..planner.analyzer import AnalysisError
            raise AnalysisError(
                f"connector {cat!r} does not support row-level DML")
        return conn

    @staticmethod
    def _sql_type_name(dt) -> str:
        if dt.kind is TypeKind.DECIMAL:
            return f"decimal({dt.precision},{dt.scale})"
        return dt.kind.value

    def _coerced_assignments(self, conn, sch, tbl, assignments):
        """Validate assignment targets and wrap each value in a cast to
        the column's declared type: the stored representation must be
        the target column's, not the expression's (e.g. a scale-1
        decimal literal written to a decimal(10,2) column)."""
        from ..planner.analyzer import AnalysisError
        schema = conn.get_table(sch, tbl).schema
        names = {f.name for f in schema.fields}
        out = []
        for col, expr in assignments:
            if col not in names:
                raise AnalysisError(
                    f"UPDATE target column {col!r} does not exist")
            dt = schema.field(col).dtype
            if dt.kind is not TypeKind.VARCHAR:
                expr = A.CastExpr(expr, self._sql_type_name(dt))
            out.append((col, expr))
        return out

    def execute_dml(self, stmt, t0) -> QueryResult:
        if isinstance(stmt, A.MergeInto):
            return self.execute_merge(stmt, t0)
        cat, sch, tbl = self.resolve_table(stmt.table)
        conn = self._dml_conn(cat)
        assignments = self._coerced_assignments(
            conn, sch, tbl, stmt.assignments) \
            if isinstance(stmt, A.Update) else ()
        shadow = self._register_shadow(conn, sch, tbl)
        try:
            items = [A.SelectItem(A.Identifier(("$rowid",)), "$rowid")]
            if isinstance(stmt, A.Update):
                for j, (_, expr) in enumerate(assignments):
                    items.append(A.SelectItem(expr, f"$v{j}"))
            q = A.Query(select=tuple(items), distinct=False,
                        relation=A.TableRef((cat, sch, shadow),
                                            alias=tbl),
                        where=stmt.where, group_by=(), having=None,
                        order_by=(), limit=None)
            fields, arrays, valids = self.query_to_columns(q)
            ids = np.asarray(arrays[0], dtype=np.int64)
            if isinstance(stmt, A.Delete):
                n = conn.delete_rows(sch, tbl, ids)
            else:
                updates = {col: (arrays[1 + j], valids[1 + j],
                                 fields[1 + j])
                           for j, (col, _) in enumerate(assignments)}
                n = conn.update_rows(sch, tbl, ids, updates)
        finally:
            conn.drop_table(sch, shadow, if_exists=True)
        self._written()
        return QueryResult(["rows"], [(n,)], time.monotonic() - t0)

    def execute_merge(self, stmt: "A.MergeInto", t0) -> QueryResult:
        """MERGE: matched rows route to UPDATE/DELETE, unmatched source
        rows to INSERT, both decided against the table as it was before
        the merge (RowChangeProcessor semantics). Supported shape: at
        most one WHEN MATCHED and one WHEN NOT MATCHED clause."""
        from ..planner.analyzer import AnalysisError
        cat, sch, tbl = self.resolve_table(stmt.target)
        conn = self._dml_conn(cat)
        alias = stmt.target_alias or tbl
        matched = [c for c in stmt.clauses if c.matched]
        unmatched = [c for c in stmt.clauses if not c.matched]
        if len(matched) > 1 or len(unmatched) > 1:
            raise AnalysisError(
                "MERGE supports one WHEN MATCHED and one "
                "WHEN NOT MATCHED clause")
        if unmatched and unmatched[0].action != "insert":
            raise AnalysisError("WHEN NOT MATCHED requires INSERT")
        shadow = self._register_shadow(conn, sch, tbl)
        n = 0
        try:
            tref = A.TableRef((cat, sch, shadow), alias=alias)
            if matched:
                mc = matched[0]
                massign = self._coerced_assignments(
                    conn, sch, tbl, mc.assignments)
                items = [A.SelectItem(A.Identifier((alias, "$rowid")),
                                      "$rowid")]
                for j, (_, expr) in enumerate(massign):
                    items.append(A.SelectItem(expr, f"$v{j}"))
                q = A.Query(select=tuple(items), distinct=False,
                            relation=A.Join("inner", stmt.source, tref,
                                            stmt.on),
                            where=mc.condition, group_by=(),
                            having=None, order_by=(), limit=None)
                fields, arrays, valids = self.query_to_columns(q)
                ids = np.asarray(arrays[0], dtype=np.int64)
                if len(np.unique(ids)) != len(ids):
                    raise RuntimeError(
                        "MERGE: one target row matched more than one "
                        "source row")
                if mc.action == "delete":
                    n += conn.delete_rows(sch, tbl, ids)
                elif mc.action == "update":
                    updates = {col: (arrays[1 + j], valids[1 + j],
                                     fields[1 + j])
                               for j, (col, _) in enumerate(massign)}
                    n += conn.update_rows(sch, tbl, ids, updates)
                else:
                    raise AnalysisError(
                        "WHEN MATCHED requires UPDATE or DELETE")
            if unmatched:
                ic = unmatched[0]
                sub = A.Query(select=(A.SelectItem(A.NumberLit("1"),
                                                   "x"),),
                              distinct=False, relation=tref,
                              where=stmt.on, group_by=(), having=None,
                              order_by=(), limit=None)
                where: A.Node = A.ExistsPredicate(sub, negated=True)
                if ic.condition is not None:
                    where = A.BinaryOp("and", where, ic.condition)
                # coerce each inserted value to its target column type
                tschema = conn.get_table(sch, tbl).schema
                inames = [c.lower() for c in ic.insert_columns] or \
                    [f.name for f in tschema.fields]
                if len(inames) != len(ic.insert_values):
                    raise AnalysisError(
                        "MERGE INSERT column/value count mismatch")
                ivalues = []
                for cname, e in zip(inames, ic.insert_values):
                    if cname not in {f.name for f in tschema.fields}:
                        raise AnalysisError(
                            f"MERGE INSERT column {cname!r} does not "
                            f"exist")
                    dt = tschema.field(cname).dtype
                    if dt.kind is not TypeKind.VARCHAR:
                        e = A.CastExpr(e, self._sql_type_name(dt))
                    ivalues.append(e)
                items = tuple(A.SelectItem(e, f"$c{j}") for j, e in
                              enumerate(ivalues))
                q2 = A.Query(select=items, distinct=False,
                             relation=stmt.source, where=where,
                             group_by=(), having=None, order_by=(),
                             limit=None)
                fields, arrays, valids = self.query_to_columns(q2)
                target = conn.get_table(sch, tbl)
                by_name = dict(zip(inames, range(len(inames))))
                n_ins = len(arrays[0]) if arrays else 0
                full_arrays, full_valids, full_fields = [], [], []
                for f in target.schema.fields:
                    j = by_name.get(f.name)
                    if j is None:     # unmentioned column: NULL
                        full_arrays.append(
                            np.zeros(n_ins, dtype=f.dtype.np_dtype))
                        full_valids.append(
                            np.zeros(n_ins, dtype=np.bool_))
                        full_fields.append(f)
                    else:
                        full_arrays.append(np.asarray(arrays[j]))
                        full_valids.append(valids[j])
                        full_fields.append(fields[j])
                n += conn.insert(sch, tbl, full_arrays, full_valids,
                                 full_fields)
        finally:
            conn.drop_table(sch, shadow, if_exists=True)
        self._written()
        return QueryResult(["rows"], [(n,)], time.monotonic() - t0)

    def query_to_columns(self, query):
        """Run a query on the device and return (fields, host arrays,
        valids): the TableWriterOperator boundary (raw codes, not decoded
        strings)."""
        rel = self.planner().plan_query(query)
        root = prune_plan(rel.node)
        batch = self.executor.execute(root)
        names, arrays, valids = self.executor.result_to_host(root, batch)
        fields = []
        for sc, name in zip(rel.scope.columns, names):
            fld = sc.field if sc.field is not None else Field(name,
                                                              sc.dtype)
            fields.append(Field(name, sc.dtype,
                                dictionary=fld.dictionary))
        return fields, list(arrays), list(valids)

    def decode_rows(self, rel, arrays, valids) -> List[tuple]:
        cols = []
        for sc, arr, val in zip(rel.scope.columns, arrays, valids):
            fld = sc.field if sc.field is not None else Field(
                sc.name, sc.dtype)
            if sc.dtype.kind is TypeKind.VARCHAR and \
                    (fld.dictionary is None):
                raise RuntimeError(
                    f"varchar output {sc.name} lost its dictionary")
            cols.append(decode_column(fld, arr, val))
        return list(zip(*cols)) if cols else []
