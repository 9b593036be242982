"""Session: the user-facing entry — SQL text in, rows out, on torch.

Counterpart of ``trino_tpu/exec/session.py`` (DispatchManager ->
SqlQueryExecution collapsed to parse -> plan -> execute -> decode). The
session properties keep the reference's names and defaults; the planner,
optimizer and parser are this package's copies of the reference's, so
both packages build the same plan for the same SQL.

``Session(device=None)`` runs on ``cuda`` and raises when CUDA is missing,
unless the caller passes ``device="cpu"`` (the CPU tests do). There is no
silent CPU path.

Kernel settings in this slice: ``enable_pallas_gather`` (K1) and
``enable_pallas_hash`` (K3) resolve ``auto`` to on, as on the TPU, and
``false`` takes each call site's non-kernel path. ``enable_multiway_join``
(K4) and ``mxu_agg`` (K5) resolve to off whatever their setting: those
kernels are not ported yet (ROADMAP). ``spill_chunk_rows`` must stay 0,
``distributed`` false, and DDL/DML are not ported: each raises
NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from ..batch import decode_column, Field
from ..catalog import Catalog, default_catalog
from ..planner.logical import OutputNode, explain_text
from ..planner.optimizer import prune_plan
from ..planner.planner import Planner
from ..sql import ast_nodes as A
from ..sql.parser import parse
from ..types import TypeKind
from .executor import Executor, _not_ported


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
    # device-time profiling (exec/profiler.py): fence every operator
    # dispatch with block_until_ready, splitting per-operator wall into
    # device/host/compile components in ExecStats / operator metrics /
    # EXPLAIN ANALYZE. Costs a device sync per plan node — forced
    # automatically during (distributed) EXPLAIN ANALYZE
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
        raise _not_ported(type(stmt).__name__, "DDL and DML")

    def _apply_executor_properties(self, t0: float) -> None:
        """Push session properties into the executor for this query."""
        if self.properties["distributed"]:
            raise _not_ported("distributed=true",
                              "the mesh tier on torch.distributed")
        ex = self.executor
        ex.pool.set_limit(self.properties["query_max_memory_mb"] << 20)
        ex.enable_dynamic_filtering = self.properties["dynamic_filtering"]
        ex.enable_merge_join = self.properties["merge_join"]
        ex.scan_cache_max_bytes = \
            self.properties["scan_cache_max_mb"] << 20
        ex.enable_zone_map_pruning = \
            self.properties["enable_zone_map_pruning"]
        ex.zone_map_rows = max(1, self.properties["zone_map_rows"])
        max_s = self.properties["query_max_run_time_s"]
        ex.deadline = (t0 + max_s) if max_s else None
        kb = self.properties["stream_build_min_kb"]
        ex.stream_build_bytes = (kb << 10) if kb else None
        ex.spill_chunk_rows = self.properties["spill_chunk_rows"] or None
        ex.enable_pallas_gather = self.properties["enable_pallas_gather"]
        ex.enable_pallas_hash = self.properties["enable_pallas_hash"]
        ex.hash_table_slots = self.properties["hash_table_slots"]
        ex.enable_multiway_join = self.properties["enable_multiway_join"]
        ex.multiway_max_dims = max(2, self.properties["multiway_max_dims"])
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
        with self.tracer.span("execute"):
            batch = self.executor.execute(root)
            names, arrays, valids = self.executor.result_to_host(root,
                                                                 batch)
        with self.tracer.span("decode", rows=len(arrays[0])
                              if arrays else 0):
            rows = self.decode_rows(rel, arrays, valids)
        return QueryResult(names, rows, time.monotonic() - t0,
                           self.executor.stats)

    def execute_explain(self, stmt: A.Explain, t0) -> QueryResult:
        planner = self.planner()
        if isinstance(stmt.query, (A.InsertInto, A.CreateTable)):
            raise _not_ported("EXPLAIN of a write", "DDL and DML")
        rel = planner.plan_query(stmt.query)
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
                return f"[{s[0] * 1000:.2f}ms, {s[1]} rows] {est}"
        text = explain_text(root, annotate=annotate)
        rows = [(line,) for line in text.split("\n")]
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
        elif stmt.name == "enable_tracing":
            from ..utils.tracing import NOOP, Tracer
            self.tracer = Tracer() if self.properties[stmt.name] else NOOP
        return QueryResult(["result"], [("SET SESSION",)],
                           time.monotonic() - t0)

    def set_distributed(self, on: bool) -> None:
        if on:
            raise _not_ported("distributed=true",
                              "the mesh tier on torch.distributed")

    def resolve_table(self, parts):
        parts = tuple(p.lower() for p in parts)
        if len(parts) == 3:
            return parts
        if len(parts) == 2:
            return self.default_cat, parts[0], parts[1]
        return self.default_cat, self.default_schema, parts[0]

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
