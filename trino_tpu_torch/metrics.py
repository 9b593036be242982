"""Port copy of ``trino_tpu/metrics.py`` (no edits): the process registry,
with the reference's metric names, rendered as Prometheus text.

Prometheus-style metrics registry: counters, gauges, histograms.

Reference: Trino exposes its operator/task/query counters through JMX and
the /v1/status + OpenMetrics endpoints (io.airlift.stats counters wired by
ServerMainModule; the openmetrics plugin renders them in Prometheus text
exposition format). Here: one dependency-free registry shared by every
layer — executors, pageserde, scheduler, spool, HTTP servers — rendered as
Prometheus text on `GET /v1/metrics` of both coordinator and worker.

Design constraints:
- hot-path cost is one dict lookup + one float add under a lock (the
  executor increments per plan node, the serde per frame) — no metric may
  force a device sync or an allocation beyond the label-key tuple;
- metrics that acceptance checks scrape (operator rows, scheduler
  retries/hedges, CRC failures) are PRE-INITIALIZED at import so a fresh
  server renders them at 0 instead of omitting them;
- registration is idempotent: re-importing or re-declaring a metric with
  the same name returns the existing instance (kind mismatch raises).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Iterable, Tuple


def _escape(v: object) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n").replace(
        '"', r'\"')


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        # label-value tuple -> float; unlabeled metrics live under ()
        self._values: "OrderedDict[tuple, float]" = OrderedDict()
        if not self.labelnames:
            self._values[()] = 0.0

    def _key(self, labels: Dict[str, object]) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} expects labels {self.labelnames}, "
                f"got {tuple(labels)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def init_labels(self, **labels) -> None:
        """Pre-create a zero-valued sample so the label combination
        renders before its first increment (scrape-surface stability)."""
        key = self._key(labels)
        with self._lock:
            self._values.setdefault(key, 0.0)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def has_sample(self, **labels) -> bool:
        with self._lock:
            return self._key(labels) in self._values

    def _sample_line(self, key: tuple, value: float,
                     suffix: str = "", extra: tuple = ()) -> str:
        pairs = list(zip(self.labelnames, key)) + list(extra)
        labels = ",".join(f'{n}="{_escape(v)}"' for n, v in pairs)
        body = f"{{{labels}}}" if labels else ""
        if value == int(value):
            return f"{self.name}{suffix}{body} {int(value)}"
        return f"{self.name}{suffix}{body} {value}"

    def render(self) -> Iterable[str]:
        with self._lock:
            items = list(self._values.items())
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} {self.kind}"
        for key, value in items:
            yield self._sample_line(key, value)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Histogram(_Metric):
    """Cumulative-bucket histogram (classic Prometheus layout):
    name_bucket{le=...}, name_sum, name_count per label set."""

    kind = "histogram"
    DEFAULT_BUCKETS = (0.005, 0.025, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0)

    def __init__(self, name, help, labelnames, lock, buckets=None):
        super().__init__(name, help, labelnames, lock)
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._values.pop((), None)       # histograms use structured slots
        self._hists: Dict[tuple, list] = {}
        if not self.labelnames:
            self._hists[()] = [0] * (len(self.buckets) + 2)

    def init_labels(self, **labels) -> None:
        """Pre-create a zeroed histogram for the label combination so it
        renders (buckets/count/sum at 0) before the first observe."""
        key = self._key(labels)
        with self._lock:
            self._hists.setdefault(key, [0] * (len(self.buckets) + 2))

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = [0] * (len(self.buckets) + 2)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    h[i] += 1
            h[-2] += 1                   # count
            h[-1] += value               # sum

    def value(self, **labels) -> float:  # count, for test symmetry
        with self._lock:
            h = self._hists.get(self._key(labels))
            return h[-2] if h else 0.0

    def has_sample(self, **labels) -> bool:
        with self._lock:
            return self._key(labels) in self._hists

    def render(self) -> Iterable[str]:
        with self._lock:
            items = [(k, list(h)) for k, h in self._hists.items()]
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} {self.kind}"
        for key, h in items:
            for i, b in enumerate(self.buckets):
                yield self._sample_line(key, h[i], suffix="_bucket",
                                        extra=(("le", b),))
            yield self._sample_line(key, h[-2], suffix="_bucket",
                                    extra=(("le", "+Inf"),))
            yield self._sample_line(key, h[-1], suffix="_sum")
            yield self._sample_line(key, h[-2], suffix="_count")


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "OrderedDict[str, _Metric]" = OrderedDict()

    def _register(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls:
                    raise ValueError(
                        f"metric {name} already registered as {m.kind}")
                return m
            m = cls(name, help, tuple(labelnames),
                    threading.Lock(), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name) -> _Metric:
        with self._lock:
            return self._metrics[name]

    def render(self) -> str:
        """Full registry in Prometheus text exposition format."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[tuple, float]:
        """{(name, label-values...): value} — bench/test delta helper."""
        out = {}
        with self._lock:
            metrics = list(self._metrics.items())
        for name, m in metrics:
            if isinstance(m, Histogram):
                with m._lock:
                    for k, h in m._hists.items():
                        out[(name,) + k] = h[-2]
            else:
                with m._lock:
                    for k, v in m._values.items():
                        out[(name,) + k] = v
        return out


# ---------------------------------------------------------------------------
# the process-global registry plus the engine's metric families. In a real
# multi-host deployment each process (coordinator or worker) has its own;
# the in-process test cluster shares one, which is also what the shared
# jitted-kernel executor implies.
# ---------------------------------------------------------------------------

REGISTRY = MetricsRegistry()

# HTTP surface (both servers route through their ROUTES table)
HTTP_REQUESTS = REGISTRY.counter(
    "trino_tpu_http_requests_total",
    "HTTP requests served, by server role and route",
    ("server", "route"))

# query lifecycle (coordinator dispatcher)
QUERIES = REGISTRY.counter(
    "trino_tpu_queries_total", "Queries reaching a terminal state",
    ("state",))
QUERY_SECONDS = REGISTRY.histogram(
    "trino_tpu_query_seconds", "End-to-end query wall time (seconds)")

# executor operators (exec/executor.py — per plan-node dispatch)
OPERATOR_DISPATCHES = REGISTRY.counter(
    "trino_tpu_operator_dispatch_total",
    "Plan-node kernel dispatches, by operator", ("operator",))
OPERATOR_WALL_MS = REGISTRY.counter(
    "trino_tpu_operator_wall_ms_total",
    "Host wall-clock spent dispatching each operator (ms; async device "
    "work overlaps unless profiling)", ("operator",))
OPERATOR_ROWS = REGISTRY.counter(
    "trino_tpu_operator_rows_total",
    "Rows flowing through instrumented operators", ("operator",))
EXEC_EVENTS = REGISTRY.counter(
    "trino_tpu_exec_events_total",
    "Executor adaptive-path events mirrored from ExecStats", ("event",))

# worker task output (server/tasks.py)
TASK_OUTPUT_ROWS = REGISTRY.counter(
    "trino_tpu_task_output_rows_total",
    "Rows emitted into worker task output buffers")
TASK_OUTPUT_BYTES = REGISTRY.counter(
    "trino_tpu_task_output_bytes_total",
    "Encoded page-frame bytes emitted into worker task output buffers")

# device-resident fact cache (exec/device_cache.py)
DEVICE_CACHE_HITS = REGISTRY.counter(
    "trino_tpu_device_cache_hits_total",
    "Fact-table device cache hits")
DEVICE_CACHE_MISSES = REGISTRY.counter(
    "trino_tpu_device_cache_misses_total",
    "Fact-table device cache misses (narrow + ingest paid)")

# scheduler (server/scheduler.py)
SCHED_TASKS = REGISTRY.counter(
    "trino_tpu_sched_tasks_total", "Remote tasks dispatched to workers")
SCHED_TASK_RETRIES = REGISTRY.counter(
    "trino_tpu_sched_task_retries_total",
    "Task-retry rounds (failed splits reassigned to survivors)")
SCHED_HEDGES = REGISTRY.counter(
    "trino_tpu_sched_hedges_total",
    "Speculative straggler re-dispatches fired")
SCHED_HEDGE_WINS = REGISTRY.counter(
    "trino_tpu_sched_hedge_wins_total",
    "Hedged attempts that beat the original task")

# page serde integrity (server/pageserde.py)
PAGE_CRC_FAILURES = REGISTRY.counter(
    "trino_tpu_pageserde_crc_failures_total",
    "Page frames rejected by the CRC32C integrity gate")

# control-plane retries (server/retrypolicy.py)
RETRY_ATTEMPTS = REGISTRY.counter(
    "trino_tpu_retry_attempts_total",
    "RetryPolicy re-attempts after a retryable failure", ("component",))

# durable exchange spool (server/exchange_spool.py)
SPOOL_HITS = REGISTRY.counter(
    "trino_tpu_spool_hits_total",
    "Exchange-spool reads satisfied from a prior attempt's output")
SPOOL_MISSES = REGISTRY.counter(
    "trino_tpu_spool_misses_total",
    "Exchange-spool reads that missed (work dispatched live)")

# memory arbitration (exec/memory.py, exec/spill.py, server/memorymanager.py)
MEMORY_RESERVED = REGISTRY.gauge(
    "trino_tpu_memory_reserved_bytes",
    "User memory reserved against each pool", ("pool",))
MEMORY_REVOCABLE = REGISTRY.gauge(
    "trino_tpu_memory_revocable_bytes",
    "Revocable (spillable) memory reserved against each pool", ("pool",))
MEMORY_REVOCATIONS = REGISTRY.counter(
    "trino_tpu_memory_revocations_total",
    "Revocation requests driven by memory pressure (spill triggers)")
MEMORY_ACCOUNTING_ERRORS = REGISTRY.counter(
    "trino_tpu_memory_accounting_errors_total",
    "Reservation double-frees / leaks detected by the pool ledger")
SPILL_BYTES = REGISTRY.counter(
    "trino_tpu_spill_bytes_total",
    "Bytes spilled to the host/disk tier by joins and aggregations")
SPILL_PARTITIONS = REGISTRY.counter(
    "trino_tpu_spill_partitions_total",
    "Radix partitions written by the spill layer")
SPILL_RETRIES = REGISTRY.counter(
    "trino_tpu_spill_retries_total",
    "Spill container write/verify failures recovered from host RAM")
QUERIES_KILLED_OOM = REGISTRY.counter(
    "trino_tpu_queries_killed_oom_total",
    "Queries killed by the cluster LowMemoryKiller")
BACKPRESSURE_WAITS = REGISTRY.counter(
    "trino_tpu_exchange_backpressure_waits_total",
    "Producer pauses because a task output buffer hit its byte bound")

# JIT-compile observability (exec/profiler.py): every jit site routes
# through the compile recorder, which mirrors into these families
JIT_COMPILES = REGISTRY.counter(
    "trino_tpu_jit_compiles_total",
    "Fresh XLA compiles detected at instrumented jit sites", ("site",))
JIT_CACHE_HITS = REGISTRY.counter(
    "trino_tpu_jit_cache_hits_total",
    "Instrumented jit-site calls served by an already-compiled program",
    ("site",))
JIT_COMPILE_SECONDS = REGISTRY.histogram(
    "trino_tpu_jit_compile_seconds",
    "Trace+compile wall per fresh XLA compile (seconds)")

# device-time attribution (profiled dispatches: enable_profiling /
# EXPLAIN ANALYZE fence each operator, splitting wall into components)
OPERATOR_DEVICE_MS = REGISTRY.counter(
    "trino_tpu_operator_device_ms_total",
    "Fenced device-execution time per operator (ms; profiled runs only)",
    ("operator",))
OPERATOR_COMPILE_MS = REGISTRY.counter(
    "trino_tpu_operator_compile_ms_total",
    "Compile time attributed to each operator's dispatch (ms; profiled "
    "runs only)", ("operator",))

# high-concurrency serving layer (server/serving.py, exec/router.py)
PLAN_CACHE_HITS = REGISTRY.counter(
    "trino_tpu_plan_cache_hits_total",
    "Statements served a cached logical plan (parse/plan skipped)")
PLAN_CACHE_MISSES = REGISTRY.counter(
    "trino_tpu_plan_cache_misses_total",
    "Plan-cache lookups that planned fresh")
PLAN_CACHE_EVICTIONS = REGISTRY.counter(
    "trino_tpu_plan_cache_evictions_total",
    "Plan-cache entries evicted by the LRU/byte cap")
RESULT_CACHE_HITS = REGISTRY.counter(
    "trino_tpu_result_cache_hits_total",
    "Queries answered from the coordinator result cache")
RESULT_CACHE_MISSES = REGISTRY.counter(
    "trino_tpu_result_cache_misses_total",
    "Result-cache lookups that executed fresh")
RESULT_CACHE_INVALIDATIONS = REGISTRY.counter(
    "trino_tpu_result_cache_invalidations_total",
    "Cached pages dropped because the catalog version moved (DDL/write)")
ROUTER_DECISIONS = REGISTRY.counter(
    "trino_tpu_router_decisions_total",
    "Cost-router execution-target decisions", ("target",))
MICROBATCH_QUERIES = REGISTRY.counter(
    "trino_tpu_microbatch_queries_total",
    "Point queries coalesced into micro-batched dispatches")
MICROBATCH_BATCHES = REGISTRY.counter(
    "trino_tpu_microbatch_batches_total",
    "Micro-batch gather windows flushed as one dispatch")

# per-operator strategy decisions (exec/executor.py gate: hash vs sort
# vs direct aggregation, dense-LUT vs hybrid-hash vs merge joins)
AGG_STRATEGY_DECISIONS = REGISTRY.counter(
    "trino_tpu_agg_strategy_decisions_total",
    "Aggregation strategy picked per operator execution", ("strategy",))
JOIN_STRATEGY_DECISIONS = REGISTRY.counter(
    "trino_tpu_join_strategy_decisions_total",
    "Join strategy picked per operator execution", ("strategy",))

# mesh join distribution (parallel/dist_executor.py gate: replicate the
# build over the mesh vs hash-repartition both sides) and the batched
# dynamic-filter / repartition data plane it rides on
JOIN_DISTRIBUTION_DECISIONS = REGISTRY.counter(
    "trino_tpu_join_distribution_decisions_total",
    "Join distribution picked per mesh join execution", ("mode",))
DYNAMIC_FILTER_ROWS_PRUNED = REGISTRY.counter(
    "trino_tpu_dynamic_filter_rows_pruned_total",
    "Probe rows pruned by build-side dynamic-filter bounds before the "
    "join ran")
MESH_REPARTITION_BYTES = REGISTRY.counter(
    "trino_tpu_mesh_repartition_bytes_total",
    "Bytes moved through all_to_all repartition exchanges by "
    "mesh-partitioned joins")

# scan-path acceleration (exec/zonemap.py + exec/chunked.py prefetch):
# zone-map split/zone pruning and the double-buffered chunk pipeline
SCAN_SPLITS_PRUNED = REGISTRY.counter(
    "trino_tpu_scan_splits_pruned_total",
    "Row-range splits dropped by zone-map pruning before dispatch "
    "(server/scheduler.py)")
SCAN_ZONES_PRUNED = REGISTRY.counter(
    "trino_tpu_scan_zones_pruned_total",
    "Zone-map row ranges skipped at scan materialization "
    "(exec/zonemap.py)")
SCAN_PREFETCH_BUFFERS = REGISTRY.gauge(
    "trino_tpu_scan_prefetch_buffers_in_use",
    "Decoded+staged chunks currently held by the chunked-driver "
    "prefetch pipeline (revocable reservations)")
SCAN_PREFETCH_STALL_SECONDS = REGISTRY.counter(
    "trino_tpu_scan_prefetch_stall_seconds",
    "Seconds the chunked-driver consumer spent waiting on a chunk the "
    "prefetch worker had not staged yet")

# elastic cluster membership (server/worker.py lifecycle state machine,
# server/coordinator.py announce protocol, server/scheduler.py drain
# handoff) + per-tenant serving (server/resourcegroups.py tenant tree,
# exec/router.py fair share) + the sustained soak harness (bench --soak)
NODE_LIFECYCLE_TRANSITIONS = REGISTRY.counter(
    "trino_tpu_node_lifecycle_transitions_total",
    "Worker lifecycle transitions observed by the coordinator's node "
    "inventory, by the state entered (ACTIVE | DRAINING | DRAINED | "
    "LEFT | FAILED)", ("state",))
SPLITS_MIGRATED = REGISTRY.counter(
    "trino_tpu_splits_migrated_total",
    "Splits handed off a DRAINING node and reassigned to survivors — "
    "counted as migrations, never as task-retry failures")
TENANT_QUERIES = REGISTRY.counter(
    "trino_tpu_tenant_queries_total",
    "Queries reaching a terminal state, by resource-group tenant",
    ("tenant",))
SOAK_SLO_VIOLATIONS = REGISTRY.counter(
    "trino_tpu_soak_slo_violations_total",
    "Per-tenant p99 SLO violations observed by the sustained-soak "
    "harness (bench.py --soak)")

# cold-start elimination (exec/prewarm.py + exec/profiler.py): AOT
# pre-warming of historical plan shapes, canonicalized-shape compile
# reuse, and the compile-aware host routing window
PREWARM_COMPILES = REGISTRY.counter(
    "trino_tpu_prewarm_compiles_total",
    "Programs compiled off the query path by the prewarm engine "
    "(historical fingerprints + staged chunk shapes)")
PREWARM_HITS = REGISTRY.counter(
    "trino_tpu_prewarm_hits_total",
    "Query-path jit calls served by a program the prewarm engine had "
    "already compiled")
COMPILE_SECONDS_SAVED = REGISTRY.counter(
    "trino_tpu_compile_seconds_saved_total",
    "Estimated query-path compile seconds avoided by prewarm hits "
    "(the off-path compile wall of each program, counted once per hit)")
JIT_DISTINCT_SHAPES = REGISTRY.gauge(
    "trino_tpu_jit_distinct_shapes",
    "Distinct (fingerprint) program shapes recorded per jit site — the "
    "shape-canonicalization regression signal", ("site",))

# fused multiway star join (ops/pallas_hash.py multiway_probe +
# exec/executor.py run_multijoin): one Pallas pass probing every
# VMEM-resident dimension table, degrading dim-by-dim to the ladder
MULTIJOIN_FUSED_PROBES = REGISTRY.counter(
    "trino_tpu_multijoin_fused_probes_total",
    "Fused multiway probe kernel launches (one per fact chunk that "
    "probed >= 2 resident dimension tables in a single pass)")
MULTIJOIN_DEGRADES = REGISTRY.counter(
    "trino_tpu_multijoin_degrades_total",
    "Dimension hops evicted from the fused star probe back to the "
    "pairwise ladder, by reason", ("reason",))

# query history + latency-regression detection (server/history.py)
LATENCY_REGRESSIONS = REGISTRY.counter(
    "trino_tpu_query_latency_regressions_total",
    "Completed queries flagged as regressed vs their per-fingerprint "
    "baseline (median + MAD)")
HISTORY_RECORDS = REGISTRY.counter(
    "trino_tpu_query_history_records_total",
    "Completed-query records appended to the query history store")

# exactly-once distributed writes (server/writeprotocol.py): staged
# attempt files, manifest dedup, journal commit, orphan sweeps
WRITE_TASKS = REGISTRY.counter(
    "trino_tpu_write_tasks_total",
    "Staged write attempts produced (one per attempt file written to a "
    "table's .staging directory)")
WRITE_ATTEMPTS_DEDUPED = REGISTRY.counter(
    "trino_tpu_write_attempts_deduped_total",
    "Duplicate write attempts dropped by (stage, partition) "
    "first-success-wins manifest dedup at commit")
WRITE_COMMITS = REGISTRY.counter(
    "trino_tpu_write_commits_total",
    "Write commit-protocol outcomes", ("outcome",))
WRITE_ORPHANS_SWEPT = REGISTRY.counter(
    "trino_tpu_write_orphans_swept_total",
    "Orphaned staging files / journals removed by abort and "
    "startup-recovery sweeps")

# critical-path wall-time attribution (server/timeline.py) + the cluster
# flight recorder (server/telemetry.py): per-query phase timelines and
# the bounded delta-encoded metric ring each node samples into
TIMELINE_QUERIES = REGISTRY.counter(
    "trino_tpu_timeline_queries_total",
    "Completed queries whose wall time was attributed into phase "
    "intervals by the critical-path analyzer")
CRITICAL_PATH_SECONDS = REGISTRY.counter(
    "trino_tpu_critical_path_seconds",
    "Attributed query wall seconds, by timeline phase (sums to total "
    "query wall across phases)", ("phase",))
TELEMETRY_SAMPLES = REGISTRY.counter(
    "trino_tpu_telemetry_samples_total",
    "Flight-recorder samples taken of the process metrics registry")
TELEMETRY_RING_EVICTIONS = REGISTRY.counter(
    "trino_tpu_telemetry_ring_evictions_total",
    "Flight-recorder samples evicted to hold the ring under its byte "
    "bound")
TENANT_QUERY_SECONDS = REGISTRY.histogram(
    "trino_tpu_tenant_query_seconds",
    "End-to-end query wall time by resource-group tenant — the "
    "flight-recorder series behind the soak's p99-over-time SLO gate",
    ("tenant",),
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
             15.0, 60.0))

# coordinator crash recovery (server/ledger.py): durable query ledger,
# warm-standby promotion, client-transparent query resumption
COORDINATOR_FAILOVERS = REGISTRY.counter(
    "trino_tpu_coordinator_failovers_total",
    "Coordinator promotions completed (a standby or restarted node "
    "claimed the ledger epoch and began accepting traffic)")
LEDGER_RECORDS = REGISTRY.counter(
    "trino_tpu_ledger_records_total",
    "Records appended to the durable query ledger, by record kind",
    ("kind",))
LEDGER_BYTES = REGISTRY.gauge(
    "trino_tpu_ledger_bytes",
    "Current size of the durable query ledger file")
QUERIES_RESUMED = REGISTRY.counter(
    "trino_tpu_queries_resumed_total",
    "Queries reconstructed from the ledger after a coordinator "
    "restart/failover, by resumption mode: replayed (pre-execution "
    "states re-run from admission), reattached (spooled/surviving task "
    "output reused), reexecuted (re-run from scratch; writes dedup "
    "through the commit journal)", ("mode",))

# live query observability (server/livestats.py): streaming task-stat
# heartbeats, stuck-query diagnosis, host/device busy-fraction gauges
TASK_HEARTBEATS = REGISTRY.counter(
    "trino_tpu_task_heartbeats_total",
    "Incremental live task-stat pushes (announce-piggybacked heartbeat "
    "payloads sent by workers)")
LIVE_STATS_BYTES = REGISTRY.counter(
    "trino_tpu_live_stats_bytes_total",
    "Encoded bytes of delta-encoded live task stats shipped on the "
    "heartbeat path")
STUCK_QUERIES_DIAGNOSED = REGISTRY.counter(
    "trino_tpu_stuck_queries_diagnosed_total",
    "Running queries whose live stats stopped advancing for the stuck "
    "threshold and received an automatic structured diagnosis")
NODE_BUSY_FRACTION = REGISTRY.gauge(
    "trino_tpu_node_busy_fraction",
    "Per-node busy fraction over the last heartbeat interval, by tier: "
    "device (dispatch wall / wall) and host (interpreter wall / wall) "
    "— the flight recorder samples this into system.runtime.utilization",
    ("tier",))
NODE_BUSY_MS = REGISTRY.counter(
    "trino_tpu_node_busy_ms_total",
    "Cumulative busy milliseconds by tier — the counter form of the "
    "busy-fraction gauge; per-interval deltas of this (what the flight "
    "recorder records) give the utilization series BENCH_soak emits",
    ("tier",))

# query-lifetime enforcement (deadlines, cancellation propagation,
# orphan reaping, overload admission control): coordinator-stamped
# deadlines ride every task dispatch, terminate() fans cancellation out
# to every assigned worker, workers abandon tasks their coordinator
# forgot, and overload degrades to fast rejection
QUERIES_DEADLINE_EXCEEDED = REGISTRY.counter(
    "trino_tpu_queries_deadline_exceeded_total",
    "Queries terminated because their coordinator-stamped deadline "
    "(query_max_run_time_s) expired — surfaced to clients as "
    "QUERY_EXCEEDED_RUN_TIME")
QUERIES_REJECTED = REGISTRY.counter(
    "trino_tpu_queries_rejected_total",
    "Queries rejected before execution by admission control, by reason: "
    "queue_full (resource-group queue bound), queued_deadline "
    "(query_max_queued_time_s expired while QUEUED), load_shed "
    "(coordinator overload gate)", ("reason",))
TASKS_ABANDONED = REGISTRY.counter(
    "trino_tpu_tasks_abandoned_total",
    "Worker tasks abandoned by the orphan reaper (no coordinator "
    "status pull or heartbeat ack referenced them within "
    "task_abandonment_timeout_s) — buffers and pool reservations freed")
CANCEL_PROPAGATIONS = REGISTRY.counter(
    "trino_tpu_cancel_propagations_total",
    "terminate() fan-outs run by the coordinator, by trigger: user "
    "(client DELETE), deadline, queued_deadline, oom (low-memory "
    "killer), stuck (diagnoser escalation)", ("reason",))
RETRY_BUDGET_EXHAUSTED = REGISTRY.counter(
    "trino_tpu_retry_budget_exhausted_total",
    "Queries failed because their per-query retry/hedge amplification "
    "budget ran out — the anti-retry-storm valve under sustained chaos")
MICROBATCH_FOLLOWER_TIMEOUTS = REGISTRY.counter(
    "trino_tpu_microbatch_follower_timeouts_total",
    "Micro-batch followers that stopped waiting on their window leader "
    "(leader dead/slow, query canceled, or deadline expired) and "
    "degraded to an individual run")
BACKPRESSURE_DEADLINE_DEGRADES = REGISTRY.counter(
    "trino_tpu_backpressure_deadline_degrades_total",
    "Exchange backpressure waits that hit their (deadline-capped) "
    "bound and degraded to unbounded buffering — logged with the "
    "owning query so the silent 300 s degrade is observable")

# the labeled families acceptance scrapes: seed the hot label values so
# a cold server's /v1/metrics already carries them at 0
for _op in ("scan", "output"):
    OPERATOR_ROWS.init_labels(operator=_op)
RETRY_ATTEMPTS.init_labels(component="announce")
MEMORY_RESERVED.init_labels(pool="general")
MEMORY_REVOCABLE.init_labels(pool="general")
for _site in ("exec.fused_chunk", "exec.slice_widen"):
    JIT_COMPILES.init_labels(site=_site)
    JIT_CACHE_HITS.init_labels(site=_site)
    JIT_DISTINCT_SHAPES.init_labels(site=_site)
for _op in ("ScanNode", "JoinNode", "AggregateNode"):
    OPERATOR_DEVICE_MS.init_labels(operator=_op)
    OPERATOR_COMPILE_MS.init_labels(operator=_op)
for _target in ("host", "device"):
    ROUTER_DECISIONS.init_labels(target=_target)
for _s in ("global", "direct", "mxu", "sort", "hash"):
    AGG_STRATEGY_DECISIONS.init_labels(strategy=_s)
for _s in ("dense-lut", "hybrid-hash", "sort-merge", "sorted", "expand",
           "multiway", "ladder"):
    JOIN_STRATEGY_DECISIONS.init_labels(strategy=_s)
for _r in ("kernel_off", "vmem", "dup", "escape", "dtype", "mesh",
           "spill"):
    MULTIJOIN_DEGRADES.init_labels(reason=_r)
for _m in ("broadcast", "partitioned"):
    JOIN_DISTRIBUTION_DECISIONS.init_labels(mode=_m)
for _ls in ("ACTIVE", "DRAINING", "DRAINED", "LEFT", "FAILED"):
    NODE_LIFECYCLE_TRANSITIONS.init_labels(state=_ls)
TENANT_QUERIES.init_labels(tenant="default")
for _o in ("committed", "aborted"):
    WRITE_COMMITS.init_labels(outcome=_o)
# kept in sync with server/timeline.py PHASES (asserted in tier-1)
for _p in ("queued", "plan", "schedule", "exchange-wait", "device",
           "host", "compile", "spill", "retry", "write-commit", "other"):
    CRITICAL_PATH_SECONDS.init_labels(phase=_p)
TENANT_QUERY_SECONDS.init_labels(tenant="default")
for _k in ("admit", "state", "assign", "spool", "terminal", "catalog",
           "promote"):
    LEDGER_RECORDS.init_labels(kind=_k)
for _m in ("replayed", "reattached", "reexecuted"):
    QUERIES_RESUMED.init_labels(mode=_m)
for _t in ("device", "host"):
    NODE_BUSY_FRACTION.init_labels(tier=_t)
    NODE_BUSY_MS.init_labels(tier=_t)
for _r in ("queue_full", "queued_deadline", "load_shed"):
    QUERIES_REJECTED.init_labels(reason=_r)
for _r in ("user", "deadline", "queued_deadline", "oom", "stuck"):
    CANCEL_PROPAGATIONS.init_labels(reason=_r)
