"""System connector: runtime tables queryable via SQL.

Port of ``trino_tpu/server/system_connector.py``: the `system` catalog's
``runtime`` tables backed by the coordinator's live state (queries,
nodes, tasks, operator_stats, resource_groups, jit_cache, query_history,
plan_cache, query_timeline, metrics_history, live_queries,
utilization). ``jit_cache`` reads the port's compile recorder
(exec/profiler.py: the kernel-library loads). A node's device bytes come
from its heartbeat, which reads ``device_memory_stats`` on its card;
``nodes`` and ``tasks`` list the announced workers and their tasks.
"""

from __future__ import annotations

import numpy as np

from ..batch import Field, Schema
from ..catalog import _strings_table
from ..connectors.tpch.datagen import TableData
from ..types import BIGINT, DOUBLE


class SystemConnector:
    name = "system"

    def __init__(self, coordinator_state=None):
        self.state = coordinator_state

    def schema_names(self):
        return ["runtime"]

    def table_names(self, schema: str):
        if schema == "runtime":
            return ["queries", "nodes", "tasks", "operator_stats",
                    "resource_groups", "jit_cache", "query_history",
                    "plan_cache", "query_timeline", "metrics_history",
                    "live_queries", "utilization"]
        return []

    def get_table(self, schema: str, table: str) -> TableData:
        if schema != "runtime":
            raise KeyError(f"system schema {schema!r} not found")
        if table == "queries":
            return self._queries_table()
        if table == "nodes":
            return self._nodes_table()
        if table == "tasks":
            return self._tasks_table()
        if table == "operator_stats":
            return self._operator_stats_table()
        if table == "resource_groups":
            return self._resource_groups_table()
        if table == "jit_cache":
            return self._jit_cache_table()
        if table == "query_history":
            return self._query_history_table()
        if table == "plan_cache":
            return self._plan_cache_table()
        if table == "query_timeline":
            return self._query_timeline_table()
        if table == "metrics_history":
            return self._metrics_history_table()
        if table == "live_queries":
            return self._live_queries_table()
        if table == "utilization":
            return self._utilization_table()
        raise KeyError(f"system table {table!r} not found")

    def _scheduler(self):
        return getattr(self.state, "scheduler", None) if self.state \
            else None

    def _livestats(self):
        return getattr(self.state, "livestats", None) if self.state \
            else None

    def _queries_table(self) -> TableData:
        queries = self.state.tracker.all() if self.state else []
        ids = [q.query_id for q in queries]
        states = [q.state for q in queries]
        users = [q.session_user for q in queries]
        sqls = [q.sql[:200] for q in queries]
        base = _strings_table("queries",
                              [("query_id", ids), ("state", states),
                               ("user", users), ("query", sqls)])
        elapsed = np.array([q.elapsed_s for q in queries],
                           dtype=np.float64)
        rows = np.array([q.rows_returned for q in queries],
                        dtype=np.int64)
        return TableData(
            "queries",
            Schema(base.schema.fields +
                   (Field("elapsed_seconds", DOUBLE),
                    Field("rows", BIGINT))),
            base.columns + [elapsed, rows])

    def _nodes_table(self) -> TableData:
        """Node inventory + each worker's last heartbeat-reported memory
        pool and live device/HBM allocator stats (zeros until the first
        heartbeat lands)."""
        nodes = list(self.state.nodes.values()) if self.state else []
        base = _strings_table(
            "nodes",
            [("node_id", [n.node_id for n in nodes]),
             ("http_uri", [n.uri for n in nodes]),
             ("state", [n.state for n in nodes])])
        mem = [getattr(n, "memory", None) or {} for n in nodes]
        dev = [getattr(n, "device", None) or {} for n in nodes]
        reserved = np.array([int(m.get("reserved", 0)) for m in mem],
                            dtype=np.int64)
        revocable = np.array([int(m.get("revocable", 0)) for m in mem],
                             dtype=np.int64)
        in_use = np.array([int(d.get("bytesInUse", 0)) for d in dev],
                          dtype=np.int64)
        limit = np.array([int(d.get("bytesLimit", 0)) for d in dev],
                         dtype=np.int64)
        peak = np.array([int(d.get("peakBytesInUse", 0)) for d in dev],
                        dtype=np.int64)
        return TableData(
            "nodes",
            Schema(base.schema.fields +
                   (Field("reserved_bytes", BIGINT),
                    Field("revocable_bytes", BIGINT),
                    Field("device_bytes_in_use", BIGINT),
                    Field("device_bytes_limit", BIGINT),
                    Field("device_peak_bytes", BIGINT))),
            base.columns + [reserved, revocable, in_use, limit, peak])

    def _tasks_table(self) -> TableData:
        """Recent remote tasks with their merged TaskStats (the
        system.runtime.tasks view of the reference). Live records from
        the heartbeat fold (server/livestats.py) lead the view, so
        in-flight tasks are queryable BEFORE their terminal stats are
        drained back — the reference's tasks view is live the same way."""
        sched = self._scheduler()
        recs = list(sched.task_history) if sched is not None else []
        ls = self._livestats()
        if ls is not None:
            seen = {r["task_id"] for r in recs}
            live = [{"query_id": r.get("query_id") or "",
                     "task_id": r["task_id"], "node": r.get("node", ""),
                     "stage": r.get("stage", ""),
                     "state": r.get("state", ""),
                     "splits": int(r.get("splits_done", 0)),
                     "rows": int(r.get("rows", 0)),
                     "bytes": int(r.get("bytes", 0)),
                     "wall_ms": float(r.get("wall_ms", 0.0))}
                    for r in ls.live_tasks()
                    if r["task_id"] not in seen]
            recs = live + recs
        base = _strings_table(
            "tasks",
            [("query_id", [r["query_id"] for r in recs]),
             ("task_id", [r["task_id"] for r in recs]),
             ("node_id", [r["node"] for r in recs]),
             ("stage", [r["stage"] for r in recs]),
             ("state", [r["state"] for r in recs])])
        splits = np.array([r["splits"] for r in recs], dtype=np.int64)
        rows = np.array([r["rows"] for r in recs], dtype=np.int64)
        byts = np.array([r["bytes"] for r in recs], dtype=np.int64)
        wall = np.array([r["wall_ms"] for r in recs], dtype=np.float64)
        return TableData(
            "tasks",
            Schema(base.schema.fields +
                   (Field("splits", BIGINT), Field("rows", BIGINT),
                    Field("bytes", BIGINT), Field("wall_ms", DOUBLE))),
            base.columns + [splits, rows, byts, wall])

    def _resource_groups_table(self) -> TableData:
        """Live admission state per group — concurrency, queue depth,
        queue-wait totals, and the memory-aware admission fields
        (system.runtime view of resourcegroups.ResourceGroupManager)."""
        rgm = getattr(getattr(self.state, "dispatcher", None),
                      "resource_groups", None) if self.state else None
        recs = rgm.info() if rgm is not None else []
        base = _strings_table(
            "resource_groups",
            [("group_name", [r["group"] for r in recs])])
        running = np.array([r["running"] for r in recs], dtype=np.int64)
        queued = np.array([r["queued"] for r in recs], dtype=np.int64)
        limit = np.array([r["hardConcurrencyLimit"] for r in recs],
                         dtype=np.int64)
        admitted = np.array([r["totalAdmitted"] for r in recs],
                            dtype=np.int64)
        soft = np.array([r["softMemoryLimitBytes"] or 0 for r in recs],
                        dtype=np.int64)
        mem = np.array([r["memoryUsageBytes"] for r in recs],
                       dtype=np.int64)
        wait = np.array([r["totalQueueWaitSeconds"] for r in recs],
                        dtype=np.float64)
        return TableData(
            "resource_groups",
            Schema(base.schema.fields +
                   (Field("running", BIGINT), Field("queued", BIGINT),
                    Field("hard_concurrency_limit", BIGINT),
                    Field("total_admitted", BIGINT),
                    Field("soft_memory_limit_bytes", BIGINT),
                    Field("memory_usage_bytes", BIGINT),
                    Field("total_queue_wait_seconds", DOUBLE))),
            base.columns + [running, queued, limit, admitted, soft, mem,
                            wait])

    def _operator_stats_table(self) -> TableData:
        """Per-(query, operator) rollup from worker TaskStats — the
        operator half of the OperatorStats pyramid, queryable like the
        reference's optimizer_rule_stats/operator views. Profiled runs
        (EXPLAIN ANALYZE / enable_profiling) carry the fenced
        device/host/compile wall split; unprofiled rows read 0."""
        sched = self._scheduler()
        recs = list(sched.operator_history) if sched is not None else []
        base = _strings_table(
            "operator_stats",
            [("query_id", [r["query_id"] for r in recs]),
             ("operator", [r["operator"] for r in recs]),
             ("strategy", [r.get("strategy", "") for r in recs]),
             ("distribution", [r.get("distribution", "")
                               for r in recs])])
        rows = np.array([r["rows"] for r in recs], dtype=np.int64)
        wall = np.array([r["wall_ms"] for r in recs], dtype=np.float64)
        calls = np.array([r["calls"] for r in recs], dtype=np.int64)
        device = np.array([r.get("device_ms", 0.0) for r in recs],
                          dtype=np.float64)
        host = np.array([r.get("host_ms", 0.0) for r in recs],
                        dtype=np.float64)
        compile_ = np.array([r.get("compile_ms", 0.0) for r in recs],
                            dtype=np.float64)
        return TableData(
            "operator_stats",
            Schema(base.schema.fields +
                   (Field("rows", BIGINT), Field("wall_ms", DOUBLE),
                    Field("calls", BIGINT),
                    Field("device_ms", DOUBLE),
                    Field("host_ms", DOUBLE),
                    Field("compile_ms", DOUBLE))),
            base.columns + [rows, wall, calls, device, host, compile_])

    def _jit_cache_table(self) -> TableData:
        """The process compile recorder's per-(site, fingerprint)
        aggregates (exec/profiler.py) — the SQL twin of GET /v1/jit."""
        from ..exec.profiler import RECORDER
        recs = RECORDER.snapshot()
        base = _strings_table(
            "jit_cache",
            [("site", [r["site"] for r in recs]),
             ("fingerprint", [r["fingerprint"] for r in recs])])
        compiles = np.array([r["compiles"] for r in recs],
                            dtype=np.int64)
        hits = np.array([r["hits"] for r in recs], dtype=np.int64)
        total_ms = np.array([r["compile_ms"] for r in recs],
                            dtype=np.float64)
        last_ms = np.array([r["last_compile_ms"] for r in recs],
                           dtype=np.float64)
        prewarmed = np.array([int(bool(r.get("prewarmed"))) for r in recs],
                             dtype=np.int64)
        prewarm_hits = np.array([int(r.get("prewarm_hits", 0))
                                 for r in recs], dtype=np.int64)
        return TableData(
            "jit_cache",
            Schema(base.schema.fields +
                   (Field("compiles", BIGINT),
                    Field("cache_hits", BIGINT),
                    Field("compile_ms", DOUBLE),
                    Field("last_compile_ms", DOUBLE),
                    Field("prewarmed", BIGINT),
                    Field("prewarm_hits", BIGINT))),
            base.columns + [compiles, hits, total_ms, last_ms,
                            prewarmed, prewarm_hits])

    def _plan_cache_table(self) -> TableData:
        """The serving layer's logical-plan cache (server/serving.py):
        one row per cached plan with its fingerprint, hit count, and
        byte-cap weight — the SQL twin of the plan-cache metrics."""
        serving = getattr(getattr(self.state, "dispatcher", None),
                          "serving", None) if self.state else None
        recs = serving.plan_cache.snapshot() if serving is not None \
            else []
        base = _strings_table(
            "plan_cache",
            [("fingerprint", [r["fingerprint"] for r in recs]),
             ("query", [r["sql"] for r in recs])])
        hits = np.array([r["hits"] for r in recs], dtype=np.int64)
        weight = np.array([r["weight_bytes"] for r in recs],
                          dtype=np.int64)
        point = np.array([int(r["point_shape"]) for r in recs],
                         dtype=np.int64)
        cacheable = np.array([int(r["cacheable"]) for r in recs],
                             dtype=np.int64)
        return TableData(
            "plan_cache",
            Schema(base.schema.fields +
                   (Field("hits", BIGINT),
                    Field("weight_bytes", BIGINT),
                    Field("point_shape", BIGINT),
                    Field("result_cacheable", BIGINT))),
            base.columns + [hits, weight, point, cacheable])

    def _query_timeline_table(self) -> TableData:
        """Per-(query, phase) wall attribution from the critical-path
        analyzer (server/timeline.py) — one row per phase per tracked
        query, phases summing exactly to elapsed wall, plus the
        dominant phase label repeated on each row for easy filtering."""
        from .timeline import PHASES, build_timeline
        queries = self.state.tracker.all() if self.state else []
        rows = []
        for q in queries:
            tl = q.timeline
            if tl is None and q.state_machine.is_done():
                try:
                    tl = build_timeline(q)
                except Exception:  # noqa: BLE001 — view is best-effort
                    tl = None
            if tl is None:
                continue
            for ph in PHASES:
                rows.append((q.query_id, ph, tl["phases"].get(ph, 0.0),
                             tl["dominant"], tl["wall_s"],
                             tl["criticalPathSeconds"]))
        base = _strings_table(
            "query_timeline",
            [("query_id", [r[0] for r in rows]),
             ("phase", [r[1] for r in rows]),
             ("dominant", [r[3] for r in rows])])
        seconds = np.array([r[2] for r in rows], dtype=np.float64)
        wall = np.array([r[4] for r in rows], dtype=np.float64)
        cp = np.array([r[5] for r in rows], dtype=np.float64)
        return TableData(
            "query_timeline",
            Schema(base.schema.fields +
                   (Field("seconds", DOUBLE),
                    Field("wall_seconds", DOUBLE),
                    Field("critical_path_seconds", DOUBLE))),
            base.columns + [seconds, wall, cp])

    def _metrics_history_table(self) -> TableData:
        """The cluster flight recorder's federated time series
        (server/telemetry.py) — one row per (timestamp, node, metric)
        sample. Reading the table triggers a collection round so the
        view is current even without the background federation thread."""
        tel = getattr(self.state, "telemetry", None) if self.state \
            else None
        recs = []
        if tel is not None:
            try:
                tel.collect()
            except Exception:  # noqa: BLE001 — scrape is best-effort
                pass
            recs = tel.rows()
        base = _strings_table(
            "metrics_history",
            [("node_id", [r[1] for r in recs]),
             ("metric", [r[2] for r in recs])])
        ts = np.array([r[0] for r in recs], dtype=np.float64)
        value = np.array([r[3] for r in recs], dtype=np.float64)
        return TableData(
            "metrics_history",
            Schema(base.schema.fields +
                   (Field("ts", DOUBLE), Field("value", DOUBLE))),
            base.columns + [ts, value])

    def _live_queries_table(self) -> TableData:
        """In-flight query summaries from the live-stats fold
        (server/livestats.py): split-weighted progress, per-stage task
        and split counts, and the stuck-query diagnosis — the SQL twin
        of the web UI's live cluster overview."""
        ls = self._livestats()
        recs = ls.live_queries() if ls is not None else []
        base = _strings_table(
            "live_queries",
            [("query_id", [r["query_id"] for r in recs]),
             ("state", [r["state"] for r in recs]),
             ("stuck_stage", [r["diagnosis"] for r in recs])])
        progress = np.array([r["progress"] for r in recs],
                            dtype=np.float64)
        stages = np.array([r["stages"] for r in recs], dtype=np.int64)
        tasks = np.array([r["tasks"] for r in recs], dtype=np.int64)
        tasks_done = np.array([r["tasks_done"] for r in recs],
                              dtype=np.int64)
        splits_done = np.array([r["splits_done"] for r in recs],
                               dtype=np.int64)
        splits_total = np.array([r["splits_total"] for r in recs],
                                dtype=np.int64)
        rows = np.array([r["rows"] for r in recs], dtype=np.int64)
        byts = np.array([r["bytes"] for r in recs], dtype=np.int64)
        stuck = np.array([int(r["stuck"]) for r in recs],
                         dtype=np.int64)
        return TableData(
            "live_queries",
            Schema(base.schema.fields +
                   (Field("progress", DOUBLE),
                    Field("stages", BIGINT), Field("tasks", BIGINT),
                    Field("tasks_done", BIGINT),
                    Field("splits_done", BIGINT),
                    Field("splits_total", BIGINT),
                    Field("rows", BIGINT), Field("bytes", BIGINT),
                    Field("stuck", BIGINT))),
            base.columns + [progress, stages, tasks, tasks_done,
                            splits_done, splits_total, rows, byts,
                            stuck])

    def _utilization_table(self) -> TableData:
        """Per-(node, tier) busy fractions from worker heartbeats
        (server/livestats.py): how much of each node's recent wall the
        device and host tiers spent doing split work."""
        ls = self._livestats()
        recs = ls.utilization() if ls is not None else []
        base = _strings_table(
            "utilization",
            [("node_id", [r["node_id"] for r in recs]),
             ("tier", [r["tier"] for r in recs])])
        frac = np.array([r["busy_fraction"] for r in recs],
                        dtype=np.float64)
        busy_ms = np.array([r["busy_ms"] for r in recs],
                           dtype=np.float64)
        ts = np.array([r["ts"] for r in recs], dtype=np.float64)
        return TableData(
            "utilization",
            Schema(base.schema.fields +
                   (Field("busy_fraction", DOUBLE),
                    Field("busy_ms", DOUBLE), Field("ts", DOUBLE))),
            base.columns + [frac, busy_ms, ts])

    def _query_history_table(self) -> TableData:
        """The coordinator's persistent completed-query ring
        (server/history.py) — latency/bytes/spill records per plan
        fingerprint with the detector's regression verdicts."""
        store = getattr(self.state, "history", None) if self.state \
            else None
        recs = store.snapshot() if store is not None else []
        # prewarm ranking surface: the same (rank, score) the AOT warm
        # pass orders fingerprints by (history.top_fingerprints)
        ranked = store.top_fingerprints(len(recs) or 1) \
            if store is not None else []
        rank_by_fp = {e["fingerprint"]: (i + 1, e["score"])
                      for i, e in enumerate(ranked)}
        base = _strings_table(
            "query_history",
            [("query_id", [r.get("query_id", "") for r in recs]),
             ("fingerprint", [r.get("fingerprint", "") for r in recs]),
             ("state", [r.get("state", "") for r in recs]),
             ("user", [r.get("user", "") for r in recs])])
        elapsed = np.array([float(r.get("elapsed_s", 0) or 0)
                            for r in recs], dtype=np.float64)
        rows = np.array([int(r.get("rows", 0) or 0) for r in recs],
                        dtype=np.int64)
        shuffled = np.array([int(r.get("bytes_shuffled", 0) or 0)
                             for r in recs], dtype=np.int64)
        spills = np.array([int(r.get("spills", 0) or 0) for r in recs],
                          dtype=np.int64)
        regressed = np.array([int(bool(r.get("regressed")))
                              for r in recs], dtype=np.int64)
        prewarm_rank = np.array(
            [rank_by_fp.get(r.get("fingerprint", ""), (0, 0.0))[0]
             for r in recs], dtype=np.int64)
        prewarm_score = np.array(
            [rank_by_fp.get(r.get("fingerprint", ""), (0, 0.0))[1]
             for r in recs], dtype=np.float64)
        return TableData(
            "query_history",
            Schema(base.schema.fields +
                   (Field("elapsed_seconds", DOUBLE),
                    Field("rows", BIGINT),
                    Field("bytes_shuffled", BIGINT),
                    Field("spills", BIGINT),
                    Field("regressed", BIGINT),
                    Field("prewarm_rank", BIGINT),
                    Field("prewarm_score", DOUBLE))),
            base.columns + [elapsed, rows, shuffled, spills, regressed,
                            prewarm_rank, prewarm_score])
