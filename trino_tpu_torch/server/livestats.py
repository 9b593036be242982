"""Port copy of ``trino_tpu/server/livestats.py`` (no edits).

Live query stats: the coordinator's fold of streamed TaskStats.

Reference: the reference engine's coordinator continuously polls task
status (ContinuousTaskStatusFetcher) and folds the streams into live
QueryStats — progress bars, stuck-task detection and the Web UI's stage
view all read that fold, never the workers. Here the stream direction is
inverted to fit the announce path: workers PUSH bounded, delta-encoded
live TaskStats piggybacked on their announce heartbeats
(WorkerServer._heartbeat_payload), and this store folds them into:

- a per-query, per-stage live rollup (`/v1/query/{id}` stageStats,
  `system.runtime.tasks` and `system.runtime.live_queries` mid-flight);
- a split-weighted progress estimator (monotonic per query, forced to
  1.0 by the protocol layer at FINISHED) surfaced through the client
  protocol's stats pages and rendered by the CLI `--progress` line;
- a stuck/skew diagnoser: a query whose live counters stop advancing
  for `stuck_after` consecutive heartbeat folds gets one structured
  diagnosis (stage, task, node, timeline phase, max/median split-time
  skew) attached to its TrackedQuery and a slow-query-style log line;
  the same skew evidence feeds the scheduler's hedging decision
  (StageScheduler._drain_units) so stragglers hedge on LIVE data
  instead of terminal-drain medians;
- per-node host/device utilization snapshots federated as
  `system.runtime.utilization`.

Zero overhead when off: the store only changes state inside fold(), and
fold() only runs when a heartbeat arrives — no heartbeat interval, no
folds, no threads, nothing. Task registration (register_task at the
scheduler's launch sites) is a dict insert.
"""

from __future__ import annotations

import logging
import statistics
import threading
import time
from typing import Dict, List, Optional, Set

log = logging.getLogger("trino_tpu.livestats")

# live records are bounded: finished queries past this cap are evicted
# oldest-first together with their task records
MAX_FINISHED_QUERIES = 64

# a RUNNING task must have held its current work at least this long
# before pace skew can flag it for hedging — sub-ms stage medians on
# tiny queries would otherwise flag healthy tasks that merely sit
# between two heartbeats
STRAGGLER_MIN_WALL_MS = 250.0


def _split_frac(rec: dict) -> float:
    total = rec.get("splits_total") or 0
    if total <= 0:
        # exchange consumers / writers carry no splits: done-or-not
        return 1.0 if rec.get("state") in ("FINISHED",) else 0.0
    return min(1.0, rec.get("splits_done", 0) / total)


def _phase_guess(rec: dict) -> str:
    """Which timeline phase (server/timeline.py PHASES) a live task is
    most plausibly stuck in, from its so-far tier attribution."""
    dev = rec.get("device_ms", 0.0)
    host = rec.get("host_ms", 0.0)
    comp = rec.get("compile_ms", 0.0)
    if comp > dev and comp > host:
        return "compile"
    if dev > 0 and dev >= host:
        return "device"
    if host > 0:
        return "host"
    # running but never finished a split and no tier time folded yet:
    # it is waiting on inputs, the exchange-wait phase
    return "exchange-wait"


class LiveStatsStore:
    """Coordinator-side fold of heartbeat-streamed live TaskStats."""

    def __init__(self, tracked_lookup=None, stuck_after: int = 5):
        self._lock = threading.Lock()
        # task_id -> live record {query_id, task_id, stage, node, state,
        # splits_done, splits_total, rows, bytes, wall_ms, device_ms,
        # host_ms, compile_ms, updated}
        self._tasks: Dict[str, dict] = {}
        # query_id -> {task_ids, high_water, advance_sig, stale_folds,
        # diagnosed, done, started, diagnosis}
        self._queries: Dict[str, dict] = {}
        # node_id -> {device, host, busy_device_ms, busy_host_ms, ts}
        self._nodes: Dict[str, dict] = {}
        self._finished_order: List[str] = []
        # TrackedQuery lookup (CoordinatorState wires tracker.get) for
        # attaching diagnoses and reading live states
        self.tracked_lookup = tracked_lookup
        # heartbeat folds without counter advance before a running
        # query is diagnosed as stuck
        self.stuck_after = max(1, int(stuck_after))
        self.folds = 0                    # observability counter
        # stuck-query escalation: after a diagnosed query stays stalled
        # this many MORE folds, it is terminated through the hook below
        # (reason="stuck"). 0 disables — diagnosis stays report-only.
        import os
        try:
            self.escalate_after = int(os.environ.get(
                "TRINO_TPU_STUCK_ESCALATE_FOLDS", "0"))
        except ValueError:
            self.escalate_after = 0
        # terminate(query_id, reason=..., message=...) — CoordinatorState
        # wires the dispatcher's single termination path here
        self.terminate = None

    # -- registration (scheduler launch sites + failover reattach) --------

    def begin(self, query_id: Optional[str]) -> None:
        if not query_id:
            return
        with self._lock:
            self._queries.setdefault(query_id, {
                "task_ids": set(), "high_water": 0.0,
                "advance_sig": None, "stale_folds": 0,
                "diagnosed": False, "done": False,
                "started": time.time(), "diagnosis": None})

    def register_task(self, query_id: Optional[str], task_id: str,
                      stage: str = "", node: str = "",
                      splits_total: Optional[int] = None) -> None:
        """Attribute `task_id` to a query/stage. Called beside the
        scheduler's ledger-assign at every task launch, and by failover
        reattachment with only the (query, task) pair — the worker's
        next heartbeat fills in the counters (entries carry
        splitsTotal), which is how a promoted coordinator re-derives
        progress for reattached queries."""
        if not query_id:
            return
        with self._lock:
            q = self._queries.setdefault(query_id, {
                "task_ids": set(), "high_water": 0.0,
                "advance_sig": None, "stale_folds": 0,
                "diagnosed": False, "done": False,
                "started": time.time(), "diagnosis": None})
            q["task_ids"].add(task_id)
            rec = self._tasks.setdefault(task_id, {
                "query_id": query_id, "task_id": task_id,
                "stage": stage, "node": node, "state": "PENDING",
                "splits_done": 0, "splits_total": splits_total,
                "rows": 0, "bytes": 0, "wall_ms": 0.0,
                "device_ms": 0.0, "host_ms": 0.0, "compile_ms": 0.0,
                "updated": 0.0})
            rec["query_id"] = query_id
            if stage:
                rec["stage"] = stage
            if node:
                rec["node"] = node
            if splits_total is not None:
                rec["splits_total"] = splits_total

    def finish(self, query_id: Optional[str]) -> None:
        """Terminal-rollup hook (scheduler finalize): the query's live
        view is complete; clamp progress and schedule eviction."""
        if not query_id:
            return
        with self._lock:
            q = self._queries.get(query_id)
            if q is None or q["done"]:
                return
            q["done"] = True
            q["high_water"] = 1.0
            self._finished_order.append(query_id)
            while len(self._finished_order) > MAX_FINISHED_QUERIES:
                old = self._finished_order.pop(0)
                dead = self._queries.pop(old, None)
                for tid in (dead or {}).get("task_ids", ()):
                    self._tasks.pop(tid, None)

    # -- the heartbeat fold ------------------------------------------------

    def fold(self, node_id: str, payload: Optional[dict],
             now: Optional[float] = None) -> None:
        """Merge one worker's heartbeat: absolute-valued entries for
        every task that changed since the worker's cursor, plus the
        node's utilization snapshot. Idempotent — replayed deltas fold
        to the same state."""
        if not payload:
            return
        now = time.time() if now is None else now
        diagnoses = []
        escalations = []
        with self._lock:
            self.folds += 1
            util = payload.get("utilization") or {}
            busy = payload.get("busy") or {}
            self._nodes[node_id] = {
                "device": float(util.get("device", 0.0)),
                "host": float(util.get("host", 0.0)),
                "busy_device_ms": float(busy.get("deviceMs", 0.0)),
                "busy_host_ms": float(busy.get("hostMs", 0.0)),
                "ts": now}
            touched: Set[str] = set()
            for e in payload.get("tasks", ()):
                tid = e.get("taskId")
                if not tid:
                    continue
                rec = self._tasks.get(tid)
                if rec is None:
                    # heartbeat beat the registration (or an untracked
                    # task): hold it unattributed; a later
                    # register_task adopts it into its query
                    rec = self._tasks[tid] = {
                        "query_id": None, "task_id": tid, "stage": "",
                        "node": node_id, "state": "PENDING",
                        "splits_done": 0, "splits_total": None,
                        "rows": 0, "bytes": 0, "wall_ms": 0.0,
                        "device_ms": 0.0, "host_ms": 0.0,
                        "compile_ms": 0.0, "updated": 0.0}
                rec["node"] = node_id
                rec["state"] = e.get("state", rec["state"])
                rec["splits_done"] = int(e.get("splitsDone", 0))
                if int(e.get("splitsTotal", 0) or 0) > 0:
                    rec["splits_total"] = int(e["splitsTotal"])
                rec["rows"] = int(e.get("rowsOut", 0))
                rec["bytes"] = int(e.get("bytesOut", 0))
                rec["wall_ms"] = float(e.get("wallMs", 0.0))
                rec["device_ms"] = float(e.get("deviceMs", 0.0))
                rec["host_ms"] = float(e.get("hostMs", 0.0))
                rec["compile_ms"] = float(e.get("compileMs", 0.0))
                rec["updated"] = now
                if rec["query_id"]:
                    touched.add(rec["query_id"])
            # advance/stall bookkeeping: only queries with live work on
            # THIS node get their stale counter bumped by its heartbeat
            for qid, q in self._queries.items():
                if q["done"]:
                    continue
                recs = [self._tasks[t] for t in q["task_ids"]
                        if t in self._tasks]
                if not any(r["node"] == node_id and
                           r["state"] in ("PENDING", "RUNNING")
                           for r in recs):
                    continue
                sig = (sum(r["splits_done"] for r in recs),
                       sum(r["rows"] for r in recs),
                       sum(r["bytes"] for r in recs),
                       tuple(sorted(r["state"] for r in recs)))
                if sig != q["advance_sig"]:
                    q["advance_sig"] = sig
                    q["stale_folds"] = 0
                    q["diagnosed"] = False
                    continue
                q["stale_folds"] += 1
                if q["stale_folds"] >= self.stuck_after and \
                        not q["diagnosed"]:
                    d = self._diagnose_locked(qid, q, recs)
                    if d is not None:
                        q["diagnosed"] = True
                        q["diagnosis"] = d
                        diagnoses.append(d)
                if self.escalate_after > 0 and q["diagnosed"] and \
                        not q.get("escalated") and q["stale_folds"] >= \
                        self.stuck_after + self.escalate_after:
                    q["escalated"] = True
                    escalations.append((qid, q["stale_folds"]))
        # attach + log OUTSIDE the lock (tracked_lookup takes the
        # tracker's lock; the log handler may block)
        for d in diagnoses:
            self._publish_diagnosis(d)
        for qid, stale in escalations:
            if self.terminate is None:
                continue
            try:
                self.terminate(
                    qid, reason="stuck",
                    message="Query terminated by the stuck-query "
                            f"escalator: live stats stalled for {stale} "
                            "consecutive heartbeats past diagnosis")
            except Exception:  # noqa: BLE001 — escalation must not
                pass           # fail the heartbeat fold

    def _diagnose_locked(self, qid: str, q: dict,
                         recs: List[dict]) -> Optional[dict]:
        live = [r for r in recs if r["state"] in ("PENDING", "RUNNING")]
        if not live:
            return None
        # the suspect: split-holding producers outrank splitless waiters
        # (a consumer in exchange-wait is stalled BECAUSE its upstream
        # is), then least split progress, longest wall among ties
        suspect = min(live, key=lambda r: (
            0 if (r.get("splits_total") or 0) > 0 else 1,
            _split_frac(r), -r.get("wall_ms", 0.0)))
        # split-time skew across the suspect's stage peers
        peers = [r for r in recs if r["stage"] == suspect["stage"]
                 and r.get("splits_done", 0) > 0
                 and r.get("wall_ms", 0.0) > 0]
        ratio = 0.0
        if peers:
            avgs = [r["wall_ms"] / r["splits_done"] for r in peers]
            med = statistics.median(avgs)
            if med > 0:
                ratio = round(max(avgs) / med, 3)
        return {"queryId": qid, "stage": suspect["stage"] or "?",
                "taskId": suspect["task_id"],
                "node": suspect.get("node", ""),
                "phase": _phase_guess(suspect),
                "skewRatio": ratio,
                "staleHeartbeats": q["stale_folds"],
                "progress": round(q["high_water"], 4),
                "ts": time.time()}

    def _publish_diagnosis(self, d: dict) -> None:
        from ..metrics import STUCK_QUERIES_DIAGNOSED
        STUCK_QUERIES_DIAGNOSED.inc()
        tq = self.tracked_lookup(d["queryId"]) \
            if self.tracked_lookup else None
        if tq is not None:
            tq.live_diagnosis = d
        from ..utils.log import query_context
        log.warning(
            "%sstuck query: live stats stalled for %d heartbeats — "
            "stage %s task %s on %s, likely phase %s, split-time skew "
            "%.2fx, progress %.1f%%",
            query_context(d["queryId"]), d["staleHeartbeats"],
            d["stage"], d["taskId"], d["node"] or "?", d["phase"],
            d["skewRatio"], 100 * d["progress"])

    # -- progress ----------------------------------------------------------

    def progress(self, query_id: Optional[str]) -> Optional[float]:
        """Split-weighted progress in [0, 1], monotonic per query (the
        high-water clamp): Σ splits_done / Σ splits_total over the
        query's registered tasks; tasks without splits (exchange
        consumers, writers) weigh one split each, done at FINISHED.
        None for queries this store never saw."""
        if not query_id:
            return None
        with self._lock:
            q = self._queries.get(query_id)
            if q is None:
                return None
            if q["done"]:
                return 1.0
            recs = [self._tasks[t] for t in q["task_ids"]
                    if t in self._tasks]
            done = total = 0.0
            for r in recs:
                w = max(1, r.get("splits_total") or 1)
                total += w
                done += w * _split_frac(r)
            ratio = (done / total) if total > 0 else 0.0
            q["high_water"] = max(q["high_water"], min(ratio, 1.0))
            return round(q["high_water"], 6)

    def dominant_stage(self, query_id: Optional[str]) -> str:
        """The stage currently holding the most incomplete split work —
        the 'where is this query right now' label beside the progress
        ratio (and the OOM post-mortem's dominant stage)."""
        if not query_id:
            return ""
        with self._lock:
            q = self._queries.get(query_id)
            if q is None:
                return ""
            recs = [dict(self._tasks[t]) for t in q["task_ids"]
                    if t in self._tasks]
        live = [r for r in recs
                if r["state"] in ("PENDING", "RUNNING")] or recs
        if not live:
            return ""
        by_stage: Dict[str, List[dict]] = {}
        for r in live:
            by_stage.setdefault(r["stage"] or "?", []).append(r)

        def remaining(rs: List[dict]) -> float:
            return sum((r.get("splits_total") or 1) *
                       (1.0 - _split_frac(r)) for r in rs)

        return max(sorted(by_stage.items()),
                   key=lambda kv: remaining(kv[1]))[0]

    # -- read surfaces -----------------------------------------------------

    def query_rollup(self, query_id: Optional[str]) -> Optional[dict]:
        """Live per-stage rollup for /v1/query stageStats: {stages:
        {stage: {tasks, tasks_done, splits_done, splits_total, rows,
        bytes, device_ms, host_ms}}, tasks, progress, diagnosis}."""
        if not query_id:
            return None
        with self._lock:
            q = self._queries.get(query_id)
            if q is None:
                return None
            recs = [dict(self._tasks[t]) for t in q["task_ids"]
                    if t in self._tasks]
            diagnosis = q["diagnosis"]
        stages: Dict[str, dict] = {}
        for r in recs:
            st = stages.setdefault(r["stage"] or "?", {
                "tasks": 0, "tasks_done": 0, "splits_done": 0,
                "splits_total": 0, "rows": 0, "bytes": 0,
                "device_ms": 0.0, "host_ms": 0.0})
            st["tasks"] += 1
            if r["state"] in ("FINISHED", "FAILED", "CANCELED"):
                st["tasks_done"] += 1
            st["splits_done"] += r.get("splits_done", 0)
            st["splits_total"] += r.get("splits_total") or 0
            st["rows"] += r.get("rows", 0)
            st["bytes"] += r.get("bytes", 0)
            st["device_ms"] += r.get("device_ms", 0.0)
            st["host_ms"] += r.get("host_ms", 0.0)
        return {"stages": stages, "tasks": recs,
                "progress": self.progress(query_id),
                "diagnosis": diagnosis}

    def live_tasks(self) -> List[dict]:
        """Every live task record (system.runtime.tasks' mid-flight
        rows), newest update first."""
        with self._lock:
            recs = [dict(r) for r in self._tasks.values()]
        recs.sort(key=lambda r: -r.get("updated", 0.0))
        return recs

    def live_queries(self) -> List[dict]:
        """Per-query live summaries for system.runtime.live_queries."""
        with self._lock:
            qids = list(self._queries.keys())
        out = []
        for qid in qids:
            roll = self.query_rollup(qid)
            if roll is None:
                continue
            tq = self.tracked_lookup(qid) if self.tracked_lookup else None
            stages = roll["stages"]
            out.append({
                "query_id": qid,
                "state": tq.state if tq is not None else "",
                "progress": roll["progress"] or 0.0,
                "stages": len(stages),
                "tasks": sum(s["tasks"] for s in stages.values()),
                "tasks_done": sum(s["tasks_done"]
                                  for s in stages.values()),
                "splits_done": sum(s["splits_done"]
                                   for s in stages.values()),
                "splits_total": sum(s["splits_total"]
                                    for s in stages.values()),
                "rows": sum(s["rows"] for s in stages.values()),
                "bytes": sum(s["bytes"] for s in stages.values()),
                "stuck": bool(roll["diagnosis"]),
                "diagnosis": (roll["diagnosis"] or {}).get("stage", "")})
        return out

    def utilization(self) -> List[dict]:
        """Per-node busy snapshots for system.runtime.utilization:
        one row per (node, tier)."""
        with self._lock:
            nodes = {n: dict(s) for n, s in self._nodes.items()}
        rows = []
        for node, s in sorted(nodes.items()):
            for tier in ("device", "host"):
                rows.append({"node_id": node, "tier": tier,
                             "busy_fraction": s.get(tier, 0.0),
                             "busy_ms": s.get(f"busy_{tier}_ms", 0.0),
                             "ts": s.get("ts", 0.0)})
        return rows

    # -- hedging feed ------------------------------------------------------

    def straggler_task_ids(self, query_id: Optional[str],
                           multiplier: float) -> Set[str]:
        """Live-skew evidence for the hedging loop: RUNNING tasks whose
        observed per-split time (or, for tasks yet to finish a split,
        wall so far) exceeds `multiplier` x the median per-split time
        of their stage peers. Empty when there is no live evidence —
        hedging then behaves exactly as before."""
        if not query_id or multiplier <= 0:
            return set()
        with self._lock:
            q = self._queries.get(query_id)
            if q is None:
                return set()
            recs = [dict(self._tasks[t]) for t in q["task_ids"]
                    if t in self._tasks]
        now = time.time()
        by_stage: Dict[str, List[dict]] = {}
        for r in recs:
            by_stage.setdefault(r["stage"], []).append(r)
        out: Set[str] = set()
        for peers in by_stage.values():
            avgs = [r["wall_ms"] / r["splits_done"] for r in peers
                    if r.get("splits_done", 0) > 0
                    and r.get("wall_ms", 0.0) > 0]
            if not avgs:
                continue
            med = statistics.median(avgs)
            if med <= 0:
                continue
            for r in peers:
                if r["state"] != "RUNNING":
                    continue
                # delta encoding means a stalled task ships nothing —
                # its folded wall_ms stops moving exactly when its real
                # wall keeps running. Extend by the time since its last
                # fold so a frozen task's observed pace climbs in real
                # time instead of freezing with its counters.
                wall = r.get("wall_ms", 0.0)
                if r.get("updated", 0.0):
                    wall += max(0.0, (now - r["updated"]) * 1000)
                pace = (wall / r["splits_done"]
                        if r.get("splits_done", 0) > 0 else wall)
                if pace > multiplier * med and \
                        wall >= STRAGGLER_MIN_WALL_MS:
                    out.add(r["task_id"])
        return out
