"""Coordinator-side stage scheduling: split assignment, remote tasks,
task-level retry.

Reference: the pipelined scheduler stack — PipelinedQueryScheduler.java:164
creates stages, SourcePartitionedScheduler.java:228 pulls split batches and
places them via UniformNodeSelector.java:55, HttpRemoteTask.java:135
(sendUpdate:730) POSTs fragments+splits to workers and polls status, and
the FTE scheduler retries failed tasks on other nodes
(EventDrivenFaultTolerantQueryScheduler.java:206).

Port of ``trino_tpu/server/scheduler.py``, with the departures ROADMAP
lists: a drain cut short by the query's deadline marks no node FAILED,
and a task's ledger assignment is recorded before it starts, none
starting while the coordinator is fenced (`FencedError`); the write
path passes the ledger to the write protocol as its fence.
One SOURCE stage (the fragmenter's per-split partial program, executed
worker-side over row-range splits) and one FINAL stage (merge + remainder
of the plan, executed on the coordinator's device). Workers that
fail mid-query get their unfinished splits reassigned to surviving workers
— task retry with the deterministic-input property Trino gets from durable
exchange (§5.4): a split is a pure row-range of a deterministic connector
table, so any worker can recompute it identically.
"""

from __future__ import annotations

import json
import statistics
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple
from urllib.error import HTTPError, URLError
from urllib.request import Request, urlopen

import numpy as np

from ..exec.chunked import ChunkAnalysis, analyze, merge_partials
from ..metrics import (SCAN_SPLITS_PRUNED, SCHED_HEDGE_WINS, SCHED_HEDGES,
                       SCHED_TASK_RETRIES, SCHED_TASKS, SPLITS_MIGRATED)
from ..planner import logical as L
from ..planner.fragmenter import Fragment, fragment_plan
from ..planner.optimizer import prune_plan
from ..sql import ast_nodes as A
from ..sql.parser import parse
from ..utils.tracing import NOOP
from .failureinjector import InjectedFailure
from .pageserde import PageChecksumError, verify_page
from .retrypolicy import RetryPolicy
from .tasks import Split, decode_columns, encode_fragment
from .writeprotocol import FencedError, fenced, refuse


class TaskFailedError(RuntimeError):
    pass


class RetryBudgetExhaustedError(TaskFailedError):
    """The query burned through its per-query retry/hedge amplification
    budget. NOT retryable at the query level: a query whose task
    attempts keep multiplying is amplifying load on a struggling
    cluster, and another full-query attempt would amplify further."""


class PageIntegrityError(TaskFailedError):
    """A drained page failed its CRC32C check: corruption detected on the
    wire/buffer and converted into a retryable task failure (the split
    re-runs on a survivor) instead of silently wrong results."""


class NodeDrainingError(TaskFailedError):
    """A worker refused new work because it is DRAINING/DRAINED (HTTP
    409 on the task POST). The splits migrate to survivors — counted as
    migrations, never as task-retry failures, and the node keeps its
    clean failure-detector record (it is winding down, not broken)."""


def _merge_sorted_runs(sort_node, pages):
    """Order-preserving n-way merge of sorted page runs by the sort
    keys (operator/MergeOperator.java + MergeHashSort's role — each
    page is one split's independently sorted output).

    Vectorized: one np.lexsort over the concatenated runs with a stable
    (run, within-run) tiebreak reproduces exactly what a priority queue
    over per-run cursors yields — the per-row Python key tuples of the
    old heapq merge cost tens of seconds at SF1 ORDER BY sizes,
    defeating the worker-side sort. Descending keys sort by NEGATED
    RANK codes (np.unique inverse), not negated values, so non-numeric
    sort keys (e.g. object-dtype strings) merge correctly.
    Returns (arrays, valids)."""
    from .tasks import decode_columns
    runs = []
    for p in pages:
        arrs, vals = decode_columns(p)
        if len(arrs) and len(arrs[0]):
            runs.append((arrs, vals))
    if not runs:
        return [], []
    keys = sort_node.keys

    ncols = len(runs[0][0])
    arrays = [np.concatenate([a[j] for a, _ in runs])
              for j in range(ncols)]
    valids = [np.concatenate([v[j] for _, v in runs])
              for j in range(ncols)]
    lens = [len(a[0]) for a, _ in runs]
    run_id = np.repeat(np.arange(len(runs), dtype=np.int64), lens)
    within = np.concatenate([np.arange(n, dtype=np.int64)
                             for n in lens])

    # lexsort levels, least significant first: (within, run) tiebreak
    # mirrors heapq.merge's stability (equal keys come out in run
    # order, preserving each run's internal order), then per key —
    # rank code below its null-rank, keys[0]'s pair last (= primary)
    levels = [within, run_id]
    for k in reversed(keys):
        ok = np.asarray(valids[k.index], dtype=bool)
        codes = np.unique(arrays[k.index], return_inverse=True)[1] \
            .astype(np.int64)
        if not k.ascending:
            codes = -codes
        codes = np.where(ok, codes, 0)
        nr = np.where(ok, 1 if k.nulls_first else 0,
                      0 if k.nulls_first else 1).astype(np.int8)
        levels.append(codes)
        levels.append(nr)
    order = np.lexsort(levels)
    return [a[order] for a in arrays], [v[order] for v in valids]


class _HedgedUnit:
    """One work unit (a node's split group) in a drain round. A unit may
    carry several concurrent attempts once hedged; `pages` is set exactly
    once by the first successful attempt (first-success-wins dedup)."""

    __slots__ = ("first_node", "splits", "key", "pages", "live", "hedged",
                 "nodes_used", "failed_nodes", "drained_nodes", "started",
                 "tasks", "winner")

    def __init__(self, first_node: str, splits: List[Split], key: str):
        self.first_node = first_node
        self.splits = splits
        self.key = key
        self.pages: Optional[List[bytes]] = None
        self.live = 0                  # attempts currently in flight
        self.hedged = False
        self.nodes_used: Set[str] = set()
        self.failed_nodes: Set[str] = set()
        # subset of failed_nodes that 409'd the task POST (drain
        # handoff): a unit whose failures are ALL drain handoffs is a
        # migration, not a failure
        self.drained_nodes: Set[str] = set()
        self.started = time.monotonic()
        self.tasks: List["RemoteTask"] = []
        self.winner: Optional["RemoteTask"] = None


class RemoteTask:
    """Coordinator's proxy of one worker task (HttpRemoteTask.java:135)."""

    def __init__(self, node, task_id: str, fragment_blob: str,
                 splits: List[Split], http_timeout_s: float = 30.0,
                 partition: Optional[dict] = None,
                 sources: Optional[dict] = None, injector=None,
                 traceparent: Optional[str] = None,
                 deadline: Optional[float] = None):
        self.node = node
        self.task_id = task_id
        self.fragment_blob = fragment_blob
        self.splits = splits
        self.http_timeout_s = http_timeout_s
        self.partition = partition
        self.sources = sources
        self.injector = injector          # chaos hook (EXCHANGE_DRAIN)
        self.traceparent = traceparent    # W3C context for every hop
        # absolute query deadline (coordinator wall clock, None = no
        # cap); start() ships it normalized to the worker's clock
        self.deadline = deadline
        self.pages: List[dict] = []
        self.bytes_drained = 0            # frame bytes pulled (shuffle)
        self.done = False

    def _url(self, suffix: str = "") -> str:
        return f"{self.node.uri}/v1/task/{self.task_id}{suffix}"

    def _request(self, url: str, data: Optional[bytes] = None,
                 method: str = "GET", accept: str = ""):
        """JSON request; with `accept` = the binary pages media type the
        response may instead be a raw page frame (returned as bytes)."""
        from .security import internal_headers
        headers = {"Content-Type": "application/json",
                   **internal_headers()}
        if accept:
            headers["Accept"] = accept
        if self.traceparent is not None:
            headers["traceparent"] = self.traceparent
        req = Request(url, data=data, method=method, headers=headers)
        with urlopen(req, timeout=self.http_timeout_s) as resp:
            body = resp.read()
            if resp.headers.get("Content-Type", "").startswith(
                    "application/x-trino-pages"):
                return bytes(body)
            return json.loads(body.decode()) if body else {}

    def start(self) -> None:
        payload = {
            "fragment": self.fragment_blob,
            "splits": [vars(s) for s in self.splits],
        }
        if self.partition is not None:
            payload["partition"] = self.partition
        if self.sources is not None:
            payload["sources"] = self.sources
        if self.deadline is not None:
            # ship the remaining budget on the WORKER's wall clock: the
            # announce-estimated offset rebases the coordinator-absolute
            # deadline so a skewed worker enforces the same instant
            payload["deadline"] = self.deadline + \
                getattr(self.node, "clock_offset", 0.0)
        body = json.dumps(payload).encode()
        self._request(self._url(), data=body, method="POST")

    def wait_finished(self, deadline: float) -> None:
        """Poll task status until FINISHED (producer stages whose buffers
        are drained by OTHER workers — the coordinator only needs the
        terminal state, ContinuousTaskStatusFetcher's role)."""
        while time.time() < deadline:
            st = self._request(self._url())
            if st.get("state") == "FINISHED":
                self.done = True
                return
            if st.get("state") in ("FAILED", "CANCELED"):
                raise TaskFailedError(
                    f"task {self.task_id} on {self.node.node_id}: "
                    f"{st.get('error', st.get('state'))}")
            time.sleep(0.02)
        raise TaskFailedError(f"task {self.task_id} timed out")

    def _verified(self, frame: bytes) -> bytes:
        """Chaos corruption hook + CRC32C integrity gate for one drained
        frame. A checksum failure is a *retryable* task failure: the
        work re-runs on a survivor rather than merging garbled columns."""
        if self.injector is not None:
            frame = self.injector.corrupt_page("EXCHANGE_DRAIN",
                                               self.task_id, frame)
        try:
            verify_page(frame)
        except PageChecksumError as e:
            raise PageIntegrityError(
                f"task {self.task_id} on {self.node.node_id}: {e}") from e
        return frame

    def drain(self, deadline: float) -> List[bytes]:
        """Pull result pages token by token until the buffer completes
        (HttpPageBufferClient.sendGetResults:355's loop). Pages cross
        the wire as binary zstd/zlib frames (pageserde.py), the JSON
        envelope only carries terminal/empty states. Every frame is
        CRC32C-verified before it is accepted."""
        token = 0
        while time.time() < deadline:
            if self.injector is not None:
                # chaos: drop/delay/raise at the results-fetch boundary
                self.injector.maybe_fail("EXCHANGE_DRAIN", self.task_id)
            out = self._request(self._url(f"/results/{token}"),
                                accept="application/x-trino-pages")
            if isinstance(out, bytes):
                self.pages.append(self._verified(out))
                self.bytes_drained += len(out)
                token += 1
                continue
            if out.get("page") is not None:
                page = out["page"]
                if isinstance(page, dict) and "b64" in page:
                    import base64
                    page = base64.b64decode(page["b64"])
                if isinstance(page, (bytes, bytearray)):
                    page = self._verified(bytes(page))
                    self.bytes_drained += len(page)
                self.pages.append(page)
                token += 1
                continue
            if out.get("state") == "FAILED":
                raise TaskFailedError(
                    f"task {self.task_id} on {self.node.node_id}: "
                    f"{out.get('error', '')}")
            if out.get("complete"):
                self.done = True
                return self.pages
            time.sleep(0.02)
        raise TaskFailedError(f"task {self.task_id} timed out")

    def cancel(self) -> None:
        try:
            self._request(self._url(), method="DELETE")
        except Exception:        # noqa: BLE001 — best-effort abort
            pass


class StageScheduler:
    """Schedules eligible queries across announced workers; falls back to
    local execution by returning None (the caller keeps the single-node
    path — Trino's coordinator-only queries take the same shortcut)."""

    def __init__(self, coordinator_state, session, split_rows: int = None,
                 max_task_retries: int = None, task_timeout_s: float = 300.0,
                 spool=None):
        self.state = coordinator_state
        self.session = session
        # Constructor args, when given, override session properties —
        # SESSION_PROPERTY_DEFAULTS pre-populates every key, so a plain
        # props.get(name, arg) would silently ignore the caller's values.
        props = getattr(session, "properties", {})
        self.split_rows = split_rows if split_rows is not None \
            else props.get("split_rows", 250_000)
        self.max_task_retries = max_task_retries \
            if max_task_retries is not None \
            else props.get("task_retries", 2)
        self.task_timeout_s = task_timeout_s
        # straggler hedging: a task past max(hedge_min_s, multiplier *
        # median drain time of its round) gets a speculative duplicate on
        # a survivor; first success wins (spool work-key dedup + the
        # all-or-nothing drain make the race safe). multiplier <= 0
        # disables.
        self.hedge_multiplier = float(props.get("hedge_multiplier", 4.0))
        self.hedge_min_s = float(props.get("hedge_min_s", 2.0))
        # backoff between task-retry rounds (shared RetryPolicy shape)
        self.retry_backoff_base_s = float(
            props.get("retry_backoff_base_s", 0.05))
        self.retry_backoff_max_s = float(
            props.get("retry_backoff_max_s", 2.0))
        self._seq = 0
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {"queries": 0, "tasks": 0,
                                      "task_retries": 0, "spool_hits": 0,
                                      "hedged_tasks": 0, "hedge_wins": 0,
                                      "checksum_failures": 0,
                                      "splits_pruned": 0,
                                      "splits_migrated": 0}
        # observability: per-query stage/task rollup (reset each execute;
        # read by the dispatcher into TrackedQuery.stage_stats), recent
        # task records for system.runtime.tasks, and per-(query, operator)
        # aggregates for system.runtime.operator_stats
        self.last_query: Optional[dict] = None
        self.task_history: "deque[dict]" = deque(maxlen=256)
        self.operator_history: "deque[dict]" = deque(maxlen=512)
        self._current_stage = "source"
        self._profile_tasks = False     # EXPLAIN ANALYZE: force worker
                                        # per-operator profiling
        # durable exchange (FTE): drained task outputs persist keyed by
        # work identity; later attempts reuse instead of re-running
        from .exchange_spool import ExchangeSpool
        self.spool = spool if spool is not None else ExchangeSpool()
        self.failure_injector = None     # hook: fail between stages
        # why the last execute() declined (picked up by the dispatcher
        # into TrackedQuery.fallback_reason — the round-3 verdict's
        # "silently local" complaint)
        self.fallback_reason: Optional[str] = None
        # wired by CoordinatorState: query_id -> TrackedQuery, so
        # EXPLAIN ANALYZE can fold queued time (state-machine stamps)
        # into its critical-path line. None under session-local use.
        self.tracked_lookup = None
        # wired by CoordinatorState: the live-stats store
        # (server/livestats.py) heartbeat folds land in. Launched tasks
        # register so mid-flight rollups know stage/node/split counts
        # before the first heartbeat arrives. None under session-local use.
        self.livestats = None
        # cancellation fan-out (round-22): every in-flight RemoteTask of
        # the current query — hedge twins included — so terminate() can
        # DELETE them all on every assigned worker. Cleared per query.
        self._live_tasks: Dict[str, List[RemoteTask]] = {}
        self._live_tasks_lock = threading.Lock()
        # per-query retry/hedge amplification budget: extra attempts
        # (retry rounds + hedges) past this fail the query instead of
        # multiplying load on a struggling cluster
        self.max_task_amplification = int(
            props.get("task_amplification_budget", 16))
        self._amplification = 0

    # -- durable query ledger hooks ---------------------------------------

    def reserve_task_seq(self, task_id: str) -> None:
        """Never mint `task_id` (a `t<seq>` id another coordinator issued
        and a ledger recorded) or any id below it again."""
        if task_id.startswith("t") and task_id[1:].isdigit():
            with self._lock:
                self._seq = max(self._seq, int(task_id[1:]))

    def _ledger_assign(self, task) -> None:
        """Record a task/stage assignment in the coordinator's durable
        query ledger (server/ledger.py) — the promoted coordinator
        reconciles these against live worker task inventories to decide
        re-attach vs re-execute. No-op without a ledger.

        Called before the task starts: a coordinator whose ledger is
        sealed or deposed raises FencedError instead, so every task id
        it ever started is in the ledger a promoted standby replays and
        reserves (a task id the standby minted again would hand it this
        coordinator's task on the worker)."""
        led = getattr(self.state, "ledger", None)
        if led is None:
            return
        qid = (self.last_query or {}).get("query_id") or ""
        what = f"task {task.task_id} to {task.node.node_id}"
        why = fenced(led)
        if why is None and qid and not led.assign(
                qid, task.task_id, task.node.node_id, self._current_stage):
            why = "sealed" if led.sealed else "deposed"
        if why is not None:
            refuse(led, why, "dispatch", what, qid)

    def _livestats_register(self, task) -> None:
        """Pre-register a launched task with the live-stats store so the
        per-stage rollup carries stage/node/split-count attribution from
        launch, not from the first heartbeat. No-op without a store."""
        self._track_live(task)
        ls = self.livestats
        qid = (self.last_query or {}).get("query_id")
        if ls is None or not qid:
            return
        ls.register_task(qid, task.task_id, stage=self._current_stage,
                         node=task.node.node_id,
                         splits_total=len(task.splits))

    # -- cancellation fan-out + amplification budget (round-22) ------------

    def _track_live(self, task: "RemoteTask") -> None:
        """Register a launched task in the per-query live registry —
        the terminate() fan-out's worker-task DELETE target list."""
        qid = (self.last_query or {}).get("query_id")
        if not qid:
            return
        with self._live_tasks_lock:
            self._live_tasks.setdefault(qid, []).append(task)

    def cancel_query_tasks(self, query_id: str) -> List[str]:
        """Best-effort DELETE of every in-flight worker task launched
        for `query_id` — hedge twins included. Returns the task ids the
        fan-out covered (the DELETEs themselves never raise)."""
        with self._live_tasks_lock:
            tasks = list(self._live_tasks.get(query_id, ()))
        for t in tasks:
            t.cancel()
        return [t.task_id for t in tasks]

    def _amplify(self, n: int = 1, required: bool = True) -> bool:
        """Charge `n` extra task attempts (a retry round, a hedge)
        against the query's amplification budget. Past the cap:
        required attempts (retries) raise RetryBudgetExhaustedError —
        non-retryable, the query fails rather than multiplying load —
        while optional ones (hedges) are simply declined."""
        if self._amplification + n > self.max_task_amplification:
            from ..metrics import RETRY_BUDGET_EXHAUSTED
            RETRY_BUDGET_EXHAUSTED.inc()
            if required:
                raise RetryBudgetExhaustedError(
                    f"query exceeded its retry/hedge amplification "
                    f"budget ({self.max_task_amplification} extra "
                    f"attempts)")
            return False
        self._amplification += n
        return True

    def _query_deadline(self) -> Optional[float]:
        """The current query's absolute run deadline (coordinator wall
        clock), or None. Caps every stage/drain/wait deadline so no
        scheduler wait outlives the query, and rides every task POST."""
        lookup = self.tracked_lookup
        qid = (self.last_query or {}).get("query_id")
        if lookup is None or not qid:
            return None
        tq = lookup(qid)
        return getattr(tq, "deadline", None) if tq is not None else None

    def _query_dead(self) -> bool:
        """True once the current query's state machine went terminal
        (terminate() fan-out, deadline expiry) — drain loops poll this
        so a canceled query's dispatch stops instead of retrying work
        nobody will read."""
        lookup = self.tracked_lookup
        qid = (self.last_query or {}).get("query_id")
        if lookup is None or not qid:
            return False
        tq = lookup(qid)
        return tq is not None and tq.state_machine.is_done()

    def _ledger_spool(self, key: str) -> None:
        """Record a result-spool pointer: after a failover, spooled
        output keyed here lets a resumed query re-attach instead of
        re-running the work."""
        led = getattr(self.state, "ledger", None)
        qid = (self.last_query or {}).get("query_id")
        if led is None or not qid:
            return
        led.spool(qid, key)

    # -- per-query observability rollup -----------------------------------

    def _tracer(self):
        """The session's tracer (the dispatcher swaps a per-query tracer
        in while a traced query executes); NOOP otherwise."""
        return getattr(self.session, "tracer", None) or NOOP

    def _begin_query(self, query_id: Optional[str]) -> None:
        self._stats_snap = dict(self.stats)
        self.last_query = {"query_id": query_id, "stages": 0,
                           "tasks": [], "operators": {},
                           "bytes_shuffled": 0}
        self._current_stage = "source"
        self._amplification = 0
        if query_id:
            # fresh attempt: drop the previous attempt's task registry
            # (those tasks are already terminal or canceled)
            with self._live_tasks_lock:
                self._live_tasks.pop(query_id, None)
        if self.livestats is not None and query_id:
            self.livestats.begin(query_id)

    def _finalize_rollup(self) -> None:
        """Compute the per-query deltas of the cumulative counters and
        publish operator aggregates to the history ring (idempotent —
        EXPLAIN ANALYZE finalizes early to render, execute()'s finally is
        then a no-op)."""
        lq = self.last_query
        if lq is None or lq.get("_final"):
            return
        lq["_final"] = True
        if lq.get("query_id"):
            with self._live_tasks_lock:
                self._live_tasks.pop(lq["query_id"], None)
        if self.livestats is not None and lq.get("query_id"):
            self.livestats.finish(lq["query_id"])
        snap = getattr(self, "_stats_snap", {})
        for k in ("task_retries", "hedged_tasks", "hedge_wins",
                  "checksum_failures", "spool_hits", "splits_migrated"):
            lq[k] = self.stats.get(k, 0) - snap.get(k, 0)
        lq["stages"] = self.stats.get("stages", 0) - snap.get("stages", 0)
        lq["faults_survived"] = lq["task_retries"] + \
            lq["checksum_failures"]
        if lq.get("splits_pruned"):
            # surface split pruning on the TableScan rollup row so
            # system.runtime.operator_stats carries the verdict
            acc = lq["operators"].setdefault(
                "TableScan", {"rows": 0, "wall_ms": 0.0, "calls": 0,
                              "device_ms": 0.0, "host_ms": 0.0,
                              "compile_ms": 0.0, "strategy": "",
                              "distribution": ""})
            acc["strategy"] = (f"zone-pruned:{lq['splits_pruned']}/"
                               f"{lq.get('splits_total', 0)} splits")
        with self._lock:
            for op, d in lq["operators"].items():
                self.operator_history.append(
                    {"query_id": lq.get("query_id") or "",
                     "operator": op, "rows": d["rows"],
                     "wall_ms": d["wall_ms"], "calls": d["calls"],
                     "device_ms": d.get("device_ms", 0.0),
                     "host_ms": d.get("host_ms", 0.0),
                     "compile_ms": d.get("compile_ms", 0.0),
                     "strategy": d.get("strategy", ""),
                     "distribution": d.get("distribution", "")})

    def _record_task(self, task: "RemoteTask") -> None:
        """Fetch a finished task's terminal status — TaskStats + spans —
        and fold it into the per-query rollup, the system.runtime.tasks
        ring, and the stitched trace (the merge step of the reference's
        operator -> task -> stage -> query stats pyramid)."""
        try:
            st = task._request(task._url())
        except Exception:  # noqa: BLE001 — stats fetch is best-effort
            return
        stats = st.get("stats") or {}
        ops = stats.get("operators") or {}
        rec = {"query_id": (self.last_query or {}).get("query_id") or "",
               "task_id": task.task_id, "node": task.node.node_id,
               "stage": self._current_stage,
               "state": st.get("state", ""),
               "splits": int(stats.get("splitsDone", 0)),
               "rows": int(stats.get("rowsOut", 0)),
               "bytes": int(stats.get("bytesOut", 0)),
               "wall_ms": float(stats.get("wallMs", 0.0)),
               # per-task device/host/compile split: the timeline's
               # blocking-task attribution (server/timeline.py) reads
               # these off the stage's slowest task
               "device_ms": sum(float(d.get("deviceMs", 0.0))
                                for d in ops.values()),
               "host_ms": sum(float(d.get("hostMs", 0.0))
                              for d in ops.values()),
               "compile_ms": sum(float(d.get("compileMs", 0.0))
                                 for d in ops.values())}
        with self._lock:
            self.task_history.append(rec)
            lq = self.last_query
            if lq is not None:
                lq["tasks"].append(rec)
                lq["bytes_shuffled"] += task.bytes_drained
                for op, d in (stats.get("operators") or {}).items():
                    acc = lq["operators"].setdefault(
                        op, {"rows": 0, "wall_ms": 0.0, "calls": 0,
                             "device_ms": 0.0, "host_ms": 0.0,
                             "compile_ms": 0.0, "strategy": "",
                             "distribution": ""})
                    acc["rows"] += int(d.get("rows", 0))
                    acc["wall_ms"] += float(d.get("wallMs", 0.0))
                    acc["calls"] += int(d.get("calls", 0))
                    acc["device_ms"] += float(d.get("deviceMs", 0.0))
                    acc["host_ms"] += float(d.get("hostMs", 0.0))
                    acc["compile_ms"] += float(d.get("compileMs", 0.0))
                    if d.get("strategy"):
                        acc["strategy"] = d["strategy"]
                    if d.get("distribution"):
                        acc["distribution"] = d["distribution"]
        # rebase the worker's span stamps onto the coordinator clock
        # using the offset estimated at announce (skew satellite)
        self._tracer().adopt(
            st.get("spans") or [],
            offset_s=getattr(task.node, "clock_offset", 0.0))

    # -- eligibility + planning -------------------------------------------

    def plan(self, sql: str):
        return self._plan_stmt(parse(sql))

    def _plan_stmt(self, stmt):
        if not isinstance(stmt, A.Query):
            self.fallback_reason = "coordinator-only statement"
            return None
        rel = self.session.planner().plan_query(stmt)
        root = prune_plan(rel.node)
        # eligibility pre-gate: something must be split-worthy, or local
        # execution wins outright (coordinator-only queries, Trino-style)
        from ..planner.fragmenter import _scan_rows, _subtree_nodes
        if not any(isinstance(n, L.ScanNode) and
                   _scan_rows(self.session.catalog, n) > self.split_rows
                   for n in _subtree_nodes(root)):
            self.fallback_reason = (
                f"no scan larger than split_rows={self.split_rows}")
            return None
        return rel, root

    def execute(self, sql: str, query_id: Optional[str] = None):
        """Distributed execution; returns QueryResult or None (fall back
        to local). EXPLAIN ANALYZE of an eligible query executes it
        distributed and renders the merged per-stage/per-operator stats.

        Phased multi-stage execution (PipelinedQueryScheduler.java:164 +
        PhasedExecutionSchedule): the fragmenter cuts heavy join build
        sides into their own stages; build stages run first (distributed
        when their driver table is large, else on the coordinator), each
        materialized output broadcast into its consumers; the probe spine
        then runs as the split-streamed SOURCE stage and the coordinator
        merges in the FINAL stage."""
        stmt = parse(sql)
        self._begin_query(query_id)
        try:
            if isinstance(stmt, A.Explain) and stmt.analyze and \
                    (isinstance(stmt.query, A.Query) or
                     isinstance(stmt.query, (A.InsertInto, A.CreateTable))
                     and getattr(stmt.query, "query", None) is not None):
                return self._execute_explain_analyze(stmt, sql)
            return self._execute_stmt(stmt, sql)
        finally:
            self._finalize_rollup()

    def _execute_stmt(self, stmt, sql: str):
        t0 = time.monotonic()
        tracer = self._tracer()
        self.fallback_reason = None
        # one injector governs every coordinator-side chaos point,
        # including the spool's read/write hooks
        self.spool.injector = self.failure_injector
        workers = self.state.active_nodes()
        if not workers:
            self.fallback_reason = "no active workers"
            return None
        if isinstance(stmt, (A.InsertInto, A.CreateTable)):
            with tracer.span("distributed-write"):
                return self._execute_write(stmt, sql, t0, workers)
        with tracer.span("plan-distributed"):
            planned = self._plan_stmt(stmt)
        if planned is None:
            return None
        rel, root = planned

        # session-forced partitioned join distribution: hash-repartition
        # both sides across workers instead of broadcasting the build
        # (DetermineJoinDistributionType.java:51's PARTITIONED choice)
        props = getattr(self.session, "properties", {})
        if props.get("join_distribution_type") == "partitioned":
            desc = self._analyze_partitioned(root)
            if desc is not None:
                self._current_stage = "partitioned"
                with tracer.span("partitioned-exchange",
                                 workers=len(workers)):
                    result = self._execute_partitioned(rel, root, workers,
                                                       desc)
                result.elapsed_s = time.monotonic() - t0
                self.stats["queries"] += 1
                return result
            self.fallback_reason = ("join_distribution_type=PARTITIONED "
                                    "but plan shape does not support a "
                                    "partitioned exchange")

        frags = fragment_plan(root, self.session.catalog,
                              min_build_rows=self.split_rows)
        # the probe spine itself must be split-worthy BEFORE any build
        # stage runs — otherwise distributed builds execute and the local
        # fallback throws their work away
        from ..planner.fragmenter import _scan_rows, _subtree_nodes
        if not any(isinstance(n, L.ScanNode) and
                   _scan_rows(self.session.catalog, n) > self.split_rows
                   for n in _subtree_nodes(frags[-1].root)):
            self.fallback_reason = "probe spine below split threshold"
            return None
        self.stats["stages"] = self.stats.get("stages", 0) + len(frags) + 1
        materialized: Dict[int, L.ValuesNode] = {}
        for f in frags[:-1]:
            plan_f = self._bind_remotes(f.root, materialized)
            self._current_stage = f"build-{f.id}"
            with tracer.span("build-stage", fragment=f.id):
                materialized[f.id] = self._run_build_stage(plan_f)
            if self.failure_injector is not None:
                self.failure_injector.maybe_fail("STAGE_BOUNDARY", sql)
        self._current_stage = "source"
        root = self._bind_remotes(frags[-1].root, materialized)

        analysis = analyze(root, self.session.catalog, self.split_rows,
                           allow_sort_merge=True)
        if analysis is None:
            self.fallback_reason = ("plan shape not split-streamable "
                                    "(sort/window/distinct below the "
                                    "merge point, or driver on a build "
                                    "side)")
            return None
        workers = self.state.active_nodes()
        if not workers:      # every worker died during the build stages
            self.fallback_reason = "all workers failed during build stages"
            return None
        partial_pages = self._run_source_stage(workers, analysis, root)
        if self.failure_injector is not None:
            # between-stage failure point: source outputs are already
            # spooled, so the QUERY retry resumes from them
            self.failure_injector.maybe_fail("STAGE_BOUNDARY", sql)
        with tracer.span("final-stage", pages=len(partial_pages)):
            result = self._run_final_stage(rel, root, analysis,
                                           partial_pages)
        result.elapsed_s = time.monotonic() - t0
        self.stats["queries"] += 1
        return result

    def _execute_write(self, stmt, sql: str, t0: float, workers):
        """Distributed INSERT / CTAS with exactly-once commit (the FTE
        write path: TableWriterOperator staging + TableFinishOperator
        commit under task retries). Source tasks run the inner query
        split-streamed with hash-partitioned output; P write tasks each
        pull one partition through the CRC-framed exchange and stage an
        attempt file, reporting a manifest in terminal status; the
        coordinator dedups manifests first-success-wins, journals the
        commit, publishes by rename, and bumps the catalog version.
        Returns None (local staged fallback) only before any task has
        side effects."""
        import os as _os
        import uuid as _uuid
        from ..batch import Field
        from ..exec import zonemap
        from ..exec.session import QueryResult
        from ..metrics import WRITE_ATTEMPTS_DEDUPED
        from ..types import BIGINT
        from . import writeprotocol as wp
        sess = self.session
        inner = getattr(stmt, "query", None)
        if inner is None or not isinstance(inner, A.Query):
            self.fallback_reason = "coordinator-only statement"
            return None
        cat, sch, tbl = sess.resolve_table(stmt.table)
        try:
            conn = sess.catalog.connector(cat)
        except Exception:
            self.fallback_reason = f"unknown catalog {cat}"
            return None
        if not getattr(conn, "supports_staged_writes", False):
            self.fallback_reason = (f"connector {cat} has no staged "
                                    f"write support")
            return None
        is_ctas = isinstance(stmt, A.CreateTable)
        qid = (self.last_query or {}).get("query_id") or \
            f"adhoc_{_uuid.uuid4().hex[:10]}"
        table_dir = _os.path.abspath(conn._table_dir(sch, tbl))
        # the coordinator's ledger fences every change this write makes
        # to the table directory: a sealed or deposed coordinator's
        # thread is refused (WriteFencedError), the directory untouched
        fence = getattr(self.state, "ledger", None)
        # commit-phase wall (stage / commit), surfaced on the EXPLAIN
        # ANALYZE write line and read by the timeline's write-commit
        # attribution when tracing is off; empty on the idempotent
        # already-committed path (no staging happened this attempt)
        phase_times: Dict[str, float] = {}

        def _finish_commit(stats, partitions, staged):
            conn._cache.pop((sch, tbl), None)
            sess.catalog.bump_version()
            sess.executor.invalidate_scan_cache()
            try:
                zonemap.note_table(conn.get_table(sch, tbl))
            except Exception:   # noqa: BLE001 — registration best-effort
                pass
            with self._lock:
                lq = self.last_query
                if lq is not None:
                    lq["write"] = {
                        "partitions": partitions, "staged": staged,
                        "deduped": stats.get("deduped", 0),
                        "rows": stats["rows"],
                        "bytes": stats.get("bytes", 0),
                        "phase": stats.get("phase", "committed"),
                        "stage_s": round(phase_times.get("stage", 0.0), 6),
                        "commit_s": round(phase_times.get("commit", 0.0),
                                          6)}
            return QueryResult(["rows"], [(stats["rows"],)],
                               time.monotonic() - t0)

        # a prior attempt of this very query already committed: the
        # protocol's idempotence — return its result, never re-stage
        already = wp.published_rows_for(table_dir, qid)
        if already is not None:
            wp.recover_table_dir(table_dir, fence=fence, query_id=qid)
            return _finish_commit({"rows": already, "phase": "committed"},
                                  0, 0)
        wp.recover_table_dir(table_dir, fence=fence, query_id=qid)
        if is_ctas and conn.table_exists(sch, tbl):
            self.fallback_reason = "CTAS target exists (local path " \
                                   "resolves IF NOT EXISTS / errors)"
            return None
        if not is_ctas and not conn.table_exists(sch, tbl):
            self.fallback_reason = "insert target missing (local path " \
                                   "raises the canonical error)"
            return None
        planned = self._plan_stmt(inner)
        if planned is None:
            return None
        rel, root = planned
        analysis = analyze(root, sess.catalog, self.split_rows)
        if analysis is None or analysis.merge_agg is not None or \
                analysis.merge_sort is not None:
            self.fallback_reason = ("write source not split-streamable "
                                    "in concat mode")
            return None
        out_fields = []
        for name, sc in zip(root.names, rel.scope.columns):
            fld = sc.field if sc.field is not None else Field(name,
                                                              sc.dtype)
            out_fields.append(Field(name, sc.dtype,
                                    dictionary=fld.dictionary))
        if not is_ctas:
            target = conn.get_table_schema(sch, tbl)
            if len(target) != len(out_fields) or any(
                    tf.dtype.kind is not of.dtype.kind
                    for tf, of in zip(target, out_fields)):
                self.fallback_reason = ("insert column mismatch (local "
                                        "path raises)")
                return None
            out_fields = [Field(tf.name, of.dtype,
                                dictionary=of.dictionary)
                          for tf, of in zip(target, out_fields)]

        props = getattr(sess, "properties", {})
        P = int(props.get("write_partitions") or 0) or len(workers)
        src_root = root.child
        keys = [i for i, (_, dt) in enumerate(src_root.output)
                if np.issubdtype(dt.np_dtype, np.integer)][:1]
        if not keys:
            # no hashable column: everything lands in partition 0, so a
            # single write partition avoids empty-part churn
            P = 1
        t_deadline = time.time() + self.task_timeout_s
        qd = self._query_deadline()
        if qd is not None:
            t_deadline = min(t_deadline, qd)
        traceparent = self._tracer().traceparent()
        splits = self._make_splits(analysis)
        blob = encode_fragment({"root": src_root,
                                "driver": analysis.driver})
        src_tasks = []
        live: Dict[int, list] = {}
        _os.makedirs(table_dir, exist_ok=True)
        created_dir = is_ctas
        tracer = self._tracer()
        try:
            _t_stage = time.monotonic()
            with tracer.span("write-stage", partitions=P):
                for wi, w in enumerate(workers):
                    sp = [s for i, s in enumerate(splits)
                          if i % len(workers) == wi]
                    if not sp:
                        continue
                    with self._lock:
                        self._seq += 1
                        tid = f"t{self._seq}"
                    task = RemoteTask(w, tid, blob, sp,
                                      partition={"keys": keys, "count": P},
                                      injector=self.failure_injector,
                                      traceparent=traceparent,
                                      deadline=qd)
                    self._ledger_assign(task)
                    task.start()
                    self._livestats_register(task)
                    self.stats["tasks"] += 1
                    SCHED_TASKS.inc()
                    src_tasks.append(task)

                def launch_writer(p: int, attempt_no: int, exclude=()):
                    w = next((n for n in self.state.active_nodes()
                              if n.node_id not in exclude),
                             None) or workers[(p + attempt_no) % len(workers)]
                    with self._lock:
                        self._seq += 1
                        tid = f"t{self._seq}"
                    node = L.TableWriterNode(
                        child=L.RemoteSourceNode(1, src_root.output),
                        catalog=cat, schema_name=sch, table=tbl,
                        table_dir=table_dir, fmt=conn.fmt, query_id=qid,
                        stage=1, partition=p, attempt=tid,
                        fields=tuple(out_fields), output=(("rows", BIGINT),))
                    wblob = encode_fragment({"root": node,
                                             "timeout_s":
                                                 self.task_timeout_s})
                    sources = {"1": [{"uri": t.node.uri, "taskId": t.task_id,
                                      "buffer": p} for t in src_tasks]}
                    task = RemoteTask(w, tid, wblob, [], sources=sources,
                                      injector=self.failure_injector,
                                      traceparent=traceparent,
                                      deadline=qd)
                    self._ledger_assign(task)
                    task.start()
                    self._livestats_register(task)
                    self.stats["tasks"] += 1
                    SCHED_TASKS.inc()
                    return task

                attempts: Dict[int, int] = {}
                for p in range(P):
                    live[p] = [launch_writer(p, 0)]
                    attempts[p] = 1
                    if getattr(self, "force_write_hedge", False):
                        # duplicate-attempt injection: both stage; commit's
                        # (stage, partition) dedup must drop one
                        live[p].append(launch_writer(p, 1))
                        attempts[p] += 1
                        self.stats["hedged_tasks"] = \
                            self.stats.get("hedged_tasks", 0) + 1
                manifests: List[dict] = []
                collected: Set[str] = set()
                done: Set[int] = set()
                max_attempts = 4
                while len(done) < P:
                    if time.time() > t_deadline:
                        raise TaskFailedError("write stage timed out")
                    for p in range(P):
                        if p in done:
                            continue
                        failed_nodes = []
                        all_failed = bool(live[p])
                        for t in list(live[p]):
                            try:
                                st = t._request(t._url())
                            except Exception:
                                st = {"state": "FAILED", "error": "status "
                                      "fetch failed (node dead?)"}
                            state = st.get("state")
                            if state == "FINISHED":
                                m = (st.get("stats") or {}).get("manifest")
                                if m is not None:
                                    manifests.append(m)
                                    collected.add(t.task_id)
                                    done.add(p)
                                    self._record_task(t)
                                    all_failed = False
                                    break
                                state = "FAILED"
                            if state in ("FAILED", "CANCELED"):
                                live[p].remove(t)
                                failed_nodes.append(t.node.node_id)
                                self._amplify(1)
                                self.stats["task_retries"] += 1
                                SCHED_TASK_RETRIES.inc()
                            else:
                                all_failed = False
                        if p in done or not all_failed:
                            continue
                        if attempts[p] >= max_attempts:
                            raise TaskFailedError(
                                f"write partition {p} exhausted "
                                f"{max_attempts} attempts")
                        live[p].append(launch_writer(p, attempts[p],
                                                     exclude=failed_nodes))
                        attempts[p] += 1
                    time.sleep(0.02)
                # duplicate attempts that also finished report their
                # manifests too — commit's (stage, partition) dedup drops
                # them; still-running stragglers are cancelled (their staged
                # files, if any, fall to the post-commit sweep)
                for p in range(P):
                    for t in live[p]:
                        if t.task_id in collected:
                            continue
                        try:
                            st = t._request(t._url())
                            m = (st.get("stats") or {}).get("manifest") \
                                if st.get("state") == "FINISHED" else None
                        except Exception:  # noqa: BLE001
                            m = None
                        if m is not None:
                            manifests.append(m)
                            collected.add(t.task_id)
                            continue
                        try:
                            t.cancel()
                        except Exception:  # noqa: BLE001
                            pass
                for t in src_tasks:
                    t.wait_finished(t_deadline)
                    self._record_task(t)
            phase_times["stage"] = time.monotonic() - _t_stage
            _t_commit = time.monotonic()
            with tracer.span("write-commit", partitions=P,
                             manifests=len(manifests)):
                stats = wp.commit(table_dir, qid, manifests,
                                  injector=self.failure_injector,
                                  tracer=tracer, fence=fence)
            phase_times["commit"] = time.monotonic() - _t_commit
            WRITE_ATTEMPTS_DEDUPED.inc(stats.get("deduped", 0))
            self.stats["stages"] = self.stats.get("stages", 0) + 2
            self.stats["queries"] += 1
            return _finish_commit(stats, P, len(manifests))
        except BaseException:
            for t in src_tasks + [t for ts in live.values() for t in ts]:
                try:
                    t.cancel()
                except Exception:  # noqa: BLE001
                    pass
            wp.abort(table_dir, qid, fence=fence)
            committed = wp.published_rows_for(table_dir, qid)
            if committed is not None:
                # the INTENT was durable: abort rolled the commit
                # FORWARD — report success, a re-run would double-write
                return _finish_commit(
                    {"rows": committed, "phase": "committed"}, P, 0)
            if created_dir:
                try:
                    _os.rmdir(table_dir)
                except OSError:
                    pass
            raise

    def _critical_path_line(self, t0: float) -> str:
        """The `critical path: ...` EXPLAIN ANALYZE line — phase
        attribution over this query's elapsed wall (server/timeline.py).
        Dispatcher-tracked queries fold in queued time from their
        state-machine stamps; session-local runs attribute only the
        scheduler-observed elapsed."""
        from .timeline import attribute_phases, breakdown_line
        lq = self.last_query or {}
        wall = max(0.0, time.monotonic() - t0)
        queued = 0.0
        lookup = self.tracked_lookup
        tq = lookup(lq.get("query_id") or "") if lookup else None
        if tq is not None:
            sm = tq.state_machine
            stamps = getattr(sm, "state_times", {}) or {}
            queued = max(0.0, stamps.get("PLANNING", sm.created_at) -
                         sm.created_at)
            wall = max(queued, time.time() - sm.created_at)
        phases = attribute_phases(wall, queued, self._tracer().export(),
                                  lq, lq.get("write"))
        return breakdown_line(phases, wall)

    def _execute_explain_analyze(self, stmt, sql: str):
        """EXPLAIN ANALYZE over the cluster: run the inner query
        distributed (with worker-side per-operator profiling forced),
        then render the logical plan followed by the merged per-stage and
        per-operator rollup — the distributed half EXPLAIN ANALYZE
        previously lacked (it profiled only coordinator-local runs)."""
        from ..exec.session import QueryResult
        from ..planner.logical import explain_text
        t0 = time.monotonic()
        self._profile_tasks = True
        try:
            result = self._execute_stmt(stmt.query, sql)
        finally:
            self._profile_tasks = False
        if result is None:
            return None      # not eligible: local EXPLAIN ANALYZE runs
        self._finalize_rollup()
        lq = self.last_query
        inner = stmt.query
        wstmt = None
        if isinstance(inner, (A.InsertInto, A.CreateTable)):
            wstmt, inner = inner, inner.query
        rel = self.session.planner().plan_query(inner)
        lines = explain_text(prune_plan(rel.node)).split("\n")
        if wstmt is not None:
            cat, sch, tbl = self.session.resolve_table(wstmt.table)
            lines = [f"TableCommit[{cat}.{sch}.{tbl}]",
                     f"  TableWriter[{cat}.{sch}.{tbl}]"] + \
                [f"    {ln}" for ln in lines]
        stages: Dict[str, list] = {}
        for t in lq["tasks"]:
            s = stages.setdefault(t["stage"], [0, 0, 0, 0.0])
            s[0] += 1
            s[1] += t["splits"]
            s[2] += t["rows"]
            s[3] = max(s[3], t["wall_ms"])
        lines += ["", f"Distributed execution: {lq['stages']} stages, "
                      f"{len(lq['tasks'])} tasks, "
                      f"{lq['bytes_shuffled']} bytes shuffled, "
                      f"{lq['task_retries']} task retries, "
                      f"{lq['hedged_tasks']} hedged",
                  self._critical_path_line(t0),
                  f"scan: {lq.get('splits_total', 0)} splits, "
                  f"{lq.get('splits_pruned', 0)} pruned by zone maps"]
        wr = lq.get("write")
        if wr is not None:
            lines.append(f"write: {wr['partitions']} partitions, "
                         f"{wr['staged']} staged, "
                         f"{wr['deduped']} deduped, {wr['rows']} rows "
                         f"(stage {wr.get('stage_s', 0.0) * 1000:.1f}ms + "
                         f"commit {wr.get('commit_s', 0.0) * 1000:.1f}ms)")
        for name in sorted(stages):
            n, splits, rows, wall = stages[name]
            lines.append(f"Stage {name}: tasks={n}, splits={splits}, "
                         f"rows={rows}, max task wall={wall:.1f}ms")
        for op in sorted(lq["operators"]):
            d = lq["operators"][op]
            lines.append(f"  operator {op}: rows={d['rows']}, "
                         f"wall={d['wall_ms']:.1f}ms "
                         f"(device {d.get('device_ms', 0.0):.1f} + "
                         f"host {d.get('host_ms', 0.0):.1f} + "
                         f"compile {d.get('compile_ms', 0.0):.1f}), "
                         f"calls={d['calls']}")
        return QueryResult(["query plan"],
                           [(line,) for line in lines],
                           time.monotonic() - t0)

    # -- build stages ------------------------------------------------------

    def _bind_remotes(self, plan: L.PlanNode, materialized) -> L.PlanNode:
        from ..planner.fragmenter import _subtree_nodes
        mapping = {id(n): materialized[n.fragment_id]
                   for n in _subtree_nodes(plan)
                   if isinstance(n, L.RemoteSourceNode)}
        return L.replace_nodes(plan, mapping) if mapping else plan

    def _run_build_stage(self, plan: L.PlanNode) -> L.ValuesNode:
        """Execute one build fragment to completion and materialize its
        output as a broadcastable ValuesNode (REPLICATED distribution).
        Distributed over workers when the fragment's own driver table is
        split-worthy, else executed on the coordinator's devices."""
        from ..batch import batch_to_numpy
        out_node = L.OutputNode(plan, tuple(n for n, _ in plan.output),
                                plan.output)
        analysis = analyze(out_node, self.session.catalog, self.split_rows)
        workers = self.state.active_nodes()
        if analysis is not None and workers:
            pages = self._run_source_stage(workers, analysis, out_node)
            batch = self._merge_pages(out_node, analysis, pages)
        else:
            ex = self.session.executor
            batch = ex.run(plan)
        arrays, valids = batch_to_numpy(batch)
        # build output now lives on host inside the ValuesNode: drop the
        # device-side reservations the stage's plan-node runs took
        self.session.executor.release_all_reservations()
        return L.ValuesNode(arrays=tuple(arrays), valids=tuple(valids),
                            num_rows=len(arrays[0]) if arrays else 0,
                            fields=(), output=plan.output)

    def _merge_pages(self, root: L.OutputNode, analysis: ChunkAnalysis,
                     pages: List[dict]):
        """Merge source-stage partial pages and run the rest of the
        fragment — the FINAL step shared by build stages and the root
        stage. Partial-agg states re-aggregate with merge functions;
        concat-mode pages concatenate below the output node."""
        from ..batch import batch_from_numpy
        ex = self.session.executor
        saved = dict(ex._subst)
        saved_opaque = set(ex._subst_opaque)
        try:
            if analysis.merge_agg is not None:
                partials = []
                for p in pages:
                    arrs, vals = decode_columns(p)
                    if len(arrs) == 0 or len(arrs[0]) == 0:
                        continue
                    partials.append(batch_from_numpy(arrs, valids=vals,
                                                     device=ex.device))
                merged = merge_partials(ex, analysis.merge_agg, partials) \
                    if partials else self._empty_like(analysis.merge_agg)
                ex._subst[id(analysis.merge_agg)] = merged
                ex._subst_opaque.add(id(analysis.merge_agg))
            elif analysis.merge_sort is not None:
                arrs, vals = _merge_sorted_runs(
                    analysis.merge_sort, pages)
                ex._subst[id(analysis.merge_sort)] = batch_from_numpy(
                    arrs, valids=vals, device=ex.device)
                ex._subst_opaque.add(id(analysis.merge_sort))
            else:
                from .tasks import concat_pages
                arrs, vals = concat_pages(pages, root.child.output)
                ex._subst[id(root.child)] = batch_from_numpy(
                    arrs, valids=vals, device=ex.device)
                ex._subst_opaque.add(id(root.child))
            return ex.run(root.child)
        finally:
            ex._subst.clear()
            ex._subst.update(saved)
            ex._subst_opaque.clear()
            ex._subst_opaque.update(saved_opaque)

    # -- source stage ------------------------------------------------------

    def _make_splits(self, analysis: ChunkAnalysis) -> List[Split]:
        d = analysis.driver
        splits = [Split(d.catalog, d.schema_name, d.table, start,
                        min(self.split_rows, analysis.driver_rows - start))
                  for start in range(0, analysis.driver_rows,
                                     self.split_rows)]
        total = len(splits)
        # zone-map split pruning: drop row-range splits whose zones
        # provably cannot match the scan's pushed-down predicate — the
        # dispatch never happens (vs. the worker decoding the range and
        # filtering it to nothing). Advisory: the fragment's residual
        # filter makes dropping a MAY-match split unnecessary and keeping
        # a cannot-match split harmless.
        props = getattr(self.session, "properties", {})
        pred = getattr(d, "predicate", None)
        if pred is not None and props.get("enable_zone_map_pruning", True):
            try:
                from ..exec import zonemap
                data = self.session.catalog.get_table(
                    d.catalog, d.schema_name, d.table)
                zm = zonemap.zone_map_for(
                    data, props.get("zone_map_rows",
                                    zonemap.DEFAULT_ZONE_ROWS))
                kept = [s for s in splits
                        if zonemap.range_may_match(
                            zm, pred, d.column_indices, s.start, s.count)]
                # keep one split so every downstream merge path sees at
                # least one page; its residual filter drops all rows
                splits = kept or splits[:1]
            except Exception:   # noqa: BLE001 — pruning is best-effort
                pass
        pruned = total - len(splits)
        if pruned:
            self.stats["splits_pruned"] = \
                self.stats.get("splits_pruned", 0) + pruned
            SCAN_SPLITS_PRUNED.inc(pruned)
        lq = self.last_query
        if lq is not None:
            lq["splits_total"] = lq.get("splits_total", 0) + total
            lq["splits_pruned"] = lq.get("splits_pruned", 0) + pruned
        return splits

    def _run_source_stage(self, workers, analysis: ChunkAnalysis,
                          root: L.OutputNode) -> List[dict]:
        # agg mode: workers compute PARTIAL aggregates; sort mode: they
        # sort per split (sorted RUNS the coordinator n-way merges);
        # concat mode: they run everything below the output node
        fragment_root = analysis.merge_agg if analysis.merge_agg \
            is not None else (analysis.merge_sort
                              if analysis.merge_sort is not None
                              else root.child)
        frag = {"root": fragment_root, "driver": analysis.driver}
        if self._profile_tasks:
            # EXPLAIN ANALYZE: workers profile per-operator device time
            # (also keys the spool differently, so profiled runs never
            # reuse unprofiled spooled output)
            frag["profile"] = True
        blob = encode_fragment(frag)
        # the work key hashes (fragment, splits) but not data contents:
        # only deterministic generator sources may reuse spooled outputs
        # (a memory-connector table can change between attempts)
        use_spool = analysis.driver.catalog in ("tpch", "tpcds")
        splits = self._make_splits(analysis)
        # memory-aware placement: order workers by heartbeat-reported
        # reserved bytes so the round-robin lands extra splits on the
        # least-pressured nodes first (UniformNodeSelector weighted by
        # the ClusterMemoryManager's per-node view)
        workers = sorted(
            workers,
            key=lambda w: (getattr(w, "memory", None) or {}).get(
                "reserved", 0))
        # uniform assignment (UniformNodeSelector's round-robin core)
        assignment: Dict[str, List[Split]] = {w.node_id: [] for w in workers}
        by_id = {w.node_id: w for w in workers}
        for i, s in enumerate(splits):
            assignment[workers[i % len(workers)].node_id].append(s)

        pages: List[dict] = []
        pending = {nid: sp for nid, sp in assignment.items() if sp}
        retries = 0
        # backoff between retry rounds (decorrelated jitter): an
        # immediately-retried round lands on the same overloaded or
        # flapping survivors it just failed on
        backoff = RetryPolicy(self.retry_backoff_base_s,
                              self.retry_backoff_max_s,
                              max_attempts=self.max_task_retries + 2
                              ).delays()
        with self._tracer().span("source-stage", splits=len(splits),
                                 workers=len(workers)):
            pages = self._drain_rounds(pending, by_id, blob, use_spool,
                                       backoff)
        return pages

    def _drain_rounds(self, pending, by_id, blob, use_spool,
                      backoff) -> List[bytes]:
        pages: List[bytes] = []
        retries = 0
        migration_rounds = 0
        while pending:
            if self._query_dead():
                from ..exec.executor import QueryTerminatedError
                raise QueryTerminatedError(
                    "query terminated during stage drain")
            units: List[_HedgedUnit] = []
            for nid, sp in list(pending.items()):
                # durable-exchange hit: a prior attempt already produced
                # this work's output — consume the spool, skip dispatch
                key = self.spool.work_key(blob, sp)
                spooled = self.spool.get(key) if use_spool else None
                if spooled is not None:
                    pages.extend(spooled)
                    self.stats["spool_hits"] += 1
                    continue
                units.append(_HedgedUnit(nid, sp, key))
            failed_splits, failed_nodes, migrated = self._drain_units(
                units, by_id, blob, use_spool, pages)
            if not failed_splits:
                break
            if migrated:
                self.stats["splits_migrated"] += migrated
                SPLITS_MIGRATED.inc(migrated)
            if migrated == len(failed_splits):
                # pure drain handoff: the splits move to survivors
                # without burning retry budget, backoff, or the nodes'
                # detector records — the cluster is healthy, just
                # smaller. Bounded so a cluster draining faster than the
                # inventory updates cannot ping-pong forever.
                migration_rounds += 1
                if migration_rounds > 16:
                    raise TaskFailedError(
                        "drain handoff did not converge: " +
                        ", ".join(sorted(failed_nodes)))
            else:
                # task retry: reassign failed nodes' splits to survivors
                # (EventDrivenFaultTolerantQueryScheduler's per-task retry)
                self._amplify(1)
                retries += 1
                self.stats["task_retries"] += 1
                SCHED_TASK_RETRIES.inc()
                if retries > self.max_task_retries:
                    raise TaskFailedError(
                        "task retries exhausted: " +
                        ", ".join(sorted(failed_nodes)))
                time.sleep(next(backoff, self.retry_backoff_max_s))
            survivors = [w for w in self.state.active_nodes()
                         if w.node_id not in failed_nodes]
            if not survivors:
                raise TaskFailedError("no active workers left")
            workers = survivors
            by_id = {w.node_id: w for w in workers}
            redo: Dict[str, List[Split]] = {w.node_id: [] for w in workers}
            for i, s in enumerate(failed_splits):
                redo[workers[i % len(workers)].node_id].append(s)
            pending = {nid: sp for nid, sp in redo.items() if sp}
        return pages

    def _drain_units(self, units: List["_HedgedUnit"], by_id, blob: str,
                     use_spool: bool, pages: List[bytes]
                     ) -> Tuple[List[Split], Set[str], int]:
        """Dispatch and drain one round of work units CONCURRENTLY with
        straggler hedging. Successful units' pages append to `pages`
        (and spool, when eligible); returns (failed splits, failed node
        ids, migrated-split count) for the caller's retry round — a
        unit whose failures were ALL drain handoffs (409s from
        DRAINING workers) contributes to the migrated count and its
        nodes keep clean detector records.

        Hedging: once enough units complete to establish a median drain
        time, any unit still running past max(hedge_min_s, multiplier *
        median) gets a second, speculative attempt on a node it has not
        tried. The first successful attempt wins — a unit's attempts all
        compute the same deterministic split set, drains are
        all-or-nothing, and only the winning attempt's pages are kept
        (the spool's work-key dedup gives later query attempts the same
        guarantee) — so hedging can duplicate WORK but never RESULTS."""
        if not units:
            return [], set(), 0
        deadline = time.time() + self.task_timeout_s
        qd = self._query_deadline()
        if qd is not None:
            deadline = min(deadline, qd)
        lock = threading.Lock()
        durations: List[float] = []
        fence_errors: List[Exception] = []
        # capture the trace context ON THIS THREAD (the source-stage span
        # is open here; drain threads have empty span stacks)
        traceparent = self._tracer().traceparent()

        def attempt(unit: "_HedgedUnit", node) -> None:
            t0 = time.monotonic()
            with self._lock:
                self._seq += 1
                tid = f"t{self._seq}"
            task = RemoteTask(node, tid, blob, unit.splits,
                              injector=self.failure_injector,
                              traceparent=traceparent,
                              deadline=qd)
            with lock:
                unit.tasks.append(task)
            losers: List[RemoteTask] = []
            try:
                self._ledger_assign(task)
                task.start()
                self._livestats_register(task)
                self.stats["tasks"] += 1
                SCHED_TASKS.inc()
                drained = task.drain(deadline)
            except FencedError as e:
                # this coordinator is fenced, not the node: the stage
                # ends with the error once the round has drained
                with lock:
                    fence_errors.append(e)
                    unit.live -= 1
                return
            except (TaskFailedError, InjectedFailure, URLError,
                    HTTPError, OSError) as e:
                if isinstance(e, HTTPError) and e.code == 409:
                    # drain handoff: the worker refused the POST because
                    # it is winding down. No _mark_failed (the node is
                    # healthy), no detector sample — the splits simply
                    # migrate to a survivor in the next round.
                    with lock:
                        unit.failed_nodes.add(node.node_id)
                        unit.drained_nodes.add(node.node_id)
                        unit.live -= 1
                    return
                if isinstance(e, PageIntegrityError):
                    self.stats["checksum_failures"] += 1
                task.cancel()
                # a drain cut short by the query's own deadline (or a
                # query already terminal) says nothing of the node: it
                # stays schedulable for the next query
                if not (self._query_dead() or
                        (qd is not None and time.time() >= qd)):
                    self._mark_failed(node.node_id, e)
                with lock:
                    unit.failed_nodes.add(node.node_id)
                    unit.live -= 1
            else:
                with lock:
                    unit.live -= 1
                    if unit.pages is None:     # first success wins
                        unit.pages = drained
                        unit.winner = task
                        durations.append(time.monotonic() - t0)
                        losers = [t for t in unit.tasks if t is not task]
                        if unit.hedged and task is not unit.tasks[0]:
                            # the speculative attempt beat the original
                            self.stats["hedge_wins"] += 1
                            SCHED_HEDGE_WINS.inc()
                # abort outstanding hedge twins outside the lock — their
                # output is dropped either way
                for t in losers:
                    t.cancel()

        def launch(unit: "_HedgedUnit", node) -> None:
            with lock:
                unit.live += 1
                unit.nodes_used.add(node.node_id)
            t = threading.Thread(target=attempt, args=(unit, node),
                                 name=f"drain-{node.node_id}", daemon=True)
            t.start()

        for u in units:
            launch(u, by_id[u.first_node])

        while time.time() < deadline + 5.0:
            if self._query_dead():
                break    # terminate() fan-out already DELETEd the tasks
            with lock:
                unresolved = [u for u in units
                              if u.pages is None and u.live > 0]
                if not unresolved:
                    break
                med = statistics.median(durations) if durations else None
            # drain-aware hedging: a unit whose attempt is running on a
            # node the inventory now shows DRAINING hedges immediately —
            # the drain deadline may cut that attempt off, so a
            # survivor copy starts NOW instead of after the straggler
            # threshold (first success still wins either way)
            with self.state.nodes_lock:
                draining = {nid for nid, n in self.state.nodes.items()
                            if n.state in ("DRAINING", "DRAINED")}
            # live-evidence straggler feed (server/livestats.py): a
            # RUNNING task whose heartbeat-observed per-split pace trails
            # its stage peers past the hedge multiplier is treated like a
            # draining node — its unit hedges NOW on live skew evidence
            # rather than waiting out the wall-clock threshold
            live_skew: Set[str] = set()
            if self.livestats is not None:
                lq_qid = (self.last_query or {}).get("query_id")
                if lq_qid:
                    live_skew = self.livestats.straggler_task_ids(
                        lq_qid, self.hedge_multiplier)
            if self.hedge_multiplier > 0 and \
                    (med is not None or draining or live_skew):
                threshold = max(self.hedge_min_s,
                                self.hedge_multiplier * med) \
                    if med is not None else float("inf")
                now = time.monotonic()
                for u in unresolved:
                    candidate = None
                    with lock:
                        urgent = bool(u.nodes_used & draining) or \
                            any(t.task_id in live_skew
                                for t in u.tasks)
                        if u.hedged or u.pages is not None or \
                                (not urgent and
                                 now - u.started < threshold):
                            continue
                        for w in self.state.active_nodes():
                            if w.node_id not in u.nodes_used:
                                candidate = w
                                break
                        if candidate is None:
                            continue
                        u.hedged = True
                    if not self._amplify(required=False):
                        # amplification budget spent: no more hedges
                        # this query (the original attempt still runs)
                        continue
                    self.stats["hedged_tasks"] += 1
                    SCHED_HEDGES.inc()
                    launch(u, candidate)
            time.sleep(0.02)

        if fence_errors:
            raise fence_errors[0]
        failed_splits: List[Split] = []
        failed_nodes: Set[str] = set()
        migrated = 0
        with lock:
            resolved = [(u, u.pages, u.winner) for u in units]
        for u, got, winner in resolved:
            if got is not None:
                pages.extend(got)
                if use_spool:
                    self.spool.put(u.key, got)
                    self._ledger_spool(u.key)
                if winner is not None:
                    # TaskStats + worker spans ride the terminal status —
                    # fetched HERE (main thread, before the stage
                    # returns) so the rollup is complete by the time the
                    # dispatcher publishes the completion event
                    self._record_task(winner)
            else:
                failed_splits.extend(u.splits)
                failed_nodes.update(u.failed_nodes or {u.first_node})
                if u.failed_nodes and \
                        u.failed_nodes <= u.drained_nodes:
                    migrated += len(u.splits)
        return failed_splits, failed_nodes, migrated

    def _mark_failed(self, node_id: str, err: Exception) -> None:
        with self.state.nodes_lock:
            n = self.state.nodes.get(node_id)
            if n is not None:
                n.state = "FAILED"
        # record the task-path failure into the heartbeat detector's
        # decayed stats too: without this, the node's very next
        # successful ping (or re-announce) flips it straight back to
        # ACTIVE even while its task executor is wedged — now the same
        # hysteresis that governs ping failures applies (it must sustain
        # several clean pings before rejoining the schedulable set)
        det = getattr(self.state, "failure_detector", None)
        if det is not None:
            det.record_failure(node_id)

    # -- final stage -------------------------------------------------------

    def _run_final_stage(self, rel, root: L.OutputNode,
                         analysis: ChunkAnalysis, pages: List[dict]):
        from ..exec.session import QueryResult
        ex = self.session.executor
        batch = self._merge_pages(root, analysis, pages)
        names, arrays, valids = ex.result_to_host(root, batch)
        rows = self.session.decode_rows(rel, arrays, valids)
        # the merge ran plan nodes outside execute(): release their pool
        # reservations now that the result is host rows — otherwise a
        # stream of distributed queries leaks the pool dry
        ex.release_all_reservations()
        return QueryResult(names, rows, 0.0, ex.stats)

    def _empty_like(self, agg: L.AggregateNode):
        from ..batch import batch_from_numpy
        arrs = [np.zeros(0, dtype=dt.np_dtype) for _, dt in agg.output]
        return batch_from_numpy(arrs, device=self.session.executor.device)

    # -- partitioned worker<->worker exchange ------------------------------
    #
    # A 3-stage tree (PipelinedQueryScheduler's FIXED_HASH_DISTRIBUTION
    # path): stage A streams the probe side's splits and hash-partitions
    # its output by the join keys into P buffers; stage B does the same
    # for the build side; stage C runs P exchange-consumer tasks, task p
    # pulling buffer p from EVERY upstream task (worker<->worker binary
    # page frames, DirectExchangeClient.java:56) and running
    # join+partial-agg on its co-partitioned slice; the coordinator FINAL
    # merges. Pulls overlap production: C tasks start with A/B and poll
    # buffers until upstream completes.

    def _analyze_partitioned(self, root: L.OutputNode):
        """Match Agg(Filter/Project*(Join(probe, build))) where BOTH join
        sides contain split-worthy scans and every join key is integer-
        typed (dictionary varchar codes are per-table, so hash routing
        on them would be inconsistent across tables). Returns (join,
        merge_agg, probe_driver, build_driver) or None."""
        from ..exec.chunked import MERGE_FUNC
        from ..planner.fragmenter import _scan_rows, _subtree_nodes
        # phase 1 — above the merge point: Sort/Limit/Filter/Project all
        # run on the coordinator after the merge, so they may be skipped
        node = root.child
        merge_agg = None
        while isinstance(node, (L.FilterNode, L.ProjectNode,
                                L.SortNode, L.LimitNode)):
            node = node.child
        if isinstance(node, L.AggregateNode):
            if any(a.distinct for a in node.aggs) or \
                    any(a.func not in MERGE_FUNC for a in node.aggs):
                return None
            merge_agg = node
            node = node.child
        if merge_agg is None:     # concat-mode repartition needs ordered
            return None           # merge support; agg merge only for now
        # phase 2 — below the merge point, INSIDE the consumer fragment:
        # only order-insensitive nodes are allowed (a Sort/Limit here
        # would compute per-partition top-N, not global)
        while isinstance(node, (L.FilterNode, L.ProjectNode)):
            node = node.child
        if not isinstance(node, L.JoinNode) or node.null_aware or \
                node.kind not in ("inner", "left", "semi", "anti"):
            return None
        join = node
        for side, keys in ((join.left, join.left_keys),
                           (join.right, join.right_keys)):
            for k in keys:
                dt = side.output[k][1]
                if not np.issubdtype(np.dtype(dt.np_dtype), np.integer):
                    return None

        def driver_of(side):
            scans = [n for n in _subtree_nodes(side)
                     if isinstance(n, L.ScanNode)]
            if not scans:
                return None
            d = max(scans, key=lambda s: _scan_rows(
                self.session.catalog, s))
            return d if _scan_rows(self.session.catalog, d) > \
                self.split_rows else None

        probe_driver = driver_of(join.left)
        build_driver = driver_of(join.right)
        if probe_driver is None or build_driver is None:
            return None
        # the worker streams splits of the driver scan; everything else
        # in the side's subtree must be split-invariant (pinned)
        for side, driver in ((join.left, probe_driver),
                             (join.right, build_driver)):
            an = analyze(L.OutputNode(side, tuple(n for n, _ in
                                                  side.output),
                                      side.output),
                         self.session.catalog, self.split_rows)
            if an is None or an.driver is not driver:
                return None
        return join, merge_agg, probe_driver, build_driver

    def _execute_partitioned(self, rel, root: L.OutputNode, workers,
                             desc):
        join, merge_agg, probe_driver, build_driver = desc
        P = len(workers)
        t_deadline = time.time() + self.task_timeout_s
        qd = self._query_deadline()
        if qd is not None:
            t_deadline = min(t_deadline, qd)
        traceparent = self._tracer().traceparent()

        def stage_tasks(side_root, driver, keys):
            blob = encode_fragment({"root": side_root, "driver": driver})
            rows = self.session.catalog.get_table(
                driver.catalog, driver.schema_name, driver.table).num_rows
            splits = [Split(driver.catalog, driver.schema_name,
                            driver.table, start,
                            min(self.split_rows, rows - start))
                      for start in range(0, rows, self.split_rows)]
            tasks = []
            for wi, w in enumerate(workers):
                sp = [s for i, s in enumerate(splits)
                      if i % len(workers) == wi]
                if not sp:
                    continue
                with self._lock:
                    self._seq += 1
                    tid = f"t{self._seq}"
                task = RemoteTask(w, tid, blob, sp,
                                  partition={"keys": list(keys),
                                             "count": P},
                                  injector=self.failure_injector,
                                  traceparent=traceparent,
                                  deadline=qd)
                self._ledger_assign(task)
                task.start()
                self._livestats_register(task)
                self.stats["tasks"] += 1
                SCHED_TASKS.inc()
                tasks.append(task)
            return tasks

        a_tasks = stage_tasks(join.left, probe_driver, join.left_keys)
        b_tasks = stage_tasks(join.right, build_driver, join.right_keys)

        rs_a = L.RemoteSourceNode(1, join.left.output)
        rs_b = L.RemoteSourceNode(2, join.right.output)
        c_root = L.replace_nodes(
            merge_agg, {id(join.left): rs_a, id(join.right): rs_b})
        blob_c = encode_fragment({"root": c_root,
                                  "timeout_s": self.task_timeout_s})
        c_tasks = []
        for p in range(P):
            sources = {
                "1": [{"uri": t.node.uri, "taskId": t.task_id,
                       "buffer": p} for t in a_tasks],
                "2": [{"uri": t.node.uri, "taskId": t.task_id,
                       "buffer": p} for t in b_tasks],
            }
            with self._lock:
                self._seq += 1
                tid = f"t{self._seq}"
            task = RemoteTask(workers[p % len(workers)], tid, blob_c, [],
                              sources=sources,
                              injector=self.failure_injector,
                              traceparent=traceparent,
                              deadline=qd)
            self._ledger_assign(task)
            task.start()
            self._livestats_register(task)
            self.stats["tasks"] += 1
            SCHED_TASKS.inc()
            c_tasks.append(task)

        pages: List[bytes] = []
        try:
            for t in c_tasks:
                pages.extend(t.drain(t_deadline))
            for t in a_tasks + b_tasks:
                t.wait_finished(t_deadline)
        except Exception:
            for t in a_tasks + b_tasks + c_tasks:
                t.cancel()
            raise
        for t in a_tasks + b_tasks + c_tasks:
            self._record_task(t)
        self.stats["stages"] = self.stats.get("stages", 0) + 4
        self.stats["partitioned_joins"] = \
            self.stats.get("partitioned_joins", 0) + 1
        shim = ChunkAnalysis(None, merge_agg, [], 0)
        return self._run_final_stage(rel, root, shim, pages)
