"""Worker-side task execution: the engine's L5.

Reference: TaskResource (server/TaskResource.java:93 — createOrUpdateTask
:146, results :332, ack :372, fail :319) backed by SqlTaskManager
(execution/SqlTaskManager.java:107, updateTask:491) and SqlTaskExecution
(execution/SqlTaskExecution.java:81): the coordinator POSTs a plan fragment
plus split assignments; the worker runs the fragment over each split and
stages output pages for downstream pull.

Port of ``trino_tpu/server/tasks.py``. A *fragment* is a logical-plan
subtree in the JSON serde (server/serde.py, the reference's wire form, so a
JAX coordinator can drive port workers) whose leaf scan is replaced per
split by a row-range of the table (split scheduling,
SourcePartitionedScheduler.java:247's batches); the worker executes it with
its own Executor on its device (the card unless the caller names the CPU)
and serves *partial result pages* (host numpy columns): the PARTIAL side of
Trino's exchange. The final stage merges on the coordinator. Output pages
use token-based pull with acks, the OutputBuffer protocol (execution/buffer/
PartitionedOutputBuffer.java:42) reduced to its sequential-consumer core.
"""

from __future__ import annotations

import base64
import logging
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..metrics import TASK_OUTPUT_BYTES, TASK_OUTPUT_ROWS
from ..utils.tracing import NOOP, Tracer

log = logging.getLogger("trino_tpu.tasks")


# --------------------------------------------------------------------------
# wire serde: numpy column sets and plan fragments
# (PagesSerde's role, execution/buffer/CompressingEncryptingPageSerializer.java:60)
# Pages are length-prefixed binary frames with zstd/zlib compression
# (server/pageserde.py); the worker serves them raw on the binary results
# route and base64-wrapped on the legacy JSON route.
# --------------------------------------------------------------------------

def encode_columns(arrays: List[np.ndarray],
                   valids: List[np.ndarray]) -> bytes:
    from .pageserde import encode_page
    return encode_page(arrays, valids)


def decode_columns(page) -> tuple:
    """Accepts a binary frame (bytes), its base64 JSON wrapping
    ({"b64": ...}), or the round-3 dict layout (rolling upgrade)."""
    from .pageserde import decode_page
    if isinstance(page, (bytes, bytearray)):
        return decode_page(bytes(page))
    if isinstance(page, dict) and "b64" in page:
        return decode_page(base64.b64decode(page["b64"]))
    arrays, valids = [], []
    for c in page["columns"]:
        a = np.frombuffer(base64.b64decode(c["data"]),
                          dtype=np.dtype(c["dtype"]))
        v = np.frombuffer(base64.b64decode(c["valid"]), dtype=np.bool_)
        arrays.append(a)
        valids.append(v)
    return arrays, valids


def concat_pages(pages, out_types) -> tuple:
    """Decode + concatenate page frames into one (arrays, valids) column
    set; zero-row input yields empty columns typed from `out_types`
    (pairs of (name, dtype)). Shared by the coordinator merge and the
    exchange consumer."""
    cols = None
    for p in pages:
        arrs, vals = decode_columns(p)
        if len(arrs) == 0 or len(arrs[0]) == 0:
            continue
        if cols is None:
            cols = [[a] for a in arrs], [[v] for v in vals]
        else:
            for j, a in enumerate(arrs):
                cols[0][j].append(a)
                cols[1][j].append(vals[j])
    if cols is not None:
        return ([np.concatenate(c) for c in cols[0]],
                [np.concatenate(c) for c in cols[1]])
    arrs = [np.zeros(0, dtype=dt.np_dtype) for _, dt in out_types]
    return arrs, [np.zeros(0, dtype=np.bool_) for _ in arrs]


def encode_fragment(root) -> str:
    """Plan subtree -> wire form: a data-only JSON serde (server/serde.py),
    the analog of the reference's Jackson-serialized PlanFragment — a
    crafted POST body can at worst build a malformed plan, never run code."""
    from . import serde
    return serde.dumps(root)


def decode_fragment(blob: str):
    from . import serde
    return serde.loads(blob)


def _subtree_nodes_all(root):
    """Every node of a fragment subtree (id -> operator-name mapping for
    per-operator TaskStats)."""
    from ..planner.fragmenter import _subtree_nodes
    return _subtree_nodes(root)


def _static_subtrees(root, driver) -> list:
    """Maximal subtrees of `root` that do not contain the driver scan —
    join build sides and friends, constant across splits. Bare scans and
    values leaves are excluded (the scan cache already memoizes them)."""
    from ..planner import logical as L
    memo = {}

    def contains(n) -> bool:
        r = memo.get(id(n))
        if r is None:
            r = n is driver or any(contains(c) for c in L.children(n))
            memo[id(n)] = r
        return r

    out = []

    def walk(n):
        for c in L.children(n):
            if contains(c):
                walk(c)
            elif not isinstance(c, (L.ScanNode, L.ValuesNode)):
                out.append(c)

    if contains(root):
        walk(root)
    return out


@dataclass(frozen=True)
class Split:
    """A row-range of one table (ConnectorSplit reduced to the range case;
    the tpch/tpcds/memory connectors are all range-splittable)."""
    catalog: str
    schema_name: str
    table: str
    start: int
    count: int


# --------------------------------------------------------------------------
# hash partitioning for the worker<->worker exchange
# (operator/output/PagePartitioner.java:135's role; the hash must be
# identical on every worker so co-partitioned sides land together)
# --------------------------------------------------------------------------

def _splitmix64(x: np.ndarray) -> np.ndarray:
    """uint64 -> uint64 mix (same finalizer family as the reference's
    XxHash64-based partitioning — any good avalanche works, it only has
    to be consistent across workers)."""
    z = x + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def partition_assignment(arrays, valids, key_idxs, count: int):
    """Per-row partition ids from the key columns. Integer-typed keys
    only (dictionary varchar codes are per-table and would partition
    inconsistently across tables); NULLs hash to a fixed marker so every
    worker routes them identically."""
    n = len(arrays[0]) if arrays else 0
    h = np.zeros(n, np.uint64)
    with np.errstate(over="ignore"):
        for j, i in enumerate(key_idxs):
            a = arrays[i]
            if not np.issubdtype(a.dtype, np.integer) and \
                    a.dtype != np.bool_:
                raise ValueError(
                    f"partitioned exchange requires integer keys, "
                    f"got {a.dtype}")
            k = a.astype(np.int64).view(np.uint64)
            k = np.where(valids[i], k, np.uint64(0xA5A5A5A5A5A5A5A5))
            h ^= _splitmix64(k + np.uint64(j))
    return (h % np.uint64(count)).astype(np.int64)


# --------------------------------------------------------------------------
# task state + manager
# --------------------------------------------------------------------------

TASK_STATES = ("PENDING", "RUNNING", "FINISHED", "FAILED", "CANCELED",
               "ABANDONED")


@dataclass
class WorkerTask:
    """One task's state. Output is a set of numbered buffers: buffer 0
    for the plain single-consumer case, buffers 0..P-1 when `partition`
    is set (PartitionedOutputBuffer.java:42's role). `sources` makes the
    task an exchange CONSUMER: instead of splits it pulls its partition
    from upstream tasks on other workers (worker<->worker data plane,
    DirectExchangeClient.java:56)."""
    task_id: str
    fragment_blob: str
    splits: List[Split]
    # {"keys": [out col idx, ...], "count": P} -> partitioned output
    partition: Optional[dict] = None
    # {fragment_id(str): [{"uri","taskId","buffer"}, ...]} -> pull inputs
    sources: Optional[dict] = None
    state: str = "PENDING"
    error: str = ""
    buffers: Dict[int, List[bytes]] = field(default_factory=dict)
    acked: Dict[int, int] = field(default_factory=dict)
    splits_done: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock)
    # observability: W3C trace context adopted from the coordinator's
    # POST, per-task output accounting (TaskStats), and the worker-side
    # spans shipped back with the terminal status for trace stitching
    traceparent: Optional[str] = None
    rows_out: int = 0
    bytes_out: int = 0
    stats: Dict[str, object] = field(default_factory=dict)
    spans: List[dict] = field(default_factory=list)
    # exchange backpressure: bytes currently staged across all buffers
    # (un-acked pages) and how often the producer had to pause for a
    # slow consumer (OutputBuffer's maxBufferedBytes + isFull blocking)
    buffered_bytes: int = 0
    backpressure_waits: int = 0
    # staged-file manifest for write tasks (rides terminal status stats;
    # publication is the coordinator's commit, never this worker's)
    manifest: Optional[dict] = None
    # live observability (round-21): a manager-global change sequence
    # stamped on every counter move (the heartbeat's delta cursor), the
    # task's start stamp (live wall), and device/host/compile ms
    # accumulated so far — terminal status_json never reads these, so
    # the terminal wire format stays byte-identical with heartbeats off
    live_seq: int = 0
    started_at: float = 0.0
    device_ms: float = 0.0
    host_ms: float = 0.0
    compile_ms: float = 0.0
    # query-lifetime enforcement (round-22): worker-monotonic execution
    # cutoff derived from the coordinator's clock-skew-normalized wall
    # deadline shipped with the task POST (None = no cap), and the
    # orphan reaper's liveness stamp — the last monotonic time a
    # coordinator request (status/results/delete/update) referenced
    # this task
    deadline: Optional[float] = None
    last_referenced: float = 0.0

    def __post_init__(self):
        self.last_referenced = time.monotonic()
        # producer/consumer rendezvous sharing the task lock: _emit
        # waits on it when the buffer is full, the results route
        # notifies as acks drain pages
        self.cond = threading.Condition(self.lock)

    @property
    def pages(self) -> List[bytes]:       # legacy single-buffer view
        return self.buffers.setdefault(0, [])

    def total_pages(self) -> int:
        return sum(len(v) for v in self.buffers.values()) + \
            sum(self.acked.values())


class TaskManager:
    """SqlTaskManager's role: registry + execution of tasks on this
    worker. Execution runs on a worker thread per task; the handler
    returns immediately (the reference's updateTask is async the same
    way)."""

    def __init__(self, catalog, injector=None, node_id: str = "worker",
                 device=None):
        import os
        from ..exec.session import resolve_device
        self.catalog = catalog
        # the card unless the caller names the CPU (resolve_device raises
        # without CUDA): splits, builds and exchange inputs all land here
        self.device = resolve_device(device)
        self.node_id = node_id            # span service attribution
        self.tasks: Dict[str, WorkerTask] = {}
        self._lock = threading.Lock()
        self.injector = injector          # FailureInjector hook
        self.tasks_run = 0                # observability counter
        # terminal-status push hook (WorkerServer wires it): fired once
        # from the task thread when a task reaches FINISHED/FAILED/
        # CANCELED, after stats finalize — the worker-initiated half of
        # status delivery that survives a coordinator failover
        self.on_terminal = None
        # exchange backpressure: per-task output-buffer byte bound — a
        # slow consumer pauses the producer instead of ballooning the
        # worker's memory (PartitionedOutputBuffer's max-buffered-bytes)
        self.max_buffer_bytes = int(os.environ.get(
            "TRINO_TPU_TASK_BUFFER_BYTES", 64 << 20))
        # hard cap on one producer pause so a dead consumer degrades to
        # an unbounded buffer (memory risk) rather than a hung task;
        # per-task deadlines cap it further, and the degrade is counted
        # + logged (round-22) so it is never silent
        self.backpressure_timeout_s = 300.0
        # orphan reaping (round-22): tasks no coordinator request has
        # referenced for this long are abandoned — buffers freed, state
        # ABANDONED — so a dead coordinator cannot leak worker memory
        self.task_abandonment_timeout_s = float(os.environ.get(
            "TRINO_TPU_TASK_ABANDONMENT_S", 600.0))
        # the task currently holding the exec lock (cancel propagation
        # target: a DELETE for it interrupts the running split
        # cooperatively via the executor's check_cancel points)
        self._current_task_id: Optional[str] = None
        # one Executor per worker; the lock serializes device use within
        # this worker
        from ..exec.executor import Executor
        self._executor = Executor(catalog, self.device)
        # executor-side chaos points (e.g. SCAN_PREFETCH in the chunked
        # driver's prefetch worker) share this worker's injector, so the
        # same seeded schedule covers threads the task manager spawns
        self._executor.failure_injector = injector
        self._exec_lock = threading.Lock()
        # live observability (round-21): one monotonically-increasing
        # change sequence across ALL tasks (the heartbeat delta cursor)
        # plus cumulative split-execution busy time split by tier —
        # device (fenced dispatch wall from profiled runs) vs host
        # (interpreter wall). Both are plain counters bumped on the task
        # thread; no thread, no timer, nothing runs unless read.
        self._live_lock = threading.Lock()
        self._live_seq = 0
        self.busy_device_ms = 0.0
        self.busy_host_ms = 0.0

    def create_or_update(self, task_id: str, fragment_blob: str,
                         splits: List[Split], partition: dict = None,
                         sources: dict = None,
                         traceparent: str = None,
                         deadline: float = None) -> WorkerTask:
        if self.injector is not None:
            # chaos: fail/delay/drop task intake (the worker dies or
            # hangs between accept and ack — TaskResource's createOrUpdate
            # boundary); the coordinator sees a failed POST and reassigns
            self.injector.maybe_fail("WORKER_TASK_CREATE", task_id)
        with self._lock:
            task = self.tasks.get(task_id)
            if task is None:
                task = WorkerTask(task_id, fragment_blob, splits,
                                  partition=partition, sources=sources,
                                  traceparent=traceparent)
                if deadline is not None:
                    # `deadline` is wall time on THIS worker's clock (the
                    # coordinator normalized its absolute deadline by the
                    # node's announce-measured clock offset); convert to
                    # a monotonic cutoff so wall jumps can't extend it
                    task.deadline = time.monotonic() + max(
                        0.0, deadline - time.time())
                self.tasks[task_id] = task
                t = threading.Thread(target=self._run, args=(task,),
                                     name=f"task-{task_id}", daemon=True)
                t.start()
            else:
                task.last_referenced = time.monotonic()
            return task

    def get(self, task_id: str) -> Optional[WorkerTask]:
        return self.tasks.get(task_id)

    def touch(self, task_id: str) -> None:
        """Stamp a coordinator reference (status/results/delete pull) —
        the orphan reaper's liveness signal."""
        task = self.tasks.get(task_id)
        if task is not None:
            task.last_referenced = time.monotonic()

    def cancel(self, task_id: str) -> None:
        task = self.tasks.get(task_id)
        if task is not None:
            with task.cond:
                task.last_referenced = time.monotonic()
                if task.state in ("PENDING", "RUNNING"):
                    task.state = "CANCELED"
                # wake a producer paused on a full output buffer
                task.cond.notify_all()
            # cooperative interrupt: if this task holds the exec lock,
            # the running split bails at the executor's next
            # check_cancel point (chunk/partition/prefetch boundary)
            # instead of running the split to completion
            if self._current_task_id == task_id:
                self._executor.request_cancel(
                    f"task {task_id} canceled")
            self._note_live_change(task)

    def reap_orphans(self, timeout_s: Optional[float] = None) -> List[str]:
        """Abandon tasks no coordinator request has referenced for
        `timeout_s`: free their staged output buffers and mark them
        ABANDONED so running split loops bail at the next boundary.
        Returns the reaped task ids. The worker's announce loop drives
        this — and fences it off entirely around coordinator failover
        (worker.py) so a promoted standby reattaching to live tasks is
        never raced by the reaper."""
        if timeout_s is None:
            timeout_s = self.task_abandonment_timeout_s
        now = time.monotonic()
        reaped: List[str] = []
        with self._lock:
            tasks = list(self.tasks.values())
        for t in tasks:
            with t.cond:
                if t.state not in ("PENDING", "RUNNING", "FINISHED"):
                    continue
                if now - t.last_referenced < timeout_s:
                    continue
                t.state = "ABANDONED"
                t.buffers.clear()
                t.buffered_bytes = 0
                t.cond.notify_all()
            if self._current_task_id == t.task_id:
                self._executor.request_cancel(
                    f"task {t.task_id} abandoned (orphaned)")
            reaped.append(t.task_id)
            from ..metrics import TASKS_ABANDONED
            TASKS_ABANDONED.inc()
            log.warning("reaped orphaned task %s (unreferenced %.1fs)",
                        t.task_id, now - t.last_referenced)
            self._note_live_change(t)
        return reaped

    def inflight(self) -> List[str]:
        """Ids of tasks still PENDING/RUNNING (drain bookkeeping)."""
        with self._lock:
            return [t.task_id for t in self.tasks.values()
                    if t.state in ("PENDING", "RUNNING")]

    def inventory(self) -> List[dict]:
        """Compact id/state list of every task this worker holds. Rides
        each announce body so a promoted coordinator can reconcile its
        ledger-replayed task assignments against what actually survived
        the old primary's death."""
        with self._lock:
            return [{"taskId": t.task_id, "state": t.state}
                    for t in self.tasks.values()]

    # -- live observability (round-21) -------------------------------------

    def _note_live_change(self, task: WorkerTask) -> None:
        """Stamp `task` with the next global change sequence. Called on
        the task thread whenever a live-visible counter moves (split
        done, page staged, state transition) so the heartbeat's delta
        encoder can ship ONLY tasks that changed since its cursor."""
        with self._live_lock:
            self._live_seq += 1
            task.live_seq = self._live_seq

    def _note_busy(self, device_ms: float, host_ms: float) -> None:
        with self._live_lock:
            self.busy_device_ms += device_ms
            self.busy_host_ms += host_ms

    def busy_ms(self) -> dict:
        """Cumulative split-execution busy time by tier — the worker's
        utilization numerator (the heartbeat divides deltas of this by
        wall to get the per-interval busy fraction)."""
        with self._live_lock:
            return {"deviceMs": round(self.busy_device_ms, 3),
                    "hostMs": round(self.busy_host_ms, 3)}

    def live_status(self, task: WorkerTask) -> dict:
        """Bounded incremental TaskStats for one task: fixed scalar
        fields only (no operators/spans/manifest), so a 100-task fanout
        heartbeat stays byte-bounded."""
        with task.lock:
            if task.started_at and task.state == "RUNNING":
                wall_ms = (time.monotonic() - task.started_at) * 1000
            else:
                wall_ms = float(task.stats.get("wallMs", 0.0)) \
                    if task.stats else 0.0
            return {"taskId": task.task_id, "state": task.state,
                    "seq": task.live_seq,
                    "splitsDone": task.splits_done,
                    "splitsTotal": len(task.splits),
                    "rowsOut": task.rows_out,
                    "bytesOut": task.bytes_out,
                    "wallMs": round(wall_ms, 3),
                    "deviceMs": round(task.device_ms, 3),
                    "hostMs": round(task.host_ms, 3),
                    "compileMs": round(task.compile_ms, 3)}

    def live_delta(self, since: int = 0) -> tuple:
        """(cursor, entries): live status of every task whose change
        sequence advanced past `since`, plus the cursor to pass next
        time. Entries carry ABSOLUTE counter values (folds are
        idempotent), the delta encoding is in which tasks ship at all —
        an idle worker's heartbeat is an empty list."""
        with self._lock:
            tasks = list(self.tasks.values())
        with self._live_lock:
            cursor = self._live_seq
        entries = [self.live_status(t) for t in tasks
                   if t.live_seq > since]
        return cursor, entries

    def unflushed(self) -> List[str]:
        """Ids of finished tasks whose output buffers still hold
        un-acked pages — a draining worker keeps serving these until its
        downstream consumers pull them (or the drain deadline passes and
        the scheduler's retry machinery re-runs the work elsewhere)."""
        out = []
        with self._lock:
            tasks = list(self.tasks.values())
        for t in tasks:
            with t.cond:
                if t.state == "FINISHED" and any(t.buffers.values()):
                    out.append(t.task_id)
        return out

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Bounded graceful drain: wait for every in-flight task to reach
        a terminal state, then for every finished task's output buffers
        to be fully pulled/acked by their consumers. Returns True when
        the worker quiesced cleanly (no orphaned splits, no unflushed
        pages) within the budget. The caller stops accepting NEW task
        POSTs before calling this; existing buffers stay pullable
        throughout and after."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        while (self.inflight() or self.unflushed()) and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        return not self.inflight() and not self.unflushed()

    def memory_info(self) -> dict:
        """Pool snapshot + staged output bytes, reported on /v1/status so
        heartbeats carry this worker's memory to the coordinator's
        ClusterMemoryManager."""
        snap = self._executor.pool.snapshot()
        with self._lock:
            snap["outputBufferBytes"] = sum(
                t.buffered_bytes for t in self.tasks.values())
        return snap

    def _stage_page(self, task: WorkerTask, buffer: int, page: bytes,
                    rows: int) -> None:
        """Append one page under backpressure: while the task's staged
        bytes exceed the bound, the producer waits for consumer acks —
        a slow consumer can no longer balloon this worker's memory. A
        single page larger than the bound always proceeds (progress
        guarantee), as does a task leaving RUNNING."""
        import time as _time
        deadline = _time.monotonic() + self.backpressure_timeout_s
        if task.deadline is not None:
            # the query's deadline caps the pause: a query about to
            # expire must not sit 300s behind a dead consumer first
            deadline = min(deadline, task.deadline)
        with task.cond:
            waited = False
            while task.buffered_bytes + len(page) > self.max_buffer_bytes \
                    and task.buffered_bytes > 0 \
                    and task.state == "RUNNING" \
                    and _time.monotonic() < deadline:
                if not waited:
                    waited = True
                    task.backpressure_waits += 1
                    from ..metrics import BACKPRESSURE_WAITS
                    BACKPRESSURE_WAITS.inc()
                task.cond.wait(0.05)
            if waited and task.state == "RUNNING" \
                    and task.buffered_bytes + len(page) > \
                    self.max_buffer_bytes \
                    and _time.monotonic() >= deadline:
                # the degrade-to-unbounded escape hatch fired: count it
                # and name the task so the memory risk is attributable
                from ..metrics import BACKPRESSURE_DEADLINE_DEGRADES
                BACKPRESSURE_DEADLINE_DEGRADES.inc()
                log.warning(
                    "task %s: backpressure wait expired; staging page "
                    "past the %d-byte buffer bound (consumer stalled)",
                    task.task_id, self.max_buffer_bytes)
            task.buffers.setdefault(buffer, []).append(page)
            task.buffered_bytes += len(page)
            task.rows_out += rows
            task.bytes_out += len(page)
        TASK_OUTPUT_ROWS.inc(rows)
        TASK_OUTPUT_BYTES.inc(len(page))
        self._note_live_change(task)

    def _emit(self, task: WorkerTask, arrs, vals) -> None:
        """Stage one result batch into the task's output buffers,
        hash-partitioned when the task has a partition spec. Rows/bytes
        are counted on the host arrays (already materialized — no device
        sync) into the task's TaskStats and the process metrics."""
        rows = len(arrs[0]) if arrs else 0
        if task.partition is None:
            self._stage_page(task, 0, encode_columns(arrs, vals), rows)
            return
        keys, count = task.partition["keys"], task.partition["count"]
        part = partition_assignment(arrs, vals, keys, count)
        for p in range(count):
            m = part == p
            if not m.any():
                continue
            page = encode_columns([a[m] for a in arrs],
                                  [v[m] for v in vals])
            self._stage_page(task, p, page, int(m.sum()))

    def _tracer_for(self, task: WorkerTask) -> Tracer:
        """Worker-side tracer adopting the coordinator's trace context —
        spans stitch under the coordinator span that POSTed the task. No
        traceparent (tracing off for the query) = zero-overhead NOOP."""
        if task.traceparent is None:
            return NOOP
        return Tracer.from_traceparent(task.traceparent,
                                       service=f"worker:{self.node_id}")

    @staticmethod
    def _fold_node_stats(ex, names: Dict[int, str],
                         op_agg: Dict[str, list]) -> None:
        """Aggregate one profiled run's per-node stats into per-operator
        totals [wall_ms, rows, calls, device_ms, host_ms, compile_ms]
        and reset for the next split. Fenced runs (exec/profiler.py)
        carry the device/host/compile split; the components sum to
        wall, so the rollup preserves that invariant per operator."""
        for nid, st in ex.node_stats.items():
            acc = op_agg.setdefault(names.get(nid, "?"),
                                    [0.0, 0, 0, 0.0, 0.0, 0.0])
            acc[0] += st[0] * 1000
            acc[1] += st[1]
            acc[2] += 1
            if len(st) >= 5:
                acc[3] += st[2] * 1000
                acc[4] += st[3] * 1000
                acc[5] += st[4] * 1000
        ex.node_stats = {}

    @staticmethod
    def _live_totals(op_agg: Dict[str, list]) -> tuple:
        """(device_ms, host_ms, compile_ms) totals of an op_agg rollup —
        differenced per split for the live tier attribution."""
        return (sum(v[3] for v in op_agg.values()),
                sum(v[4] for v in op_agg.values()),
                sum(v[5] for v in op_agg.values()))

    def _finalize_stats(self, task: WorkerTask, tracer: Tracer,
                        t_start: float, op_agg: Dict[str, list]) -> None:
        """Roll this task's TaskStats (rows/bytes/wall/operators) and its
        exported spans into the task record the coordinator fetches with
        the terminal status (OperatorStats pyramid: operator -> task).
        On success paths this runs BEFORE the FINISHED transition so a
        consumer that sees the terminal state always sees final stats."""
        strategies = getattr(self._executor, "strategy_decisions", {})
        ops = {op: {"wallMs": round(v[0], 3), "rows": int(v[1]),
                    "calls": int(v[2]), "deviceMs": round(v[3], 3),
                    "hostMs": round(v[4], 3),
                    "compileMs": round(v[5], 3),
                    "strategy": strategies.get(op, ""),
                    # mesh placement (broadcast vs partitioned) rides
                    # beside the strategy; only joins carry one
                    "distribution": strategies.get("JoinDistribution", "")
                    if op == "JoinNode" else ""}
               for op, v in op_agg.items()}
        with task.lock:
            task.stats = {"rowsOut": task.rows_out,
                          "bytesOut": task.bytes_out,
                          "wallMs": round(
                              (time.monotonic() - t_start) * 1000, 3),
                          "splitsDone": task.splits_done,
                          "operators": ops}
            if task.manifest is not None:
                task.stats["manifest"] = task.manifest
            if tracer.enabled:
                task.spans = tracer.export()
        self._executor.flush_metrics()

    def _run(self, task: WorkerTask) -> None:
        from ..batch import batch_from_numpy, batch_to_numpy, bucket_capacity
        with task.lock:
            if task.state != "PENDING":   # canceled before the thread ran
                return
            task.state = "RUNNING"
            task.started_at = time.monotonic()
        self._note_live_change(task)
        self.tasks_run += 1
        tracer = self._tracer_for(task)
        t_start = time.monotonic()
        op_agg: Dict[str, list] = {}
        try:
            if self.injector is not None:
                self.injector.maybe_fail("TASK", task.task_id)
                self.injector.maybe_fail("WORKER_TASK_RUN", task.task_id)
            if task.sources is not None:
                with tracer.span("worker-task", taskId=task.task_id,
                                 node=self.node_id, kind="exchange"):
                    self._run_exchange_consumer(task, tracer, op_agg)
                # final stats/spans land BEFORE the terminal state so a
                # status fetch racing the transition never sees partials
                self._finalize_stats(task, tracer, t_start, op_agg)
                with task.lock:
                    if task.state == "RUNNING":
                        task.state = "FINISHED"
                return
            fragment = decode_fragment(task.fragment_blob)
            root, driver_scan = fragment["root"], fragment["driver"]
            cap = bucket_capacity(max(s.count for s in task.splits)) \
                if task.splits else 1024
            # per-operator profiling: on for traced tasks AND for
            # fragments flagged by the coordinator (EXPLAIN ANALYZE) —
            # pays a per-node device sync for true operator times
            profiling = tracer.enabled or bool(fragment.get("profile"))
            names = {id(n): type(n).__name__ for n in
                     _subtree_nodes_all(root)} if profiling else {}
            # The executor (and its _subst/pool state) is shared by every
            # task on this worker, so the whole pin-builds + splits loop
            # holds _exec_lock: build state pinned across splits must not
            # be clobbered by a concurrent task's cleanup. Device work is
            # serialized by the chip anyway (Trino's analog: one lookup
            # source per build, drivers share it under memory context
            # locking).
            with self._exec_lock, \
                    tracer.span("worker-task", taskId=task.task_id,
                                node=self.node_id,
                                splits=len(task.splits)) as wspan:
                ex = self._executor
                ex._subst.clear()
                ex._subst_opaque.clear()
                # per-task lifetime enforcement: the executor's
                # check_cancel points (chunk/partition/prefetch
                # boundaries) observe this task's deadline and any
                # cancel posted while it runs
                ex._cancel_reason = None
                ex.deadline = task.deadline
                self._current_task_id = task.task_id
                saved_profile = ex.profile
                saved_node_stats = ex.node_stats
                if profiling:
                    ex.profile = True
                    ex.node_stats = {}
                try:
                    # pin maximal driver-free subtrees ONCE per task (join
                    # build sides, HashBuilderOperator's build-once-probe-
                    # many): else every split re-executes every build join
                    with tracer.span("pin-builds"):
                        for sub in _static_subtrees(root, driver_scan):
                            ex._subst[id(sub)] = ex.run(sub)
                    if profiling:
                        self._fold_node_stats(ex, names, op_agg)
                    live_prev = self._live_totals(op_agg)
                    for si, split in enumerate(task.splits):
                        if task.state in ("CANCELED", "ABANDONED"):
                            return
                        if task.deadline is not None and \
                                time.monotonic() > task.deadline:
                            from ..exec.executor import QueryDeadlineError
                            raise QueryDeadlineError(
                                "task deadline exceeded "
                                "(query_max_run_time_s)")
                        if self.injector is not None:
                            # chaos mid-split: CRASH kills the executor
                            # with work half-done (partial pages already
                            # buffered — the coordinator's all-or-nothing
                            # drain discards them), DELAY makes this
                            # worker a straggler (hedge-mitigation target)
                            self.injector.maybe_fail(
                                "WORKER_TASK_RUN",
                                f"{task.task_id}:{si}")
                        data = self.catalog.get_table(
                            split.catalog, split.schema_name, split.table)
                        arrays = [np.asarray(data.columns[i])
                                  [split.start:split.start + split.count]
                                  for i in driver_scan.column_indices]
                        valids = None
                        if data.valids is not None:
                            valids = [
                                None if data.valids[i] is None else
                                np.asarray(data.valids[i])
                                [split.start:split.start + split.count]
                                for i in driver_scan.column_indices]
                        chunk = batch_from_numpy(arrays, valids=valids,
                                                 capacity=cap,
                                                 device=self.device)
                        ex._subst[id(driver_scan)] = chunk
                        ex._subst_opaque.add(id(driver_scan))
                        sp_t0 = time.monotonic()
                        try:
                            with tracer.span("split", index=si,
                                             rows=split.count):
                                out = ex.run(root)
                        finally:
                            ex._subst.pop(id(driver_scan), None)
                            ex._subst_opaque.discard(id(driver_scan))
                            # per-split outputs die here; pinned builds
                            # keep their reservations until task end
                            ex.release_path_reservations(
                                root, keep=ex._subst)
                        if profiling:
                            self._fold_node_stats(ex, names, op_agg)
                        arrs, vals = batch_to_numpy(out)
                        self._emit(task, arrs, vals)
                        # live tier attribution: fenced device/host/
                        # compile deltas when profiling; unprofiled
                        # splits ride entirely in host (the round-10
                        # convention), so the live so-far numbers match
                        # what _finalize_stats will report
                        sp_wall_ms = (time.monotonic() - sp_t0) * 1000
                        d_dev, d_host, d_comp = 0.0, sp_wall_ms, 0.0
                        if profiling:
                            tot = self._live_totals(op_agg)
                            d_dev = max(0.0, tot[0] - live_prev[0])
                            d_host = max(0.0, tot[1] - live_prev[1])
                            d_comp = max(0.0, tot[2] - live_prev[2])
                            live_prev = tot
                        with task.lock:
                            task.splits_done += 1
                            task.device_ms += d_dev
                            task.host_ms += d_host
                            task.compile_ms += d_comp
                        self._note_live_change(task)
                        self._note_busy(
                            d_dev, max(0.0, sp_wall_ms - d_dev))
                finally:
                    ex.profile = saved_profile
                    ex.node_stats = saved_node_stats
                    ex.deadline = None
                    ex._cancel_reason = None
                    self._current_task_id = None
                    ex._subst.clear()
                    ex._subst_opaque.clear()
                    for b in ex._node_bytes.values():
                        ex.pool.free(b)
                    ex._node_bytes.clear()
                    if wspan is not None and op_agg:
                        # fenced split totals ride the worker-task span
                        # so the stitched trace carries device time, not
                        # just host wall
                        wspan.attributes["deviceMs"] = round(
                            sum(v[3] for v in op_agg.values()), 3)
                        wspan.attributes["hostMs"] = round(
                            sum(v[4] for v in op_agg.values()), 3)
                        wspan.attributes["compileMs"] = round(
                            sum(v[5] for v in op_agg.values()), 3)
            self._finalize_stats(task, tracer, t_start, op_agg)
            with task.lock:
                # a cancel landing during the last split must not be
                # overwritten by FINISHED
                if task.state == "RUNNING":
                    task.state = "FINISHED"
        except Exception as e:        # noqa: BLE001 — task failure boundary
            task.error = f"{type(e).__name__}: {e}\n" + traceback.format_exc()
            with task.lock:
                if task.state not in ("CANCELED", "ABANDONED"):
                    task.state = "FAILED"
        finally:
            # failure/cancel paths (and early returns) still record what
            # completed; success paths already finalized pre-transition
            if not task.stats:
                self._finalize_stats(task, tracer, t_start, op_agg)
            self._note_live_change(task)   # terminal state is a change
            cb = self.on_terminal
            if cb is not None and task.state in ("FINISHED", "FAILED",
                                                 "CANCELED"):
                try:
                    cb(task)
                except Exception:  # noqa: BLE001 — push is best-effort;
                    pass           # the status long-poll still works

    # -- exchange consumer: worker<->worker partitioned shuffle ------------

    def _pull_buffer(self, uri: str, task_id: str, buffer: int,
                     deadline: float, task: WorkerTask,
                     tracer: Tracer = NOOP,
                     ack: bool = True) -> List[bytes]:
        """Pull one upstream buffer to completion (the worker-side twin
        of the coordinator's RemoteTask.drain — HttpPageBufferClient's
        loop, running worker-to-worker). The consumer's trace context
        rides the pull requests so cross-worker data-plane hops appear
        in the stitched query trace."""
        import json as _json
        import time as _time
        from urllib.request import Request, urlopen
        from .security import internal_headers
        headers = {"Accept": "application/x-trino-pages",
                   **internal_headers()}
        tp = tracer.traceparent()
        if tp is not None:
            headers["traceparent"] = tp
        pages: List[bytes] = []
        token = 0
        while _time.time() < deadline:
            if task.state in ("CANCELED", "ABANDONED"):
                raise RuntimeError("task canceled during exchange pull")
            req = Request(
                f"{uri}/v1/task/{task_id}/results/{buffer}/{token}"
                + ("" if ack else "?ack=0"),
                headers=headers)
            with urlopen(req, timeout=30.0) as resp:
                body = resp.read()
                if resp.headers.get("Content-Type", "").startswith(
                        "application/x-trino-pages"):
                    # worker<->worker frames get the same CRC32C gate as
                    # the coordinator drain; PageChecksumError fails THIS
                    # task, which the coordinator sees and retries
                    from .pageserde import verify_page
                    verify_page(bytes(body))
                    pages.append(bytes(body))
                    token += 1
                    continue
                out = _json.loads(body.decode()) if body else {}
            if out.get("state") == "FAILED":
                raise RuntimeError(
                    f"upstream task {task_id} failed: {out.get('error')}")
            if out.get("complete"):
                return pages
            _time.sleep(0.02)
        raise RuntimeError(f"exchange pull from {task_id} timed out")

    def _run_exchange_consumer(self, task: WorkerTask,
                               tracer: Tracer = NOOP,
                               op_agg: Dict[str, list] = None) -> None:
        """Execute a fragment whose leaves are RemoteSourceNodes: pull
        each source's partition from the upstream tasks, bind the
        concatenated batches, run once, emit (re-partitioned when the
        task has a partition spec). Pulls happen BEFORE taking the
        executor lock so an upstream task on this same worker can finish
        producing while we wait."""
        import time as _time

        from ..batch import batch_from_numpy
        from ..planner import logical as L
        fragment = decode_fragment(task.fragment_blob)
        root = fragment["root"]
        writer = None
        if isinstance(root, L.TableWriterNode):
            # write-stage task: execute the subtree, then stage the rows
            # to an attempt file instead of emitting exchange pages
            writer, root = root, root.child
        deadline = _time.time() + float(fragment.get("timeout_s", 300.0))
        if task.deadline is not None:
            # the query deadline caps exchange pulls too: a consumer must
            # not out-wait the query it feeds
            deadline = min(deadline, _time.time() + max(
                0.0, task.deadline - time.monotonic()))

        from ..planner.fragmenter import _subtree_nodes
        by_fid = {}
        for n in _subtree_nodes(root):
            if isinstance(n, L.RemoteSourceNode):
                by_fid.setdefault(n.fragment_id, []).append(n)
        batches = {}
        for fid_str, srcs in task.sources.items():
            fid = int(fid_str)
            pages = []
            for s in srcs:
                with tracer.span("exchange-pull", uri=s["uri"],
                                 upstreamTask=s["taskId"],
                                 buffer=int(s.get("buffer", 0))):
                    pages.extend(self._pull_buffer(
                        s["uri"], s["taskId"], int(s.get("buffer", 0)),
                        deadline, task, tracer,
                        ack=writer is None))
            nodes = by_fid.get(fid)
            arrs, vals = concat_pages(
                pages, nodes[0].output if nodes else ())
            batches[fid] = batch_from_numpy(arrs, valids=vals,
                                            device=self.device)

        from ..batch import batch_to_numpy
        names = {id(n): type(n).__name__
                 for n in _subtree_nodes_all(root)} if tracer.enabled else {}
        with self._exec_lock:
            ex = self._executor
            ex._subst.clear()
            ex._subst_opaque.clear()
            ex._cancel_reason = None
            ex.deadline = task.deadline
            self._current_task_id = task.task_id
            saved_merge = ex.enable_merge_join
            saved_profile = ex.profile
            saved_node_stats = ex.node_stats
            if tracer.enabled:
                ex.profile = True
                ex.node_stats = {}
            # the reference pins the consumer to the dense-LUT/expansion
            # join paths (its merge-sort kernel recompiles per partition
            # shape); the port keeps the pin so both pick the same join
            ex.enable_merge_join = False
            try:
                for fid, nodes in by_fid.items():
                    for n in nodes:
                        ex._subst[id(n)] = batches[fid]
                        ex._subst_opaque.add(id(n))
                with tracer.span("consume-run"):
                    out = ex.run(root)
                if tracer.enabled and op_agg is not None:
                    self._fold_node_stats(ex, names, op_agg)
                arrs, vals = batch_to_numpy(out)
            finally:
                ex.enable_merge_join = saved_merge
                ex.profile = saved_profile
                ex.node_stats = saved_node_stats
                ex.deadline = None
                ex._cancel_reason = None
                self._current_task_id = None
                ex._subst.clear()
                ex._subst_opaque.clear()
                for b in ex._node_bytes.values():
                    ex.pool.free(b)
                ex._node_bytes.clear()
        if writer is not None:
            self._stage_write(task, writer, arrs, vals)
            return
        self._emit(task, arrs, vals)
        # terminal state is set by _run AFTER stats finalize — a status
        # fetch racing completion must never see FINISHED + partial stats

    def _stage_write(self, task: WorkerTask, writer,
                     arrs, vals) -> None:
        """Write-stage terminal: rows land in a uniquely-named attempt
        file under `<table>/.staging/`; the manifest (path, rows, CRC,
        zone stats) rides the terminal task status. The write buffer is
        a memory-pool reservation for its lifetime — a worker near its
        memory limit fails the attempt instead of silently ballooning."""
        from ..batch import Schema
        from ..connectors.tpch.datagen import TableData
        from . import writeprotocol as wp
        arrays = [np.asarray(a) for a in arrs]
        valids = None
        if vals is not None and any(v is not None and not bool(np.all(v))
                                    for v in vals):
            valids = [None if v is None or bool(np.all(v))
                      else np.asarray(v) for v in vals]
        data = TableData(writer.table, Schema(tuple(writer.fields)),
                         arrays, valids=valids)
        nbytes = sum(a.nbytes for a in arrays)
        ex = self._executor
        ex.pool.reserve(nbytes, tag=f"write:{task.task_id}")
        try:
            m = wp.stage_table_data(
                writer.table_dir, data, writer.query_id, writer.stage,
                writer.partition, writer.attempt or task.task_id,
                writer.fmt, injector=self.injector)
        finally:
            ex.pool.free(nbytes, tag=f"write:{task.task_id}")
        with task.lock:
            task.manifest = m
            task.rows_out += m["rows"]
            task.bytes_out += m["bytes"]

    def status_json(self, task: WorkerTask) -> dict:
        with task.lock:      # buffers/acked mutate on the task thread
            done = task.state in ("FINISHED", "FAILED", "CANCELED",
                                  "ABANDONED")
            stats = dict(task.stats) if task.stats else {
                "rowsOut": task.rows_out, "bytesOut": task.bytes_out,
                "splitsDone": task.splits_done}
            out = {"taskId": task.task_id, "state": task.state,
                   "error": task.error.splitlines()[0]
                   if task.error else "",
                   "splitsDone": task.splits_done,
                   "pages": task.total_pages(),
                   "stats": stats}
            if done and task.spans:
                # spans ship only with terminal status (one fetch per
                # task, not per poll)
                out["spans"] = list(task.spans)
            return out
