"""Port copy of ``trino_tpu/server/statemachine.py`` (no edits).

Query state machine and query tracking.

Reference: execution/QueryState.java:21 (QUEUED -> WAITING_FOR_RESOURCES ->
DISPATCHING -> PLANNING -> STARTING -> RUNNING -> FINISHING -> FINISHED /
FAILED), the generic CAS StateMachine (execution/StateMachine.java:43) and
QueryTracker (execution/QueryTracker.java:51). Python edition: a lock-guarded
state holder with listeners, plus a registry with expiry.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

TERMINAL = ("FINISHED", "FAILED", "CANCELED")
ORDER = ("QUEUED", "PLANNING", "STARTING", "RUNNING", "FINISHING",
         "FINISHED", "FAILED", "CANCELED")


class QueryStateMachine:
    """CAS-style state transitions; listeners fire outside the lock."""

    def __init__(self, query_id: str):
        self.query_id = query_id
        self._state = "QUEUED"
        self._lock = threading.Lock()
        self._listeners: List[Callable[[str], None]] = []
        # set once the terminal transition's listeners have all run:
        # the protocol layer holds a terminal page until then, so a
        # fast-polling client can never observe FINISHED before the
        # completion pipeline (events, ledger record, metrics) fires
        self.settled = threading.Event()
        self.error: Optional[str] = None
        # error taxonomy (the reference's ErrorCode): user errors like
        # QUERY_EXCEEDED_MEMORY carry their own name/code so clients can
        # distinguish them from GENERIC_INTERNAL_ERROR
        self.error_name: str = "GENERIC_INTERNAL_ERROR"
        self.error_code: int = 1
        self.created_at = time.time()
        self.ended_at: Optional[float] = None
        # entry timestamp per state reached — the timeline analyzer's
        # queued/plan attribution input (server/timeline.py); QUEUED is
        # stamped at creation so queued time exists even for queries
        # failed before their first transition
        self.state_times: Dict[str, float] = {"QUEUED": self.created_at}

    @property
    def state(self) -> str:
        return self._state

    def is_done(self) -> bool:
        return self._state in TERMINAL

    def transition(self, new_state: str) -> bool:
        """Advance to new_state; never moves backward or out of terminal."""
        to_fire = []
        with self._lock:
            if self._state in TERMINAL:
                return False
            if ORDER.index(new_state) <= ORDER.index(self._state):
                return False
            self._state = new_state
            self.state_times.setdefault(new_state, time.time())
            if new_state in TERMINAL:
                self.ended_at = time.time()
            to_fire = list(self._listeners)
        try:
            for fn in to_fire:
                fn(new_state)
        finally:
            if new_state in TERMINAL:
                self.settled.set()
        return True

    def fail(self, message: str,
             error_name: str = "GENERIC_INTERNAL_ERROR",
             error_code: int = 1) -> bool:
        with self._lock:
            if self._state in TERMINAL:
                return False
            self.error = message
            self.error_name = error_name
            self.error_code = error_code
            self._state = "FAILED"
            self.state_times.setdefault("FAILED", time.time())
            self.ended_at = time.time()
            to_fire = list(self._listeners)
        try:
            for fn in to_fire:
                fn("FAILED")
        finally:
            self.settled.set()
        return True

    def cancel(self) -> bool:
        with self._lock:
            if self._state in TERMINAL:
                return False
            self._state = "CANCELED"
            # stamped exactly like FAILED above, and carrying the same
            # error taxonomy the payload serves — so timeline
            # attribution and ledger replay treat canceled and failed
            # queries identically
            self.state_times.setdefault("CANCELED", time.time())
            self.error = "Query was canceled"
            self.error_name = "USER_CANCELED"
            self.error_code = 2
            self.ended_at = time.time()
            to_fire = list(self._listeners)
        try:
            for fn in to_fire:
                fn("CANCELED")
        finally:
            self.settled.set()
        return True

    def add_listener(self, fn: Callable[[str], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def adopt_times(self, times: Dict[str, float]) -> None:
        """Merge recorded state-entry stamps (ledger replay): earliest
        wins per state, so a resumed query's queued/plan attribution
        spans from its ORIGINAL admission, not from the resume."""
        with self._lock:
            for st, ts in (times or {}).items():
                if st not in ORDER:
                    continue
                cur = self.state_times.get(st)
                if cur is None or ts < cur:
                    self.state_times[st] = ts
            q0 = self.state_times.get("QUEUED")
            if q0 is not None and q0 < self.created_at:
                self.created_at = q0

    @classmethod
    def restored(cls, query_id: str, state: str,
                 state_times: Optional[Dict[str, float]] = None,
                 error: Optional[str] = None,
                 error_name: str = "GENERIC_INTERNAL_ERROR",
                 error_code: int = 1) -> "QueryStateMachine":
        """Rebuild a state machine from ledger records. Recorded stamps
        land in state_times byte-for-byte as the live transitions set
        them — FAILED and CANCELED included — so post-replay timeline
        attribution sums exactly as it did before the crash."""
        sm = cls(query_id)
        sm.adopt_times(state_times or {})
        sm._state = state if state in ORDER else "FAILED"
        if sm._state in TERMINAL:
            sm.ended_at = sm.state_times.get(sm._state) or time.time()
            sm.state_times.setdefault(sm._state, sm.ended_at)
            if sm._state == "FAILED":
                sm.error = error or "Query failed before coordinator " \
                                    "restart"
                sm.error_name = error_name
                sm.error_code = error_code
            elif sm._state == "CANCELED":
                sm.error = error or "Query was canceled"
                sm.error_name = "USER_CANCELED"
                sm.error_code = 2
            # terminal from birth: there is no completion pipeline to
            # wait for, so the protocol layer must not block on it
            sm.settled.set()
        return sm


@dataclass
class TrackedQuery:
    """One query's full lifecycle record (QueryInfo essentials)."""
    query_id: str
    sql: str
    session_user: str
    state_machine: QueryStateMachine
    result: Optional[object] = None       # exec.session.QueryResult
    plan_text: Optional[str] = None
    rows_returned: int = 0
    cpu_time_s: float = 0.0
    elapsed_s: float = 0.0
    retries: int = 0
    distributed: bool = False             # ran via the stage scheduler
    # why the stage scheduler declined (None when distributed/local-only
    # coordinator): surfaced in /v1/query info so `SET SESSION
    # distributed = true` degrading to local is never silent
    fallback_reason: Optional[str] = None
    # observability: W3C trace context from the client's POST, the
    # per-query tracer (live while executing), the stitched trace
    # exported at completion (GET /v1/query/{id}/trace), and the
    # scheduler's per-query stage/task rollup (events + system tables)
    traceparent: Optional[str] = None
    tracer: Optional[object] = None       # utils.tracing.Tracer
    trace: Optional[list] = None          # exported span dicts
    stage_stats: Optional[dict] = None
    # spill-tier activations during this query (executor stats delta) —
    # one of the regression detector's inputs (server/history.py)
    spills: int = 0
    # serving-layer verdicts (server/serving.py): where the query ran
    # ('host' | 'device' | 'cache' | 'microbatch') and the router's
    # reasoning — surfaced in /v1/query info
    route: Optional[str] = None
    route_reason: Optional[str] = None
    # resource-group tenant (the principal's selected leaf group):
    # labels metrics, history records, and audit events so per-tenant
    # isolation is observable, not just enforced
    tenant: str = "default"
    # critical-path timeline (server/timeline.py): phase attribution
    # summing exactly to elapsed wall, built at terminal transition and
    # served at GET /v1/query/{id}/timeline + system.runtime.query_timeline
    timeline: Optional[dict] = None
    # live observability (server/livestats.py): the last computed
    # split-weighted progress (monotonic; survives into OOM-kill
    # post-mortems via history + QueryCompletedEvent), the dominant
    # in-flight stage behind it, and the stuck-query diagnosis the
    # live-stats fold attached (None when the query never stalled)
    progress_ratio: float = 0.0
    dominant_stage: str = ""
    live_diagnosis: Optional[dict] = None
    # query-lifetime enforcement: absolute wall-clock deadlines stamped
    # at admission (coordinator time.time()). `deadline` bounds total
    # run time (query_max_run_time_s), `queued_deadline` bounds how long
    # the query may sit QUEUED (query_max_queued_time_s); None = no cap.
    # The remaining budget rides every task dispatch, clock-skew
    # normalized per node, and the deadline enforcer terminates the
    # query cluster-wide once either expires.
    deadline: Optional[float] = None
    queued_deadline: Optional[float] = None
    # why terminate() fired ("user" | "deadline" | "queued_deadline" |
    # "oom" | "stuck"); None when the query ended on its own
    terminate_reason: Optional[str] = None

    @property
    def state(self) -> str:
        return self.state_machine.state


class QueryTracker:
    """Registry of live + recently finished queries (QueryTracker.java:51;
    expiry mirrors query.min-expire-age). The cap is configurable via
    TRINO_TPU_QUERY_HISTORY, and evicted queries flush through the
    `on_evict` hook (the coordinator wires it to the persistent history
    store) so completed-query stats outlive the in-memory ring."""

    def __init__(self, max_history: Optional[int] = None):
        self._queries: Dict[str, TrackedQuery] = {}
        self._lock = threading.Lock()
        self._seq = 0
        if max_history is None:
            try:
                max_history = int(
                    os.environ.get("TRINO_TPU_QUERY_HISTORY", 100))
            except ValueError:
                max_history = 100
        self.max_history = max_history
        self.on_evict: Optional[Callable[[TrackedQuery], None]] = None

    def next_query_id(self) -> str:
        with self._lock:
            self._seq += 1
            # Trino ids look like 20240101_000000_00000_abcde
            return time.strftime("%Y%m%d_%H%M%S") + f"_{self._seq:05d}_tpu"

    def reserve_seq(self, seq: int) -> None:
        """Advance the id sequence past `seq`. A promoted coordinator
        calls this with the highest sequence found in the replayed
        ledger: its ids are minted by a FRESH counter in the same
        wall-second format, so without the bump a sub-second failover
        could re-issue an id the dead primary already handed out."""
        with self._lock:
            self._seq = max(self._seq, seq)

    def register(self, q: TrackedQuery) -> None:
        with self._lock:
            self._queries[q.query_id] = q
            evicted = self._expire_locked()
        # the flush runs OUTSIDE the lock: the history store may hit disk,
        # and a listener calling back into the tracker must not deadlock
        if self.on_evict is not None:
            for old in evicted:
                try:
                    self.on_evict(old)
                except Exception:  # noqa: BLE001 — eviction never fails
                    pass

    def get(self, query_id: str) -> Optional[TrackedQuery]:
        with self._lock:
            return self._queries.get(query_id)

    def all(self) -> List[TrackedQuery]:
        with self._lock:
            return list(self._queries.values())

    def _expire_locked(self) -> List[TrackedQuery]:
        done = [q for q in self._queries.values()
                if q.state_machine.is_done()]
        excess = len(done) - self.max_history
        evicted: List[TrackedQuery] = []
        if excess > 0:
            done.sort(key=lambda q: q.state_machine.ended_at or 0)
            for q in done[:excess]:
                del self._queries[q.query_id]
                evicted.append(q)
        return evicted
