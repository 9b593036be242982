"""Coordinator HTTP server: the statement protocol front end.

Port of ``trino_tpu/server/coordinator.py``: the queued->executing REST
protocol (``POST /v1/statement``, ``nextUri`` paging, ``DELETE`` to
cancel), query info at /v1/query/{id}, /v1/info, /v1/status, /v1/metrics
and /v1/jit, the node inventory fed by worker announcements, the stage
scheduler that runs distributable statements on the announced workers,
the dispatcher's admission, resource groups, deadlines and QUERY retries,
the serving layer (plan cache, result cache, host/device router,
micro-batcher), the durable query ledger with its restart replay and admin
promotion, and the warm standby that watches a primary. Without a session,
``CoordinatorServer`` builds ``Session()``, which runs on the card: a
device-routed statement runs on CUDA or fails with its error on the
protocol. With no active worker a statement runs on the coordinator and
reports ``fallbackReason = "no active workers"``, as the reference's does.

stdlib http.server only: the protocol layer is the host-side control
plane. Routes live in the ROUTES table (server/routes.py) so every
request lands in trino_tpu_http_requests_total; /v1/metrics serves the
process registry in Prometheus text; `enable_tracing` sessions run each
query under a propagating tracer whose stitched trace (coordinator +
worker spans) is served at GET /v1/query/{id}/trace.
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..exec.session import Session
from .routes import STAR, dispatch, register_routes
from .statemachine import QueryStateMachine, QueryTracker, TrackedQuery

PAGE_ROWS = 1000          # rows per protocol page (target-result-size analog)

SERVER_NAME = "coordinator"

# (METHOD, pattern, handler method, needs_auth) — see server/routes.py.
# /v1/info, /v1/status and /v1/metrics stay open (liveness + scrape
# surface, no query data); everything that exposes query text/results
# authenticates.
ROUTES = (
    ("POST", ("v1", "statement"), "_post_statement", True),
    # worker registration is cluster-internal: guarded by the shared
    # secret (TRINO_TPU_INTERNAL_SECRET) so a rogue process with network
    # reach cannot join the cluster and absorb splits
    ("POST", ("v1", "announce"), "_post_announce", "internal"),
    # buffered terminal-status push from workers: tasks that finished
    # while the coordinator was unreachable re-deliver here after the
    # next successful announce (possibly to a promoted standby)
    ("POST", ("v1", "task-status"), "_post_task_status", "internal"),
    ("GET", ("v1", "info"), "_get_info", False),
    # coordinator role probe (PRIMARY | PASSIVE | RECONCILING) — the
    # health/ready surface a standby serves while tailing the ledger
    ("GET", ("v1", "info", "state"), "_get_info_state", False),
    # admin promotion (the coordinator mirror of the worker drain
    # route): PUT {"state": "PRIMARY"} promotes a standby
    ("PUT", ("v1", "info", "state"), "_put_info_state", "internal"),
    ("GET", ("v1", "status"), "_get_status", False),
    ("GET", ("v1", "metrics"), "_get_metrics", False),
    ("GET", ("v1", "jit"), "_get_jit", False),
    # warm-manifest for joining workers (exec/prewarm.py): top
    # historical fingerprints + the canonical shape lattice. Internal:
    # it exposes query text
    ("GET", ("v1", "prewarm"), "_get_prewarm", "internal"),
    ("GET", ("v1", "spooled", "segments", STAR), "_get_segment", True),
    ("GET", ("v1", "resourceGroup"), "_get_resource_group", True),
    ("GET", ("v1", "memory"), "_get_memory", True),
    ("GET", ("v1", "node"), "_get_nodes", True),
    ("GET", ("v1", "query"), "_get_queries", True),
    ("GET", ("v1", "query", STAR), "_get_query", True),
    ("GET", ("v1", "query", STAR, "trace"), "_get_query_trace", True),
    ("GET", ("v1", "query", STAR, "timeline"), "_get_query_timeline",
     True),
    # the coordinator's own flight-recorder ring — same contract the
    # workers serve, so the federation scrape path is uniform. Internal:
    # metric keys carry tenant/route labels a stranger shouldn't map
    ("GET", ("v1", "telemetry"), "_get_telemetry", "internal"),
    ("GET", ("v1", "statement", "executing", STAR), "_get_executing",
     True),
    ("GET", ("v1", "statement", "executing", STAR, STAR),
     "_get_executing", True),
    ("DELETE", ("v1", "spooled", "segments", STAR), "_delete_segment",
     True),
    ("DELETE", ("v1", "statement", "executing", STAR),
     "_delete_executing", True),
    ("DELETE", ("v1", "statement", "executing", STAR, STAR),
     "_delete_executing", True),
)

register_routes(SERVER_NAME, ROUTES)


class ClusterHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a serving-grade accept backlog: the
    stdlib default (request_queue_size=5) resets connections under a
    thundering herd of concurrent clients — the exact load the serving
    layer exists to absorb."""
    request_queue_size = 256


class QueryDeclinedError(RuntimeError):
    """Deterministic user-configuration decline (require_distributed on a
    shape the cluster can't take) — never retried."""


def _is_retryable(e: Exception) -> bool:
    """User errors (bad SQL, missing columns) never retry; runtime/injected
    failures do — the reference draws the same line via error categories
    (USER_ERROR vs INTERNAL_ERROR/EXTERNAL). Memory kills are user
    errors too: retrying an OOM reproduces it. Deadline expiry and
    termination never retry (a rerun restarts the clock the user
    bounded), and an exhausted task-amplification budget means retrying
    is exactly what the budget forbade."""
    from ..exec.executor import QueryDeadlineError, QueryTerminatedError
    from ..exec.memory import ExceededMemoryLimitError
    from ..planner.analyzer import AnalysisError
    from ..sql.tokenizer import SqlSyntaxError
    from .scheduler import RetryBudgetExhaustedError
    return not isinstance(e, (AnalysisError, SqlSyntaxError,
                              AssertionError, QueryDeclinedError,
                              ExceededMemoryLimitError,
                              QueryDeadlineError, QueryTerminatedError,
                              RetryBudgetExhaustedError))


class RegisteredNode:
    """One announced worker (node/InternalNodeManager inventory entry)."""

    def __init__(self, node_id: str, uri: str):
        self.node_id = node_id
        self.uri = uri
        self.last_announce = time.time()
        # lifecycle: ACTIVE | DRAINING | DRAINED | FAILED (a LEFT
        # announce removes the entry from the inventory entirely)
        self.state = "ACTIVE"
        # last heartbeat-reported memory pool snapshot (cluster
        # arbitration input; scheduler placement prefers low-memory nodes)
        self.memory: Optional[dict] = None
        # last heartbeat-reported device/HBM allocator stats
        # (system.runtime.nodes surface)
        self.device: Optional[dict] = None
        # estimated clock skew (worker clock minus coordinator clock),
        # refreshed from the `now` stamp each announce carries; adopted
        # worker spans are rebased by it so stitched-trace intervals
        # cannot go negative under skewed wall clocks
        self.clock_offset: float = 0.0
        # live task inventory from the last announce ([{taskId, state}])
        # — a promoted coordinator reconciles the ledger against this
        # before deciding re-attach vs re-execute
        self.tasks: Optional[list] = None


class Dispatcher:
    """Admission + async execution (DispatchManager + SqlQueryManager).

    `max_concurrency` plays the resource-group concurrency limit
    (InternalResourceGroup.java hardConcurrencyLimit); queries past it sit
    QUEUED. Execution itself is serialized per engine session via an
    executor lock (the single-process mesh is one 'cluster').
    """

    def __init__(self, session: Session, tracker: QueryTracker,
                 max_concurrency: int = 4, retry_policy: str = "NONE",
                 max_retries: int = 3):
        self.session = session
        self.tracker = tracker
        self.pool = ThreadPoolExecutor(max_workers=max_concurrency,
                                       thread_name_prefix="dispatch")
        # RLock: traced attempts hold it across the whole attempt while
        # the serving layer re-acquires for its device-path execution
        self.exec_lock = threading.RLock()
        self.failure_injector = None      # FailureInjector (tests/ops)
        # retry-policy QUERY (admin/fault-tolerant-execution.md): rerun the
        # whole query on failure; deterministic kernels + the dedup of
        # serving only the final attempt's result give identical output
        # (DeduplicatingDirectExchangeBuffer.java:87's role)
        self.retry_policy = retry_policy  # NONE | QUERY
        self.max_retries = max_retries
        self.scheduler = None             # StageScheduler (cluster mode)
        # ClusterMemoryManager back-ref (set by CoordinatorState): the
        # load-shed admission gate reads its pressure snapshot
        self.memory_manager = None
        # lazy deadline-enforcer sweep: started by the first admission
        # that carries a run/queued deadline, so deadline-free sessions
        # never pay for the thread
        self._enforcer: Optional[threading.Thread] = None
        self._enforcer_lock = threading.Lock()
        # durable query ledger (server/ledger.py): set by
        # CoordinatorState when a ledger path is configured. None keeps
        # the pre-failover behavior bit-for-bit (no appends, no fsyncs).
        self.ledger = None
        from ..events import EventListenerManager
        self.event_listeners = EventListenerManager()
        from .resourcegroups import (ResourceGroupConfig,
                                     ResourceGroupManager)
        self.resource_groups = ResourceGroupManager(
            ResourceGroupConfig("root",
                                hard_concurrency_limit=max_concurrency))
        # security hooks (AccessControlManager's seat): authn gates the
        # HTTP intake, authz runs at dispatch with resolved table refs
        from .security import AllowAllAccessControl
        self.authenticator = None            # None = open cluster
        self.access_control = AllowAllAccessControl()
        # high-concurrency serving layer (server/serving.py): plan +
        # result caches, CPU/TPU cost routing, micro-batched point
        # queries. Host-routed and cache-served statements bypass the
        # exec lock entirely; device executions still take it inside
        # ServingLayer.run_routed.
        from .serving import ServingLayer
        self.serving = ServingLayer(session, self.exec_lock)

    def submit(self, sql: str, user: str,
               traceparent: Optional[str] = None) -> TrackedQuery:
        qid = self.tracker.next_query_id()
        tq = TrackedQuery(qid, sql, user, QueryStateMachine(qid),
                          traceparent=traceparent)
        return self._admit(tq)

    def resume(self, q: dict, mode: str) -> TrackedQuery:
        """Re-admit a non-terminal query reconstructed from the ledger,
        under its ORIGINAL query id — the client's nextUri keeps working
        against the resumed execution. `mode` is the resumption-mode
        label: replayed (pre-execution), reattached (spooled output
        survives), reexecuted (re-run; writes dedup via the commit
        journal)."""
        from ..metrics import QUERIES_RESUMED
        qid = q["query_id"]
        sm = QueryStateMachine(qid)
        sm.adopt_times(q.get("state_times") or {})
        tq = TrackedQuery(qid, q.get("sql") or "", q.get("user")
                          or "anonymous", sm)
        tq.resumed = mode
        QUERIES_RESUMED.inc(mode=mode)
        return self._admit(tq, resumed=True)

    def restore_terminal(self, q: dict) -> TrackedQuery:
        """Register a query the ledger shows as already terminal —
        byte-for-byte state reconstruction (state, stamps, error
        taxonomy, row/elapsed stats), with no listeners and no
        re-execution: it already completed and already counted. A
        restored FINISHED query carries result=None; the executing
        route lazily re-executes on the first data poll."""
        qid = q["query_id"]
        sm = QueryStateMachine.restored(
            qid, q["terminal"], q.get("state_times"),
            error=q.get("error"),
            error_name=q.get("error_name") or "GENERIC_INTERNAL_ERROR",
            error_code=q.get("error_code") or 1)
        tq = TrackedQuery(qid, q.get("sql") or "", q.get("user")
                          or "anonymous", sm)
        tq.tenant = q.get("tenant") or \
            self.resource_groups.tenant_of(tq.session_user)
        tq.rows_returned = q.get("rows") or 0
        tq.elapsed_s = q.get("elapsed_s") or 0.0
        tq.resumed = "restored"
        self.tracker.register(tq)
        return tq

    def _admit(self, tq: TrackedQuery,
               resumed: bool = False) -> TrackedQuery:
        # tenant = the principal's resource-group leaf; labels metrics,
        # history records, and audit events for per-tenant isolation
        tq.tenant = self.resource_groups.tenant_of(tq.session_user)
        self.tracker.register(tq)
        self.event_listeners.query_created(tq)
        led = self.ledger
        if led is not None:
            if not resumed:
                # the admission record is durable BEFORE the client sees
                # a query id: any id a client holds survives replay
                from .history import plan_fingerprint
                led.admit(tq.query_id, tq.sql, tq.session_user,
                          tq.tenant, plan_fingerprint(tq.sql),
                          getattr(self.session, "properties", {}))
            sm_led = tq.state_machine

            def on_ledger(state, _tq=tq, _sm=sm_led):
                ts = _sm.state_times.get(state, time.time())
                if state in ("FINISHED", "FAILED", "CANCELED"):
                    led.terminal(
                        _tq.query_id, state, ts, error=_sm.error,
                        error_name=_sm.error_name,
                        error_code=_sm.error_code,
                        rows=_tq.rows_returned, elapsed_s=_tq.elapsed_s,
                        catalog_version=getattr(self.session.catalog,
                                                "version", 0))
                else:
                    led.state(_tq.query_id, state, ts)

            sm_led.add_listener(on_ledger)

        def on_terminal(state):
            if state in ("FINISHED", "FAILED", "CANCELED"):
                from ..metrics import (QUERIES, QUERY_SECONDS,
                                       TENANT_QUERIES,
                                       TENANT_QUERY_SECONDS)
                QUERIES.inc(state=state)
                TENANT_QUERIES.inc(tenant=tq.tenant)
                QUERY_SECONDS.observe(tq.elapsed_s)
                TENANT_QUERY_SECONDS.observe(tq.elapsed_s,
                                             tenant=tq.tenant)
                # critical-path attribution BEFORE the completion event
                # fires, so listeners (history store, event sinks) see
                # the dominant phase
                try:
                    from ..metrics import (CRITICAL_PATH_SECONDS,
                                           TIMELINE_QUERIES)
                    from .timeline import build_timeline
                    tq.timeline = build_timeline(tq)
                    TIMELINE_QUERIES.inc()
                    for p, v in tq.timeline["phases"].items():
                        if v > 0:
                            CRITICAL_PATH_SECONDS.inc(v, phase=p)
                except Exception:  # noqa: BLE001 — attribution never
                    pass           # fails a query
                self.event_listeners.query_completed(tq)

        tq.state_machine.add_listener(on_terminal)
        # absolute wall deadlines stamped AT ADMISSION: every downstream
        # hop (scheduler dispatch, worker split loops, exchange drains,
        # retry backoffs) budgets against these, and the enforcer sweep
        # is the backstop for work stuck where no cooperative check runs
        props = getattr(self.session, "properties", {})
        now = time.time()
        max_run = float(props.get("query_max_run_time_s", 0) or 0)
        if max_run > 0 and tq.deadline is None:
            tq.deadline = now + max_run
        max_queued = float(props.get("query_max_queued_time_s", 0) or 0)
        if max_queued > 0 and tq.queued_deadline is None:
            tq.queued_deadline = now + max_queued
        if tq.deadline is not None or tq.queued_deadline is not None:
            self._ensure_enforcer()
        from ..metrics import QUERIES_REJECTED
        from .resourcegroups import QueryQueueFullError
        if self._should_shed(tq):
            QUERIES_REJECTED.inc(reason="load_shed")
            tq.state_machine.fail(
                "Query rejected: coordinator overloaded (load shed; "
                f"tenant {tq.tenant!r} is above its fair share) — "
                "retry when load drops",
                error_name=QueryQueueFullError.error_name,
                error_code=QueryQueueFullError.error_code)
            return tq
        try:
            self.resource_groups.submit(
                tq.session_user,
                lambda: self.pool.submit(self._run_admitted, tq),
                is_dead=tq.state_machine.is_done)
        except QueryQueueFullError as e:
            QUERIES_REJECTED.inc(reason="queue_full")
            tq.state_machine.fail(str(e), error_name=e.error_name,
                                  error_code=e.error_code)
        return tq

    # ---- termination / deadlines / overload ------------------------------

    def terminate(self, query_id: str, reason: str = "user",
                  message: Optional[str] = None) -> bool:
        """The single cancellation path: user DELETE, deadline expiry,
        the low-memory killer and the stuck-diagnoser all converge here.
        Moves the state machine to the terminal state the reason's
        taxonomy demands, interrupts a locally-executing attempt at its
        next cooperative check point, fans best-effort task DELETEs out
        to every live remote task (hedge twins included), and prunes
        dead queue entries so a terminated queued query never runs.
        Returns True when this call performed the termination."""
        tq = self.tracker.get(query_id)
        if tq is None:
            return False
        sm = tq.state_machine
        if sm.is_done():
            return False
        tq.terminate_reason = reason
        from ..metrics import (CANCEL_PROPAGATIONS,
                               QUERIES_DEADLINE_EXCEEDED)
        if reason == "user":
            did = sm.cancel()
        elif reason == "deadline":
            did = sm.fail(
                message or "Query exceeded the maximum run time "
                           "(query_max_run_time_s)",
                error_name="QUERY_EXCEEDED_RUN_TIME", error_code=4)
            if did:
                QUERIES_DEADLINE_EXCEEDED.inc()
        elif reason == "queued_deadline":
            from .resourcegroups import QueryQueuedTimeExceededError
            did = sm.fail(
                message or "Query exceeded the maximum queued time "
                           "(query_max_queued_time_s) — retry when "
                           "load drops",
                error_name=QueryQueuedTimeExceededError.error_name,
                error_code=QueryQueuedTimeExceededError.error_code)
            if did:
                QUERIES_DEADLINE_EXCEEDED.inc()
        elif reason == "oom":
            from ..exec.memory import ExceededMemoryLimitError
            did = sm.fail(
                message or "Query killed by the cluster low-memory "
                           "killer",
                error_name=ExceededMemoryLimitError.error_name,
                error_code=ExceededMemoryLimitError.error_code)
        else:                       # "stuck" and future reasons
            did = sm.fail(message or f"Query terminated ({reason})")
        if not did:
            return False            # lost the race to another terminator
        CANCEL_PROPAGATIONS.inc(reason=reason)
        # a locally-executing attempt holds the exec lock: request a
        # cooperative cancel so the next chunk/partition/prefetch
        # boundary raises and frees the lock within a bounded grace
        ex = getattr(self.session, "executor", None)
        pool = getattr(ex, "pool", None)
        if ex is not None and pool is not None and \
                getattr(pool, "_current_tag", "") == query_id:
            ex.request_cancel(
                f"query {query_id} terminated ({reason})", tag=query_id)
        # fan out best-effort DELETEs to every live remote task — the
        # worker side frees buffers, pool reservations and wakes its
        # backpressure waiters
        if self.scheduler is not None:
            try:
                self.scheduler.cancel_query_tasks(query_id)
            except Exception:  # noqa: BLE001 — fan-out is best-effort
                pass
        try:
            self.resource_groups.prune_dead()
        except Exception:  # noqa: BLE001
            pass
        return True

    def _should_shed(self, tq: TrackedQuery) -> bool:
        """Overload admission gate: once cluster-wide queue depth (or
        reported memory pressure) crosses the shed threshold, new work
        from tenants already holding the most in-flight device work —
        the ones with the least remaining fair-share claim — is rejected
        with a retryable QUERY_QUEUE_FULL instead of queued into a
        pile-up. Disabled unless TRINO_TPU_LOAD_SHED_QUEUE_DEPTH is
        set."""
        import os
        try:
            depth_cap = int(os.environ.get(
                "TRINO_TPU_LOAD_SHED_QUEUE_DEPTH", "0"))
        except ValueError:
            depth_cap = 0
        if depth_cap <= 0:
            return False
        overloaded = self.resource_groups.total_queued() >= depth_cap
        mm = self.memory_manager
        if not overloaded and mm is not None and \
                mm.cluster_limit_bytes is not None:
            reserved = sum(m.get("reserved", 0)
                           for m in mm.last_snapshot.values())
            overloaded = reserved >= mm.cluster_limit_bytes
        if not overloaded:
            return False
        fair = getattr(getattr(self, "serving", None), "fair_share",
                       None)
        infl = fair.inflight() if fair is not None else {}
        mine = infl.get(tq.tenant, 0)
        # the least-loaded tenant keeps admission even under overload —
        # shedding it would starve exactly the principal fair share
        # exists to protect
        return bool(infl) and mine > min(infl.values())

    def _ensure_enforcer(self) -> None:
        if self._enforcer is not None:
            return
        with self._enforcer_lock:
            if self._enforcer is not None:
                return
            t = threading.Thread(target=self._deadline_loop,
                                 name="deadline-enforcer", daemon=True)
            self._enforcer = t
            t.start()

    def _deadline_loop(self) -> None:
        while True:
            time.sleep(0.1)
            try:
                self.enforce_deadlines()
            except Exception:  # noqa: BLE001 — the sweep must survive
                pass

    def enforce_deadlines(self) -> int:
        """One enforcement sweep over every live query: expire run
        deadlines (any state) and queued-time deadlines (QUEUED only),
        then prune the dead queue entries. Returns the number of queries
        terminated — exposed so tests and ops can tick synchronously."""
        n = 0
        now = time.time()
        for tq in self.tracker.all():
            sm = tq.state_machine
            if sm.is_done():
                continue
            if tq.deadline is not None and now >= tq.deadline:
                if self.terminate(tq.query_id, reason="deadline"):
                    n += 1
            elif tq.queued_deadline is not None and \
                    now >= tq.queued_deadline and sm.state == "QUEUED":
                if self.terminate(tq.query_id,
                                  reason="queued_deadline"):
                    n += 1
        return n

    def _run_admitted(self, tq: TrackedQuery) -> None:
        group_path = self.resource_groups.select(tq.session_user).path
        try:
            self._run(tq)
        finally:
            nxt = self.resource_groups.finished(group_path)
            if nxt is not None:
                nxt()

    def _run(self, tq: TrackedQuery) -> None:
        sm = tq.state_machine
        attempts = 1 + (self.max_retries
                        if self.retry_policy == "QUERY" else 0)
        if not sm.transition("PLANNING"):
            return                        # canceled while queued
        # authorization BEFORE any execution, with resolved table refs
        # (DispatchManager.createQueryInternal's access-check step)
        from .security import AccessDeniedError, check_statement_access
        try:
            check_statement_access(self.access_control, self.session,
                                   tq.sql, tq.session_user)
        except AccessDeniedError as e:
            sm.fail(str(e))
            return
        except Exception:     # noqa: BLE001 — malformed SQL fails later
            pass              # with its real parse/analysis error
        # per-query tracer (enable_tracing sessions): adopts the client's
        # traceparent when present so the query trace continues the
        # caller's trace; exported to tq.trace at the end either way
        tracer = None
        if self.session.properties.get("enable_tracing"):
            from ..utils.tracing import Tracer
            tracer = Tracer.from_traceparent(tq.traceparent,
                                             service="coordinator")
            tq.tracer = tracer
        last_error: Optional[str] = None
        last_exc: Optional[Exception] = None
        # backoff between QUERY-retry attempts (shared RetryPolicy,
        # decorrelated jitter): failed queries re-admitting immediately
        # compound whatever overload/flap failed them the first time
        from .retrypolicy import RetryPolicy
        retry_waits = RetryPolicy(base_delay_s=0.05, max_delay_s=1.0,
                                  max_attempts=attempts).delays()
        try:
            for attempt in range(attempts):
                if sm.is_done():
                    return
                if attempt > 0:
                    from ..metrics import RETRY_ATTEMPTS
                    RETRY_ATTEMPTS.inc(component="dispatch")
                    time.sleep(next(retry_waits, 1.0))
                try:
                    if attempt > 0:
                        tq.retries = attempt
                    if self.failure_injector is not None:
                        self.failure_injector.maybe_fail("DISPATCH",
                                                         tq.sql)
                    if tracer is not None:
                        # tracing swaps the SHARED session tracer, so a
                        # traced attempt serializes end-to-end like the
                        # pre-serving coordinator did
                        with self.exec_lock:
                            if sm.is_done():
                                return
                            sm.transition("RUNNING")
                            if self.failure_injector is not None:
                                self.failure_injector.maybe_fail(
                                    "EXECUTION", tq.sql)
                            saved_tracer = self.session.tracer
                            self.session.tracer = tracer
                            try:
                                with tracer.span("query",
                                                 queryId=tq.query_id,
                                                 user=tq.session_user,
                                                 attempt=attempt):
                                    self._execute_attempt(tq)
                            finally:
                                self.session.tracer = saved_tracer
                    else:
                        # untraced path: the exec lock moves INSIDE the
                        # attempt (serving layer) so host-routed and
                        # cache-served queries run concurrently while
                        # device executions still serialize
                        if sm.is_done():
                            return
                        sm.transition("RUNNING")
                        if self.failure_injector is not None:
                            self.failure_injector.maybe_fail(
                                "EXECUTION", tq.sql)
                        # restore the session tracer afterwards even
                        # untraced: a SET SESSION enable_tracing=true
                        # must not leave a live session-level tracer
                        # soaking up every later query's spans (the
                        # per-query tracer swap above is the only way
                        # spans reach a protocol query)
                        saved_tracer = self.session.tracer
                        try:
                            self._execute_attempt(tq)
                        finally:
                            self.session.tracer = saved_tracer
                    sm.transition("FINISHING")
                    sm.transition("FINISHED")
                    return
                except Exception as e:  # noqa: BLE001 — retry boundary
                    last_error = f"{type(e).__name__}: {e}"
                    last_exc = e
                    tq.plan_text = traceback.format_exc()
                    if not _is_retryable(e):
                        break
            # user-error taxonomy: memory kills fail with their own
            # errorName (QUERY_EXCEEDED_MEMORY) instead of the generic
            # internal-failure envelope
            sm.fail(last_error or "query failed",
                    error_name=getattr(last_exc, "error_name",
                                       "GENERIC_INTERNAL_ERROR")
                    if last_error else "GENERIC_INTERNAL_ERROR",
                    error_code=getattr(last_exc, "error_code", 1)
                    if last_error else 1)
        finally:
            if tracer is not None:
                tq.trace = tracer.export()

    def _execute_attempt(self, tq: TrackedQuery) -> None:
        """One execution attempt under the exec lock: cluster path first,
        local fallback second (Trino's coordinator-only path)."""
        t0 = time.monotonic()
        result = None
        # tag the pool ledger with the query id so the LowMemoryKiller's
        # total-reservation-dominant policy can attribute bytes
        pool = getattr(getattr(self.session, "executor", None),
                       "pool", None)
        if pool is not None:
            pool.set_current_tag(tq.query_id)
        try:
            self._execute_attempt_inner(tq, t0)
        finally:
            if pool is not None:
                pool.set_current_tag("")

    def _spill_counter(self) -> int:
        """Cumulative spill-tier activations of the session executor —
        diffed around an attempt so the completion event (and history
        store) carry a per-query spill count."""
        st = getattr(getattr(self.session, "executor", None), "stats",
                     None)
        if st is None:
            return 0
        return (st.spilled_joins + st.spilled_aggregations +
                st.spilled_sorts)

    def _committed_write_result(self, tq: TrackedQuery):
        """Exactly-once guard for resumed writes: if a pre-crash attempt
        of this very query id already published parts (the commit
        journal's INTENT was durable), return its committed result
        instead of re-executing — re-running a committed CTAS locally
        would double-write or trip on the existing table."""
        import os as _os
        from ..sql import ast_nodes as A
        from ..sql.parser import parse
        from . import writeprotocol as wp
        try:
            stmt = parse(tq.sql)
        except Exception:  # noqa: BLE001 — not parseable here: let the
            return None    # normal path raise the canonical error
        if not isinstance(stmt, (A.CreateTable, A.InsertInto)) or \
                getattr(stmt, "query", None) is None:
            return None
        try:
            cat, sch, tbl = self.session.resolve_table(stmt.table)
            conn = self.session.catalog.connector(cat)
        except Exception:  # noqa: BLE001
            return None
        if not getattr(conn, "supports_staged_writes", False):
            return None
        table_dir = _os.path.abspath(conn._table_dir(sch, tbl))
        already = wp.published_rows_for(table_dir, tq.query_id)
        if already is None:
            return None
        wp.recover_table_dir(table_dir)
        conn._cache.pop((sch, tbl), None)
        self.session.catalog.bump_version()
        self.session.executor.invalidate_scan_cache()
        from ..exec.session import QueryResult
        return QueryResult(["rows"], [(already,)], 0.0)

    def _execute_attempt_inner(self, tq: TrackedQuery, t0: float) -> None:
        result = None
        spills0 = self._spill_counter()
        if getattr(tq, "resumed", None):
            result = self._committed_write_result(tq)
            if result is not None:
                tq.elapsed_s = time.monotonic() - t0
                tq.result = result
                tq.rows_returned = len(result.rows)
                return
            result = None
        serving = getattr(self, "serving", None)
        if serving is not None:
            # FINISHED page straight from the result cache: no lock, no
            # planning, no scheduler round trip
            result = serving.lookup_cached(tq)
        no_workers = self.scheduler is not None and \
            not self.scheduler.state.active_nodes()
        if result is None and self.scheduler is not None and no_workers:
            # no cluster: skip the exec-lock round trip entirely so
            # host-routed queries stay lock-free on a plain coordinator
            tq.fallback_reason = "no active workers"
        elif result is None and self.scheduler is not None:
            # cluster path: fragment + dispatch to workers; None = not
            # eligible (coordinator executes locally)
            from .scheduler import TaskFailedError
            # distributed execution occupies the exec lock like a device
            # run: register it with the tenant fair-share tracker so a
            # scan-heavy tenant's cluster queries count as device
            # contention for everyone else's routing decisions
            fair = getattr(serving, "fair_share", None)
            if fair is not None:
                fair.device_begin(getattr(tq, "tenant", "default"))
            try:
                with self.exec_lock:
                    result = self.scheduler.execute(tq.sql,
                                                    query_id=tq.query_id)
                tq.fallback_reason = self.scheduler.fallback_reason \
                    if result is None else None
            except TaskFailedError as te:
                from .scheduler import RetryBudgetExhaustedError
                if isinstance(te, RetryBudgetExhaustedError):
                    raise    # the budget forbade more attempts: fail,
                             # don't silently degrade to local re-run
                result = None   # degrade to local execution
                tq.fallback_reason = f"task failure: {te}"
            finally:
                if fair is not None:
                    fair.device_end(getattr(tq, "tenant", "default"))
            tq.distributed = result is not None
            if tq.distributed:
                # per-query stage/task rollup for events +
                # system.runtime tables + /v1/query info
                tq.stage_stats = getattr(self.scheduler,
                                         "last_query", None)
        if result is None and getattr(
                self.session, "properties", {}).get(
                "require_distributed") and \
                tq.fallback_reason != "coordinator-only statement":
            # SET SESSION/SHOW and friends never distribute by design —
            # erroring on them would brick the very statement that turns
            # the property off
            raise QueryDeclinedError(
                "require_distributed: cluster declined the "
                f"query ({tq.fallback_reason})")
        if result is None:
            if serving is not None:
                # local path through the serving layer: plan cache,
                # micro-batching, CPU/TPU routing (device executions
                # take the exec lock inside)
                result = serving.execute_local(tq)
            else:
                with self.exec_lock:
                    result = self.session.execute(tq.sql)
        tq.elapsed_s = time.monotonic() - t0
        tq.result = result
        tq.rows_returned = len(result.rows)
        tq.spills = max(0, self._spill_counter() - spills0)


class CoordinatorState:
    def __init__(self, session: Session, max_concurrency: int = 4,
                 retry_policy: str = "NONE",
                 telemetry_interval_s: Optional[float] = None,
                 ledger_path: Optional[str] = None,
                 node_id: str = "coordinator", role: str = "primary",
                 peer_uri: Optional[str] = None,
                 spool_root: Optional[str] = None):
        import os
        self.session = session
        self.tracker = QueryTracker()
        self.dispatcher = Dispatcher(session, self.tracker, max_concurrency,
                                     retry_policy)
        self.nodes: Dict[str, RegisteredNode] = {}
        self.nodes_lock = threading.Lock()
        self.failure_detector = None   # set by HeartbeatFailureDetector
        self.started_at = time.time()
        # ---- coordinator crash recovery (server/ledger.py) ----
        self.node_id = node_id
        self.uri: Optional[str] = None      # set by CoordinatorServer
        self.peer_uri = peer_uri
        self.standbys: Dict[str, float] = {}   # standby uri -> last seen
        self.task_reports: Dict[str, dict] = {}  # worker terminal push
        self._promote_lock = threading.Lock()
        self._reexec_lock = threading.Lock()
        self._reexec_started: set = set()
        ledger_path = ledger_path or os.environ.get(
            "TRINO_TPU_LEDGER_PATH")
        self.ledger = None
        if ledger_path:
            from .ledger import QueryLedger
            self.ledger = QueryLedger(ledger_path, node_id=node_id)
        self.dispatcher.ledger = self.ledger
        # PRIMARY serves traffic; PASSIVE tails the ledger (a standby,
        # or a fenced ex-primary); RECONCILING is the promotion window
        if role == "standby":
            self.role = "PASSIVE"
        elif self.ledger is not None:
            epoch, owner = self.ledger.read_epoch()
            if epoch > 0 and owner != node_id:
                # another instance holds the ledger epoch: a resurrected
                # old primary must NOT split-brain — boot fenced
                self.role = "PASSIVE"
            else:
                self.role = "PRIMARY"
                self.ledger.claim_epoch()
        else:
            self.role = "PRIMARY"
        from .scheduler import StageScheduler
        # a durable spool root survives coordinator restarts: resumed
        # queries re-attach to completed task output instead of
        # re-running it (exchange_spool.py's durability contract)
        spool_root = spool_root or os.environ.get("TRINO_TPU_SPOOL_ROOT")
        spool = None
        if spool_root:
            from .exchange_spool import ExchangeSpool
            spool = ExchangeSpool(root=spool_root)
        self.scheduler = StageScheduler(self, session, spool=spool)
        self.dispatcher.scheduler = self.scheduler
        from .spooling import SpoolingManager
        self.spooling = SpoolingManager()
        # cluster memory arbitration: pooled accounting over worker
        # heartbeat reports + the low-memory killer; start() its loop (or
        # tick() on demand) to enforce a cluster limit
        from .memorymanager import ClusterMemoryManager
        self.memory_manager = ClusterMemoryManager(self)
        # the dispatcher's load-shed admission gate reads the manager's
        # last pressure snapshot
        self.dispatcher.memory_manager = self.memory_manager
        # query history + regression detection (server/history.py): fed
        # from QueryCompletedEvent, flushed-to on tracker eviction, and
        # served as system.runtime.query_history
        from .history import HistoryEventListener, QueryHistoryStore
        self.history = QueryHistoryStore()
        self.dispatcher.event_listeners.register(
            HistoryEventListener(self.history))
        self.tracker.on_evict = self.history.record_tracked
        # the cost router's history baseline input + EXPLAIN's routing
        # annotation both read per-fingerprint medians from this store
        self.dispatcher.serving.history = self.history
        session.history_store = self.history
        # cold-start elimination (exec/prewarm.py): AOT-warm the top
        # historical fingerprints at startup and feed the router's
        # compile-aware cold signal. Off unless TRINO_TPU_PREWARM is
        # set — disabled, serving/routing behave exactly as before.
        from ..exec.prewarm import PrewarmEngine
        self.prewarm = PrewarmEngine(session, history=self.history,
                                     exec_lock=self.dispatcher.exec_lock)
        self.dispatcher.serving.prewarm = self.prewarm
        self.prewarm.maybe_start()
        # the timeline analyzer's EXPLAIN ANALYZE hook: the scheduler
        # looks up the running TrackedQuery (state-machine stamps) to
        # print queued time in the critical-path breakdown line
        self.scheduler.tracked_lookup = self.tracker.get
        # live query observability (server/livestats.py): the fold of
        # heartbeat-streamed worker TaskStats into live per-stage
        # rollups, split-weighted progress, stuck/skew diagnosis and
        # per-node utilization. Pure fold state — only mutated when a
        # heartbeat arrives or the scheduler registers a task launch,
        # so the heartbeat-off path costs nothing.
        from .livestats import LiveStatsStore
        self.livestats = LiveStatsStore(tracked_lookup=self.tracker.get)
        self.scheduler.livestats = self.livestats
        # stuck-query escalation routes through the dispatcher's single
        # termination path (off unless TRINO_TPU_STUCK_ESCALATE_FOLDS)
        self.livestats.terminate = self.dispatcher.terminate
        # cluster flight recorder (server/telemetry.py): the local ring
        # plus coordinator-scrape federation of worker rings. The sampler
        # thread only runs when an interval is configured
        # (TRINO_TPU_TELEMETRY_INTERVAL_S or the constructor arg); the
        # default path creates the recorder but no thread and no samples.
        from .telemetry import ClusterTelemetry, FlightRecorder
        self.telemetry = ClusterTelemetry(
            FlightRecorder("coordinator",
                           interval_s=telemetry_interval_s),
            lambda: [(n.node_id, n.uri) for n in self.active_nodes()])
        # system.runtime.{queries,nodes,tasks,operator_stats,jit_cache,
        # query_history,query_timeline,metrics_history} backed by this
        # coordinator's state
        from .system_connector import SystemConnector
        session.catalog.register("system", SystemConnector(self))
        # boot-time recovery: a primary with a ledger replays it before
        # the HTTP server ever binds — queued/running queries resume
        # under their original ids, terminal ones are restored
        if self.role == "PRIMARY" and self.ledger is not None:
            self._replay_ledger()

    # ---- crash recovery / failover ---------------------------------------

    def accepting(self) -> bool:
        """May this coordinator serve statement traffic? PRIMARY only —
        and a primary that lost the ledger epoch (a newer promotion
        fenced it) demotes itself here, on the serving path, before it
        can hand out state a newer primary owns."""
        if self.role != "PRIMARY":
            return False
        if self.ledger is not None and not self.ledger.owns_epoch():
            self.role = "PASSIVE"
            return False
        return True

    def coordinator_uris(self) -> List[str]:
        """The failover address list carried in announce responses:
        this coordinator first, then every fresh standby."""
        uris = [self.uri] if self.uri else []
        cutoff = time.time() - 10.0
        for u, seen in sorted(self.standbys.items()):
            if seen >= cutoff and u not in uris:
                uris.append(u)
        if self.peer_uri and self.peer_uri not in uris:
            uris.append(self.peer_uri)
        return uris

    def promote(self, reason: str = "admin",
                wait_workers_s: float = 1.5) -> dict:
        """Standby -> primary: claim the ledger epoch (fencing every
        previous holder), wait for workers to re-announce, reconcile
        ledger state against live task inventories, sweep orphaned
        spool/staging artifacts, then resume every non-terminal query
        and start accepting traffic."""
        from ..metrics import COORDINATOR_FAILOVERS
        with self._promote_lock:
            if self.role == "PRIMARY":
                return {"role": self.role, "promoted": False}
            self.role = "RECONCILING"
            epoch = 0
            view = None
            if self.ledger is not None:
                epoch = self.ledger.claim_epoch()
                view, _ = self.ledger.replay()
            self._wait_for_workers(view, wait_workers_s)
            if self.ledger is not None:
                # again: the fenced primary may have appended until its
                # next epoch check
                view, _ = self.ledger.replay()
                self._sweep_orphans(view)
            self.memory_manager.on_promotion()
            if view is not None:
                self._replay_ledger(view)
            self.role = "PRIMARY"
            COORDINATOR_FAILOVERS.inc()
            return {"role": "PRIMARY", "promoted": True, "epoch": epoch,
                    "reason": reason}

    # a promotion's wait for the workers its ledger names, and for the
    # rest of them once one is back (a named worker that died with the
    # primary never returns)
    NAMED_WORKERS_WAIT_S = 5.0
    NAMED_WORKERS_SETTLE_S = 0.5

    def _wait_for_workers(self, view, wait_s: float) -> None:
        """Hold the promotion until workers have re-announced here, so
        resumed queries go distributed and re-attach. With no worker
        named in the ledger, the first active node ends the wait (at
        most `wait_s`). When the ledger names workers, all of them back
        ends it, or NAMED_WORKERS_SETTLE_S after the first, or
        NAMED_WORKERS_WAIT_S. A worker re-announces here only after its
        announce to the dead primary fails, which may take longer than
        `wait_s` under load."""
        named = set()
        if view is not None:
            for q in view.queries.values():
                for a in q["assigned"].values():
                    if a.get("node"):
                        named.add(a["node"])
        deadline = time.monotonic() + (self.NAMED_WORKERS_WAIT_S if named
                                       else wait_s)
        settle_until = None
        while True:
            now = time.monotonic()
            active = {n.node_id for n in self.active_nodes()}
            back = (active & named) if named else active
            if back:
                if back >= named:
                    return
                if settle_until is None:
                    settle_until = now + self.NAMED_WORKERS_SETTLE_S
                elif now >= settle_until:
                    return
            if now >= deadline:
                return
            time.sleep(0.02)

    def _replay_ledger(self, view=None) -> int:
        """Fold the ledger into live coordinator state: catalog version,
        terminal-query registry (with recorded stamps and error
        taxonomy), and resumption of every non-terminal query. Safe to
        run twice — already-tracked query ids are skipped, and the
        view itself is an idempotent fold."""
        if self.ledger is None:
            return 0
        if view is None:
            view, _ = self.ledger.replay()
        cat = self.session.catalog
        while getattr(cat, "version", 0) < view.catalog_version:
            cat.bump_version()
        # fence the id namespace: never re-mint a sequence number the
        # dead primary already issued (ids share the wall-second prefix)
        for qid in view.queries:
            parts = qid.split("_")
            if len(parts) >= 3 and parts[2].isdigit():
                self.tracker.reserve_seq(int(parts[2]))
        # and the task-id namespace: workers create tasks idempotently by
        # id, so a re-minted id would hand a resumed query the dead
        # primary's task and its (drained) buffers
        for q in view.queries.values():
            for tid in q.get("assigned", ()):
                self.scheduler.reserve_task_seq(tid)
        resumed = 0
        for qid, q in sorted(view.queries.items()):
            if self.tracker.get(qid) is not None:
                continue                 # already live: double replay
            if q["terminal"] is not None:
                self.dispatcher.restore_terminal(q)
            else:
                self.dispatcher.resume(q, self._resume_mode(q))
                # live progress re-derivation: re-register the ledger's
                # task assignments so reattached tasks' next heartbeat
                # folds back into THIS coordinator's progress estimate
                self.livestats.begin(qid)
                for tid in q.get("assigned", ()):
                    self.livestats.register_task(qid, tid)
                resumed += 1
        return resumed

    def _resume_mode(self, q: dict) -> str:
        """Resumption-mode classification: pre-execution states replay
        from admission; mid-execution queries re-attach when spooled
        output or a surviving assigned task exists, else re-execute."""
        if q["state"] in ("QUEUED", "PLANNING"):
            return "replayed"
        if q["spooled"]:
            return "reattached"
        live_tasks = set(self.task_reports)
        with self.nodes_lock:
            for n in self.nodes.values():
                for t in getattr(n, "tasks", None) or ():
                    tid = t.get("taskId") if isinstance(t, dict) else t
                    if tid:
                        live_tasks.add(tid)
        if any(tid in live_tasks for tid in q["assigned"]):
            return "reattached"
        return "reexecuted"

    def _sweep_orphans(self, view) -> None:
        """Promotion-time hygiene: drop result-spool entries no live
        query can claim, and roll forward / sweep staged-write state in
        every staged-write catalog (a durable commit INTENT finishes
        publishing; everything else is swept — re-executed writes then
        dedup against the published parts)."""
        keep = set()
        for q in view.live():
            keep.update(q["spooled"])
        try:
            self.scheduler.spool.sweep(keep=keep)
        except Exception:  # noqa: BLE001 — sweep is best-effort hygiene
            pass
        from . import writeprotocol as wp
        for conn in self.session.catalog._connectors.values():
            root = getattr(conn, "root", None)
            if root and getattr(conn, "supports_staged_writes", False):
                try:
                    wp.sweep_root(root)
                except Exception:  # noqa: BLE001
                    pass

    def reexecute_restored(self, tq: TrackedQuery) -> TrackedQuery:
        """A ledger-restored FINISHED query got polled for data it no
        longer holds: re-run it under the original id. Reads are pure
        (bit-exact result); writes short-circuit through the commit
        journal's published parts. Triggered at most once per id."""
        with self._reexec_lock:
            if tq.query_id in self._reexec_started:
                return self.tracker.get(tq.query_id) or tq
            self._reexec_started.add(tq.query_id)
        times = {k: v for k, v in tq.state_machine.state_times.items()
                 if k not in ("FINISHED", "FAILED", "CANCELED")}
        q = {"query_id": tq.query_id, "sql": tq.sql,
             "user": tq.session_user, "state_times": times}
        return self.dispatcher.resume(q, "reexecuted")

    def announce(self, node_id: str, uri: str,
                 state: str = "ACTIVE",
                 now: Optional[float] = None,
                 tasks: Optional[list] = None,
                 live_stats: Optional[dict] = None,
                 memory: Optional[dict] = None) -> None:
        """Register/refresh a worker, honoring its reported lifecycle
        state. LEFT deregisters (the graceful mirror of a failure-
        detector eviction); DRAINING/DRAINED pull the node out of
        placement without the detector penalty; ACTIVE restores a node
        from a canceled drain (FAILED→ACTIVE recovery still goes
        through the detector-ratio gate). Any membership or state
        change triggers an immediate cluster-memory re-arbitration.

        STANDBY announces come from a peer coordinator, not a worker:
        they only refresh the failover address list. `tasks` is the
        worker's live task inventory — the promoted coordinator's
        reconciliation input."""
        from ..metrics import NODE_LIFECYCLE_TRANSITIONS
        if state == "STANDBY":
            if uri:
                self.standbys[uri] = time.time()
            return
        changed = False
        # clock-skew estimate: the worker stamped `now` at send time and
        # we read our clock at receive time — the send/recv midpoint of a
        # sub-millisecond local POST, so offset ≈ worker_clock - ours.
        # Adopted worker spans are rebased by it (utils/tracing.py).
        offset = (now - time.time()) if now is not None else None
        with self.nodes_lock:
            node = self.nodes.get(node_id)
            if offset is not None and node is not None and state != "LEFT":
                node.clock_offset = offset
            if state == "LEFT":
                if node is not None:
                    del self.nodes[node_id]
                    changed = True
            elif node is None or node.uri != uri:
                self.nodes[node_id] = RegisteredNode(node_id, uri)
                self.nodes[node_id].state = \
                    state if state in ("DRAINING", "DRAINED") else "ACTIVE"
                if offset is not None:
                    self.nodes[node_id].clock_offset = offset
                changed = True
                state = self.nodes[node_id].state
            else:
                node.last_announce = time.time()
                if state in ("DRAINING", "DRAINED"):
                    # drain overrides FAILED: the worker is reachable
                    # and winding down, not dead
                    if node.state != state:
                        node.state = state
                        changed = True
                elif node.state in ("DRAINING", "DRAINED"):
                    node.state = "ACTIVE"    # drain canceled
                    changed = True
                elif node.state == "FAILED" and \
                        self._recovery_allowed(node_id):
                    node.state = "ACTIVE"    # recovered
                    changed = True
            survivor = self.nodes.get(node_id)
            if survivor is not None and tasks is not None:
                survivor.tasks = tasks
            if survivor is not None and memory is not None:
                # heartbeat pool snapshot: refreshes the same field the
                # failure detector's pings write, shrinking the memory
                # manager's staleness window between status polls
                survivor.memory = memory
        if changed:
            NODE_LIFECYCLE_TRANSITIONS.inc(state=state)
            # outside nodes_lock: tick() re-reads the inventory itself
            self.memory_manager.on_membership_change()
        if live_stats is not None:
            # fold the piggybacked live task stats outside nodes_lock
            # (the fold takes its own lock and may log)
            self.livestats.fold(node_id, live_stats)

    def _recovery_allowed(self, node_id: str) -> bool:
        """A FAILED node may only rejoin on announce when the failure
        detector's decayed ratio has dropped back under the threshold
        (or no detector is attached). Without this gate, a node whose
        task executor is wedged but whose announcer still runs flips
        straight back to ACTIVE and reabsorbs splits every round."""
        det = self.failure_detector
        if det is None:
            return True
        st = det.stats.get(node_id)
        return st is None or st.failure_ratio <= det.threshold

    def active_nodes(self) -> List[RegisteredNode]:
        with self.nodes_lock:
            return [n for n in self.nodes.values() if n.state == "ACTIVE"]


def _column_json(result) -> List[dict]:
    cols = []
    for name in result.column_names:
        cols.append({"name": name, "type": "unknown"})
    return cols


def _rows_json(rows: List[tuple]) -> List[list]:
    out = []
    for r in rows:
        vals = []
        for v in r:
            if v is None or isinstance(v, (int, float, str, bool)):
                vals.append(v)
            else:
                vals.append(str(v))      # Decimal, date -> text like Trino
        out.append(vals)
    return out


class _Handler(BaseHTTPRequestHandler):
    state: CoordinatorState = None       # injected by make_server
    protocol_version = "HTTP/1.1"

    # -- helpers ----------------------------------------------------------

    def _send(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str,
                   content_type: str = "text/plain; version=0.0.4") -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _not_found(self, path: str) -> None:
        self._send(404, {"error": {"message": f"no route {path}"}})

    def _base(self) -> str:
        host = self.headers.get("Host", "localhost")
        return f"http://{host}"

    def log_message(self, fmt, *args):   # quiet
        pass

    def _read_body(self) -> str:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n).decode()

    def _query_payload(self, tq: TrackedQuery, token: int) -> dict:
        """One protocol page: state + columns + data + nextUri while more."""
        sm = tq.state_machine
        if sm.is_done():
            # terminal pages wait for the completion pipeline (event
            # listeners, ledger terminal record, metrics) to finish, so
            # the client's view of "done" is never ahead of the server's
            sm.settled.wait(5.0)
        base = self._base()
        # split-weighted live progress (server/livestats.py): monotonic
        # per query (the store high-waters, TrackedQuery remembers),
        # 1.0 exactly at FINISHED. Queries the store never saw (local
        # execution, heartbeats off) ride their remembered ratio — 0.0
        # until terminal, so the CLI progress line still behaves.
        ls = self.state.livestats
        progress = ls.progress(tq.query_id)
        if progress is not None and progress > tq.progress_ratio:
            tq.progress_ratio = progress
        stage = ls.dominant_stage(tq.query_id)
        if stage:
            tq.dominant_stage = stage
        if sm.state == "FINISHED":
            tq.progress_ratio = 1.0
        payload = {
            "id": tq.query_id,
            "infoUri": f"{base}/v1/query/{tq.query_id}",
            "stats": {
                "state": tq.state,
                "queued": tq.state == "QUEUED",
                "elapsedTimeMillis": int(tq.elapsed_s * 1000),
                "rows": tq.rows_returned,
                "progressRatio": round(tq.progress_ratio, 6),
                "stage": tq.dominant_stage,
            },
        }
        if sm.state == "FAILED":
            payload["error"] = {"message": sm.error,
                                "errorCode": sm.error_code,
                                "errorName": sm.error_name}
            if sm.error_name in ("QUERY_QUEUE_FULL",
                                 "QUERY_EXCEEDED_QUEUED_TIME"):
                # overload rejections are safe to retry later/elsewhere
                # — the statement-level mirror of the 503 contract the
                # client's failover loop already keys on
                payload["error"]["retryable"] = True
            return payload
        if sm.state == "CANCELED":
            payload["error"] = {"message": "Query was canceled",
                                "errorCode": 2, "errorName": "USER_CANCELED"}
            return payload
        if sm.state != "FINISHED":
            payload["nextUri"] = (f"{base}/v1/statement/executing/"
                                  f"{tq.query_id}/{token}")
            return payload
        result = tq.result
        payload["columns"] = _column_json(result)
        # spooled protocol: opted-in clients get segment descriptors for
        # large results instead of inline pages (spi/spool/ role)
        if self.headers.get("X-Trino-Spooled") == "true" and \
                len(result.rows) > PAGE_ROWS and token == 0:
            segments = self.state.spooling.spool(_rows_json(result.rows))
            payload["segments"] = [
                {**s, "uri": f"{base}{s['uri']}"} for s in segments]
            return payload
        start = token * PAGE_ROWS
        chunk = result.rows[start:start + PAGE_ROWS]
        payload["data"] = _rows_json(chunk)
        if start + PAGE_ROWS < len(result.rows):
            payload["nextUri"] = (f"{base}/v1/statement/executing/"
                                  f"{tq.query_id}/{token + 1}")
        return payload

    def _authenticate(self):
        """Returns the authenticated user, or None after sending 401.
        Open clusters (no authenticator) pass the header user through."""
        user = self.headers.get("X-Trino-User", "anonymous")
        auth = self.state.dispatcher.authenticator
        if auth is None:
            return user
        from .security import AuthenticationError
        secret = self.headers.get("X-Trino-Password")
        if secret is None:
            bearer = self.headers.get("Authorization", "")
            if bearer.startswith("Bearer "):
                secret = bearer[len("Bearer "):]
        try:
            return auth.authenticate(user, secret)
        except AuthenticationError as e:
            self.send_response(401)
            body = json.dumps(
                {"error": {"message": str(e),
                           "errorName": "AUTHENTICATION_FAILED"}}).encode()
            self.send_header("Content-Type", "application/json")
            self.send_header("WWW-Authenticate", "Basic")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return None

    # -- dispatch ----------------------------------------------------------

    def do_POST(self):
        dispatch(self, "POST", ROUTES, SERVER_NAME)

    def do_GET(self):
        dispatch(self, "GET", ROUTES, SERVER_NAME)

    def do_DELETE(self):
        dispatch(self, "DELETE", ROUTES, SERVER_NAME)

    def do_PUT(self):
        dispatch(self, "PUT", ROUTES, SERVER_NAME)

    def _unavailable(self) -> bool:
        """503 on statement traffic while not PRIMARY — the retryable
        signal the client's failover poll loop keys on."""
        if self.state.accepting():
            return False
        self._send(503, {"error": {
            "message": f"coordinator is {self.state.role}",
            "errorName": "COORDINATOR_UNAVAILABLE",
            "retryable": True}})
        return True

    # -- routes -----------------------------------------------------------

    def _post_statement(self, parts, user):
        if self._unavailable():
            return
        sql = self._read_body()
        if not sql.strip():
            self._send(400, {"error": {"message": "empty statement"}})
            return
        tq = self.state.dispatcher.submit(
            sql, user, traceparent=self.headers.get("traceparent"))
        self._send(200, self._query_payload(tq, 0))

    def _post_announce(self, parts, user):
        body = json.loads(self._read_body() or "{}")
        st = self.state
        st.announce(body.get("nodeId", "unknown"),
                    body.get("uri", ""),
                    state=body.get("state", "ACTIVE"),
                    now=body.get("now"),
                    tasks=body.get("tasks"),
                    live_stats=body.get("liveStats"),
                    memory=body.get("memory"))
        # the failover contract: every announce response carries the
        # coordinator address list (primary first, fresh standbys after)
        # so workers and clients always know where to re-announce
        resp = {"ok": True, "role": st.role,
                "coordinators": st.coordinator_uris()}
        if st.ledger is not None:
            resp["epoch"] = st.ledger.read_epoch()[0]
        self._send(202, resp)

    def _post_task_status(self, parts, user):
        # buffered terminal-status re-delivery from workers (possibly
        # reports the old primary never saw) — reconciliation input
        body = json.loads(self._read_body() or "{}")
        tid = body.get("taskId")
        if tid:
            self.state.task_reports[tid] = body
        self._send(202, {"ok": True})

    def _get_info_state(self, parts, user):
        st = self.state
        payload = {"state": st.role, "nodeId": st.node_id,
                   "ready": st.role == "PRIMARY",
                   "coordinators": st.coordinator_uris()}
        if st.ledger is not None:
            epoch, owner = st.ledger.read_epoch()
            payload["epoch"] = epoch
            payload["epochOwner"] = owner
        self._send(200, payload)

    def _put_info_state(self, parts, user):
        body = json.loads(self._read_body() or "{}")
        want = str(body.get("state", "")).upper()
        if want in ("PRIMARY", "ACTIVE"):
            self._send(200, self.state.promote(reason="admin"))
            return
        self._send(400, {"error": {
            "message": f"unsupported coordinator state {want!r} "
                       f"(PUT PRIMARY/ACTIVE to promote)"}})

    def _get_info(self, parts, user):
        self._send(200, {
            "nodeVersion": {"version": "trino-tpu-0.1"},
            "coordinator": True, "starting": False,
            "uptime": time.time() - self.state.started_at})

    def _get_status(self, parts, user):
        # liveness for load balancers / the failure detector: open
        # even on a secured cluster (no query data exposed)
        from ..exec.prewarm import compile_cache_stats
        from ..exec.profiler import device_memory_stats
        self._send(200, {"nodeId": "coordinator", "state": "ACTIVE",
                         "device": device_memory_stats(),
                         "compileCache": compile_cache_stats(),
                         "prewarm": self.state.prewarm.stats()})

    def _get_metrics(self, parts, user):
        from ..metrics import REGISTRY
        self._send_text(200, REGISTRY.render())

    def _get_jit(self, parts, user):
        # JIT-compile observability (exec/profiler.py): per-(site,
        # fingerprint) compile/hit aggregates plus process totals — the
        # scrape twin of system.runtime.jit_cache (no query data, so it
        # stays open like /v1/metrics)
        from ..exec.profiler import RECORDER
        self._send(200, {"totals": RECORDER.totals(),
                         "entries": RECORDER.snapshot(),
                         # shape-canonicalization signal + prewarm view:
                         # entries carry prewarmed/prewarm_hits columns,
                         # distinctShapes is the per-site shape count
                         "distinctShapes": RECORDER.site_shape_counts(),
                         "prewarm": self.state.prewarm.stats()})

    def _get_prewarm(self, parts, user):
        # the joining-worker warm-manifest handshake (server/worker.py
        # pulls this before its first ACTIVE announce)
        self._send(200, self.state.prewarm.manifest())

    def _get_segment(self, parts, user):
        data = self.state.spooling.read(parts[3])
        if data is None:
            self._send(404, {"error": {"message": "unknown segment"}})
            return
        self._send(200, {"data": data})

    def _get_resource_group(self, parts, user):
        self._send(200, self.state.dispatcher.resource_groups.info())

    def _get_memory(self, parts, user):
        # cluster memory view (memory/ClusterMemoryManager's JMX beans,
        # flattened): coordinator pool + per-worker heartbeat reports
        self._send(200, self.state.memory_manager.snapshot())

    def _get_nodes(self, parts, user):
        nodes = [{"nodeId": n.node_id, "uri": n.uri, "state": n.state}
                 for n in self.state.nodes.values()]
        self._send(200, nodes)

    def _get_queries(self, parts, user):
        out = []
        for tq in self.state.tracker.all():
            out.append({"queryId": tq.query_id, "state": tq.state,
                        "query": tq.sql, "user": tq.session_user})
        self._send(200, out)

    def _get_query(self, parts, user):
        tq = self.state.tracker.get(parts[2])
        if tq is None:
            self._send(404, {"error": {"message": "unknown query"}})
            return
        sm = tq.state_machine
        st = tq.stage_stats or {}
        # live observability (server/livestats.py): high-water the
        # heartbeat-fed progress onto the tracked query, then serve the
        # in-flight per-stage rollup + stuck diagnosis alongside the
        # terminal stage stats — mid-flight GETs see real numbers
        ls = self.state.livestats
        progress = ls.progress(tq.query_id)
        if progress is not None and progress > tq.progress_ratio:
            tq.progress_ratio = progress
        dom = ls.dominant_stage(tq.query_id)
        if dom:
            tq.dominant_stage = dom
        if sm.state == "FINISHED":
            tq.progress_ratio = 1.0
        rollup = ls.query_rollup(tq.query_id)
        self._send(200, {
            "queryId": tq.query_id, "state": tq.state, "query": tq.sql,
            "user": tq.session_user, "error": sm.error,
            "elapsedSeconds": tq.elapsed_s,
            "rows": tq.rows_returned, "retries": tq.retries,
            "distributed": tq.distributed,
            "fallbackReason": tq.fallback_reason,
            "route": tq.route, "routeReason": tq.route_reason,
            "progressRatio": round(tq.progress_ratio, 6),
            "dominantStage": tq.dominant_stage,
            "liveStats": rollup,
            "diagnosis": tq.live_diagnosis,
            "stageStats": {
                "stages": st.get("stages", 0),
                "tasks": len(st.get("tasks", ())),
                "bytesShuffled": st.get("bytes_shuffled", 0),
                "taskRetries": st.get("task_retries", 0),
                "hedgedTasks": st.get("hedged_tasks", 0),
                "hedgeWins": st.get("hedge_wins", 0),
                "faultsSurvived": st.get("faults_survived", 0)},
            # exactly-once write rollup (empty for reads)
            "writtenRows": (st.get("write") or {}).get("rows", 0),
            "writtenBytes": (st.get("write") or {}).get("bytes", 0),
            "commitPhase": (st.get("write") or {}).get("phase", "")})

    def _get_query_trace(self, parts, user):
        """Stitched query trace (coordinator + adopted worker spans) as
        OTLP-like JSON — the reference exports the same shape over OTLP."""
        tq = self.state.tracker.get(parts[2])
        if tq is None:
            self._send(404, {"error": {"message": "unknown query"}})
            return
        spans = tq.trace
        if spans is None and tq.tracer is not None:
            spans = tq.tracer.export()    # still executing: live view
        tracer = tq.tracer
        self._send(200, {
            "queryId": tq.query_id,
            "traceId": tracer.trace_id if tracer is not None else None,
            "spans": spans or []})

    def _get_query_timeline(self, parts, user):
        """Critical-path wall-time attribution (server/timeline.py):
        phase intervals summing exactly to elapsed wall, the dominant
        phase, and the blocking critical path over stage spans."""
        tq = self.state.tracker.get(parts[2])
        if tq is None:
            self._send(404, {"error": {"message": "unknown query"}})
            return
        tl = tq.timeline
        if tl is None:                    # still executing: live view
            from .timeline import build_timeline
            tl = build_timeline(tq)
        self._send(200, tl)

    def _get_telemetry(self, parts, user):
        from urllib.parse import parse_qs, urlparse
        try:
            since = float(parse_qs(urlparse(self.path).query)
                          .get("since", ["0"])[0])
        except ValueError:
            since = 0.0
        rec = self.state.telemetry.recorder
        self._send(200, {"nodeId": rec.node_id,
                         "samples": rec.since(since)})

    def _get_executing(self, parts, user):
        if self._unavailable():
            return
        qid = parts[3]
        token = int(parts[4]) if len(parts) > 4 else 0
        tq = self.state.tracker.get(qid)
        if tq is None:
            self._send(404, {"error": {"message": "unknown query"}})
            return
        if tq.state_machine.state == "FINISHED" and tq.result is None:
            # ledger-restored FINISHED query without its result pages:
            # re-run under the original id (pure reads are bit-exact;
            # writes short-circuit on the published commit)
            tq = self.state.reexecute_restored(tq)
        # long-poll lite: give the dispatcher a moment before answering
        # (ExecutingStatementResource waits up to ~1s the same way)
        deadline = time.time() + 0.5
        while not tq.state_machine.is_done() and time.time() < deadline:
            time.sleep(0.01)
        self._send(200, self._query_payload(tq, token))

    def _delete_segment(self, parts, user):
        self.state.spooling.ack(parts[3])
        self._send(204, {})

    def _delete_executing(self, parts, user):
        # route through the dispatcher's single termination path: a bare
        # state_machine.cancel() here used to leave every in-flight
        # worker task running to completion (and its buffers pinned)
        tq = self.state.tracker.get(parts[3])
        if tq is not None:
            self.state.dispatcher.terminate(tq.query_id, reason="user")
        self._send(204, {})


class CoordinatorServer:
    """In-process coordinator (TestingTrinoServer.java:155 pattern: real
    HTTP, embeddable in one process for tests)."""

    def __init__(self, session: Optional[Session] = None, port: int = 0,
                 max_concurrency: int = 4, retry_policy: str = "NONE",
                 telemetry_interval_s: Optional[float] = None,
                 ledger_path: Optional[str] = None,
                 node_id: str = "coordinator", role: str = "primary",
                 peer_uri: Optional[str] = None,
                 spool_root: Optional[str] = None,
                 standby_interval_s: float = 0.25,
                 auto_promote: bool = True):
        self.state = CoordinatorState(session or Session(),
                                      max_concurrency, retry_policy,
                                      telemetry_interval_s,
                                      ledger_path=ledger_path,
                                      node_id=node_id, role=role,
                                      peer_uri=peer_uri,
                                      spool_root=spool_root)
        handler = type("BoundHandler", (_Handler,), {"state": self.state})
        self.httpd = ClusterHTTPServer(("127.0.0.1", port), handler)
        self.port = self.httpd.server_address[1]
        self.uri = f"http://127.0.0.1:{self.port}"
        self.state.uri = self.uri
        self._thread: Optional[threading.Thread] = None
        self._watcher = None
        self._standby_interval_s = standby_interval_s
        self._auto_promote = auto_promote

    def start(self) -> "CoordinatorServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="coordinator-http",
                                        daemon=True)
        self._thread.start()
        # no-op unless a telemetry interval is configured
        self.state.telemetry.start()
        # warm standby: announce ourselves to the primary (so announce
        # responses carry our address), tail the ledger, and promote on
        # primary death (detector-driven) — failuredetector.py
        if self.state.role != "PRIMARY" and self.state.peer_uri:
            from .failuredetector import StandbyWatcher
            self._watcher = StandbyWatcher(
                self.state, self.uri, self.state.peer_uri,
                interval_s=self._standby_interval_s,
                auto_promote=self._auto_promote)
            self._watcher.start()
        return self

    def stop(self) -> None:
        if self._watcher is not None:
            self._watcher.stop()
        self.state.telemetry.stop()
        # shutdown() blocks until serve_forever acknowledges — which
        # never happens if start() was never called, so only wave at a
        # loop that actually exists
        if self._thread is not None:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def kill(self) -> None:
        """Crash model (the coordinator twin of WorkerServer.kill):
        stop serving instantly with no drain or goodbye, and seal the
        ledger so the dead instance can never append another record —
        in-flight dispatch threads keep running but their world is
        write-protected, exactly like a machine losing power."""
        if self.state.ledger is not None:
            self.state.ledger.seal()
        self.state.role = "PASSIVE"
        # the dead process's card memory: its executor's caches go (the
        # in-flight threads keep what they hold)
        self.state.session.executor.release_device_caches()
        if self._watcher is not None:
            self._watcher.stop()
        self.state.telemetry.stop()
        try:
            if self._thread is not None:
                self.httpd.shutdown()
            self.httpd.server_close()
        except Exception:  # noqa: BLE001 — dying twice is fine
            pass
