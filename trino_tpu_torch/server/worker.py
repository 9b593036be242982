"""Worker server + announcer.

Reference: the worker role of Server.java (ServerMainModule.java:200
WorkerModule) — a worker exposes /v1/status for liveness and /v1/task for
fragment execution, and announces itself to discovery (node/Announcer.java).

Port of ``trino_tpu/server/worker.py``. A worker owns one Executor on
its device (the card unless the caller names the CPU) and runs the
fragments the coordinator's stage scheduler sends it; HTTP workers share no
communicator, so several may share one card. /v1/task accepts work
descriptors (a fragment and its splits) and serves result pages for pull.

Routes live in the module-level ROUTES table (server/routes.py): every
request is counted in the process metrics registry, and /v1/metrics serves
the registry in Prometheus text format. Task POSTs carry the coordinator's
W3C `traceparent`, which the task manager adopts so worker spans stitch
into the query trace.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.request import Request, urlopen

from .routes import STAR, dispatch, register_routes

SERVER_NAME = "worker"


def _refused(e: OSError) -> bool:
    """Did nothing listen at the address? urlopen wraps the socket's
    ConnectionRefusedError in a URLError's `reason`."""
    return isinstance(e, ConnectionRefusedError) or \
        isinstance(getattr(e, "reason", None), ConnectionRefusedError)


# (METHOD, pattern, handler method, needs_auth) — see server/routes.py.
# The task/exchange data plane is cluster-internal: with
# TRINO_TPU_INTERNAL_SECRET set, callers without the shared-secret
# header get 401 (anyone with network reach could otherwise pull result
# pages or inject work). Liveness/metrics stay open.
ROUTES = (
    ("GET", ("v1", "status"), "_get_status", False),
    ("GET", ("v1", "info"), "_get_info", False),
    ("GET", ("v1", "info", "state"), "_get_state", False),
    ("GET", ("v1", "metrics"), "_get_metrics", False),
    ("GET", ("v1", "task", STAR), "_get_task", "internal"),
    # incremental live TaskStats (round-21): ?since=<seq> returns the
    # bounded live record only when the task changed past the cursor
    ("GET", ("v1", "task", STAR, "status"), "_get_task_status",
     "internal"),
    ("GET", ("v1", "task", STAR, "results", STAR), "_get_results",
     "internal"),
    ("GET", ("v1", "task", STAR, "results", STAR, STAR), "_get_results",
     "internal"),
    ("POST", ("v1", "task", STAR), "_post_task", "internal"),
    ("DELETE", ("v1", "task", STAR), "_delete_task", "internal"),
    ("PUT", ("v1", "info", "state"), "_put_state", "internal"),
    # flight-recorder scrape (server/telemetry.py): the coordinator
    # federates worker rings from here. Internal: metric keys carry
    # tenant/route labels a stranger shouldn't map
    ("GET", ("v1", "telemetry"), "_get_telemetry", "internal"),
)

register_routes(SERVER_NAME, ROUTES)


class _WorkerHandler(BaseHTTPRequestHandler):
    worker: "WorkerServer" = None
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

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

    def _send_page(self, frame: bytes, headers: dict) -> None:
        """Binary data-plane response: the page frame raw in the body,
        pull-protocol metadata in headers (PagesSerde over HTTP — the
        reference's TaskResource results route with
        application/x-trino-pages)."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-trino-pages")
        self.send_header("Content-Length", str(len(frame)))
        for k, v in headers.items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(frame)

    def _not_found(self, path: str) -> None:
        self._send(404, {"error": f"no route {path}"})

    # -- dispatch ----------------------------------------------------------

    def do_GET(self):
        dispatch(self, "GET", ROUTES, SERVER_NAME)

    def do_POST(self):
        dispatch(self, "POST", ROUTES, SERVER_NAME)

    def do_DELETE(self):
        dispatch(self, "DELETE", ROUTES, SERVER_NAME)

    def do_PUT(self):
        dispatch(self, "PUT", ROUTES, SERVER_NAME)

    # -- routes -----------------------------------------------------------

    def _get_status(self, parts, user):
        if self.worker.fail_status:          # fault injection hook
            self._send(500, {"error": "injected failure"})
            return
        from ..exec.prewarm import compile_cache_stats
        from ..exec.profiler import device_memory_stats
        payload = {"nodeId": self.worker.node_id,
                   "state": self.worker.state,
                   "uptime": time.time() - self.worker.started_at,
                   # heartbeat memory report: the failure
                   # detector's pings carry this to the
                   # coordinator's ClusterMemoryManager
                   "memory":
                       self.worker.task_manager.memory_info(),
                   # live accelerator/HBM allocator stats (zeros
                   # off-TPU) — surfaced in system.runtime.nodes
                   "device": device_memory_stats(),
                   # persistent compile-cache report: operators verify
                   # cache-dir sharing across workers from here
                   "compileCache": compile_cache_stats()}
        if self.worker.prewarm is not None:
            payload["prewarm"] = self.worker.prewarm.stats()
        self._send(200, payload)

    def _get_info(self, parts, user):
        self._send(200, {"nodeVersion": {"version": "trino-tpu-0.1"},
                         "coordinator": False,
                         "state": self.worker.state})

    # GET /v1/info/state — the read side of the drain request (the
    # reference's NodeState resource); open like the other liveness
    # routes so operators can watch a drain without the secret
    def _get_state(self, parts, user):
        self._send(200, {"state": self.worker.state})

    def _get_metrics(self, parts, user):
        from ..metrics import REGISTRY
        self._send_text(200, REGISTRY.render())

    # GET /v1/telemetry?since=<ts> — incremental flight-recorder scrape
    def _get_telemetry(self, parts, user):
        from urllib.parse import parse_qs, urlparse
        try:
            since = float(parse_qs(urlparse(self.path).query)
                          .get("since", ["0"])[0])
        except ValueError:
            since = 0.0
        rec = self.worker.telemetry
        self._send(200, {"nodeId": self.worker.node_id,
                         "samples": rec.since(since)})

    def _task_or_404(self, task_id: str):
        task = self.worker.task_manager.get(task_id)
        if task is None:
            self._send(404, {"error": f"unknown task {task_id}"})
        else:
            # every coordinator pull is a liveness signal for the
            # orphan reaper: a referenced task is never abandoned
            self.worker.task_manager.touch(task_id)
        return task

    # GET /v1/task/{id} — TaskStatus long-poll target
    # (server/remotetask/ContinuousTaskStatusFetcher's endpoint)
    def _get_task(self, parts, user):
        task = self._task_or_404(parts[2])
        if task is not None:
            self._send(200, self.worker.task_manager.status_json(task))

    # GET /v1/task/{id}/status?since=<seq> — the pull twin of the
    # announce-piggybacked heartbeat: a bounded live TaskStats record
    # when the task's change sequence advanced past `since`, a
    # fixed-size unchanged ack otherwise. Unlike GET /v1/task/{id} this
    # never ships operators/spans, so polling it is O(1) per task.
    def _get_task_status(self, parts, user):
        task = self._task_or_404(parts[2])
        if task is None:
            return
        from urllib.parse import parse_qs, urlparse
        try:
            since = int(parse_qs(urlparse(self.path).query)
                        .get("since", ["0"])[0])
        except ValueError:
            since = 0
        live = self.worker.task_manager.live_status(task)
        if live["seq"] <= since:
            self._send(200, {"taskId": task.task_id,
                             "seq": live["seq"], "changed": False})
        else:
            self._send(200, {"taskId": task.task_id,
                             "seq": live["seq"], "changed": True,
                             "task": live})

    # GET /v1/task/{id}/results/{token}            — buffer 0
    # GET /v1/task/{id}/results/{buffer}/{token}   — partitioned
    # (server/TaskResource.java:332; buffers are the partitioned
    # output of the worker<->worker exchange)
    def _get_results(self, parts, user):
        task = self._task_or_404(parts[2])
        if task is None:
            return
        if self.worker.fail_results:         # fault injection hook
            self._send(500, {"error": "injected results failure"})
            return
        buffer = int(parts[4]) if len(parts) == 6 else 0
        token = int(parts[-1])
        binary = "x-trino-pages" in self.headers.get("Accept", "")
        # ?ack=0: serve without the implicit-ack page drop — write-stage
        # consumers use it so a retried or hedged attempt re-reads the
        # whole buffer (an acked page is gone for every later attempt)
        from urllib.parse import parse_qs, urlparse
        ack = parse_qs(urlparse(self.path).query).get(
            "ack", ["1"])[0] != "0"
        # only bookkeeping under the lock: P concurrent consumer
        # pulls + the producer's _emit all contend on it, so socket
        # writes must happen after release
        frame = None
        envelope = None
        with task.cond:
            pages = task.buffers.setdefault(buffer, [])
            acked = task.acked.get(buffer, 0)
            # Advancing to `token` acknowledges every page below it
            # (TaskResource.java:372's implicit-ack contract) — drop
            # drained pages so a long-lived worker's memory stays flat;
            # same-token retries after a fetch failure still succeed.
            drained = 0
            while ack and acked < token and pages:
                drained += len(pages.pop(0))
                acked += 1
            task.acked[buffer] = acked
            if drained:
                # acks free staged bytes: wake a producer paused on a
                # full output buffer (exchange backpressure)
                task.buffered_bytes = max(0, task.buffered_bytes - drained)
                task.cond.notify_all()
            idx = token - acked
            total = acked + len(pages)
            if 0 <= idx < len(pages):
                frame = pages[idx]
            else:
                done = task.state in ("FINISHED", "FAILED",
                                      "CANCELED")
                envelope = {"token": token,
                            "complete": done and token >= total,
                            "state": task.state,
                            "error": task.error, "page": None}
        if frame is not None:
            if binary:
                self._send_page(frame, {"X-Trino-Token": token,
                                        "X-Trino-Complete": "false"})
            else:
                import base64
                self._send(200, {
                    "token": token, "complete": False,
                    "page": {"b64": base64.b64encode(
                        frame).decode()}})
        else:
            self._send(200, envelope)

    # POST /v1/task/{id} — create/update with fragment + splits
    # (server/TaskResource.java:146 createOrUpdateTask)
    def _post_task(self, parts, user):
        if self.worker.fail_tasks:           # fault injection hook
            self._send(500, {"error": "injected task failure"})
            return
        if self.worker.state != "ACTIVE":
            # a draining/drained worker accepts NO new work; 409 tells
            # the scheduler this is a lifecycle handoff (the splits
            # migrate to survivors), not a node failure
            self._send(409, {"error": f"node is {self.worker.state}",
                             "errorName": "NODE_DRAINING"})
            return
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n).decode())
        from .failureinjector import InjectedFailure
        from .tasks import Split
        splits = [Split(**s) for s in body.get("splits", [])]
        try:
            task = self.worker.task_manager.create_or_update(
                parts[2], body["fragment"], splits,
                partition=body.get("partition"),
                sources=body.get("sources"),
                traceparent=self.headers.get("traceparent"),
                deadline=body.get("deadline"))
        except InjectedFailure as e:
            # chaos at task intake (crash/drop/raise all surface to
            # the coordinator as a failed POST -> split reassignment)
            self._send(500, {"error": str(e)})
            return
        self._send(200, self.worker.task_manager.status_json(task))

    # DELETE /v1/task/{id} — cancel/abort (TaskResource.java:319's
    # fail route collapsed with delete)
    def _delete_task(self, parts, user):
        self.worker.task_manager.cancel(parts[2])
        self._send(204, {})

    # PUT /v1/info/state — the admin drain request
    # (server/ServerInfoResource.java updateState's SHUTTING_DOWN path):
    # "DRAINING" starts the graceful-drain sequence asynchronously;
    # "ACTIVE" cancels a not-yet-completed drain (the node resumes
    # accepting work and re-announces).
    def _put_state(self, parts, user):
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n).decode())
        requested = body.get("state") if isinstance(body, dict) else body
        if requested not in ("DRAINING", "ACTIVE"):
            self._send(400, {"error": f"cannot request state "
                                      f"{requested!r} (valid: DRAINING, "
                                      f"ACTIVE)"})
            return
        if requested == "DRAINING":
            self.worker.request_drain()
        else:
            self.worker.cancel_drain()
        self._send(200, {"state": self.worker.state})


class WorkerServer:
    """One worker process stand-in: HTTP status endpoint + announcer loop.

    Lifecycle: ACTIVE -> DRAINING -> DRAINED -> LEFT. A drain (admin
    `PUT /v1/info/state` or a graceful `stop()`) stops task intake,
    finishes in-flight splits, keeps output buffers pullable until
    consumers drain them, then deregisters with a final LEFT announce.
    Every announce carries the state, so the coordinator's scheduler
    stops placing splits here the moment DRAINING lands."""

    def __init__(self, node_id: str, coordinator_uri: str, port: int = 0,
                 announce_interval_s: float = 1.0, catalog=None,
                 drain_timeout_s: float = 30.0,
                 flush_grace_s: float = 1.0,
                 telemetry_interval_s: Optional[float] = None,
                 heartbeat_interval_s: Optional[float] = None,
                 device=None):
        self.node_id = node_id
        self.coordinator_uri = coordinator_uri
        # coordinator failover address list: seeded with the boot uri,
        # refreshed from every announce response (the serving
        # coordinator echoes itself + its standbys), rotated through
        # when a full announce round fails — this is how a worker finds
        # the promoted standby after the primary dies without a goodbye
        self.coordinators = [coordinator_uri]
        self._coord_lock = threading.Lock()
        # terminal task reports the coordinator couldn't take (dead or
        # mid-failover); re-delivered after the next successful announce
        self._pending_reports: deque = deque(maxlen=256)
        self.state = "ACTIVE"
        self.drain_timeout_s = drain_timeout_s
        # bounded wait for FINISHED tasks' unpulled output buffers
        # before DRAINED: consumers normally drain within this; buffers
        # abandoned by failed/hedge-lost queries must not hold the
        # drain hostage (they stay pullable until the process stops)
        self.flush_grace_s = flush_grace_s
        self.fail_status = False
        self.fail_tasks = False          # inject: task creation fails
        self.fail_results = False        # inject: result fetch fails
        self.started_at = time.time()
        # joining-worker prewarm handshake (exec/prewarm.py): with
        # TRINO_TPU_PREWARM set, the announcer thread first pulls the
        # coordinator's warm-manifest and compiles the canonical shape
        # lattice, so the node is warm BEFORE its first ACTIVE announce
        # puts it in the scheduler's placement set
        from ..exec.prewarm import prewarm_enabled_by_env
        self.prewarm_enabled = prewarm_enabled_by_env()
        self.prewarm = None              # PrewarmEngine after handshake
        self.prewarm_manifest: Optional[dict] = None
        from ..catalog import default_catalog
        from .tasks import TaskManager
        self.catalog = catalog if catalog is not None else default_catalog()
        self.task_manager = TaskManager(self.catalog, node_id=node_id,
                                        device=device)
        self.task_manager.on_terminal = self._task_terminal
        handler = type("BoundWorkerHandler", (_WorkerHandler,),
                       {"worker": self})
        from .coordinator import ClusterHTTPServer
        self.httpd = ClusterHTTPServer(("127.0.0.1", port), handler)
        self.port = self.httpd.server_address[1]
        self.uri = f"http://127.0.0.1:{self.port}"
        self.announce_interval_s = announce_interval_s
        self._stop = threading.Event()
        self._state_lock = threading.Lock()
        self._drain_thread: Optional[threading.Thread] = None
        self._drain_cancel = threading.Event()
        self._threads = []
        # per-node flight recorder; interval<=0 (the default) records
        # only on demand and spawns no sampler thread
        from .telemetry import FlightRecorder
        self.telemetry = FlightRecorder(node_id,
                                        interval_s=telemetry_interval_s)
        # live-stats heartbeat (round-21): when set, every announce
        # piggybacks delta-encoded live task stats + a pool snapshot and
        # the announce loop ticks at min(announce, heartbeat) interval.
        # Unset (the default): NO extra thread, the announce body stays
        # byte-identical to the heartbeat-less wire form, and terminal
        # task status is untouched — the telemetry zero-overhead
        # contract applied to the task-status path.
        self.heartbeat_interval_s = heartbeat_interval_s
        self._live_cursor = 0             # last DELIVERED change seq
        self._busy_prev = None            # (monotonic, busy_ms) sample
        # orphan-reaper failover fence (round-22): the announce loop
        # only reaps after a successful announce to a PRIMARY
        # coordinator, and not until this monotonic stamp passes. A
        # failed announce round, a coordinator rotation, or an answer
        # from a still-RECONCILING promotee all push the fence forward —
        # a promoted standby reattaching to this worker's live tasks
        # must never find them reaped out from under it.
        self.reap_fence_s = 30.0
        self._reap_fence_until = 0.0
        self._last_announce_role = "PRIMARY"

    def start(self) -> "WorkerServer":
        t1 = threading.Thread(target=self.httpd.serve_forever,
                              name=f"worker-{self.node_id}", daemon=True)
        t1.start()
        t2 = threading.Thread(target=self._announce_loop,
                              name=f"announcer-{self.node_id}", daemon=True)
        t2.start()
        self._threads = [t1, t2]
        self.telemetry.start()
        return self

    def announce_once(self, attempts: int = 5,
                      state: Optional[str] = None) -> None:
        """Announce to the coordinator, retrying transient failures with
        backoff + decorrelated jitter — a worker that boots before the
        coordinator (or across a coordinator restart) must not fail its
        announcement permanently on one refused connection. The announce
        body carries the lifecycle state so membership transitions reach
        the coordinator without waiting for a heartbeat round trip."""
        from .retrypolicy import RetryPolicy

        # heartbeat piggyback (round-21): computed ONCE per announce so
        # retries re-ship the same delta; the cursor commits only after
        # the announce lands, so a failed round loses nothing
        hb_cursor = hb = None
        if self.heartbeat_interval_s is not None:
            hb_cursor, hb = self._heartbeat_payload()

        def post():
            from .security import internal_headers
            # "now" lets the coordinator estimate this node's clock
            # offset (announce RTT is sub-ms in-process, so the send
            # stamp ~= receive time on a synchronized clock); the task
            # inventory lets a freshly-promoted coordinator reconcile
            # ledger-assigned work against what actually survived here
            doc = {"nodeId": self.node_id,
                   "uri": self.uri,
                   "state": state or self.state,
                   "now": time.time(),
                   "tasks": self.task_manager.inventory()}
            if hb is not None:
                doc["liveStats"] = hb
                # pool snapshot between failure-detector pings: shrinks
                # the memory manager's staleness window
                doc["memory"] = self.task_manager.memory_info()
            body = json.dumps(doc).encode()
            # a refused connection means nothing listens at that address
            # any more (a killed primary): try the next address of the
            # failover list at once instead of spending the retries on
            # it, so a promoting standby sees this worker within one
            # announce round
            for _ in range(max(1, len(self.coordinators))):
                uri = self.coordinator_uri
                req = Request(f"{uri}/v1/announce", data=body,
                              headers={"Content-Type": "application/json",
                                       **internal_headers()})
                try:
                    with urlopen(req, timeout=5) as r:
                        try:
                            resp = json.loads(r.read().decode())
                        except ValueError:
                            resp = {}
                    break
                except OSError as e:
                    if not _refused(e):
                        raise
                    self._reap_fence_until = \
                        time.monotonic() + self.reap_fence_s
                    self._rotate_coordinator()
                    if self.coordinator_uri == uri:
                        raise
            else:
                raise ConnectionRefusedError(
                    "every coordinator address refused the announce")
            self._adopt_coordinators(resp.get("coordinators"))
            self._last_announce_role = resp.get("role", "PRIMARY")

        RetryPolicy(base_delay_s=0.1, max_delay_s=1.0,
                    max_attempts=max(1, attempts),
                    name="announce").call(
            post, retry_on=(OSError,),
            sleep=lambda d: self._stop.wait(d))
        if hb_cursor is not None:
            self._live_cursor = hb_cursor
        # the announce landed, so the coordinator at this address is
        # alive: drain any terminal reports it (or its dead predecessor)
        # missed
        self._flush_reports()

    def _heartbeat_payload(self) -> tuple:
        """(cursor, payload): delta-encoded live task stats — only
        tasks whose change sequence moved past the last DELIVERED
        cursor ship, with absolute counter values so folds are
        idempotent — plus this node's per-interval device/host busy
        fractions (sampled into the node_busy_fraction gauges so the
        flight recorder picks them up)."""
        from ..metrics import (LIVE_STATS_BYTES, NODE_BUSY_FRACTION,
                               NODE_BUSY_MS, TASK_HEARTBEATS)
        cursor, entries = self.task_manager.live_delta(self._live_cursor)
        now = time.monotonic()
        busy = self.task_manager.busy_ms()
        util = {}
        if self._busy_prev is not None:
            prev_t, prev_busy = self._busy_prev
            wall_ms = max(1e-9, (now - prev_t) * 1000)
            for tier, key in (("device", "deviceMs"), ("host", "hostMs")):
                delta = max(0.0, busy[key] - prev_busy[key])
                frac = min(1.0, delta / wall_ms)
                util[tier] = round(frac, 4)
                NODE_BUSY_FRACTION.set(round(frac, 4), tier=tier)
                # cumulative form: a delta-encoding scraper (the flight
                # recorder) turns this into per-interval busy time,
                # which survives several in-process workers sharing one
                # registry where the instantaneous gauge is last-writer-
                # wins
                if delta:
                    NODE_BUSY_MS.inc(delta, tier=tier)
        self._busy_prev = (now, busy)
        payload = {"seq": cursor, "tasks": entries, "busy": busy,
                   "utilization": util}
        TASK_HEARTBEATS.inc()
        LIVE_STATS_BYTES.inc(
            len(json.dumps(payload, separators=(",", ":"))))
        return cursor, payload

    def _adopt_coordinators(self, uris) -> None:
        """Refresh the failover address list from an announce response
        (serving coordinator first, standbys after). The current target
        is kept while still listed so the worker doesn't flap between
        equally-healthy addresses."""
        if not uris:
            return
        with self._coord_lock:
            self.coordinators = list(dict.fromkeys(uris))
            if self.coordinator_uri not in self.coordinators:
                self.coordinator_uri = self.coordinators[0]

    def _rotate_coordinator(self) -> None:
        """Point announces at the next address after a failed round."""
        with self._coord_lock:
            if len(self.coordinators) < 2:
                return
            try:
                i = self.coordinators.index(self.coordinator_uri)
            except ValueError:
                i = -1
            self.coordinator_uri = self.coordinators[
                (i + 1) % len(self.coordinators)]

    # -- terminal-status delivery ------------------------------------------

    def _task_terminal(self, task) -> None:
        """Push a task's final report the moment it completes. An
        undeliverable report — coordinator dead or mid-failover — is
        buffered and re-delivered after the next successful announce
        instead of dropped, so a promoted coordinator hears about work
        that finished while nobody was listening."""
        report = self.task_manager.status_json(task)
        if not self._post_report(report):
            self._pending_reports.append(report)

    def _post_report(self, report: dict) -> bool:
        from .security import internal_headers
        body = json.dumps(report).encode()
        req = Request(f"{self.coordinator_uri}/v1/task-status", data=body,
                      headers={"Content-Type": "application/json",
                               **internal_headers()})
        try:
            with urlopen(req, timeout=5):
                pass
            return True
        except Exception:  # noqa: BLE001 — buffered for re-delivery
            return False

    def _flush_reports(self) -> None:
        while self._pending_reports:
            report = self._pending_reports.popleft()
            if not self._post_report(report):
                self._pending_reports.appendleft(report)
                return

    def prewarm_handshake(self) -> bool:
        """Pull the coordinator's warm-manifest and compile the
        canonical shape lattice before this node announces ACTIVE.
        Best-effort: a missing/denied manifest must never keep a worker
        out of the cluster."""
        from ..exec.prewarm import PrewarmEngine
        from .security import internal_headers
        try:
            req = Request(f"{self.coordinator_uri}/v1/prewarm",
                          headers=internal_headers())
            with urlopen(req, timeout=5) as r:
                manifest = json.loads(r.read().decode())
        except Exception:     # noqa: BLE001 — handshake is best-effort
            return False
        self.prewarm_manifest = manifest
        if self.prewarm is None:
            self.prewarm = PrewarmEngine(enabled=True)
        shapes = [int(c) for c in manifest.get("shapes", ())]
        self.prewarm.warm_shapes(shapes)
        return True

    def _announce_loop(self) -> None:
        if self.prewarm_enabled:
            try:
                self.prewarm_handshake()
            except Exception:
                pass                      # warm-up is best-effort
        while not self._stop.is_set():
            try:
                self.announce_once()
                now = time.monotonic()
                if self._last_announce_role != "PRIMARY":
                    # mid-failover: the promotee is still reconciling
                    # our inventory against its replayed ledger
                    self._reap_fence_until = now + self.reap_fence_s
                elif now >= self._reap_fence_until:
                    try:
                        self.task_manager.reap_orphans()
                    except Exception:  # noqa: BLE001 — reap best-effort
                        pass
            except Exception:
                # coordinator down: rotate to the next address in the
                # failover list for the following round and keep trying;
                # fence the reaper — the silence may be a failover, and
                # the promotee must find our tasks intact
                self._reap_fence_until = \
                    time.monotonic() + self.reap_fence_s
                self._rotate_coordinator()
            interval = self.announce_interval_s
            if self.heartbeat_interval_s is not None:
                # heartbeats ride the announcer thread (no new thread):
                # tick at the faster of the two cadences
                interval = min(interval, self.heartbeat_interval_s)
            self._stop.wait(interval)

    # -- lifecycle state machine -------------------------------------------

    def _transition(self, new_state: str) -> bool:
        """ACTIVE -> DRAINING -> DRAINED -> LEFT (DRAINING may revert to
        ACTIVE when an admin cancels the drain). Invalid edges no-op."""
        allowed = {"ACTIVE": ("DRAINING",),
                   "DRAINING": ("DRAINED", "ACTIVE"),
                   "DRAINED": ("LEFT",),
                   "LEFT": ()}
        with self._state_lock:
            if new_state not in allowed.get(self.state, ()):
                return False
            self.state = new_state
        from ..metrics import NODE_LIFECYCLE_TRANSITIONS
        NODE_LIFECYCLE_TRANSITIONS.inc(state=new_state)
        return True

    def request_drain(self) -> bool:
        """Start the graceful-drain sequence asynchronously: stop
        accepting task POSTs now (state flips before this returns),
        finish/flush in flight, then deregister."""
        if not self._transition("DRAINING"):
            return self.state in ("DRAINING", "DRAINED", "LEFT")
        self._drain_cancel.clear()
        self._drain_thread = threading.Thread(
            target=self._drain_sequence, name=f"drain-{self.node_id}",
            daemon=True)
        self._drain_thread.start()
        return True

    def cancel_drain(self) -> bool:
        """Abort a DRAINING worker back to ACTIVE (no-op once DRAINED:
        the handoff already happened, rejoining takes a fresh announce
        anyway — which `_transition` forbids to keep the ratchet
        one-way per drain request)."""
        self._drain_cancel.set()
        if self._transition("ACTIVE"):
            self._announce_now()
            return True
        return False

    def _announce_now(self, state: Optional[str] = None) -> None:
        try:
            self.announce_once(attempts=2, state=state)
        except Exception:     # noqa: BLE001 — coordinator may be gone
            pass

    def _drain_sequence(self) -> None:
        """The drain body: announce DRAINING immediately, finish every
        in-flight task (bounded by drain_timeout_s), give finished
        tasks' output buffers a flush grace for downstream consumers to
        pull, then DRAINED, then the deregistering LEFT announce.
        Anything the deadline cuts off re-runs on survivors via the
        scheduler's retry machinery (durable-spool dedup keeps that
        bit-exact); buffers stay pullable even after LEFT, until the
        process actually stops — hedge losers and failed queries
        abandon FINISHED buffers nobody will ever pull, so the flush
        wait is a grace period, not a completion requirement."""
        self._announce_now()
        deadline = time.monotonic() + self.drain_timeout_s
        while self.task_manager.inflight() and \
                time.monotonic() < deadline and \
                not self._drain_cancel.is_set():
            time.sleep(0.02)
        flush_deadline = min(deadline,
                             time.monotonic() + self.flush_grace_s)
        while self.task_manager.unflushed() and \
                time.monotonic() < flush_deadline and \
                not self._drain_cancel.is_set():
            time.sleep(0.02)
        if self._drain_cancel.is_set():
            return                        # admin reverted to ACTIVE
        if self._transition("DRAINED"):
            self._announce_now()
        if self._transition("LEFT"):
            self._announce_now()

    def drained(self) -> bool:
        """True once the drain sequence fully quiesced (no in-flight
        tasks, no unflushed buffers) and the worker deregistered."""
        return self.state == "LEFT"

    def stop(self, graceful: bool = True,
             timeout_s: Optional[float] = None) -> None:
        """Graceful by default: run the same bounded drain an admin
        `PUT /v1/info/state` triggers (SIGTERM in the soak harness is
        indistinguishable from an admin drain), then shut the HTTP
        server down. `graceful=False` is the hard-crash path tests use
        to simulate worker death."""
        if graceful and self.state == "ACTIVE":
            budget = self.drain_timeout_s if timeout_s is None \
                else timeout_s
            if self.request_drain():
                deadline = time.monotonic() + budget
                while self.state != "LEFT" and \
                        time.monotonic() < deadline:
                    time.sleep(0.02)
        self.telemetry.stop()
        self._stop.set()
        # shutdown() handshakes with serve_forever — skip it when
        # start() was never called or it would block forever
        if self._threads:
            self.httpd.shutdown()
        self.httpd.server_close()

    def kill(self) -> None:
        """Ungraceful death (no drain, no deregister) — the crash the
        failure detector and retry machinery exist for."""
        self.stop(graceful=False)
