"""Heartbeat failure detector.

Reference: failuredetector/HeartbeatFailureDetector.java:76 — the
coordinator pings every worker's /v1/status (ping:344) and keeps an
exponentially-decayed failure ratio per node; nodes above the threshold are
excluded from scheduling until they recover (:91, :377).

Port of ``trino_tpu/server/failuredetector.py``, unchanged but for its
imports.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict
from urllib.request import urlopen

from .coordinator import CoordinatorState


class NodeStats:
    """Exponentially-decayed success/failure ratio for one node."""

    def __init__(self, decay: float = 0.8):
        self.decay = decay
        self.failure_ratio = 0.0
        self.last_seen = time.time()

    def record(self, success: bool) -> None:
        sample = 0.0 if success else 1.0
        self.failure_ratio = (self.decay * self.failure_ratio +
                              (1 - self.decay) * sample)
        if success:
            self.last_seen = time.time()


class HeartbeatFailureDetector:
    """Pings announced workers; marks nodes FAILED past the threshold and
    ACTIVE again when the decayed ratio drops back (same hysteresis as the
    reference's failure-detector.threshold, default 0.1)."""

    def __init__(self, state: CoordinatorState,
                 interval_s: float = 0.5, threshold: float = 0.1,
                 timeout_s: float = 2.0):
        self.state = state
        self.interval_s = interval_s
        self.threshold = threshold
        self.timeout_s = timeout_s
        self.stats: Dict[str, NodeStats] = {}
        self.injector = None          # chaos hook (HEARTBEAT_PING)
        self._stop = threading.Event()
        self._thread = None
        # registered on the coordinator state so the scheduler's
        # task-path failures feed the same decayed stats (a node whose
        # executor is wedged but whose /v1/status answers must not flip
        # straight back to ACTIVE) and announce() can consult the
        # hysteresis before resurrecting a FAILED node
        state.failure_detector = self

    def record_failure(self, node_id: str) -> None:
        """Fold a non-heartbeat failure observation (task create/drain
        error seen by the scheduler) into the node's decayed ratio. One
        sample pushes a healthy node past the default threshold, so it
        must then sustain several clean pings before rejoining."""
        self.stats.setdefault(node_id, NodeStats()).record(False)

    def start(self) -> "HeartbeatFailureDetector":
        self._thread = threading.Thread(target=self._loop,
                                        name="failure-detector", daemon=True)
        self._thread.start()
        return self

    def ping_all(self) -> None:
        with self.state.nodes_lock:
            nodes = list(self.state.nodes.values())
        for node in nodes:
            st = self.stats.setdefault(node.node_id, NodeStats())
            ok = False
            memory = None
            device = None
            reported = None
            try:
                if self.injector is not None:
                    # chaos: RAISE/DROP -> failed probe sample; DELAY ->
                    # slow status endpoint (sleeps, then pings normally)
                    self.injector.maybe_fail("HEARTBEAT_PING",
                                             node.node_id)
                with urlopen(f"{node.uri}/v1/status",
                             timeout=self.timeout_s) as resp:
                    ok = resp.status == 200
                    try:
                        # heartbeat payload carries the worker's memory
                        # pool snapshot for cluster arbitration plus its
                        # live device/HBM allocator stats
                        payload = json.loads(resp.read().decode())
                        memory = payload.get("memory")
                        device = payload.get("device")
                        reported = payload.get("state")
                    except Exception:    # noqa: BLE001 — old workers
                        memory = None
            except Exception:
                ok = False
            st.record(ok)
            with self.state.nodes_lock:
                live = self.state.nodes.get(node.node_id)
                if live is None:
                    continue
                if ok and memory is not None:
                    live.memory = memory
                if ok and device is not None:
                    live.device = device
                if st.failure_ratio > self.threshold:
                    # an unreachable node is FAILED even mid-drain: the
                    # crash path (retry machinery) takes over from the
                    # graceful one
                    live.state = "FAILED"
                elif ok and reported in ("DRAINING", "DRAINED"):
                    # lifecycle propagation: a healthy draining worker
                    # leaves placement/hedging without a detector penalty
                    live.state = reported
                elif live.state == "FAILED":
                    live.state = "ACTIVE"
                elif ok and reported == "ACTIVE" and \
                        live.state in ("DRAINING", "DRAINED"):
                    live.state = "ACTIVE"    # drain canceled

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.ping_all()
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


class StandbyWatcher:
    """Standby-coordinator side of failover: the warm loop that (a)
    announces the standby to the primary with state=STANDBY so every
    announce response carries the failover address list, (b) tails the
    ledger to keep a warm replay view, and (c) counts consecutive
    probe failures against the primary — `fail_after` misses in a row
    is the detector-driven promotion trigger (`promote(reason=
    "detector")`). Admin promotion via PUT /v1/info/state works whether
    or not this watcher is running."""

    def __init__(self, state: CoordinatorState, own_uri: str,
                 primary_uri: str, interval_s: float = 0.25,
                 fail_after: int = 3, auto_promote: bool = True):
        self.state = state
        self.own_uri = own_uri
        self.primary_uri = primary_uri
        self.interval_s = interval_s
        self.fail_after = fail_after
        self.auto_promote = auto_promote
        self.failures = 0
        self.records_seen = 0
        self._tail_off = 0
        self._stop = threading.Event()
        self._thread = None

    def start(self) -> "StandbyWatcher":
        self._thread = threading.Thread(target=self._loop,
                                        name="standby-watcher",
                                        daemon=True)
        self._thread.start()
        return self

    def probe_once(self) -> bool:
        """One announce-as-probe round trip to the primary."""
        from urllib.request import Request
        from .security import internal_headers
        body = json.dumps({"nodeId": self.state.node_id,
                           "uri": self.own_uri, "state": "STANDBY",
                           "now": time.time()}).encode()
        req = Request(f"{self.primary_uri}/v1/announce", data=body,
                      headers={"Content-Type": "application/json",
                               **internal_headers()}, method="POST")
        try:
            with urlopen(req, timeout=2.0):
                pass
            return True
        except Exception:  # noqa: BLE001 — any probe error is a miss
            return False

    def tail_ledger(self) -> None:
        """Consume newly-durable ledger records so promotion starts
        from a warm view (the full replay at promote() is idempotent
        on top of this — the tail is a latency optimization and a
        liveness signal, never a correctness dependency)."""
        led = self.state.ledger
        if led is None:
            return
        recs, self._tail_off = led.tail_records(self._tail_off)
        self.records_seen += len(recs)

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self.state.role == "PRIMARY":
                return                      # promoted out from under us
            if self.probe_once():
                self.failures = 0
            else:
                self.failures += 1
            self.tail_ledger()
            if self.auto_promote and self.failures >= self.fail_after:
                self.state.promote(reason="detector")
                return
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
