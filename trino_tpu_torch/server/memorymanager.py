"""Port copy of ``trino_tpu/server/memorymanager.py`` (no edits).

Cluster memory arbitration: pooled accounting + the low-memory killer.

Reference: memory/ClusterMemoryManager.java:96 — the coordinator sums
every node's reported pool reservations, triggers memory revocation
(spill) when the cluster crosses its limit, and as the last resort runs a
LowMemoryKiller. The policy here is TotalReservationLowMemoryKiller.java's
total-reservation-dominant choice: kill the single query holding the most
reserved bytes, never a worker process.

TPU shape: every worker's /v1/status heartbeat carries its executor
pool's snapshot (reserved/revocable/limit/peak); the failure detector
records it on the node inventory as it pings. The manager's tick then:

1. sums cluster reserved + revocable bytes (workers + the coordinator's
   own session executor) and publishes them to the resource-group tree
   (memory-aware admission: groups above their soft_memory_limit_bytes
   keep their queued queries queued);
2. above the cluster limit, requests REVOCATION first — spillable
   holders (build caches, partial-aggregation state) move bytes to host;
3. if pressure persists for `kill_after_ticks` consecutive ticks, kills
   the dominant query: a MemoryKilledError is injected at the executor's
   next plan-node boundary and the state machine records a dedicated
   user-facing QUERY_EXCEEDED_MEMORY error — the query dies, the worker
   never does.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

log = logging.getLogger("trino_tpu.memory")


class ClusterMemoryManager:
    def __init__(self, state, cluster_limit_bytes: Optional[int] = None,
                 interval_s: float = 0.5, kill_after_ticks: int = 2):
        self.state = state                    # CoordinatorState
        self.cluster_limit_bytes = cluster_limit_bytes
        self.interval_s = interval_s
        self.kill_after_ticks = kill_after_ticks
        self.queries_killed = 0
        self.revocations = 0
        # elastic membership: announce() calls on_membership_change()
        # whenever a node joins/drains/leaves so arbitration re-runs
        # against the new node set immediately instead of waiting out
        # the polling interval
        self.membership_rearbitrations = 0
        self._membership_sig: tuple = ()
        self._pressure_ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_snapshot: Dict[str, dict] = {}
        state.memory_manager = self

    # -- accounting --------------------------------------------------------

    def _local_pool(self):
        ex = getattr(self.state.session, "executor", None)
        return getattr(ex, "pool", None)

    def snapshot(self) -> dict:
        """Cluster memory view: the coordinator's own pool plus every
        worker's last heartbeat-reported pool."""
        nodes = {}
        pool = self._local_pool()
        if pool is not None:
            nodes["coordinator"] = pool.snapshot()
        with self.state.nodes_lock:
            for n in self.state.nodes.values():
                mem = getattr(n, "memory", None)
                if mem:
                    nodes[n.node_id] = mem
        total_reserved = sum(m.get("reserved", 0) for m in nodes.values())
        total_revocable = sum(m.get("revocable", 0)
                              for m in nodes.values())
        self.last_snapshot = nodes
        return {"nodes": nodes, "reserved": total_reserved,
                "revocable": total_revocable,
                "limit": self.cluster_limit_bytes}

    def _dominant_query(self):
        """The running query holding the most reserved bytes (the
        total-reservation-dominant policy). Attribution comes from the
        pool's per-holder ledger, tagged with query ids by the
        dispatcher; ties (or an empty ledger) fall back to the
        longest-running query, which holds the lock — and therefore the
        bytes — in this serialized-execution runtime."""
        running = [tq for tq in self.state.tracker.all()
                   if not tq.state_machine.is_done()
                   and tq.state == "RUNNING"]
        if not running:
            return None
        pool = self._local_pool()
        held = {tq.query_id: (pool.query_bytes(tq.query_id)
                              if pool is not None else 0)
                for tq in running}
        running.sort(key=lambda tq: (held[tq.query_id],
                                     -tq.state_machine.created_at),
                     reverse=True)
        return running[0]

    # -- arbitration -------------------------------------------------------

    def on_membership_change(self) -> None:
        """Immediate re-arbitration on a membership/lifecycle change
        (worker joined, started draining, or left): the cluster's
        capacity just moved, so the resource-group tree and the
        over-limit check must see the new node set now — a query
        admitted against capacity that left with a drained worker
        would otherwise run straight into the killer."""
        try:
            self.tick()
        except Exception:    # noqa: BLE001 — arbitration must not fail
            pass             # the announce that triggered it

    def on_promotion(self) -> None:
        """Failover re-arbitration: a promoted coordinator inherits no
        heartbeat-reported pool snapshots — every worker's `memory`
        view is stale-from-birth until its first announce lands here.
        Drop inherited per-node reports and re-arbitrate against
        whatever the re-announce wave has delivered so far, so the
        first post-failover admission decision never trusts numbers
        recorded by the dead primary."""
        with self.state.nodes_lock:
            for n in self.state.nodes.values():
                n.memory = None
        self.on_membership_change()

    def _note_membership(self) -> None:
        with self.state.nodes_lock:
            sig = tuple(sorted((n.node_id, n.state)
                               for n in self.state.nodes.values()))
        if sig != self._membership_sig:
            self._membership_sig = sig
            self.membership_rearbitrations += 1

    def tick(self) -> dict:
        self._note_membership()
        snap = self.snapshot()
        total = snap["reserved"] + snap["revocable"]
        # memory-aware admission: the resource-group tree sees the
        # cluster's usage; groups above soft_memory_limit_bytes keep
        # queued queries queued until it drops
        rgm = getattr(self.state.dispatcher, "resource_groups", None)
        if rgm is not None:
            runnable = rgm.set_cluster_memory(total)
            for run in runnable:
                run()
        limit = self.cluster_limit_bytes
        if limit is None or total <= limit:
            self._pressure_ticks = 0
            return snap
        # over the limit: revoke (spill) before killing
        deficit = total - limit
        pool = self._local_pool()
        if pool is not None and snap["revocable"] > 0:
            self.revocations += 1
            pool.request_revocation(deficit)
            snap = self.snapshot()
            if snap["reserved"] + snap["revocable"] <= limit:
                self._pressure_ticks = 0
                return snap
        self._pressure_ticks += 1
        if self._pressure_ticks >= self.kill_after_ticks:
            self._pressure_ticks = 0
            self.kill_dominant(
                f"cluster memory {total} bytes over limit {limit}")
        return snap

    def kill_dominant(self, why: str) -> Optional[str]:
        """Kill the dominant query with a user-facing
        QUERY_EXCEEDED_MEMORY — the Trino guarantee: under pressure a
        QUERY dies, never a worker."""
        tq = self._dominant_query()
        if tq is None:
            return None
        from ..exec.memory import ExceededMemoryLimitError
        msg = (f"Query killed by the cluster low-memory killer: {why} "
               f"(dominant reservation {tq.query_id})")
        # post-mortem context BEFORE the kill lands: snapshot the live
        # progress ratio and dominant stage (server/livestats.py) onto
        # the tracked query so history + QueryCompletedEvent record how
        # far the victim got and where it was when it died
        ls = getattr(self.state, "livestats", None)
        if ls is not None:
            progress = ls.progress(tq.query_id)
            if progress is not None and progress > tq.progress_ratio:
                tq.progress_ratio = progress
            stage = ls.dominant_stage(tq.query_id)
            if stage:
                tq.dominant_stage = stage
        ex = getattr(self.state.session, "executor", None)
        if ex is not None and hasattr(ex, "request_kill"):
            ex.request_kill(msg)      # stops the running plan promptly
        # the dispatcher's single termination path: taxonomy on the
        # state machine, worker task fan-out, cancel-propagation
        # accounting — an OOM kill of a distributed query must free its
        # remote buffers, not just the local plan
        term = getattr(self.state.dispatcher, "terminate", None)
        if term is not None:
            term(tq.query_id, reason="oom", message=msg)
        else:
            tq.state_machine.fail(
                msg, error_name=ExceededMemoryLimitError.error_name,
                error_code=ExceededMemoryLimitError.error_code)
        self.queries_killed += 1
        from ..metrics import QUERIES_KILLED_OOM
        QUERIES_KILLED_OOM.inc()
        from ..utils.log import tq_context
        log.warning("%skilled by the cluster low-memory killer: %s "
                    "(progress %.1f%%, dominant stage %s)",
                    tq_context(tq), why, 100 * tq.progress_ratio,
                    tq.dominant_stage or "?")
        return tq.query_id

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ClusterMemoryManager":
        self._thread = threading.Thread(target=self._loop,
                                        name="memory-manager", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:    # noqa: BLE001 — arbitration must not die
                pass
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
