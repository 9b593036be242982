"""Port copy of ``trino_tpu/server/resourcegroups.py`` (no edits).

Hierarchical resource groups — admission control.

Reference: execution/resourcegroups/InternalResourceGroup.java:76 —
groups form a tree; each group has a hard concurrency limit and a queue
bound; selectors route queries to groups by user; FIFO within a group.
Config is pluggable in the reference (file/DB managers,
plugin/trino-resource-group-managers) — here a plain dataclass tree.

Round-9 growth — memory-aware admission + queue-wait accounting:

- `soft_memory_limit_bytes` (InternalResourceGroup.softMemoryLimitBytes):
  while a group's observed memory usage exceeds its soft limit, queued
  queries STAY queued (admission gates on bytes, not just concurrency).
  The ClusterMemoryManager publishes the cluster's reserved+revocable
  total each tick via `set_cluster_memory`, which also drains any queues
  that became runnable as memory dropped.
- queue-wait accounting: every queued entry records its enqueue time;
  admission (via `finished` or the memory tick) folds the wait into the
  group's stats, exposed in info() and system.runtime.resource_groups —
  the old code admitted queued queries without ever recording how long
  they waited.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class QueryQueueFullError(RuntimeError):
    """Admission rejected past the queue bound. Retryable by design:
    the query never started, so a client backing off and resubmitting
    is always safe — overload degrades to fast rejection, not collapse."""
    error_name = "QUERY_QUEUE_FULL"
    error_code = 5
    retryable = True


class QueryQueuedTimeExceededError(RuntimeError):
    """query_max_queued_time_s expired while the query was still
    QUEUED. Retryable like the queue-full rejection — nothing executed,
    the cluster was simply too busy to start it in time."""
    error_name = "QUERY_EXCEEDED_QUEUED_TIME"
    error_code = 6
    retryable = True


@dataclass
class ResourceGroupConfig:
    name: str
    hard_concurrency_limit: int = 4
    max_queued: int = 100
    # memory-aware admission: while the group's observed usage exceeds
    # this, queued queries stay queued (None = no memory gate)
    soft_memory_limit_bytes: Optional[int] = None
    sub_groups: tuple = ()


@dataclass
class Selector:
    user_pattern: str             # regex over the session user
    group: str                    # dot path, e.g. "root.adhoc"


class ResourceGroup:
    def __init__(self, config: ResourceGroupConfig,
                 parent: Optional["ResourceGroup"] = None):
        self.config = config
        self.parent = parent
        self.running = 0
        # (run callable, enqueue monotonic time)
        self.queue: deque = deque()
        self.sub_groups: Dict[str, ResourceGroup] = {
            sub.name: ResourceGroup(sub, self)
            for sub in config.sub_groups}
        self.stats_total_admitted = 0
        self.stats_peak_queued = 0
        self.stats_total_queue_wait_s = 0.0
        self.stats_dequeued = 0          # admissions that waited in queue
        self.memory_usage_bytes = 0      # last published observation

    @property
    def path(self) -> str:
        return self.config.name if self.parent is None else \
            f"{self.parent.path}.{self.config.name}"

    def can_run(self) -> bool:
        """A query may start when every group up the chain has headroom
        (the reference's canRunMore walk) — concurrency AND memory."""
        g: Optional[ResourceGroup] = self
        while g is not None:
            if g.running >= g.config.hard_concurrency_limit:
                return False
            soft = g.config.soft_memory_limit_bytes
            if soft is not None and g.memory_usage_bytes > soft:
                return False
            g = g.parent
        return True

    def acquire(self) -> None:
        g: Optional[ResourceGroup] = self
        while g is not None:
            g.running += 1
            g = g.parent
        self.stats_total_admitted += 1

    def release(self) -> None:
        g: Optional[ResourceGroup] = self
        while g is not None:
            g.running = max(0, g.running - 1)
            g = g.parent


def tenant_tree(tenants: Dict[str, dict],
                hard_concurrency_limit: int = 4,
                max_queued: int = 100) -> "ResourceGroupManager":
    """Build a per-tenant manager: one sub-group per tenant under root,
    each with its own concurrency/queue/soft-memory knobs, and a
    selector routing `<tenant>` and `<tenant>-*` principals to it.
    `tenants` maps tenant name -> overrides (any ResourceGroupConfig
    field). The elastic soak uses this shape; production configs build
    the same tree from whatever config source they like."""
    subs = tuple(
        ResourceGroupConfig(
            name,
            hard_concurrency_limit=ov.get("hard_concurrency_limit",
                                          hard_concurrency_limit),
            max_queued=ov.get("max_queued", max_queued),
            soft_memory_limit_bytes=ov.get("soft_memory_limit_bytes"))
        for name, ov in tenants.items())
    selectors = [Selector(rf"{re.escape(name)}(-.*)?", f"root.{name}")
                 for name in tenants]
    root = ResourceGroupConfig(
        "root",
        hard_concurrency_limit=max(
            hard_concurrency_limit,
            sum(s.hard_concurrency_limit for s in subs)),
        sub_groups=subs)
    return ResourceGroupManager(root, selectors)


class ResourceGroupManager:
    """Routes queries to leaf groups and gates execution: run now, queue,
    or reject (Too many queued queries)."""

    def __init__(self, root: ResourceGroupConfig,
                 selectors: Optional[List[Selector]] = None):
        self.root = ResourceGroup(root)
        self.selectors = selectors or []
        self._lock = threading.Lock()

    def _find(self, path: str) -> ResourceGroup:
        parts = path.split(".")
        g = self.root
        assert parts[0] == self.root.config.name, path
        for p in parts[1:]:
            g = g.sub_groups[p]
        return g

    def _groups(self):
        out = []

        def walk(g: ResourceGroup):
            out.append(g)
            for sub in g.sub_groups.values():
                walk(sub)
        walk(self.root)
        return out

    def select(self, user: str) -> ResourceGroup:
        for sel in self.selectors:
            if re.fullmatch(sel.user_pattern, user):
                return self._find(sel.group)
        return self.root

    def tenant_of(self, user: str) -> str:
        """The principal's tenant label: the leaf name of its selected
        group ('default' for unselected users landing on root). Labels
        per-tenant metrics, history records, and audit events."""
        group = self.select(user)
        return "default" if group is self.root \
            else group.config.name

    def submit(self, user: str, run: Callable[[], None],
               is_dead: Optional[Callable[[], bool]] = None) -> str:
        """Admit or queue `run`; returns the chosen group path. Raises
        QueryQueueFullError past the queue bound. `is_dead` (optional)
        lets admission skip entries that died while QUEUED (queued-time
        deadline, user cancel) instead of running a terminal query."""
        with self._lock:
            group = self.select(user)
            self._prune_dead_locked(group)
            if group.can_run():
                group.acquire()
                to_run = run
            elif len(group.queue) < group.config.max_queued:
                group.queue.append((run, time.monotonic(), is_dead))
                group.stats_peak_queued = max(group.stats_peak_queued,
                                              len(group.queue))
                return group.path
            else:
                raise QueryQueueFullError(
                    f"Too many queued queries for {group.path!r}")
        to_run()
        return group.path

    @staticmethod
    def _prune_dead_locked(group: ResourceGroup) -> None:
        """Drop queue entries whose query reached a terminal state while
        waiting — their slot frees immediately, so a wave of expired/
        canceled queued queries cannot wedge admission."""
        if any(dead is not None and dead() for _, _, dead in group.queue):
            group.queue = deque(e for e in group.queue
                                if e[2] is None or not e[2]())

    def _pop_runnable_locked(self, group: ResourceGroup) \
            -> Optional[Callable[[], None]]:
        """Admit the group's next queued query if it can run now,
        recording its queue wait (the accounting `finished()` used to
        skip entirely)."""
        self._prune_dead_locked(group)
        if group.queue and group.can_run():
            run, t0, _dead = group.queue.popleft()
            group.acquire()
            group.stats_total_queue_wait_s += time.monotonic() - t0
            group.stats_dequeued += 1
            return run
        return None

    def prune_dead(self) -> None:
        """Sweep every group's queue for dead entries (the coordinator's
        deadline enforcer calls this after failing queued queries)."""
        with self._lock:
            for g in self._groups():
                self._prune_dead_locked(g)

    def total_queued(self) -> int:
        """Cluster-wide queued-query count — the load-shed gate's queue-
        depth signal."""
        with self._lock:
            return sum(len(g.queue) for g in self._groups())

    def finished(self, group_path: str) -> Optional[Callable[[], None]]:
        """Release a slot; returns the next queued query to start (the
        caller runs it outside the lock), if any."""
        with self._lock:
            group = self._find(group_path)
            group.release()
            return self._pop_runnable_locked(group)

    def set_cluster_memory(self, total_bytes: int) \
            -> List[Callable[[], None]]:
        """Publish the cluster's observed memory usage to every group
        and return any queued queries that became admittable (memory
        dropped below a soft limit). The caller runs them outside the
        lock. Group-level attribution collapses to the cluster total —
        one engine session per coordinator means every group observes
        the same pressure (the reference attributes per-group via
        per-query contexts; the ledger tags exist for that refinement)."""
        runnable: List[Callable[[], None]] = []
        with self._lock:
            groups = self._groups()
            for g in groups:
                g.memory_usage_bytes = total_bytes
            for g in groups:
                while True:
                    run = self._pop_runnable_locked(g)
                    if run is None:
                        break
                    runnable.append(run)
        return runnable

    def info(self) -> List[dict]:
        with self._lock:
            groups = self._groups()
            out = []
            for g in groups:
                waited = g.stats_dequeued
                out.append({
                    "group": g.path, "running": g.running,
                    "queued": len(g.queue),
                    "hardConcurrencyLimit":
                        g.config.hard_concurrency_limit,
                    "totalAdmitted": g.stats_total_admitted,
                    "softMemoryLimitBytes":
                        g.config.soft_memory_limit_bytes,
                    "memoryUsageBytes": g.memory_usage_bytes,
                    "totalQueueWaitSeconds":
                        round(g.stats_total_queue_wait_s, 6),
                    "avgQueueWaitSeconds":
                        round(g.stats_total_queue_wait_s / waited, 6)
                        if waited else 0.0,
                    "peakQueued": g.stats_peak_queued})
        return out
