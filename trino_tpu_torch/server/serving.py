"""High-concurrency serving layer: plan cache, result cache,
cost-based host/device routing, micro-batched point-query dispatch.

Port of ``trino_tpu/server/serving.py`` (the same code over the port's
router and Session). Four cooperating parts:

1. **Plan cache**: LRU + byte-capped map from the normalized-SQL plan
   fingerprint (server/history.py plan_fingerprint) to the planned +
   pruned logical tree, so repeated statements skip parse/plan. Keyed
   also by the session-property digest and the catalog version (DDL
   invalidates). Served as ``system.runtime.plan_cache``.

2. **Result cache**: FINISHED query pages keyed the same way, stamped
   with the catalog version observed at execution start; any DDL/write
   bumps the counter and stale entries count as invalidations. Opt-in
   via ``enable_result_cache``; plans that scan volatile catalogs
   (system / information_schema) are never cached.

3. **Cost router** (exec/router.py): small/point queries execute on the
   host numpy path WITHOUT the coordinator's device exec lock;
   scan-heavy plans run on the session's device (the card) under it,
   through ``Session.execute_planned``.

4. **Micro-batcher**: concurrent point queries that share a plan shape
   and differ only in one equality literal gather behind a short window
   and execute as ONE dispatch (``k = ?`` -> ``k IN (...)`` with the
   key column appended), then demultiplex to their clients. The merged
   plan routes like any other.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from ..exec.router import (HostUnsupported, TenantFairShare, decide_route,
                           run_host)
from ..planner import logical as L
from ..planner.optimizer import prune_plan
from ..sql import ast_nodes as A
from ..sql.parser import parse
from ..utils.log import tq_context
from .history import plan_fingerprint

log = logging.getLogger("trino_tpu.serving")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _subtree_nodes(node):
    yield node
    for c in L.children(node):
        yield from _subtree_nodes(c)


def _plan_scans(root):
    """Every ScanNode reachable from the plan, INCLUDING subplans
    embedded in expressions (scalar/IN subqueries) — the result cache's
    volatility check must see through them."""
    from .. import ir
    todo = [root]
    while todo:
        node = todo.pop()
        for n in _subtree_nodes(node):
            if isinstance(n, L.ScanNode):
                yield n
            for e in _node_exprs(n):
                for sub in ir.walk(e):
                    plan = getattr(sub, "plan", None)
                    if isinstance(plan, L.PlanNode):
                        todo.append(plan)


def _node_exprs(node):
    if isinstance(node, L.FilterNode):
        return (node.predicate,)
    if isinstance(node, L.ProjectNode):
        return node.exprs
    if isinstance(node, L.AggregateNode):
        return tuple(a.arg for a in node.aggs if a.arg is not None)
    return ()


def _plan_weight(root, sql: str) -> int:
    """Rough retained-bytes estimate for the byte cap (node count drives
    the tree size; the SQL text rides along for the system table)."""
    return sum(1 for _ in _subtree_nodes(root)) * 512 + 2 * len(sql)


def _result_weight(rows) -> int:
    if not rows:
        return 64
    sample = rows[:64]
    per = sum(sum(len(v) if isinstance(v, str) else 16 for v in r) + 48
              for r in sample) / len(sample)
    return int(per * len(rows)) + 64


# --------------------------------------------------------------------------
# plan cache
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PlanEntry:
    sql: str
    fingerprint: str
    stmt: object                       # parsed AST (Query/SetOp/Values)
    rel: object                        # PlannedRelation (decode scope)
    root: object                       # pruned L.OutputNode
    cacheable: bool                    # result-cache eligible
    point_shape: Optional[tuple]       # (shape_key, key_ident, lit_text)
    catalog_version: int = 0           # version the plan was built at
    weight: int = 0
    hits: int = 0
    created_at: float = 0.0


class PlanCache:
    """LRU + byte-capped logical-plan cache keyed by (fingerprint,
    session-property digest, catalog version)."""

    def __init__(self, max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self.max_entries = max_entries if max_entries is not None else \
            _env_int("TRINO_TPU_PLAN_CACHE_ENTRIES", 512)
        self.max_bytes = max_bytes if max_bytes is not None else \
            _env_int("TRINO_TPU_PLAN_CACHE_BYTES", 64 << 20)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, PlanEntry]" = OrderedDict()
        self._bytes = 0

    def get(self, key: tuple) -> Optional[PlanEntry]:
        from ..metrics import PLAN_CACHE_HITS, PLAN_CACHE_MISSES
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                PLAN_CACHE_MISSES.inc()
                return None
            self._entries.move_to_end(key)
            entry.hits += 1
        PLAN_CACHE_HITS.inc()
        return entry

    def put(self, key: tuple, entry: PlanEntry) -> None:
        from ..metrics import PLAN_CACHE_EVICTIONS
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.weight
            self._entries[key] = entry
            self._bytes += entry.weight
            while self._entries and (
                    len(self._entries) > self.max_entries or
                    self._bytes > self.max_bytes):
                if len(self._entries) == 1:
                    break              # never evict the sole entry
                _, dropped = self._entries.popitem(last=False)
                self._bytes -= dropped.weight
                evicted += 1
        if evicted:
            PLAN_CACHE_EVICTIONS.inc(evicted)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [{"fingerprint": e.fingerprint,
                     "sql": e.sql[:120],
                     "hits": e.hits,
                     "weight_bytes": e.weight,
                     "point_shape": e.point_shape is not None,
                     "cacheable": e.cacheable,
                     "created_at": e.created_at}
                    for e in self._entries.values()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# --------------------------------------------------------------------------
# result cache
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _ResultEntry:
    names: list
    rows: list
    catalog_version: int
    weight: int
    hits: int = 0


class ResultCache:
    """FINISHED-page cache with catalog-version invalidation. Entries
    are immutable snapshots; readers share the row list (the protocol
    layer never mutates results)."""

    def __init__(self, max_bytes: Optional[int] = None,
                 max_entry_bytes: Optional[int] = None):
        self.max_bytes = max_bytes if max_bytes is not None else \
            _env_int("TRINO_TPU_RESULT_CACHE_BYTES", 128 << 20)
        self.max_entry_bytes = max_entry_bytes if max_entry_bytes \
            is not None else _env_int(
                "TRINO_TPU_RESULT_CACHE_ENTRY_BYTES", 8 << 20)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _ResultEntry]" = OrderedDict()
        self._bytes = 0

    def get(self, key: tuple, catalog_version: int):
        from ..metrics import (RESULT_CACHE_HITS,
                               RESULT_CACHE_INVALIDATIONS,
                               RESULT_CACHE_MISSES)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and \
                    entry.catalog_version != catalog_version:
                # a DDL/write bumped the monotonic counter since this
                # page finished: the entry is unservable, drop it
                self._entries.pop(key)
                self._bytes -= entry.weight
                entry = None
                RESULT_CACHE_INVALIDATIONS.inc()
            if entry is None:
                RESULT_CACHE_MISSES.inc()
                return None
            self._entries.move_to_end(key)
            entry.hits += 1
        RESULT_CACHE_HITS.inc()
        return entry

    def put(self, key: tuple, names, rows, catalog_version: int) -> None:
        weight = _result_weight(rows)
        if weight > self.max_entry_bytes:
            return                     # oversized pages never cache
        entry = _ResultEntry(list(names), rows, catalog_version, weight)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.weight
            self._entries[key] = entry
            self._bytes += weight
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, dropped = self._entries.popitem(last=False)
                self._bytes -= dropped.weight

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# --------------------------------------------------------------------------
# point-shape detection + micro-batching
# --------------------------------------------------------------------------

_INT_LIT = re.compile(r"-?\d+$")

_FORBIDDEN_AST = (A.FunctionCall, A.WindowFunc, A.ScalarSubquery,
                  A.InSubquery, A.ExistsPredicate, A.Query)


def _ast_walk(node):
    yield node
    if dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            items = v if isinstance(v, tuple) else (v,)
            for it in items:
                if dataclasses.is_dataclass(it):
                    yield from _ast_walk(it)


def point_shape(stmt) -> Optional[tuple]:
    """(shape_key, key_identifier, literal_text) when the statement is a
    micro-batchable point query: single-table SELECT whose WHERE is one
    integer-literal equality, no aggregation/ordering/limit — the shape
    where ``k = ?`` generalizes to ``k IN (...)`` and rows demultiplex
    by the key value."""
    if not isinstance(stmt, A.Query):
        return None
    if stmt.distinct or stmt.group_by or stmt.having is not None or \
            stmt.order_by or stmt.limit is not None or stmt.ctes or \
            stmt.grouping_sets:
        return None
    if not isinstance(stmt.relation, A.TableRef):
        return None
    w = stmt.where
    if not (isinstance(w, A.BinaryOp) and w.op == "=" and
            isinstance(w.left, A.Identifier) and
            isinstance(w.right, A.NumberLit)):
        return None
    if not _INT_LIT.match(w.right.text.strip()):
        return None
    for item in stmt.select:
        if item.expr is None:
            continue                   # SELECT *: demux column still last
        for n in _ast_walk(item.expr):
            if isinstance(n, _FORBIDDEN_AST):
                return None
    shape = dataclasses.replace(
        stmt, where=dataclasses.replace(w, right=A.NumberLit("?")))
    return (repr(shape), w.left, w.right.text.strip())


class _Window:
    __slots__ = ("members", "closed")

    def __init__(self):
        # each member: (entry, lit_text, Event, box=[result, error])
        self.members: list = []
        self.closed = False


class MicroBatcher:
    """Gather window for same-shape point queries. The first arrival
    for a shape leads: it sleeps out the window (off every lock),
    coalesces followers' literals into one IN-list dispatch, and
    demultiplexes rows back per client."""

    def __init__(self, serving: "ServingLayer"):
        self.serving = serving
        self._lock = threading.Lock()
        self._windows: Dict[str, _Window] = {}

    def submit(self, entry: PlanEntry, tq) -> Optional[object]:
        shape_key, key_ident, lit_text = entry.point_shape
        props = self.serving.session.properties
        window_s = float(props.get("microbatch_window_ms", 4.0)) / 1000.0
        with self._lock:
            w = self._windows.get(shape_key)
            if w is not None and not w.closed:
                box = [None, None]
                ev = threading.Event()
                w.members.append((entry, lit_text, ev, box))
                follower = True
            else:
                w = _Window()
                self._windows[shape_key] = w
                follower = False
        if follower:
            # deadline/cancel-aware wait: capped by the query's wall
            # deadline, polled so a terminate() lands between slices,
            # and degrading to an individual run on a wedged leader
            # instead of failing the query outright
            sm = getattr(tq, "state_machine", None)
            qdl = getattr(tq, "deadline", None)
            bound = time.time() + 60.0
            if qdl is not None:
                bound = min(bound, qdl)
            flushed = ev.wait(timeout=0.05)
            while not flushed and time.time() < bound:
                if sm is not None and sm.is_done():
                    from ..exec.executor import QueryTerminatedError
                    raise QueryTerminatedError(
                        "query terminated while waiting on a "
                        "micro-batch window")
                flushed = ev.wait(timeout=0.05)
            if not flushed:
                from ..metrics import MICROBATCH_FOLLOWER_TIMEOUTS
                MICROBATCH_FOLLOWER_TIMEOUTS.inc()
                if qdl is not None and time.time() >= qdl:
                    from ..exec.executor import QueryDeadlineError
                    raise QueryDeadlineError(
                        "query deadline expired waiting on a "
                        "micro-batch window (query_max_run_time_s)")
                return self.serving.route_and_run(entry, tq)
            if box[1] is not None:
                raise box[1]
            if tq is not None:
                tq.route = "microbatch"
            return box[0]
        return self._lead(w, shape_key, entry, lit_text, tq, window_s)

    # -- leader ------------------------------------------------------------

    def _lead(self, w: _Window, shape_key: str, entry: PlanEntry,
              lit_text: str, tq, window_s: float):
        time.sleep(window_s)
        with self._lock:
            w.closed = True
            self._windows.pop(shape_key, None)
            members = list(w.members)
        if not members:
            return None                # nobody joined: normal route
        from ..metrics import MICROBATCH_BATCHES, MICROBATCH_QUERIES
        MICROBATCH_BATCHES.inc()
        MICROBATCH_QUERIES.inc(1 + len(members))
        if tq is not None:
            tq.route = "microbatch"
        # stamp cached pages with the version observed BEFORE the merged
        # dispatch: a write landing mid-flight then invalidates them
        # instead of blessing pre-write rows with the post-write version
        version = self.serving.catalog_version()
        try:
            demux = self._run_merged(entry, lit_text, members)
        except Exception:              # noqa: BLE001 — degrade to N
            # merged dispatch failed (or demux was unsafe): run every
            # member individually so one odd shape can't fail a batch
            return self._run_individually(entry, lit_text, members, tq)
        for m_entry, m_lit, ev, box in members:
            res = demux(m_lit)
            self.serving.store_result(m_entry, res, version=version)
            box[0] = res
            ev.set()
        own = demux(lit_text)
        self.serving.store_result(entry, own, version=version)
        return own

    def _run_individually(self, entry: PlanEntry, lit_text: str,
                          members, tq):
        for m_entry, _lit, ev, box in members:
            try:
                box[0] = self.serving.route_and_run(m_entry, None)
            except Exception as e:     # noqa: BLE001 — per-member verdict
                box[1] = e
            ev.set()
        return self.serving.route_and_run(entry, tq)

    def _run_merged(self, entry: PlanEntry, lit_text: str, members):
        """One dispatch for the whole window: rewrite ``k = ?`` into
        ``k IN (all literals)`` with the key column appended, execute
        through the normal route machinery, split rows by key value.
        Returns a demux function lit_text -> QueryResult."""
        stmt = entry.stmt
        _, key_ident, _ = entry.point_shape
        lits: List[str] = []
        seen = set()
        for t in [lit_text] + [m[1] for m in members]:
            v = int(t)
            if v not in seen:
                seen.add(v)
                lits.append(t)
        select = tuple(stmt.select) + (A.SelectItem(key_ident, "$mbkey"),)
        where = A.InPredicate(key_ident,
                              tuple(A.NumberLit(t) for t in lits),
                              negated=False)
        merged = dataclasses.replace(stmt, select=select, where=where)
        session = self.serving.session
        with self.serving.plan_lock:
            rel = session.planner().plan_query(merged)
            root = prune_plan(rel.node)
        result = self.serving.run_routed(rel, root, None)
        rows = result.rows
        if rows and not isinstance(rows[0][-1], int):
            # demux key decoded to a non-integer representation: the
            # split below would silently drop rows — bail to individual
            raise HostUnsupported("non-integer micro-batch key")
        names = result.column_names[:-1]
        by_key: Dict[int, list] = {}
        for r in rows:
            by_key.setdefault(int(r[-1]), []).append(tuple(r[:-1]))
        from ..exec.session import QueryResult

        def demux(t: str) -> QueryResult:
            return QueryResult(list(names), by_key.get(int(t), []),
                               result.elapsed_s)
        return demux


# --------------------------------------------------------------------------
# the serving layer
# --------------------------------------------------------------------------

class ServingLayer:
    """Coordinator-side front end tying the four parts together. Owns
    NO device state: device executions still funnel through the
    dispatcher's exec lock; host/cache paths bypass it entirely."""

    def __init__(self, session, exec_lock: threading.Lock):
        self.session = session
        self.exec_lock = exec_lock
        # serializes parse+plan (the planner touches connector caches &
        # lazily-computed stats; execution stays concurrent)
        self.plan_lock = threading.Lock()
        self.plan_cache = PlanCache()
        self.result_cache = ResultCache()
        self.microbatcher = MicroBatcher(self)
        self.history = None            # QueryHistoryStore (coordinator)
        self.prewarm = None            # PrewarmEngine (exec/prewarm.py)
        # per-tenant device-contention tracker (exec/router.py): under
        # contention from other tenants, host-eligible queries overflow
        # to the host tier instead of queueing on the exec lock
        self.fair_share = TenantFairShare()
        # fingerprints the serving layer does not own: non-query
        # statements (DDL/SET/SHOW) and volatile system-table queries
        # both execute through the legacy session path; remembering them
        # avoids a wasted parse+plan on every repeat
        self._bypass: set = set()

    # -- keys --------------------------------------------------------------

    def catalog_version(self) -> int:
        return getattr(self.session.catalog, "version", 0)

    def props_key(self) -> int:
        items = tuple(sorted((k, str(v)) for k, v in
                             self.session.properties.items()))
        return hash(items)

    # -- plan cache --------------------------------------------------------

    def plan_entry(self, sql: str) -> Optional[PlanEntry]:
        """Planned + pruned entry for a query statement, via the plan
        cache; None for non-query statements (DDL/SET/SHOW execute
        through the session as before)."""
        fp = plan_fingerprint(sql)
        if fp in self._bypass:
            return None
        session = self.session
        enabled = bool(session.properties.get("enable_plan_cache", True))
        key = (fp, self.props_key(), self.catalog_version())
        if enabled:
            entry = self.plan_cache.get(key)
            if entry is not None:
                return entry
        with self.plan_lock:
            stmt = parse(sql)
            if not isinstance(stmt, (A.Query, A.SetOp, A.Values)):
                self._remember_bypass(fp)
                return None
            rel = session.planner().plan_query(stmt)
            root = prune_plan(rel.node)
        cacheable = self._cacheable(root)
        if not cacheable:
            # volatile scans (system / information_schema): the data can
            # change between plan and execution with no catalog-version
            # bump — including by THIS statement's own plan-cache
            # insertion — so a decode scope snapshotted at plan time can
            # go stale. Those statements keep the legacy atomic
            # plan+execute path under the exec lock.
            self._remember_bypass(fp)
            return None
        entry = PlanEntry(
            sql=sql, fingerprint=fp, stmt=stmt, rel=rel, root=root,
            cacheable=cacheable,
            point_shape=point_shape(stmt),
            catalog_version=key[2],
            weight=_plan_weight(root, sql), created_at=time.time())
        if enabled:
            self.plan_cache.put(key, entry)
        return entry

    def _remember_bypass(self, fp: str) -> None:
        if len(self._bypass) > 4096:
            self._bypass.clear()
        self._bypass.add(fp)

    @staticmethod
    def _cacheable(root) -> bool:
        """Deterministic + non-volatile: plans reading system /
        information_schema state change between executions without any
        catalog-version bump, so their pages must never be served from
        cache."""
        for scan in _plan_scans(root):
            if scan.catalog == "system" or \
                    scan.schema_name == "information_schema":
                return False
        return True

    # -- result cache ------------------------------------------------------

    def lookup_cached(self, tq):
        """FINISHED page served straight from the result cache (no lock,
        no planning). None on miss or when the cache is disabled."""
        props = self.session.properties
        if not props.get("enable_result_cache"):
            return None
        if props.get("require_distributed"):
            return None
        fp = plan_fingerprint(tq.sql)
        entry = self.result_cache.get((fp, self.props_key()),
                                      self.catalog_version())
        if entry is None:
            return None
        tq.route = "cache"
        from ..exec.session import QueryResult
        return QueryResult(list(entry.names), entry.rows, 0.0)

    def store_result(self, entry: PlanEntry, result,
                     version: Optional[int] = None) -> None:
        if not self.session.properties.get("enable_result_cache"):
            return
        if not entry.cacheable:
            return
        self.result_cache.put(
            (entry.fingerprint, self.props_key()),
            result.column_names, result.rows,
            self.catalog_version() if version is None else version)

    # -- execution ---------------------------------------------------------

    def execute_local(self, tq):
        """The dispatcher's local execution path: plan via the cache,
        micro-batch point queries, route host/device, fill the result
        cache. Non-query statements fall through to the session under
        the exec lock exactly as before."""
        entry = self.plan_entry(tq.sql)
        if entry is None:
            with self.exec_lock:
                return self.session.execute(tq.sql)
        if entry.point_shape is not None and \
                self.session.properties.get("enable_microbatch"):
            res = self.microbatcher.submit(entry, tq)
            if res is not None:
                return res
        return self.route_and_run(entry, tq)

    def route_and_run(self, entry: PlanEntry, tq):
        version = self.catalog_version()
        try:
            result = self.run_routed(entry.rel, entry.root, tq,
                                     fingerprint=entry.fingerprint)
        except Exception:
            # stale-plan hazard: a concurrent DDL/write can swap table
            # data between this entry's planning and its (lock-free)
            # execution, leaving decode scopes pointing past the new
            # dictionaries. Only that hazard is retried — if the catalog
            # version never moved, the data cannot have changed and the
            # failure is genuine.
            if self.catalog_version() == entry.catalog_version:
                raise
            with self.exec_lock:
                version = self.catalog_version()
                result = self.session.execute(entry.sql)
            if tq is not None:
                tq.route = "device"
                tq.route_reason = "replanned: catalog changed mid-flight"
                log.info("%sreplanned: catalog changed mid-flight",
                         tq_context(tq))
        self.store_result(entry, result, version=version)
        return result

    def run_routed(self, rel, root, tq, fingerprint=None):
        """Route one pruned plan and execute it (host: lock-free numpy;
        device: the session executor under the exec lock). The tenant
        fair-share tracker sees every device occupancy so a contended
        device overflows other tenants' small queries to the host."""
        from ..metrics import ROUTER_DECISIONS
        session = self.session
        t0 = time.monotonic()
        planner = session.planner()
        tenant = getattr(tq, "tenant", None) if tq is not None else None
        decision = decide_route(planner, root, session.properties,
                                history=self.history,
                                fingerprint=fingerprint,
                                tenant=tenant,
                                fair_share=self.fair_share,
                                prewarm=self.prewarm)
        if tq is not None:
            tq.route = decision.target
            tq.route_reason = decision.reason
        if decision.target == "host":
            if self.prewarm is not None and fingerprint and \
                    decision.reason.startswith("device program cold"):
                # compile-aware window: this query is served host-side;
                # warm the device program in the background so the NEXT
                # submission of the fingerprint routes to device
                self.prewarm.ensure_warming(
                    fingerprint, getattr(tq, "sql", None) or "",
                    context=tq_context(tq) if tq is not None else "")
            try:
                result = run_host(session, rel, root, t0)
                ROUTER_DECISIONS.inc(target="host")
                return result
            except HostUnsupported as e:
                # belt and braces: decide_route pre-checks support, but
                # an interpreter gap must degrade, not fail the query
                if tq is not None:
                    tq.route = "device"
                    tq.route_reason = f"host fallback: {e}"
                    log.info("%shost route fell back to device: %s",
                             tq_context(tq), e)
        ROUTER_DECISIONS.inc(target="device")
        self.fair_share.device_begin(tenant or "default")
        try:
            with self.exec_lock:
                result = session.execute_planned(rel, root, t0)
        finally:
            self.fair_share.device_end(tenant or "default")
        if self.prewarm is not None:
            # a completed device run compiled this fingerprint's
            # programs on-path: it is warm from here on
            self.prewarm.mark_warm(fingerprint)
        return result

    def info(self) -> dict:
        return {
            "planCache": {"entries": len(self.plan_cache)},
            "resultCache": self.result_cache.stats(),
        }
