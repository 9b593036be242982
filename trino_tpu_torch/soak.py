"""The server tier's soaks: correctness gates under faults and load.

Seven soaks, each bringing up an in-process cluster over real HTTP at
``tpch.tiny`` (a coordinator and two to four workers; the coordinator
chaos soak a primary and a warm standby per seed), driving it, and
returning one record whose booleans are the gates:

- ``chaos_soak``: seeded fault schedules (crash / delay / drop / corrupt
  at every distributed control-plane point) over a query matrix; rows
  equal to the fault-free run's, corrupted pages always caught.
- ``overload_soak``: queue-full and queued-time rejections, deadline
  kills of HANG-wedged queries, a mass cancel; every query terminal on
  every node and every pool drained.
- ``write_chaos_soak``: distributed CTAS killed at WRITE_STAGE,
  WRITE_COMMIT and WRITE_PUBLISH; 0 lost rows, 0 duplicate rows, 0
  orphaned staging files.
- ``coordinator_chaos_soak``: the primary killed in five lifecycle
  phases; exactly-once across the failover.
- ``memory_pressure_soak``: concurrent queries with every pool at 25%
  of the measured working set; they spill or fail cleanly, no worker
  crashes.
- ``concurrency_soak``: many mixed clients against the serving layer;
  the result cache, plan cache, router and micro-batch counters, and
  invalidation after a write.
- ``elastic_soak``: a worker drained and another joined while three
  tenants load the cluster under chaos, with per-tenant p99 SLOs.

Names, parameters, defaults and record keys are those of the JAX
package's harness (``bench.py``). Every soak runs on the card unless
given ``device="cpu"``, and writes a file only when given ``out_path``.

    python -m trino_tpu_torch.soak --chaos [--seeds N] [--device cpu]

runs one soak, prints its record and exits 0 when its gates held.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

# name -> (sql, unordered): unordered queries (no ORDER BY) compare as
# multisets — page arrival order legitimately varies under retry/hedging
CHAOS_QUERIES = {
    "agg": (("SELECT l_returnflag, l_linestatus, sum(l_quantity) AS q, "
             "count(*) AS c FROM lineitem WHERE l_shipdate <= DATE "
             "'1998-09-02' GROUP BY l_returnflag, l_linestatus "
             "ORDER BY l_returnflag, l_linestatus"), False),
    "concat": (("SELECT l_orderkey, l_quantity FROM lineitem "
                "WHERE l_shipdate > DATE '1998-11-01'"), True),
    "sort": (("SELECT l_orderkey, l_linenumber FROM lineitem "
              "WHERE l_shipdate > DATE '1998-10-01' "
              "ORDER BY l_orderkey, l_linenumber"), False),
}

WRITE_CHAOS_SRC = ("SELECT o_orderkey, o_custkey, o_orderstatus, "
                   "o_totalprice FROM tpch.tiny.orders")

COORD_CHAOS_PHASES = ("QUEUED", "PLANNING", "RUNNING", "FINISHING",
                      "WRITE_COMMIT")

# the concurrency soak's client mixes (memory.s.counters is made by the
# soak before it starts the server)
CONCURRENCY_MIXES = {
    "point": [f"SELECT n_name FROM nation WHERE n_nationkey = {k}"
              for k in range(25)],
    "cached": ["SELECT r_name FROM region ORDER BY r_name",
               "SELECT count(*) FROM supplier",
               "SELECT v FROM memory.s.counters WHERE k = 2"],
    "small_agg": ["SELECT min(s_suppkey), max(s_suppkey) "
                  "FROM supplier",
                  "SELECT count(*) FROM customer"],
    "scan_heavy": [
        "SELECT l_returnflag, l_linestatus, sum(l_quantity) AS q, "
        "count(*) AS c FROM lineitem "
        "GROUP BY l_returnflag, l_linestatus "
        "ORDER BY l_returnflag, l_linestatus",
        "SELECT count(*) FROM orders JOIN customer "
        "ON o_custkey = c_custkey WHERE c_acctbal > 0"],
}


def _chaos_rows(rows):
    return [tuple(v if v is None or isinstance(v, (int, float, str, bool))
                  else str(v) for v in r) for r in rows]


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def _emit(rec: dict, out_path) -> dict:
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return rec


def _fresh_history(prefix: str):
    """Point the coordinator's history store at a fresh file (stale
    medians from earlier runs would bias the router's baseline input);
    returns (path, the variable's old value)."""
    import tempfile
    fd, path = tempfile.mkstemp(prefix=prefix, suffix=".jsonl")
    os.close(fd)
    saved = os.environ.get("TRINO_TPU_HISTORY_PATH")
    os.environ["TRINO_TPU_HISTORY_PATH"] = path
    return path, saved


def _restore_history(saved) -> None:
    """The coordinator's history store is bound: restore the variable so
    later stores in this process keep their configured path."""
    if saved is None:
        os.environ.pop("TRINO_TPU_HISTORY_PATH", None)
    else:
        os.environ["TRINO_TPU_HISTORY_PATH"] = saved


# ---------------------------------------------------------------------------
# chaos: seeded randomized fault injection
# ---------------------------------------------------------------------------

def chaos_soak(n_seeds=None, cluster=None, out_path=None, device="cuda"):
    """Seeded chaos soak: run the query matrix under generated fault
    schedules (crash / delay / drop / corrupt at every distributed
    control-plane point) and require bit-identical results vs the
    fault-free run — zero wrong-answer escapes, corrupted pages always
    caught by the CRC32C page checksums and recovered via task retry.

    A 3-worker in-process cluster over real HTTP, tiny schema, small
    splits; the record has injected-fault counts and recovery latencies
    (fault wall minus fault-free best). Pass `cluster=(coord, workers,
    session)` to reuse a live cluster."""
    from .client.client import Client, QueryError
    from .exec.session import Session
    from .server.coordinator import CoordinatorServer
    from .server.failuredetector import HeartbeatFailureDetector
    from .server.failureinjector import FailureInjector
    from .server.worker import WorkerServer

    n = n_seeds if n_seeds is not None else \
        int(os.environ.get("TRINO_TPU_CHAOS_SEEDS", 50))
    budget_s = float(os.environ.get("TRINO_TPU_CHAOS_BUDGET_S", 600))
    t_start = time.monotonic()
    owns = cluster is None
    detector = None
    if owns:
        session = Session(default_schema="tiny", device=device)
        coord = CoordinatorServer(session, retry_policy="QUERY").start()
        coord.state.scheduler.split_rows = 8192
        workers = [WorkerServer(f"chaos-w{i}", coord.uri,
                                announce_interval_s=0.1,
                                catalog=session.catalog,
                                device=device).start()
                   for i in range(3)]
        detector = HeartbeatFailureDetector(coord.state,
                                            interval_s=0.2).start()
    else:
        coord, workers, session = cluster
        detector = coord.state.failure_detector
    sched = coord.state.scheduler
    saved = (sched.max_task_retries, sched.hedge_min_s,
             sched.hedge_multiplier)
    # chaos schedules can burn several retry rounds; the hedge threshold
    # sits well below the injected straggler delays (up to 1 s) so DELAY
    # faults exercise the speculative re-dispatch path
    sched.max_task_retries = 8
    sched.hedge_min_s, sched.hedge_multiplier = 0.3, 2.0
    client = Client(coord.uri, user="chaos", timeout_s=120)

    def wait_active(k=3, timeout=5.0):
        deadline = time.time() + timeout
        while len(coord.state.active_nodes()) < k and \
                time.time() < deadline:
            time.sleep(0.05)

    wait_active()
    # fault-free baselines THROUGH the cluster (also warms the workers
    # so first-use costs don't pollute recovery latencies)
    baselines, base_wall = {}, {}
    for name, (q, unordered) in CHAOS_QUERIES.items():
        walls = []
        for _ in range(2):
            sched.spool.clear()
            t0 = time.monotonic()
            r = client.execute(q)
            walls.append(time.monotonic() - t0)
        rows = _chaos_rows(r.rows)
        baselines[name] = sorted(rows) if unordered else rows
        base_wall[name] = min(walls)

    rec = {"metric": "chaos_soak", "schedules": 0, "queries_run": 0,
           "wrong_answers": 0, "failed_queries": 0, "injected_total": 0,
           "injected_by_fault": {}, "corrupt_detected": 0,
           "recovery_latency_s": [], "task_retries": 0,
           "hedged_tasks": 0, "spool_hits": 0, "budget_exhausted": False}
    retries0 = sched.stats["task_retries"]
    hedged0 = sched.stats["hedged_tasks"]
    spool0 = sched.stats["spool_hits"]
    crc0 = sched.stats["checksum_failures"]
    for seed in range(n):
        if time.monotonic() - t_start > budget_s:
            rec["budget_exhausted"] = True
            break
        inj = FailureInjector.from_seed(seed, max_delay_s=1.0)
        sched.failure_injector = inj
        if detector is not None:
            detector.injector = inj
        for w in workers:
            w.task_manager.injector = inj
        try:
            for name, (q, unordered) in CHAOS_QUERIES.items():
                sched.spool.clear()
                fired_before = inj.injected_count
                t0 = time.monotonic()
                try:
                    r = client.execute(q)
                except QueryError:
                    rec["failed_queries"] += 1
                    continue
                wall = time.monotonic() - t0
                rec["queries_run"] += 1
                got = _chaos_rows(r.rows)
                if unordered:
                    got = sorted(got)
                if got != baselines[name]:
                    rec["wrong_answers"] += 1
                if inj.injected_count > fired_before:
                    rec["recovery_latency_s"].append(
                        round(max(0.0, wall - base_wall[name]), 3))
        finally:
            sched.failure_injector = None
            if detector is not None:
                detector.injector = None
            for w in workers:
                w.task_manager.injector = None
        rec["schedules"] += 1
        rec["injected_total"] += inj.injected_count
        for fault, cnt in inj.injected_by_fault.items():
            if cnt:
                rec["injected_by_fault"][fault] = \
                    rec["injected_by_fault"].get(fault, 0) + cnt
        inj.clear()
        wait_active()
    rec["task_retries"] = sched.stats["task_retries"] - retries0
    rec["hedged_tasks"] = sched.stats["hedged_tasks"] - hedged0
    rec["spool_hits"] = sched.stats["spool_hits"] - spool0
    rec["corrupt_detected"] = sched.stats["checksum_failures"] - crc0 + \
        sched.spool.checksum_rejects
    lat = sorted(rec["recovery_latency_s"])
    rec["recovery_p50_s"] = lat[len(lat) // 2] if lat else 0.0
    rec["recovery_p95_s"] = lat[int(len(lat) * 0.95)] if lat else 0.0
    rec["elapsed_s"] = round(time.monotonic() - t_start, 1)
    sched.max_task_retries, sched.hedge_min_s, sched.hedge_multiplier = \
        saved
    if owns:
        if detector is not None:
            detector.stop()
        for w in workers:
            w.stop()
        coord.stop()
    return _emit(rec, out_path)


# ---------------------------------------------------------------------------
# overload: deadlines, cancellation, admission control
# ---------------------------------------------------------------------------

def overload_soak(cluster=None, out_path=None, device="cuda"):
    """Query-lifetime enforcement soak: saturating admission against a
    shrunken resource group (queue-full + queued-time rejections),
    HANG-wedged distributed queries that only the coordinator-stamped
    deadline can unstick, and a mass-cancel wave DELETEing mid-flight
    queries. Hard gates: 0 wrong answers among everything that
    FINISHED, every expired/canceled query terminal on every node
    within grace, and worker memory pools drained to zero."""
    from .client.client import Client, QueryError
    from .exec.session import Session
    from .server.coordinator import CoordinatorServer
    from .server.failureinjector import DELAY, HANG, FailureInjector
    from .server.worker import WorkerServer

    t_start = time.monotonic()
    owns = cluster is None
    if owns:
        session = Session(default_schema="tiny", device=device)
        coord = CoordinatorServer(session, retry_policy="QUERY").start()
        coord.state.scheduler.split_rows = 8192
        workers = [WorkerServer(f"ovl-w{i}", coord.uri,
                                announce_interval_s=0.1,
                                catalog=session.catalog,
                                device=device).start()
                   for i in range(3)]
    else:
        coord, workers, session = cluster
    sched = coord.state.scheduler
    deadline = time.time() + 5
    while len(coord.state.active_nodes()) < 3 and time.time() < deadline:
        time.sleep(0.05)

    q_agg, _ = CHAOS_QUERIES["agg"]
    # fault-free baseline THROUGH the cluster (rows as the protocol
    # serializes them) — also warms the workers so first-use costs never
    # eat a deadline
    want = _chaos_rows(
        Client(coord.uri, user="overload").execute(q_agg).rows)

    rec = {"metric": "overload", "submitted": 0, "finished": 0,
           "wrong_answers": 0, "rejected_queue_full": 0,
           "rejected_queued_deadline": 0, "deadline_kills": 0,
           "canceled": 0, "unexpected_errors": 0, "errors": []}

    def note_error(stage, e):
        rec["unexpected_errors"] += 1
        if len(rec["errors"]) < 8:
            rec["errors"].append(f"{stage}: {e}")

    # -- wave 1: saturating admission against a shrunken root group ----
    client_sets = Client(coord.uri, user="overload")
    client_sets.execute("SET SESSION query_max_queued_time_s = 0.5")
    root = coord.state.dispatcher.resource_groups.root
    saved_rg = (root.config.hard_concurrency_limit,
                root.config.max_queued)
    root.config.hard_concurrency_limit = 1
    root.config.max_queued = 2
    lock = threading.Lock()

    def one_query():
        rec["submitted"] += 1
        try:
            r = Client(coord.uri, user="overload",
                       timeout_s=120).execute(q_agg)
        except QueryError as e:
            with lock:
                if e.error_name == "QUERY_QUEUE_FULL":
                    rec["rejected_queue_full"] += 1
                elif e.error_name == "QUERY_EXCEEDED_QUEUED_TIME":
                    rec["rejected_queued_deadline"] += 1
                else:
                    note_error("admission", e)
            return
        with lock:
            rec["finished"] += 1
            if _chaos_rows(r.rows) != want:
                rec["wrong_answers"] += 1

    try:
        threads = [threading.Thread(target=one_query)
                   for _ in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        root.config.hard_concurrency_limit, root.config.max_queued = \
            saved_rg
        # reset via the session dict, not a SET statement: a SET issued
        # while the deadline property is still armed gets stamped with
        # that deadline and can itself be killed mid-drain
        session.properties.pop("query_max_queued_time_s", None)

    # -- wave 2: HANG-wedged queries unstuck only by their deadline ----
    n_hang = 3
    deadline_s = 1.0
    client_sets.execute(
        f"SET SESSION query_max_run_time_s = {deadline_s}")
    inj = FailureInjector(seed=722)
    inj.inject("WORKER_TASK_RUN", times=4 * n_hang, fault=HANG,
               delay_s=8.0)
    for w in workers:
        w.task_manager.injector = inj
    overshoots = []
    try:
        for _ in range(n_hang):
            # drop spooled task results so the query actually re-runs
            # on the workers (and hits the HANG) instead of being
            # served from the exchange spool
            sched.spool.clear()
            rec["submitted"] += 1
            t0 = time.monotonic()
            try:
                Client(coord.uri, user="overload",
                       timeout_s=30).execute(q_agg)
                note_error("hang", "wedged query FINISHED under a "
                                   "deadline that should have fired")
            except QueryError as e:
                wall = time.monotonic() - t0
                if e.error_name == "QUERY_EXCEEDED_RUN_TIME":
                    rec["deadline_kills"] += 1
                    overshoots.append(
                        round(max(0.0, wall - deadline_s) * 1000, 1))
                else:
                    note_error("hang", e)
    finally:
        inj.clear()                       # release every live HANG
        for w in workers:
            w.task_manager.injector = None
        session.properties.pop("query_max_run_time_s", None)

    # -- wave 3: mass-cancel of mid-flight distributed queries ---------
    n_cancel = 4
    inj = FailureInjector(seed=723)
    inj.inject("WORKER_TASK_RUN", times=8 * n_cancel, fault=DELAY,
               delay_s=1.0)
    for w in workers:
        w.task_manager.injector = inj
    cancel_walls = []
    try:
        # same spool hazard as wave 2: released wave-2 tasks may have
        # spooled their pages, and a spool-served query FINISHES before
        # the DELETE can land
        sched.spool.clear()
        cancel_client = Client(coord.uri, user="overload")
        live = []
        for _ in range(n_cancel):
            rec["submitted"] += 1
            doc = cancel_client._submit(q_agg)
            live.append((doc["id"], doc.get("nextUri")))
        # wait until the wave is mid-flight (remote tasks dispatched —
        # the exec lock serializes dispatch, so the rest of the wave is
        # canceled wherever it stands: queued, planning, or waiting),
        # then DELETE everything back-to-back
        deadline = time.time() + 15
        while time.time() < deadline and not any(
                sched._live_tasks.get(qid) for qid, _ in live):
            time.sleep(0.02)
        for qid, next_uri in live:
            t0 = time.monotonic()
            try:
                cancel_client._request("DELETE", next_uri)
            except Exception as e:  # noqa: BLE001
                note_error("cancel", e)
                continue
            tq = coord.state.tracker.get(qid)
            deadline = time.time() + 10
            while not tq.state_machine.is_done() and \
                    time.time() < deadline:
                time.sleep(0.01)
            if tq.state == "CANCELED":
                rec["canceled"] += 1
                cancel_walls.append(
                    round((time.monotonic() - t0) * 1000, 1))
            else:
                note_error("cancel", f"{qid} ended {tq.state}")
    finally:
        inj.clear()
        for w in workers:
            w.task_manager.injector = None

    # -- grace: every node terminal, every pool drained ----------------
    def all_tasks_terminal():
        return all(t.state not in ("PENDING", "RUNNING")
                   for w in workers
                   for t in list(w.task_manager.tasks.values()))

    def pools_drained():
        return all(w.task_manager.memory_info().get("reserved", 0) == 0
                   for w in workers)

    grace = time.time() + 15
    while not (all_tasks_terminal() and pools_drained()) and \
            time.time() < grace:
        time.sleep(0.05)
    rec["tasks_terminal"] = all_tasks_terminal()
    rec["pools_drained"] = pools_drained()

    cancel_walls.sort()
    overshoots.sort()
    rec["cancel_terminal_p50_ms"] = \
        cancel_walls[len(cancel_walls) // 2] if cancel_walls else None
    rec["cancel_terminal_max_ms"] = \
        cancel_walls[-1] if cancel_walls else None
    rec["deadline_overshoot_p50_ms"] = \
        overshoots[len(overshoots) // 2] if overshoots else None
    rec["rejected_total"] = (rec["rejected_queue_full"] +
                             rec["rejected_queued_deadline"])
    rec["elapsed_s"] = round(time.monotonic() - t_start, 1)
    rec["passed"] = bool(
        rec["wrong_answers"] == 0 and rec["unexpected_errors"] == 0 and
        rec["deadline_kills"] == n_hang and
        rec["canceled"] == n_cancel and rec["finished"] >= 1 and
        rec["tasks_terminal"] and rec["pools_drained"])
    if owns:
        for w in workers:
            w.stop()
        coord.stop()
    return _emit(rec, out_path)


# ---------------------------------------------------------------------------
# write chaos: exactly-once distributed writes
# ---------------------------------------------------------------------------

def write_chaos_soak(n_seeds=None, out_path=None, device="cuda"):
    """Seeded write-chaos soak: distributed CTAS with kills injected at
    each write-protocol boundary (WRITE_STAGE / WRITE_COMMIT /
    WRITE_PUBLISH, faults rotating through RAISE / CRASH / DELAY plus
    torn-journal CORRUPT appends, some seeds with forced duplicate
    hedged attempts). Every seed's committed table must equal the
    fault-free row multiset — 0 lost rows, 0 duplicate rows — and leave
    0 orphaned staging files or journals. Pre-intent failures are
    retried under the SAME query id, so the soak also proves commit
    idempotence across whole-query retries."""
    import shutil
    import tempfile
    from collections import Counter

    from .connectors.orcdir import OrcConnector
    from .exec.session import Session
    from .server import writeprotocol as wp
    from .server.coordinator import CoordinatorServer
    from .server.failureinjector import (CORRUPT, CRASH, DELAY, RAISE,
                                         WRITE_COMMIT, WRITE_POINTS,
                                         FailureInjector)
    from .server.worker import WorkerServer

    n = n_seeds if n_seeds is not None else \
        int(os.environ.get("TRINO_TPU_WRITE_CHAOS_SEEDS", 27))
    budget_s = float(os.environ.get("TRINO_TPU_WRITE_CHAOS_BUDGET_S", 420))
    t_start = time.monotonic()
    root = tempfile.mkdtemp(prefix="write_chaos_")
    os.makedirs(os.path.join(root, "out"))
    session = Session(default_schema="tiny", device=device)
    conn = OrcConnector(root)
    session.catalog.register("orc", conn)
    coord = CoordinatorServer(session, retry_policy="QUERY").start()
    sched = coord.state.scheduler
    sched.split_rows = 4096
    workers = [WorkerServer(f"wchaos-w{i}", coord.uri,
                            announce_interval_s=0.1,
                            catalog=session.catalog,
                            device=device).start()
               for i in range(3)]
    deadline = time.time() + 5
    while len(coord.state.active_nodes()) < 3 and time.time() < deadline:
        time.sleep(0.05)

    baseline = Counter(_chaos_rows(session.execute(WRITE_CHAOS_SRC).rows))
    rec = {"metric": "write_chaos", "seeds": 0, "writes_committed": 0,
           "failed_writes": 0, "query_retries": 0, "lost_rows": 0,
           "dup_rows": 0, "orphans": 0, "hedged_seeds": 0,
           "attempts_deduped": 0, "injected_total": 0,
           "injected_by_fault": {}, "injected_by_point": {},
           "points": {}, "budget_exhausted": False}
    walls = {p: [] for p in WRITE_POINTS}
    try:
        for seed in range(n):
            if time.monotonic() - t_start > budget_s:
                rec["budget_exhausted"] = True
                break
            point = WRITE_POINTS[seed % len(WRITE_POINTS)]
            fault = (RAISE, CRASH, DELAY)[(seed // 3) % 3]
            if point == WRITE_COMMIT and seed % 9 == 4:
                fault = CORRUPT          # torn intent-journal append
            inj = FailureInjector(seed=seed)
            inj.inject(point, times=1, fault=fault)
            sched.failure_injector = inj
            for w in workers:
                w.task_manager.injector = inj
            sched.force_write_hedge = seed % 4 == 3
            if sched.force_write_hedge:
                rec["hedged_seeds"] += 1
            tbl = f"w{seed}"
            qid = f"wchaos_{seed}"
            sql = f"CREATE TABLE orc.out.{tbl} AS {WRITE_CHAOS_SRC}"
            res = None
            t0 = time.monotonic()
            for _attempt in range(3):
                try:
                    res = sched.execute(sql, query_id=qid)
                    break
                except Exception:  # noqa: BLE001
                    # pre-intent abort: the QUERY retry policy reruns
                    # the same query id — exactly-once must hold
                    rec["query_retries"] += 1
            wall_ms = (time.monotonic() - t0) * 1000
            sched.failure_injector = None
            sched.force_write_hedge = False
            for w in workers:
                w.task_manager.injector = None
            rec["seeds"] += 1
            rec["injected_total"] += inj.injected_count
            rec["injected_by_point"][point] = \
                rec["injected_by_point"].get(point, 0) + inj.injected_count
            for f, cnt in inj.injected_by_fault.items():
                if cnt:
                    rec["injected_by_fault"][f] = \
                        rec["injected_by_fault"].get(f, 0) + cnt
            if res is None:
                rec["failed_writes"] += 1
                continue
            rec["writes_committed"] += 1
            walls[point].append(wall_ms)
            wr = (sched.last_query or {}).get("write") or {}
            rec["attempts_deduped"] += int(wr.get("deduped", 0))
            got = Counter(_chaos_rows(session.execute(
                f"SELECT o_orderkey, o_custkey, o_orderstatus, "
                f"o_totalprice FROM orc.out.{tbl}").rows))
            rec["lost_rows"] += sum((baseline - got).values())
            rec["dup_rows"] += sum((got - baseline).values())
            td = conn._table_dir("out", tbl)
            rec["orphans"] += len(os.listdir(wp.staging_dir(td))) \
                if os.path.isdir(wp.staging_dir(td)) else 0
            rec["orphans"] += sum(1 for f in os.listdir(td)
                                  if f.endswith(".journal")
                                  or f.startswith(".tmp."))
            conn.drop_table("out", tbl)
        # nothing may survive outside the published tables either
        for _dirpath, dirnames, filenames in os.walk(root):
            rec["orphans"] += sum(1 for d in dirnames if d == ".staging")
            rec["orphans"] += sum(1 for f in filenames
                                  if f.endswith(".journal")
                                  or f.startswith(".tmp."))
    finally:
        sched.failure_injector = None
        sched.force_write_hedge = False
        for w in workers:
            w.task_manager.injector = None
            w.stop()
        coord.stop()
        shutil.rmtree(root, ignore_errors=True)
    for point, ws in walls.items():
        if ws:
            ws = sorted(ws)
            rec["points"][point] = {
                "commits": len(ws),
                "p50_ms": round(ws[len(ws) // 2], 1),
                "p95_ms": round(ws[int(len(ws) * 0.95)], 1)}
    rec["elapsed_s"] = round(time.monotonic() - t_start, 1)
    rec["passed"] = (rec["lost_rows"] == 0 and rec["dup_rows"] == 0
                     and rec["orphans"] == 0
                     and rec["failed_writes"] == 0
                     and rec["injected_total"] >= rec["seeds"])
    return _emit(rec, out_path)


# ---------------------------------------------------------------------------
# coordinator chaos: the primary killed in every lifecycle phase
# ---------------------------------------------------------------------------

def coordinator_chaos_soak(n_seeds=None, out_path=None, device="cuda"):
    """Seeded coordinator-kill soak: for every seed, bring up a primary
    + warm standby sharing one durable query ledger and spool root plus
    two workers, submit a query through a multi-address client, and
    kill the primary at a rotating lifecycle phase (QUEUED / PLANNING /
    RUNNING / FINISHING / WRITE_COMMIT — the write phase crashes the
    staged-write commit mid-flight so exactly-once must hold across the
    failover). Promotion alternates by seed parity between
    detector-driven and admin `PUT /v1/info/state`. The client must
    finish every seed with bit-exact rows and NO visible error: 0 wrong
    results, 0 lost rows, 0 duplicate rows."""
    import shutil
    import tempfile
    from collections import Counter
    from urllib.request import Request, urlopen

    from .client.client import Client
    from .connectors.orcdir import OrcConnector
    from .exec.session import Session
    from .metrics import COORDINATOR_FAILOVERS
    from .server import ledger as led
    from .server.coordinator import CoordinatorServer
    from .server.failureinjector import (CRASH, DELAY, WRITE_COMMIT,
                                         FailureInjector)
    from .server.security import internal_headers
    from .server.worker import WorkerServer

    n = n_seeds if n_seeds is not None else \
        int(os.environ.get("TRINO_TPU_COORD_CHAOS_SEEDS", 20))
    budget_s = float(os.environ.get("TRINO_TPU_COORD_CHAOS_BUDGET_S",
                                    600))
    t_start = time.monotonic()
    read_sql = ("SELECT n_regionkey, count(*) AS c FROM nation "
                "GROUP BY n_regionkey ORDER BY n_regionkey")
    read_expect = [(0, 5), (1, 5), (2, 5), (3, 5), (4, 5)]
    write_src = WRITE_CHAOS_SRC
    rec = {"metric": "coordinator_chaos", "seeds": 0,
           "wrong_results": 0, "lost_rows": 0, "dup_rows": 0,
           "client_errors": 0, "failovers": 0,
           "detector_promotions": 0, "admin_promotions": 0,
           "kills_by_phase": {}, "resumed_by_mode": {},
           "budget_exhausted": False}
    fo_walls = []
    write_baseline = None
    for seed in range(n):
        if time.monotonic() - t_start > budget_s:
            rec["budget_exhausted"] = True
            break
        phase = COORD_CHAOS_PHASES[seed % len(COORD_CHAOS_PHASES)]
        admin = seed % 2 == 1           # else detector-driven
        write_phase = phase == "WRITE_COMMIT"
        root = tempfile.mkdtemp(prefix="coord_chaos_")
        ledger = os.path.join(root, "query.ledger")
        spool = os.path.join(root, "spool")
        s1 = Session(default_schema="tiny", device=device)
        s2 = Session(default_schema="tiny", device=device)
        if write_phase:
            os.makedirs(os.path.join(root, "orc", "out"))
            s1.catalog.register("orc", OrcConnector(
                os.path.join(root, "orc")))
            s2.catalog.register("orc", OrcConnector(
                os.path.join(root, "orc")))
        primary = CoordinatorServer(s1, ledger_path=ledger,
                                    node_id=f"p{seed}",
                                    spool_root=spool).start()
        standby = CoordinatorServer(s2, ledger_path=ledger,
                                    node_id=f"s{seed}", role="standby",
                                    peer_uri=primary.uri,
                                    spool_root=spool,
                                    standby_interval_s=0.1,
                                    auto_promote=not admin).start()
        workers = [WorkerServer(f"cc{seed}w{i}", primary.uri,
                                announce_interval_s=0.1,
                                catalog=s1.catalog,
                                device=device).start()
                   for i in range(2)]
        deadline = time.time() + 10
        while len(primary.state.active_nodes()) < 2 and \
                time.time() < deadline:
            time.sleep(0.02)
        for w in workers:
            w.announce_once()           # learn the standby address now
        inj = FailureInjector(seed=seed)
        if write_phase:
            primary.state.scheduler.split_rows = 4096
            primary.state.scheduler.failure_injector = inj
            # the commit dies mid-flight on the (sealed) primary; the
            # promoted standby re-executes and must dedup to one table
            inj.inject(WRITE_COMMIT, times=1, fault=CRASH)
            sql = f"CREATE TABLE orc.out.c{seed} AS {write_src}"
        else:
            primary.state.dispatcher.failure_injector = inj
            if phase in ("RUNNING", "FINISHING"):
                inj.inject("EXECUTION", times=1, fault=DELAY,
                           delay_s=1.5, match_sql="n_regionkey")
            sql = read_sql
        client = Client([primary.uri, standby.uri],
                        user=f"chaos{seed}", timeout_s=120)
        out = {}

        def run(client=client, sql=sql, out=out):
            try:
                out["r"] = client.execute(sql)
            except Exception as e:  # noqa: BLE001 — the gate counts it
                out["err"] = e

        t = threading.Thread(target=run)
        t.start()
        # kill when the primary's registry first shows the query at (or
        # past) the target phase — a bounded watch, so late phases that
        # flash by still get a kill near the boundary
        target = "RUNNING" if write_phase else phase
        observed = None
        deadline = time.time() + 8
        while time.time() < deadline and observed is None:
            for tq in primary.state.tracker.all():
                if led._rank(tq.state) >= led._rank(target):
                    observed = tq.state
                    break
            if observed is None:
                time.sleep(0.002)
        if phase == "FINISHING" and observed == "RUNNING":
            time.sleep(1.2)             # drift toward the boundary
        t_kill = time.monotonic()
        primary.kill()
        rec["kills_by_phase"][phase] = \
            rec["kills_by_phase"].get(phase, 0) + 1
        if admin:
            try:
                req = Request(f"{standby.uri}/v1/info/state",
                              data=json.dumps(
                                  {"state": "PRIMARY"}).encode(),
                              headers={"Content-Type":
                                       "application/json",
                                       **internal_headers()},
                              method="PUT")
                with urlopen(req, timeout=15):
                    pass
                rec["admin_promotions"] += 1
            except Exception:  # noqa: BLE001 — the client error gates
                pass
        else:
            rec["detector_promotions"] += 1
        t.join(timeout=120)
        rec["seeds"] += 1
        if "r" not in out or t.is_alive():
            rec["client_errors"] += 1
        else:
            r = out["r"]
            fo_walls.append((time.monotonic() - t_kill) * 1000)
            rec["failovers"] += r.failovers
            if write_phase:
                got = Counter(_chaos_rows(s2.execute(
                    f"SELECT o_orderkey, o_custkey, o_orderstatus, "
                    f"o_totalprice FROM orc.out.c{seed}").rows))
                if write_baseline is None:
                    write_baseline = Counter(
                        _chaos_rows(s2.execute(write_src).rows))
                rec["lost_rows"] += sum(
                    (write_baseline - got).values())
                rec["dup_rows"] += sum((got - write_baseline).values())
            else:
                if [tuple(x) for x in r.rows] != read_expect:
                    rec["wrong_results"] += 1
            tq = standby.state.tracker.get(r.query_id)
            mode = getattr(tq, "resumed", None) if tq else None
            if mode:
                rec["resumed_by_mode"][mode] = \
                    rec["resumed_by_mode"].get(mode, 0) + 1
        for w in workers:
            w.kill()
        standby.kill()
        for c in (primary, standby):
            c.state.dispatcher.pool.shutdown(wait=False)
        shutil.rmtree(root, ignore_errors=True)
    if fo_walls:
        ws = sorted(fo_walls)
        rec["failover_to_result_p50_ms"] = round(ws[len(ws) // 2], 1)
        rec["failover_to_result_p99_ms"] = round(
            ws[min(len(ws) - 1, int(len(ws) * 0.99))], 1)
    rec["coordinator_failovers_total"] = COORDINATOR_FAILOVERS.value()
    rec["elapsed_s"] = round(time.monotonic() - t_start, 1)
    rec["passed"] = (rec["wrong_results"] == 0 and rec["lost_rows"] == 0
                     and rec["dup_rows"] == 0
                     and rec["client_errors"] == 0
                     and rec["failovers"] >= rec["seeds"] > 0)
    return _emit(rec, out_path)


# ---------------------------------------------------------------------------
# memory pressure: every pool at a quarter of the working set
# ---------------------------------------------------------------------------

def memory_pressure_soak(n_queries=None, out_path=None, device="cuda"):
    """Memory-pressure soak: >= 20 concurrent queries against a 3-worker
    cluster with every executor pool clamped to 25% of the measured
    working set. Requires 0 wrong answers and 0 worker crashes —
    queries must survive by spilling or fail cleanly with
    QUERY_EXCEEDED_MEMORY, never by taking a worker down. The record
    has the spill/backpressure/killer counters."""
    from urllib.request import urlopen

    from .client.client import Client, QueryError
    from .exec.session import Session
    from .metrics import REGISTRY
    from .server.coordinator import CoordinatorServer
    from .server.failuredetector import HeartbeatFailureDetector
    from .server.worker import WorkerServer

    n = n_queries if n_queries is not None else \
        int(os.environ.get("TRINO_TPU_MEMSOAK_QUERIES", 24))
    queries = {
        "join_agg": ("SELECT o_custkey, count(*) AS c, "
                     "sum(o_totalprice) AS s FROM orders JOIN customer "
                     "ON o_custkey = c_custkey WHERE c_acctbal > 0 "
                     "GROUP BY o_custkey ORDER BY s DESC, o_custkey "
                     "LIMIT 50"),
        "wide_agg": ("SELECT l_returnflag, l_linestatus, "
                     "sum(l_quantity) AS q, count(*) AS c, "
                     "min(l_discount) AS mn, max(l_tax) AS mx "
                     "FROM lineitem GROUP BY l_returnflag, l_linestatus "
                     "ORDER BY l_returnflag, l_linestatus"),
        "big_group": ("SELECT l_orderkey, sum(l_quantity) AS q "
                      "FROM lineitem GROUP BY l_orderkey "
                      "ORDER BY q DESC, l_orderkey LIMIT 20"),
        "point": "SELECT count(*) FROM nation",
    }
    # 1) measure the working set at an unconstrained pool (rows
    # normalized like the protocol does — Decimal/date render as text)
    t_start = time.monotonic()
    session = Session(default_schema="tiny", device=device)
    baselines = {}
    for name, q in queries.items():
        baselines[name] = _chaos_rows(session.execute(q).rows)
    working_set = session.executor.pool.peak
    limit = max(1 << 20, working_set // 4)

    # 2) cluster with every pool clamped to 25%
    session.properties["query_max_memory_mb"] = max(1, limit >> 20)
    session.executor.pool.set_limit(limit)
    coord = CoordinatorServer(session, max_concurrency=4).start()
    coord.state.scheduler.split_rows = 8192
    workers = [WorkerServer(f"mem-w{i}", coord.uri,
                            announce_interval_s=0.1,
                            catalog=session.catalog,
                            device=device).start()
               for i in range(3)]
    for w in workers:
        w.task_manager._executor.pool.set_limit(limit)
        w.task_manager.max_buffer_bytes = 1 << 20   # exercise backpressure
    detector = HeartbeatFailureDetector(coord.state,
                                        interval_s=0.2).start()
    coord.state.memory_manager.interval_s = 0.2
    coord.state.memory_manager.start()

    reg0 = REGISTRY.snapshot()
    rec = {"metric": "memory_pressure_soak", "queries": 0,
           "wrong_answers": 0, "failed_queries": 0,
           "oom_user_errors": 0, "worker_crashes": 0,
           "concurrent": n, "working_set_bytes": int(working_set),
           "pool_limit_bytes": int(limit)}
    lock = threading.Lock()

    def one(i: int) -> None:
        name = list(queries)[i % len(queries)]
        client = Client(coord.uri, user=f"soak{i}", timeout_s=180)
        try:
            rows = client.execute(queries[name]).rows
        except QueryError as e:
            with lock:
                if e.error_name == "QUERY_EXCEEDED_MEMORY":
                    rec["oom_user_errors"] += 1      # clean user error
                else:
                    rec["failed_queries"] += 1
            return
        except Exception:    # noqa: BLE001 — client-side transport
            with lock:       # failure: count it, never lose the thread
                rec["failed_queries"] += 1
            return
        with lock:
            rec["queries"] += 1
            if _chaos_rows(rows) != baselines[name]:
                rec["wrong_answers"] += 1

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)

    # 3) no worker crashed: every worker still answers /v1/status
    for w in workers:
        try:
            with urlopen(f"{w.uri}/v1/status", timeout=5) as resp:
                ok = resp.status == 200
        except Exception:  # noqa: BLE001
            ok = False
        if not ok:
            rec["worker_crashes"] += 1

    after = REGISTRY.snapshot()

    def delta(key):
        return int(after.get(key, 0) - reg0.get(key, 0))

    rec["spill_bytes"] = delta(("trino_tpu_spill_bytes_total",))
    rec["spill_partitions"] = delta(("trino_tpu_spill_partitions_total",))
    rec["revocations"] = delta(("trino_tpu_memory_revocations_total",))
    rec["backpressure_waits"] = delta(
        ("trino_tpu_exchange_backpressure_waits_total",))
    rec["queries_killed_oom"] = delta(
        ("trino_tpu_queries_killed_oom_total",))
    rec["elapsed_s"] = round(time.monotonic() - t_start, 1)
    rec["passed"] = (rec["wrong_answers"] == 0 and
                     rec["worker_crashes"] == 0 and
                     rec["failed_queries"] == 0)
    coord.state.memory_manager.stop()
    detector.stop()
    for w in workers:
        w.stop()
    coord.stop()
    return _emit(rec, out_path)


# ---------------------------------------------------------------------------
# concurrency: many mixed clients against the serving layer
# ---------------------------------------------------------------------------

def concurrency_soak(n_clients=None, queries_per_client=None,
                     out_path=None, device="cuda"):
    """High-concurrency serving soak: >= 100 mixed clients against one
    coordinator with the serving layer fully on (plan cache, result
    cache, host/device cost routing, micro-batching). Point, cached and
    small-aggregate traffic runs host-side WITHOUT the device exec lock
    while scan-heavy plans keep the device, so the mix must not
    serialize. Requires 0 wrong answers vs the uncached oracle (every
    HTTP result — cache hits, micro-batched rows, host-routed rows —
    compared bit-exact against a direct pre-server execution), nonzero
    result-cache/router/micro-batch counters, and a post-write rerun
    proving catalog-version invalidation. The record has throughput and
    p50/p99 per mix."""
    from .client.client import Client
    from .exec.session import Session
    from .metrics import REGISTRY
    from .server.coordinator import CoordinatorServer
    from .server.resourcegroups import (ResourceGroupConfig,
                                        ResourceGroupManager)

    n = n_clients if n_clients is not None else \
        int(os.environ.get("TRINO_TPU_CONCURRENCY_CLIENTS", 120))
    per = queries_per_client if queries_per_client is not None else \
        int(os.environ.get("TRINO_TPU_CONCURRENCY_QUERIES", 5))
    t_start = time.monotonic()
    hist, saved_hist = _fresh_history("concurrency_hist_")

    session = Session(default_schema="tiny", device=device)
    session.execute("CREATE TABLE memory.s.counters (k bigint, v bigint)")
    session.execute("INSERT INTO memory.s.counters VALUES (1, 10), (2, 20)")

    mixes = CONCURRENCY_MIXES
    # uncached oracle: every distinct statement executed directly (no
    # serving layer) BEFORE the server starts — the soak's bit-exact
    # reference for cached/host/micro-batched paths alike
    oracle = {}
    for qs in mixes.values():
        for q in qs:
            oracle[q] = _chaos_rows(session.execute(q).rows)

    session.properties["enable_result_cache"] = True
    session.properties["enable_microbatch"] = True
    session.properties["microbatch_window_ms"] = 4.0
    coord = CoordinatorServer(session, max_concurrency=32).start()
    _restore_history(saved_hist)
    coord.state.dispatcher.resource_groups = ResourceGroupManager(
        ResourceGroupConfig("root", hard_concurrency_limit=32,
                            max_queued=100_000))

    reg0 = REGISTRY.snapshot()
    mix_names = list(mixes)
    lock = threading.Lock()
    latencies = {m: [] for m in mix_names}
    rec = {"metric": "concurrency_soak", "clients": n,
           "queries_per_client": per, "queries": 0, "wrong_answers": 0,
           "failed_queries": 0}

    def one(i: int) -> None:
        mix = mix_names[i % len(mix_names)]
        qs = mixes[mix]
        client = Client(coord.uri, user=f"conc{i}", timeout_s=180,
                        poll_interval_s=0.005)
        for j in range(per):
            q = qs[(i + j) % len(qs)]
            t0 = time.monotonic()
            try:
                rows = client.execute(q).rows
            except Exception:  # noqa: BLE001 — QueryError/transport both
                with lock:     # count as failures; the thread lives on
                    rec["failed_queries"] += 1
                continue
            ms = (time.monotonic() - t0) * 1000
            with lock:
                rec["queries"] += 1
                latencies[mix].append(ms)
                if _chaos_rows(rows) != oracle[q]:
                    rec["wrong_answers"] += 1

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(n)]
    t_soak = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    soak_s = time.monotonic() - t_soak

    # post-write rerun: the cached counter read must reflect the write
    # (catalog-version invalidation), not the cached page
    client = Client(coord.uri, user="writer")
    pre = client.execute("SELECT count(*) FROM memory.s.counters").rows
    again = client.execute("SELECT count(*) FROM memory.s.counters").rows
    client.execute("INSERT INTO memory.s.counters VALUES (3, 30)")
    post = client.execute("SELECT count(*) FROM memory.s.counters").rows
    rec["invalidation_proven"] = (pre == again ==
                                  [[2]]) and post == [[3]]

    after = REGISTRY.snapshot()

    def delta(*key):
        return int(after.get(tuple(key), 0) - reg0.get(tuple(key), 0))

    rec["throughput_qps"] = round(rec["queries"] / max(soak_s, 1e-9), 1)
    rec["soak_seconds"] = round(soak_s, 2)
    rec["mixes"] = {}
    for m in mix_names:
        vals = sorted(latencies[m])
        rec["mixes"][m] = {
            "queries": len(vals),
            "p50_ms": round(_percentile(vals, 0.50), 1),
            "p99_ms": round(_percentile(vals, 0.99), 1)}
    rec["plan_cache_hits"] = delta("trino_tpu_plan_cache_hits_total")
    rec["plan_cache_misses"] = delta("trino_tpu_plan_cache_misses_total")
    rec["result_cache_hits"] = delta("trino_tpu_result_cache_hits_total")
    rec["result_cache_invalidations"] = delta(
        "trino_tpu_result_cache_invalidations_total")
    rec["router_host"] = delta("trino_tpu_router_decisions_total", "host")
    rec["router_device"] = delta("trino_tpu_router_decisions_total",
                                 "device")
    rec["microbatch_queries"] = delta(
        "trino_tpu_microbatch_queries_total")
    rec["microbatch_batches"] = delta(
        "trino_tpu_microbatch_batches_total")
    rec["elapsed_s"] = round(time.monotonic() - t_start, 1)
    rec["passed"] = (rec["wrong_answers"] == 0 and
                     rec["failed_queries"] == 0 and
                     rec["queries"] == n * per and
                     rec["result_cache_hits"] > 0 and
                     rec["plan_cache_hits"] > 0 and
                     rec["router_host"] > 0 and
                     rec["router_device"] > 0 and
                     rec["invalidation_proven"])
    coord.stop()
    os.unlink(hist)
    return _emit(rec, out_path)


# ---------------------------------------------------------------------------
# elastic: drain and join under multi-tenant load and chaos
# ---------------------------------------------------------------------------

def elastic_soak(duration_s=None, out_path=None, device="cuda"):
    """Sustained elastic-membership soak: a mixed workload — point +
    cached + scan-heavy + writes across >= 3 tenants — with chaos
    injection, per-tenant soft memory limits, and host/device routing
    all ON simultaneously, while a worker is admin-drained (PUT
    /v1/info/state) and a fresh worker joins mid-run. Gated on: 0 wrong
    answers (every read bit-exact vs a pre-server oracle, every write
    accounted for in a final count), 0 failed queries, 0 orphaned
    splits on the drained worker, the drain reaching LEFT, the joiner
    actually receiving splits, and per-tenant p99 SLOs — the fair-share
    acceptance is that beta (the saturating scan tenant) cannot push
    alpha's point p99 past its SLO, because alpha's host-eligible
    queries overflow to the lock-free host tier under device
    contention. Each p99 past its SLO adds one to
    trino_tpu_soak_slo_violations_total."""
    from urllib.request import Request, urlopen

    from .client.client import Client
    from .exec.session import Session
    from .metrics import REGISTRY, SOAK_SLO_VIOLATIONS
    from .server.coordinator import CoordinatorServer
    from .server.failuredetector import HeartbeatFailureDetector
    from .server.failureinjector import FailureInjector
    from .server.resourcegroups import tenant_tree
    from .server.security import internal_headers
    from .server.telemetry import histogram_deltas, percentile_from_buckets
    from .server.worker import WorkerServer

    dur = duration_s if duration_s is not None else \
        float(os.environ.get("TRINO_TPU_SOAK_DURATION_S", 180))
    per_tenant = int(os.environ.get("TRINO_TPU_SOAK_CLIENTS", 3))
    # cluster flight recorder cadence: ~20 samples over the soak so the
    # p99-over-time series has real resolution even on a short run
    tel_interval = float(os.environ.get("TRINO_TPU_SOAK_TELEMETRY_S",
                                        0)) or max(0.5, dur / 20.0)
    slo_ms = {
        "alpha": float(os.environ.get("TRINO_TPU_SOAK_SLO_ALPHA_MS",
                                      5000)),
        "beta": float(os.environ.get("TRINO_TPU_SOAK_SLO_BETA_MS",
                                     60000)),
        "gamma": float(os.environ.get("TRINO_TPU_SOAK_SLO_GAMMA_MS",
                                      5000)),
    }
    t_start = time.monotonic()
    hist, saved_hist = _fresh_history("soak_hist_")

    session = Session(default_schema="tiny", device=device)
    session.execute(
        "CREATE TABLE memory.s.soak_log (k bigint, v bigint)")

    # tenant mixes: (sql, unordered, is_write). alpha = interactive
    # point/cached traffic (host tier), beta = scan-heavy distributed
    # saturator (device tier + cluster), gamma = cached reads + writes
    # (writes also bump the catalog version, which keeps invalidating
    # the result cache so beta's scans stay honest distributed work)
    mixes = {
        "alpha": [(f"SELECT n_name FROM nation WHERE n_nationkey = {k}",
                   False, False) for k in range(12)] +
                 [("SELECT r_name FROM region ORDER BY r_name",
                   False, False)],
        "beta": [(q, unordered, False)
                 for q, unordered in CHAOS_QUERIES.values()],
        "gamma": [("INSERT INTO memory.s.soak_log VALUES (1, 1)",
                   False, True),
                  ("SELECT count(*) FROM supplier", False, False),
                  ("SELECT min(s_suppkey), max(s_suppkey) FROM supplier",
                   False, False)],
    }
    oracle = {}
    for qs in mixes.values():
        for q, unordered, is_write in qs:
            if not is_write:
                rows = _chaos_rows(session.execute(q).rows)
                oracle[q] = sorted(rows) if unordered else rows

    session.properties["enable_result_cache"] = True
    session.properties["enable_microbatch"] = True
    # keep the host tier for genuinely small queries only: beta's
    # lineitem scans (~60k rows) must stay device/cluster work so the
    # drain/join path is exercised by real split placement, while
    # alpha's point lookups remain host-eligible for fair-share
    # overflow under contention
    session.properties["router_host_max_rows"] = 4096
    coord = CoordinatorServer(session, max_concurrency=16,
                              retry_policy="QUERY",
                              telemetry_interval_s=tel_interval).start()
    _restore_history(saved_hist)
    # per-tenant isolation: one resource group per tenant with a soft
    # memory limit, fair-share routing reads the tenant off each query
    coord.state.dispatcher.resource_groups = tenant_tree(
        {"alpha": {"hard_concurrency_limit": 8},
         "beta": {"hard_concurrency_limit": 4,
                  "soft_memory_limit_bytes": 1 << 31},
         "gamma": {"hard_concurrency_limit": 4}},
        max_queued=100_000)
    sched = coord.state.scheduler
    sched.split_rows = 8192
    sched.max_task_retries = 8
    sched.hedge_min_s, sched.hedge_multiplier = 0.5, 2.0
    workers = [WorkerServer(f"soak-w{i}", coord.uri,
                            announce_interval_s=0.1,
                            heartbeat_interval_s=0.1,
                            catalog=session.catalog,
                            drain_timeout_s=60.0,
                            telemetry_interval_s=tel_interval,
                            device=device).start()
               for i in range(3)]
    detector = HeartbeatFailureDetector(coord.state,
                                        interval_s=0.2).start()
    coord.state.memory_manager.start()

    def wait_active(k, timeout=10.0):
        deadline = time.time() + timeout
        while len(coord.state.active_nodes()) < k and \
                time.time() < deadline:
            time.sleep(0.05)
        return len(coord.state.active_nodes()) >= k

    wait_active(3)
    stats0 = dict(sched.stats)
    reg0 = REGISTRY.snapshot()
    # baseline flight-recorder sample: the first sample of a fresh ring
    # carries counter totals since process start; everything after this
    # timestamp is genuine per-interval soak deltas
    telemetry = coord.state.telemetry
    tel_baseline_ts = telemetry.recorder.sample_once()["ts"]
    lock = threading.Lock()
    latencies = {t: [] for t in mixes}
    rec = {"metric": "soak", "duration_s": dur, "queries": 0,
           "wrong_answers": 0, "failed_queries": 0, "writes_ok": 0,
           "chaos_schedules": 0, "injected_total": 0}
    stop_at = time.monotonic() + dur
    mismatches = []

    def one(tenant: str, i: int) -> None:
        qs = mixes[tenant]
        client = Client(coord.uri, user=f"{tenant}-{i}", timeout_s=180,
                        poll_interval_s=0.005)
        j = 0
        while time.monotonic() < stop_at:
            q, unordered, is_write = qs[(i + j) % len(qs)]
            j += 1
            t0 = time.monotonic()
            try:
                rows = client.execute(q).rows
            except Exception as e:  # noqa: BLE001 — any failure counts
                with lock:
                    rec["failed_queries"] += 1
                    if len(mismatches) < 5:
                        mismatches.append(f"{tenant}: {q[:60]}: {e}")
                continue
            ms = (time.monotonic() - t0) * 1000
            with lock:
                rec["queries"] += 1
                latencies[tenant].append(ms)
                if is_write:
                    rec["writes_ok"] += 1
                else:
                    got = _chaos_rows(rows)
                    if unordered:
                        got = sorted(got)
                    if got != oracle[q]:
                        rec["wrong_answers"] += 1
                        if len(mismatches) < 5:
                            mismatches.append(f"{tenant}: {q[:60]}")

    threads = [threading.Thread(target=one, args=(t, i), daemon=True)
               for t in mixes for i in range(per_tenant)]
    t_soak = time.monotonic()
    for t in threads:
        t.start()

    # --- the orchestrated membership events, chaos rotating throughout
    drain_at = t_soak + dur * 0.30
    join_at = t_soak + dur * 0.45
    next_chaos = t_soak
    w0, w3 = workers[0], None
    drain_requested = False
    seed = 0
    last_inj = None
    while time.monotonic() < stop_at:
        now = time.monotonic()
        if now >= next_chaos:
            inj = FailureInjector.from_seed(seed, max_delay_s=0.5)
            seed += 1
            sched.failure_injector = inj
            detector.injector = inj
            for w in workers:
                w.task_manager.injector = inj
            # drop spooled stage outputs so repeat fingerprints dispatch
            # REAL tasks: the soak must exercise live split placement
            # (and the drain/join membership), not replay the durable
            # spool's dedup of identical (fragment, splits) work
            sched.spool.clear()
            rec["chaos_schedules"] += 1
            if last_inj is not None:
                rec["injected_total"] += last_inj.injected_count
            last_inj = inj
            next_chaos = now + max(2.0, dur / 12.0)
        if not drain_requested and now >= drain_at:
            req = Request(f"{w0.uri}/v1/info/state",
                          data=json.dumps({"state": "DRAINING"}).encode(),
                          method="PUT",
                          headers={"Content-Type": "application/json",
                                   **internal_headers()})
            with urlopen(req, timeout=10) as resp:
                assert resp.status == 200, resp.status
            drain_requested = True
        if w3 is None and now >= join_at:
            w3 = WorkerServer("soak-w3", coord.uri,
                              announce_interval_s=0.1,
                              heartbeat_interval_s=0.1,
                              catalog=session.catalog,
                              telemetry_interval_s=tel_interval,
                              device=device).start()
            workers.append(w3)
            sched.spool.clear()   # next scans place splits on the joiner
        time.sleep(0.05)
    if last_inj is not None:
        rec["injected_total"] += last_inj.injected_count
    for t in threads:
        t.join(timeout=300)
    soak_s = time.monotonic() - t_soak
    sched.failure_injector = None
    detector.injector = None
    for w in workers:
        w.task_manager.injector = None

    # --- drain postconditions: w0 deregistered with nothing orphaned
    deadline = time.time() + 60
    while not w0.drained() and time.time() < deadline:
        time.sleep(0.05)
    rec["drain_completed"] = w0.drained()
    with coord.state.nodes_lock:
        rec["drained_node_deregistered"] = \
            w0.node_id not in coord.state.nodes
    rec["orphaned_splits"] = len(w0.task_manager.inflight()) + \
        len(w0.task_manager.unflushed())
    rec["join_received_splits"] = any(
        t.get("node") == "soak-w3" for t in sched.task_history)
    # write accounting: every acknowledged INSERT must be visible
    final = Client(coord.uri, user="gamma-audit").execute(
        "SELECT count(*) FROM memory.s.soak_log").rows
    rec["writes_visible"] = int(final[0][0]) == rec["writes_ok"]

    after = REGISTRY.snapshot()

    def delta(*key):
        return int(after.get(tuple(key), 0) - reg0.get(tuple(key), 0))

    rec["throughput_qps"] = round(rec["queries"] / max(soak_s, 1e-9), 1)
    rec["soak_seconds"] = round(soak_s, 2)
    rec["splits_migrated"] = sched.stats["splits_migrated"] - \
        stats0.get("splits_migrated", 0)
    rec["task_retries"] = sched.stats["task_retries"] - \
        stats0["task_retries"]
    rec["hedged_tasks"] = sched.stats["hedged_tasks"] - \
        stats0["hedged_tasks"]
    rec["lifecycle_transitions"] = {
        st: delta("trino_tpu_node_lifecycle_transitions_total", st)
        for st in ("ACTIVE", "DRAINING", "DRAINED", "LEFT", "FAILED")}
    rec["membership_rearbitrations"] = \
        coord.state.memory_manager.membership_rearbitrations
    rec["router_host"] = delta("trino_tpu_router_decisions_total",
                               "host")
    rec["router_device"] = delta("trino_tpu_router_decisions_total",
                                 "device")
    # --- p99-over-time from the cluster flight recorder. The SLO gate
    # reads its per-tenant p99 off the recorder's per-interval histogram
    # deltas of trino_tpu_tenant_query_seconds, with the client-side
    # latency list kept as the summary p50/p99 fields
    telemetry.collect()          # final round: flush the partial interval
    tel_samples = telemetry.recorder.since(tel_baseline_ts)
    tel_rec = {"interval_s": tel_interval,
               "samples": len(tel_samples),
               "ring_bytes": telemetry.recorder.ring_bytes(),
               "nodes": sorted({r[1] for r in telemetry.rows()}),
               "p99_series_ms": {}, "p99_ms": {},
               "interval_slo_violations": {}}
    fam = "trino_tpu_tenant_query_seconds"
    rec["tenants"] = {}
    slo_ok = True
    for tname in mixes:
        deltas = histogram_deltas(tel_samples, fam, labelval=tname)
        series, viol, merged = [], 0, {}
        for d in deltas:
            p = percentile_from_buckets(d["buckets"], 0.99)
            for le, c in d["buckets"]:
                merged[le] = merged.get(le, 0.0) + c
            if p is None:
                continue
            series.append([round(d["ts"], 3), round(p * 1000, 1)])
            if p * 1000 > slo_ms[tname]:
                viol += 1
                SOAK_SLO_VIOLATIONS.inc()
        soak_p99 = percentile_from_buckets(list(merged.items()), 0.99)
        tel_rec["p99_series_ms"][tname] = series
        tel_rec["p99_ms"][tname] = round(soak_p99 * 1000, 1) \
            if soak_p99 is not None else None
        tel_rec["interval_slo_violations"][tname] = viol
        # the gate: the recorder-derived whole-soak p99 within SLO
        ok = soak_p99 is not None and soak_p99 * 1000 <= slo_ms[tname]
        if not ok:
            SOAK_SLO_VIOLATIONS.inc()
            slo_ok = False
        vals = sorted(latencies[tname])
        p99 = round(_percentile(vals, 0.99), 1) if vals else 0.0
        rec["tenants"][tname] = {
            "queries": len(vals),
            "p50_ms": round(_percentile(vals, 0.50), 1) if vals else 0.0,
            "p99_ms": p99, "slo_ms": slo_ms[tname], "slo_ok": ok}
    # --- host/device utilization over the soak: per-interval deltas of
    # the cumulative busy counter (trino_tpu_node_busy_ms_total) out of
    # the flight-recorder ring, normalized to a fleet-wide busy
    # fraction. The in-process fleet shares one registry, so the
    # instantaneous busy-fraction gauge is last-writer-wins across
    # workers, while counter increments from every worker accumulate
    fam_busy = "trino_tpu_node_busy_ms_total"
    fleet = max(1, len(workers))
    busy_series = {}
    for tier in ("device", "host"):
        pts = []
        for s in tel_samples:
            iv_ms = s.get("interval_s", 0.0) * 1000
            if iv_ms <= 0:
                continue
            busy = s["values"].get(f"{fam_busy}|{tier}", 0.0)
            pts.append([round(s["ts"], 3),
                        round(min(1.0, busy / (iv_ms * fleet)), 4)])
        busy_series[tier] = pts
    tel_rec["busy_fraction_series"] = busy_series
    tel_rec["busy_fraction_mean"] = {
        tier: (round(sum(v for _, v in pts) / len(pts), 4) if pts
               else None)
        for tier, pts in busy_series.items()}
    rec["telemetry"] = tel_rec
    # live-stats folds landed (heartbeats actually streamed) + the
    # per-node utilization view the folds produced
    rec["live_stats_folds"] = coord.state.livestats.folds
    rec["utilization"] = coord.state.livestats.utilization()
    # the fair-share acceptance, stated explicitly: the saturating scan
    # tenant did not push the point tenant past its SLO
    rec["fair_share_held"] = rec["tenants"]["alpha"]["slo_ok"]
    if mismatches:
        rec["sample_failures"] = mismatches
    rec["elapsed_s"] = round(time.monotonic() - t_start, 1)
    rec["passed"] = (rec["wrong_answers"] == 0 and
                     rec["failed_queries"] == 0 and
                     rec["orphaned_splits"] == 0 and
                     rec["drain_completed"] and
                     rec["drained_node_deregistered"] and
                     rec["join_received_splits"] and
                     rec["writes_visible"] and
                     rec["queries"] > 0 and
                     slo_ok)
    detector.stop()
    coord.state.memory_manager.stop()
    for w in workers:
        w.stop()
    coord.stop()
    os.unlink(hist)
    return _emit(rec, out_path)


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def gates_held(rec: dict) -> bool:
    """Did a soak's record pass its gates? The chaos record has no
    `passed` key (as in the reference): its gates are 0 wrong answers,
    0 failed queries and at least one fault injected."""
    if rec.get("metric") == "chaos_soak":
        return (rec["wrong_answers"] == 0 and rec["failed_queries"] == 0
                and rec["injected_total"] > 0)
    return bool(rec.get("passed"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m trino_tpu_torch.soak",
        description="run one of the server tier's soaks and print "
                    "its record (exit 0 when its gates held)")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--chaos", action="store_true",
                      help="seeded fault-injection soak")
    mode.add_argument("--write-chaos", action="store_true",
                      help="exactly-once write soak: seeded kills at "
                           "every write-protocol boundary")
    mode.add_argument("--coordinator-chaos", action="store_true",
                      help="seeded coordinator-kill failover soak")
    mode.add_argument("--overload", action="store_true",
                      help="deadlines / cancellation / admission soak")
    mode.add_argument("--memory-pressure", action="store_true",
                      help="concurrent soak with every pool at 25%% of "
                           "the working set")
    mode.add_argument("--concurrency", action="store_true",
                      help="high-concurrency serving soak")
    mode.add_argument("--soak", action="store_true",
                      help="elastic soak: multi-tenant load + chaos + "
                           "drain/join mid-run")
    p.add_argument("--seeds", type=int, default=None,
                   help="chaos 50, write chaos 27, coordinator chaos 20")
    p.add_argument("--queries", type=int, default=None,
                   help="memory pressure: concurrent queries (24)")
    p.add_argument("--clients", type=int, default=None,
                   help="concurrency: clients (120)")
    p.add_argument("--queries-per-client", type=int, default=None,
                   help="concurrency: queries per client (5)")
    p.add_argument("--duration", type=float, default=None,
                   help="elastic soak: seconds (180)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--out", default=None,
                   help="also write the record to this JSON file")
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    kw = {"out_path": a.out, "device": a.device}
    if a.chaos:
        rec = chaos_soak(n_seeds=a.seeds, **kw)
    elif a.write_chaos:
        rec = write_chaos_soak(n_seeds=a.seeds, **kw)
    elif a.coordinator_chaos:
        rec = coordinator_chaos_soak(n_seeds=a.seeds, **kw)
    elif a.overload:
        rec = overload_soak(**kw)
    elif a.memory_pressure:
        rec = memory_pressure_soak(n_queries=a.queries, **kw)
    elif a.concurrency:
        rec = concurrency_soak(n_clients=a.clients,
                               queries_per_client=a.queries_per_client,
                               **kw)
    else:
        rec = elastic_soak(duration_s=a.duration, **kw)
    return 0 if gates_held(rec) else 1


if __name__ == "__main__":
    sys.exit(main())
