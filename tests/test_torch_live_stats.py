"""The port's live query observability on the CPU (tpch.tiny).

The reference's live-stats file (tests/test_live_stats.py) carried over
to `trino_tpu_torch`: streaming task heartbeats, split-weighted
progress, stuck/skew diagnosis, host/device utilization, mid-flight
system.runtime surfaces on a live 2-worker query, monotonic progress
reaching 1.0 at FINISHED through the client protocol, failover progress
re-derivation, stuck diagnosis on a chaos-frozen worker task, the
zero-overhead-off contract (no threads, byte-identical announce/terminal
wire format), and delta-heartbeat byte bounds under a 100-task fanout.
The parity cases at the end fold the same seeded heartbeat payloads
into both packages' stores and feed the same stats pages to both
progress lines.
"""

import json
import threading
import time

import pytest

from trino_tpu_torch.client.cli import ProgressLine, progress_enabled
from trino_tpu_torch.client.client import Client
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.metrics import REGISTRY
from trino_tpu_torch.server.coordinator import CoordinatorServer
from trino_tpu_torch.server.failureinjector import DELAY, FailureInjector
from trino_tpu_torch.server.livestats import LiveStatsStore
from trino_tpu_torch.server.tasks import TaskManager, WorkerTask
from trino_tpu_torch.server.worker import WorkerServer


def _counter_value(name: str) -> float:
    m = REGISTRY.render()
    for line in m.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    return 0.0


# ---------------------------------------------------------------------------
# store unit tests (no cluster)
# ---------------------------------------------------------------------------


def _entry(tid, state="RUNNING", done=0, total=4, rows=0, nbytes=0,
           wall=0.0, dev=0.0, host=0.0, comp=0.0):
    return {"taskId": tid, "state": state, "splitsDone": done,
            "splitsTotal": total, "rowsOut": rows, "bytesOut": nbytes,
            "wallMs": wall, "deviceMs": dev, "hostMs": host,
            "compileMs": comp}


def test_store_progress_split_weighted():
    ls = LiveStatsStore()
    ls.begin("q1")
    ls.register_task("q1", "q1.0.0", stage="source", node="w0",
                     splits_total=4)
    ls.register_task("q1", "q1.0.1", stage="source", node="w1",
                     splits_total=4)
    assert ls.progress("q1") == 0.0
    ls.fold("w0", {"seq": 1, "tasks": [_entry("q1.0.0", done=2)]})
    ls.fold("w1", {"seq": 1, "tasks": [_entry("q1.0.1", done=4,
                                              state="FINISHED")]})
    # (2 + 4) of 8 splits
    assert ls.progress("q1") == pytest.approx(0.75)
    # a late-registered task lowers the instantaneous ratio (6/9) but
    # the high-water clamp keeps the surfaced progress at 0.75
    ls.register_task("q1", "q1.1.0", stage="partitioned", node="w0")
    ls.fold("w0", {"seq": 2, "tasks": [_entry("q1.1.0", total=0,
                                              state="RUNNING")]})
    assert ls.progress("q1") == pytest.approx(0.75)
    # splitless tasks (exchange consumers) weigh one split, done at
    # FINISHED
    ls.begin("q2")
    ls.register_task("q2", "q2.0.0", stage="source", node="w0",
                     splits_total=4)
    ls.register_task("q2", "q2.1.0", stage="partitioned", node="w0")
    ls.fold("w0", {"seq": 3, "tasks": [
        _entry("q2.0.0", done=4, state="FINISHED"),
        _entry("q2.1.0", total=0, state="RUNNING")]})
    assert ls.progress("q2") == pytest.approx(4 / 5)
    ls.fold("w0", {"seq": 4, "tasks": [_entry("q2.1.0", total=0,
                                              state="FINISHED")]})
    assert ls.progress("q2") == 1.0


def test_store_progress_monotonic_high_water():
    ls = LiveStatsStore()
    ls.begin("q1")
    ls.register_task("q1", "t0", stage="source", splits_total=4)
    ls.fold("w0", {"seq": 1, "tasks": [_entry("t0", done=3)]})
    assert ls.progress("q1") == pytest.approx(0.75)
    # a replayed/stale delta folding lower counters must never move the
    # surfaced progress backwards (the high-water clamp)
    ls.fold("w0", {"seq": 2, "tasks": [_entry("t0", done=1)]})
    assert ls.progress("q1") == pytest.approx(0.75)
    ls.finish("q1")
    assert ls.progress("q1") == 1.0


def test_store_failover_rederives_progress_from_heartbeats():
    """A promoted coordinator re-registers ledger-assigned (query, task)
    pairs with NO stage/split attribution; the next heartbeat's entries
    carry splitsTotal and refill the counters — progress must be
    re-derivable from that alone."""
    ls = LiveStatsStore()
    ls.begin("q9")
    # failover reattach: ids only, like CoordinatorServer._replay_ledger
    ls.register_task("q9", "q9.0.0")
    ls.register_task("q9", "q9.0.1")
    assert ls.progress("q9") == 0.0
    ls.fold("w0", {"seq": 7, "tasks": [
        _entry("q9.0.0", done=4, total=4, state="FINISHED"),
        _entry("q9.0.1", done=1, total=4)]})
    assert ls.progress("q9") == pytest.approx(5 / 8)


def test_store_stuck_diagnosis_names_stage_and_task():
    class TQ:
        live_diagnosis = None

    tq = TQ()
    ls = LiveStatsStore(tracked_lookup=lambda qid: tq, stuck_after=3)
    ls.begin("q2")
    ls.register_task("q2", "q2.0.0", stage="source", node="w0",
                     splits_total=4)
    ls.register_task("q2", "q2.0.1", stage="source", node="w1",
                     splits_total=4)
    ls.register_task("q2", "q2.0.2", stage="source", node="w1",
                     splits_total=4)
    before = _counter_value("trino_tpu_stuck_queries_diagnosed_total")
    # w1's tasks finish; w0's task stalls mid-split with pathological
    # per-split wall (skew vs the finished peers' median)
    ls.fold("w1", {"seq": 1, "tasks": [
        _entry("q2.0.1", done=4, wall=40, state="FINISHED"),
        _entry("q2.0.2", done=4, wall=44, state="FINISHED")]})
    ls.fold("w0", {"seq": 1, "tasks": [_entry("q2.0.0", done=1, wall=400,
                                              host=400.0)]})
    assert tq.live_diagnosis is None
    # identical heartbeats from the node holding the live work: the
    # stale counter climbs to stuck_after and the diagnosis fires once
    for i in range(2, 6):
        ls.fold("w0", {"seq": i, "tasks": [_entry("q2.0.0", done=1,
                                                  wall=400, host=400.0)]})
    d = tq.live_diagnosis
    assert d is not None
    assert d["queryId"] == "q2"
    assert d["stage"] == "source"
    assert d["taskId"] == "q2.0.0"
    assert d["node"] == "w0"
    assert d["phase"] == "host"
    # 400ms/split vs the 10ms/split peer median -> huge skew ratio
    assert d["skewRatio"] > 4.0
    assert d["staleHeartbeats"] >= 3
    after = _counter_value("trino_tpu_stuck_queries_diagnosed_total")
    assert after == before + 1
    # advancing counters reset the stall and re-arm the diagnoser
    ls.fold("w0", {"seq": 9, "tasks": [_entry("q2.0.0", done=2,
                                              wall=500)]})
    with ls._lock:
        assert ls._queries["q2"]["stale_folds"] == 0
        assert not ls._queries["q2"]["diagnosed"]


def test_store_straggler_feed_flags_slow_running_task():
    ls = LiveStatsStore()
    ls.begin("q3")
    for i, (done, wall, state) in enumerate(
            [(4, 40, "FINISHED"), (4, 44, "FINISHED"), (1, 400,
                                                        "RUNNING")]):
        tid = f"q3.0.{i}"
        ls.register_task("q3", tid, stage="source", node=f"w{i}",
                         splits_total=4)
        ls.fold(f"w{i}", {"seq": 1, "tasks": [_entry(tid, done=done,
                                                     wall=wall,
                                                     state=state)]})
    assert ls.straggler_task_ids("q3", 4.0) == {"q3.0.2"}
    # finished tasks never hedge, and multiplier<=0 disables the feed
    assert ls.straggler_task_ids("q3", 0) == set()
    assert ls.straggler_task_ids("missing", 4.0) == set()


def test_store_utilization_rows_per_node_and_tier():
    ls = LiveStatsStore()
    ls.fold("w0", {"seq": 1, "tasks": [],
                   "busy": {"deviceMs": 120.0, "hostMs": 80.0},
                   "utilization": {"device": 0.6, "host": 0.4}})
    rows = ls.utilization()
    assert {(r["node_id"], r["tier"]) for r in rows} == \
        {("w0", "device"), ("w0", "host")}
    dev = next(r for r in rows if r["tier"] == "device")
    assert dev["busy_fraction"] == pytest.approx(0.6)
    assert dev["busy_ms"] == pytest.approx(120.0)


# ---------------------------------------------------------------------------
# delta heartbeats: byte-bounded under fanout
# ---------------------------------------------------------------------------


def test_delta_heartbeat_bounded_under_100_task_fanout():
    session = Session(default_schema="tiny", device="cpu")
    tm = TaskManager(session.catalog, node_id="fanout", device="cpu")
    for i in range(100):
        t = WorkerTask(task_id=f"qf.0.{i}", fragment_blob="", splits=[])
        t.state = "RUNNING"
        t.splits_done = i % 4
        t.rows_out = i * 10
        tm.tasks[t.task_id] = t
        tm._note_live_change(t)
    cursor, entries = tm.live_delta(0)
    assert len(entries) == 100
    # each entry is a bounded scalar record — no operators, spans or
    # manifests ride the heartbeat
    for e in entries:
        assert len(json.dumps(e)) < 256
        assert set(e) == {"taskId", "state", "splitsDone", "splitsTotal",
                          "rowsOut", "bytesOut", "wallMs", "deviceMs",
                          "hostMs", "compileMs", "seq"}
    # absolute values: idempotent folds
    by_id = {e["taskId"]: e for e in entries}
    assert by_id["qf.0.7"]["splitsDone"] == 3
    assert by_id["qf.0.7"]["rowsOut"] == 70
    # nothing changed since the cursor -> the idle heartbeat is empty
    cursor2, entries2 = tm.live_delta(cursor)
    assert entries2 == [] and cursor2 == cursor
    # only the tasks that moved ship on the next delta
    for tid in ("qf.0.3", "qf.0.42", "qf.0.99"):
        t = tm.tasks[tid]
        t.splits_done += 1
        tm._note_live_change(t)
    _, entries3 = tm.live_delta(cursor)
    assert {e["taskId"] for e in entries3} == \
        {"qf.0.3", "qf.0.42", "qf.0.99"}


# ---------------------------------------------------------------------------
# zero-overhead-off contract
# ---------------------------------------------------------------------------


def test_heartbeat_off_no_threads_and_identical_wire_format(monkeypatch):
    import trino_tpu_torch.server.worker as worker_mod

    session = Session(default_schema="tiny", device="cpu")
    coord = CoordinatorServer(
        Session(default_schema="tiny", device="cpu")).start()
    bodies = {}
    real_urlopen = worker_mod.urlopen

    def spy(req, timeout=5):
        url = getattr(req, "full_url", str(req))
        if url.endswith("/v1/announce"):
            doc = json.loads(req.data.decode())
            bodies[doc["nodeId"]] = doc
        return real_urlopen(req, timeout=timeout)

    monkeypatch.setattr(worker_mod, "urlopen", spy)
    w_off = WorkerServer("zo-off", coord.uri, announce_interval_s=30.0,
                         catalog=session.catalog, device="cpu").start()
    w_on = WorkerServer("zo-on", coord.uri, announce_interval_s=30.0,
                        heartbeat_interval_s=0.05,
                        catalog=session.catalog, device="cpu").start()
    try:
        # identical thread footprint: the heartbeat rides the announcer,
        # it never gets a thread of its own — and with the interval
        # unset nothing new runs at all
        assert len(w_off._threads) == 2
        assert len(w_on._threads) == 2
        assert not any("heartbeat" in th.name.lower()
                       for th in threading.enumerate())
        w_off.announce_once()
        w_on.announce_once()
        # heartbeats off -> the announce body is byte-identical to the
        # legacy wire format: exactly the five pre-round-21 keys
        assert set(bodies["zo-off"]) == \
            {"nodeId", "uri", "state", "now", "tasks"}
        # heartbeats on -> same keys plus the live piggyback
        assert set(bodies["zo-on"]) == \
            {"nodeId", "uri", "state", "now", "tasks", "liveStats",
             "memory"}
        assert set(bodies["zo-on"]["liveStats"]) == \
            {"seq", "tasks", "busy", "utilization"}
    finally:
        w_on.stop()
        w_off.stop()
        coord.stop()


def test_terminal_status_ignores_live_fields():
    """The live stamps (live_seq, started_at, tier ms) must never leak
    into the terminal status wire format: a task that streamed live
    stats serializes byte-identically to one that never did."""
    session = Session(default_schema="tiny", device="cpu")
    tm = TaskManager(session.catalog, node_id="n", device="cpu")

    def mk():
        t = WorkerTask(task_id="t0", fragment_blob="", splits=[])
        t.state = "FINISHED"
        t.rows_out, t.bytes_out, t.splits_done = 5, 100, 2
        t.stats = {"rowsOut": 5, "bytesOut": 100, "splitsDone": 2,
                   "wallMs": 1.5}
        return t

    plain, lived = mk(), mk()
    lived.live_seq = 999
    lived.started_at = 123.0
    lived.device_ms, lived.host_ms, lived.compile_ms = 9.0, 8.0, 7.0
    assert json.dumps(tm.status_json(plain), sort_keys=True) == \
        json.dumps(tm.status_json(lived), sort_keys=True)


# ---------------------------------------------------------------------------
# CLI progress line
# ---------------------------------------------------------------------------


class _Out:
    def __init__(self, atty=True):
        self.buf = []
        self.atty = atty

    def write(self, s):
        self.buf.append(s)

    def flush(self):
        pass

    def isatty(self):
        return self.atty


def test_progress_line_monotonic_and_cleared():
    out = _Out()
    pl = ProgressLine(out=out)
    pl.update({"state": "RUNNING", "progressRatio": 0.5,
               "stage": "source"})
    assert pl.ratio == 0.5
    # a re-derived (post-failover) lower ratio never moves the bar back
    pl.update({"state": "RUNNING", "progressRatio": 0.2})
    assert pl.ratio == 0.5
    pl.update({"state": "FINISHED"})
    assert pl.ratio == 1.0
    assert "100%" in out.buf[-2] + out.buf[-1]
    pl.clear()
    assert out.buf[-1].endswith("\r")


def test_progress_enabled_tty_pipe_dumb(monkeypatch):
    monkeypatch.setenv("TERM", "xterm-256color")
    assert progress_enabled("always", out=_Out(atty=False))
    assert not progress_enabled("never", out=_Out(atty=True))
    assert progress_enabled("auto", out=_Out(atty=True))
    assert not progress_enabled("auto", out=_Out(atty=False))
    monkeypatch.setenv("TERM", "dumb")
    assert not progress_enabled("auto", out=_Out(atty=True))


# ---------------------------------------------------------------------------
# cluster: mid-flight surfaces, progress through the protocol, stuck
# diagnosis on a frozen worker
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    session = Session(default_schema="tiny", device="cpu")
    coord = CoordinatorServer(session).start()
    coord.state.scheduler.split_rows = 8192
    workers = [WorkerServer(f"ls-w{i}", coord.uri,
                            announce_interval_s=0.1,
                            heartbeat_interval_s=0.05,
                            catalog=session.catalog, device="cpu").start()
               for i in range(2)]
    deadline = time.time() + 5
    while len(coord.state.active_nodes()) < 2 and time.time() < deadline:
        time.sleep(0.05)
    yield coord, workers, session
    for w in workers:
        w.stop()
    coord.stop()


@pytest.fixture(autouse=True)
def _clean(request):
    if "cluster" not in request.fixturenames:
        yield
        return
    coord, workers, _ = request.getfixturevalue("cluster")
    coord.state.scheduler.spool.clear()
    yield
    for w in workers:
        w.task_manager.injector = None
    deadline = time.time() + 5
    while len(coord.state.active_nodes()) < 2 and time.time() < deadline:
        time.sleep(0.05)


DIST_SQL = ("SELECT l_returnflag, count(*) AS c FROM lineitem "
            "GROUP BY l_returnflag ORDER BY l_returnflag")


def _run_async(uri, sql):
    box = {}

    def go():
        try:
            box["result"] = Client(uri, user="live").execute(sql)
        except Exception as e:             # noqa: BLE001 — surfaced below
            box["error"] = e

    th = threading.Thread(target=go, daemon=True)
    th.start()
    return th, box


def test_midflight_live_surfaces_populated(cluster):
    coord, workers, session = cluster
    want = session.execute(DIST_SQL).rows
    # warm worker-side fragments so the in-flight window is dominated by
    # the injected delays, not XLA compile
    Client(coord.uri, user="live").execute(DIST_SQL)
    coord.state.scheduler.spool.clear()
    ls = coord.state.livestats
    folds_before = ls.folds
    hb_before = _counter_value("trino_tpu_task_heartbeats_total")
    inj = FailureInjector(seed=211)
    # per-split delays on one worker hold the query observably in flight
    inj.inject("WORKER_TASK_RUN", times=8, fault=DELAY, delay_s=0.35)
    workers[0].task_manager.injector = inj
    th, box = _run_async(coord.uri, DIST_SQL)
    try:
        # wait until heartbeats have folded live task state for the query
        qid = None
        deadline = time.time() + 6
        while time.time() < deadline and qid is None:
            for rec in ls.live_queries():
                if rec["state"] == "RUNNING" and rec["tasks"] > 0:
                    qid = rec["query_id"]
                    break
            time.sleep(0.02)
        assert qid, "no live query surfaced while in flight"

        sys_client = Client(coord.uri, user="live-observer")
        # system.runtime.live_queries reflects the in-flight query
        r = sys_client.execute(
            "SELECT query_id, state, progress, tasks, splits_total, "
            "rows FROM system.runtime.live_queries")
        rows = {row[0]: row for row in r.rows}
        assert qid in rows
        _, state, progress, tasks, splits_total, _ = rows[qid]
        assert state in ("RUNNING", "FINISHED")
        assert tasks >= 1
        assert 0.0 <= progress <= 1.0

        # system.runtime.tasks carries the heartbeat-streamed live rows
        r = sys_client.execute(
            "SELECT query_id, task_id, state, splits FROM "
            "system.runtime.tasks")
        live_rows = [row for row in r.rows if row[0] == qid]
        assert live_rows, "no live task rows for the in-flight query"

        # /v1/query/{id} folds the live rollup mid-flight
        info = sys_client.query_info(qid)
        assert info["liveStats"] is not None
        assert info["liveStats"]["stages"], info["liveStats"]
        assert 0.0 <= info["progressRatio"] <= 1.0
    finally:
        th.join(timeout=30)
    assert "error" not in box, box.get("error")
    assert box["result"].state == "FINISHED"
    assert [tuple(r) for r in box["result"].rows] == \
        [tuple(r) for r in want]
    # the streams actually flowed
    assert ls.folds > folds_before
    assert _counter_value("trino_tpu_task_heartbeats_total") > hb_before
    # terminal view: forced to exactly 1.0
    info = Client(coord.uri, user="live").query_info(box["result"].query_id)
    assert info["progressRatio"] == 1.0


def test_progress_monotonic_through_protocol_pages(cluster):
    coord, workers, session = cluster
    inj = FailureInjector(seed=212)
    inj.inject("WORKER_TASK_RUN", times=6, fault=DELAY, delay_s=0.2)
    workers[1].task_manager.injector = inj
    seen = []
    client = Client(coord.uri, user="live", poll_interval_s=0.02,
                    on_progress=lambda s: seen.append(dict(s)))
    r = client.execute(DIST_SQL)
    assert r.state == "FINISHED"
    ratios = [s["progressRatio"] for s in seen if "progressRatio" in s]
    assert ratios, "protocol stats pages carried no progressRatio"
    assert all(0.0 <= x <= 1.0 for x in ratios)
    assert all(b >= a for a, b in zip(ratios, ratios[1:])), ratios
    assert ratios[-1] == 1.0
    assert seen[-1]["state"] == "FINISHED"


def test_stuck_diagnosis_fires_on_frozen_worker_task(cluster):
    coord, workers, session = cluster
    ls = coord.state.livestats
    sched = coord.state.scheduler
    # warm fragments so the freeze is the only thing holding the query
    Client(coord.uri, user="live").execute(DIST_SQL)
    sched.spool.clear()
    # hedging OFF: the live-skew feed would otherwise hedge the frozen
    # task away within a few heartbeats (test_live_skew_evidence_hedges
    # covers that) and the stall would never reach the stuck threshold
    old_multiplier = sched.hedge_multiplier
    sched.hedge_multiplier = 0
    inj = FailureInjector(seed=213)
    # freeze the first task that starts anywhere, mid-RUNNING (shared
    # times=1 rule: exactly one freeze, whichever worker hits it first)
    inj.inject("WORKER_TASK_RUN", times=1, fault=DELAY, delay_s=1.8)
    for w in workers:
        w.task_manager.injector = inj
    stuck_before = _counter_value("trino_tpu_stuck_queries_diagnosed_total")
    old_stuck_after = ls.stuck_after
    ls.stuck_after = 3
    # earlier queries in this module may carry their own diagnoses —
    # only a diagnosis on THIS test's query counts
    pre = {r["query_id"] for r in ls.live_queries()}
    th, box = _run_async(coord.uri, DIST_SQL)
    try:
        d = None
        deadline = time.time() + 10
        while time.time() < deadline and d is None:
            for rec in ls.live_queries():
                if rec["query_id"] in pre or not rec["stuck"]:
                    continue
                q = coord.state.tracker.get(rec["query_id"])
                d = getattr(q, "live_diagnosis", None)
                break
            time.sleep(0.02)
        assert inj.events, "the freeze never fired"
        frozen_task = inj.events[0][3].split(":")[0]
        frozen_node = next(
            w.node_id for w in workers
            if frozen_task in w.task_manager.tasks)
        assert d is not None, "no stuck diagnosis while a task was frozen"
        # the diagnosis names the frozen task, its node and its stage
        assert d["taskId"] == frozen_task
        assert d["node"] == frozen_node
        assert d["stage"]
        roll = ls.query_rollup(d["queryId"])
        assert d["taskId"] in {t["task_id"] for t in roll["tasks"]}
        assert d["staleHeartbeats"] >= 3
        assert d["phase"] in ("compile", "device", "host",
                              "exchange-wait")
        # ...and is surfaced on /v1/query/{id}
        info = Client(coord.uri, user="live").query_info(d["queryId"])
        assert info["diagnosis"] is not None
        assert info["diagnosis"]["taskId"] == d["taskId"]
    finally:
        ls.stuck_after = old_stuck_after
        sched.hedge_multiplier = old_multiplier
        th.join(timeout=30)
    assert "error" not in box, box.get("error")
    assert box["result"].state == "FINISHED"
    assert _counter_value("trino_tpu_stuck_queries_diagnosed_total") > \
        stuck_before


def test_live_skew_evidence_hedges_frozen_task(cluster):
    """The straggler feed in action: a task frozen mid-RUNNING is
    flagged by heartbeat-observed pace skew and its unit hedges on a
    survivor IMMEDIATELY — well before the wall-clock hedge threshold
    (hedge_min_s, default 2s) would fire — so the query finishes fast
    with exact rows."""
    coord, workers, session = cluster
    sched = coord.state.scheduler
    want = [tuple(r) for r in session.execute(DIST_SQL).rows]
    Client(coord.uri, user="live").execute(DIST_SQL)
    sched.spool.clear()
    inj = FailureInjector(seed=214)
    inj.inject("WORKER_TASK_RUN", times=1, fault=DELAY, delay_s=3.0)
    for w in workers:
        w.task_manager.injector = inj
    hedged_before = sched.stats["hedged_tasks"]
    t0 = time.monotonic()
    r = Client(coord.uri, user="live").execute(DIST_SQL)
    wall = time.monotonic() - t0
    assert r.state == "FINISHED"
    assert [tuple(row) for row in r.rows] == want
    assert sched.stats["hedged_tasks"] > hedged_before
    # live evidence beat both the 3s freeze and the 2s hedge_min_s
    assert wall < 1.8, \
        f"hedge waited for the wall-clock threshold: {wall:.2f}s"


def test_utilization_table_and_memory_refresh(cluster):
    coord, workers, session = cluster
    Client(coord.uri, user="live").execute(DIST_SQL)
    # heartbeats carried busy fractions for both workers
    deadline = time.time() + 3
    while time.time() < deadline:
        util = coord.state.livestats.utilization()
        if {r["node_id"] for r in util} >= {w.node_id for w in workers}:
            break
        time.sleep(0.05)
    r = Client(coord.uri, user="live").execute(
        "SELECT node_id, tier, busy_fraction FROM "
        "system.runtime.utilization")
    nodes = {row[0] for row in r.rows}
    assert {w.node_id for w in workers} <= nodes
    tiers = {row[1] for row in r.rows}
    assert tiers == {"device", "host"}
    assert all(0.0 <= row[2] <= 1.0 for row in r.rows)
    # satellite: heartbeat pool snapshots refresh node memory inventory
    # between announces
    with coord.state.nodes_lock:
        mems = [n.memory for n in coord.state.nodes.values()
                if n.node_id in {w.node_id for w in workers}]
    assert mems and all(m for m in mems)


# ---------------------------------------------------------------------------
# parity with the reference on the same payloads
# ---------------------------------------------------------------------------

def _store_trail(cls, seed):
    """Register seeded tasks and fold seeded heartbeats (stale and
    repeated ones included); every surface read after each fold."""
    import random
    rng = random.Random(seed)
    ls = cls(stuck_after=3)
    ls.begin("q")
    tasks = {}
    for i in range(6):
        tid = f"q.{i // 3}.{i}"
        total = rng.choice([0, 2, 4, 8])
        ls.register_task("q", tid, stage=("source", "partitioned")[i // 3],
                         node=f"w{i % 2}", splits_total=total)
        tasks[tid] = [0, total, 0.0]
    trail = []
    for seq in range(1, 25):
        node = f"w{seq % 2}"
        entries = []
        for tid in rng.sample(sorted(tasks), 3):
            done, total, wall = tasks[tid]
            if rng.random() < 0.7:
                done = min(done + rng.choice([0, 1, 2]), max(total, 1))
                wall += rng.choice([5.0, 40.0, 400.0])
            stale = max(done - rng.choice([0, 1]), 0)
            tasks[tid] = [done, total, wall]
            state = "FINISHED" if total and done >= total else "RUNNING"
            entries.append(_entry(tid, state=state, done=stale,
                                  total=total, rows=10 * done, wall=wall,
                                  dev=wall / 2, host=wall / 2))
        ls.fold(node, {"seq": seq, "tasks": entries,
                       "busy": {"deviceMs": 3.0 * seq, "hostMs": 2.0},
                       "utilization": {"device": 0.25, "host": 0.5}})
        trail.append((ls.progress("q"), ls.dominant_stage("q"),
                       sorted(ls.straggler_task_ids("q", 4.0))))
    ls.finish("q")
    trail.append(ls.progress("q"))
    trail.append(sorted((r["node_id"], r["tier"], r["busy_fraction"],
                         r["busy_ms"]) for r in ls.utilization()))
    return trail


@pytest.mark.parametrize("seed", range(4))
def test_store_trail_equals_reference(seed, monkeypatch):
    from trino_tpu.server.livestats import LiveStatsStore as JaxStore
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    monkeypatch.setattr(time, "monotonic", lambda: 50.0)
    assert _store_trail(LiveStatsStore, seed) == \
        _store_trail(JaxStore, seed)


def test_progress_line_output_equals_reference():
    from trino_tpu.client.cli import ProgressLine as JaxProgressLine
    pages = [{"state": "QUEUED"},
             {"state": "RUNNING", "progressRatio": 0.25,
              "stage": "source"},
             {"state": "RUNNING", "progressRatio": 0.1},
             {"state": "RUNNING", "progressRatio": 0.75,
              "stage": "partitioned"},
             {"state": "FINISHED"}]
    outs = []
    for cls in (ProgressLine, JaxProgressLine):
        out = _Out()
        pl = cls(out=out)
        ratios = []
        for p in pages:
            pl.update(p)
            ratios.append(pl.ratio)
        pl.clear()
        outs.append((out.buf, ratios))
    assert outs[0] == outs[1]
