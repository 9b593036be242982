"""The port's coordinator crash recovery on the CPU (tpch.tiny).

The reference's failover file (tests/test_failover.py) carried over to
`trino_tpu_torch`: the durable query ledger replays idempotently from
every byte prefix (torn tail included) and under double replay; a
coordinator killed at each query lifecycle state (QUEUED / PLANNING /
RUNNING / FINISHING / write-commit) is replaced by a promoted standby
that resumes every non-terminal query under its ORIGINAL id; the
polling client fails over across the coordinator address list and
finishes with bit-exact rows and no client-visible error; epoch
fencing stops a resurrected old primary from split-brain; workers
buffer terminal task reports while no coordinator listens and
re-deliver them after re-announcing.

The parity cases at the end hold the port to the reference on the same
inputs: the ledger's bytes after the same appends, the state machine's
stamps, and a port standby that replays a ledger written by a JAX
primary and answers with the reference's rows.
"""

import json
import os
import threading
import time

import pytest

from trino_tpu_torch.client.client import Client
from trino_tpu_torch.connectors.orcdir import OrcConnector
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.server import ledger as led
from trino_tpu_torch.server import writeprotocol as wp
from trino_tpu_torch.server.coordinator import CoordinatorServer
from trino_tpu_torch.server.exchange_spool import ExchangeSpool
from trino_tpu_torch.server.failureinjector import FailureInjector
from trino_tpu_torch.server.ledger import LedgerView, QueryLedger, replay_path
from trino_tpu_torch.server.statemachine import QueryStateMachine
from trino_tpu_torch.server.worker import WorkerServer

SQL = ("SELECT n_regionkey, count(*) AS c FROM nation "
       "GROUP BY n_regionkey ORDER BY n_regionkey")
EXPECT = [[0, 5], [1, 5], [2, 5], [3, 5], [4, 5]]


# ---------------------------------------------------------------------------
# ledger: framing, prefix/torn-tail replay, double-replay idempotence
# ---------------------------------------------------------------------------

def _scripted_records(qid="20260101_000000_00001_tpu"):
    """A representative record sequence: admission through terminal,
    with assignments and a spool pointer in between."""
    return [
        {"rec": "admit", "query": qid, "sql": SQL, "user": "alice",
         "tenant": "root", "fingerprint": "fp1", "properties": {},
         "ts": 1.0},
        {"rec": "state", "query": qid, "state": "PLANNING", "ts": 2.0},
        {"rec": "state", "query": qid, "state": "RUNNING", "ts": 3.0},
        {"rec": "assign", "query": qid, "task": f"{qid}.0.0",
         "node": "w1", "stage": "partial", "ts": 3.5},
        {"rec": "spool", "query": qid, "key": "k" * 32, "ts": 4.0},
        {"rec": "state", "query": qid, "state": "FINISHING", "ts": 5.0},
        {"rec": "terminal", "query": qid, "state": "FINISHED", "ts": 6.0,
         "error": None, "error_name": None, "error_code": 0, "rows": 5,
         "elapsed_s": 1.25, "catalog_version": 2},
    ]


def test_ledger_byte_prefix_replay_idempotent(tmp_path):
    """Every byte prefix of the ledger replays without error, torn
    tails are flagged, and each complete-frame boundary yields exactly
    the fold of the records before it (mirrors the write journal's
    prefix test)."""
    records = _scripted_records()
    frames = [wp._frame(r) for r in records]
    blob = b"".join(frames)
    boundaries = {0: 0}
    off = 0
    for i, fr in enumerate(frames):
        off += len(fr)
        boundaries[off] = i + 1
    for cut in range(len(blob) + 1):
        p = str(tmp_path / f"cut{cut:04d}.ledger")
        with open(p, "wb") as f:
            f.write(blob[:cut])
        view, torn = replay_path(p)
        if cut in boundaries:
            assert not torn, cut
            want = LedgerView()
            for r in records[:boundaries[cut]]:
                want.apply(r)
            assert view.fingerprint() == want.fingerprint(), cut
        else:
            # mid-frame cut: replay stops at the last whole frame
            assert torn, cut
        # replay is a pure function of the bytes: run it again
        again, _ = replay_path(p)
        assert again.fingerprint() == view.fingerprint(), cut


def test_ledger_double_replay_converges():
    """Applying the whole record stream twice (a standby that tailed,
    then replayed at promotion) equals applying it once."""
    records = _scripted_records()
    once = LedgerView()
    for r in records:
        once.apply(r)
    twice = LedgerView()
    for r in records + records:
        twice.apply(r)
    assert twice.fingerprint() == once.fingerprint()
    q = once.queries["20260101_000000_00001_tpu"]
    assert q["terminal"] == "FINISHED" and q["rows"] == 5
    assert q["state_times"]["QUEUED"] == 1.0
    assert list(q["assigned"]) == ["20260101_000000_00001_tpu.0.0"]
    assert once.catalog_version == 2


def test_ledger_view_state_is_monotonic():
    """Late/duplicate state records (re-delivered after a resume) never
    regress the view; the first terminal wins over a later one."""
    qid = "q"
    v = LedgerView()
    v.apply({"rec": "state", "query": qid, "state": "RUNNING", "ts": 3.0})
    v.apply({"rec": "state", "query": qid, "state": "PLANNING", "ts": 9.0})
    assert v.queries[qid]["state"] == "RUNNING"
    assert v.queries[qid]["state_times"]["PLANNING"] == 9.0
    v.apply({"rec": "terminal", "query": qid, "state": "FAILED",
             "ts": 4.0, "error": "boom", "error_name": "E", "rows": 0})
    v.apply({"rec": "terminal", "query": qid, "state": "FINISHED",
             "ts": 5.0, "rows": 7})
    assert v.queries[qid]["terminal"] == "FAILED"
    assert v.queries[qid]["error"] == "boom"


def test_ledger_append_replay_roundtrip(tmp_path):
    lg = QueryLedger(str(tmp_path / "q.ledger"), node_id="c1")
    lg.admit("q1", SQL, "alice", "root", "fp", {"p": 1, "obj": {"x": 1}})
    lg.state("q1", "RUNNING", 3.0)
    lg.assign("q1", "q1.0.0", "w1", "partial")
    lg.spool("q1", "abc")
    lg.terminal("q1", "FINISHED", 4.0, rows=5, elapsed_s=0.5,
                catalog_version=1)
    view, torn = lg.replay()
    assert not torn
    q = view.queries["q1"]
    assert q["sql"] == SQL and q["user"] == "alice"
    # non-scalar session properties are filtered at append time
    assert q["properties"] == {"p": 1}
    assert q["terminal"] == "FINISHED" and q["spooled"] == ["abc"]


# ---------------------------------------------------------------------------
# epoch fencing
# ---------------------------------------------------------------------------

def test_epoch_fences_deposed_writer(tmp_path):
    path = str(tmp_path / "q.ledger")
    a = QueryLedger(path, node_id="c1")
    a.claim_epoch()
    assert a.append({"rec": "state", "query": "q1", "state": "RUNNING",
                     "ts": 1.0})
    b = QueryLedger(path, node_id="c2")
    assert not b.owns_epoch()         # c1 holds the epoch
    epoch = b.claim_epoch()
    assert epoch == 2 and b.owns_epoch()
    # the deposed writer's cached ownership expires within the TTL and
    # its appends become no-ops — never an exception
    time.sleep(QueryLedger.EPOCH_TTL_S + 0.05)
    assert not a.append({"rec": "state", "query": "q1",
                         "state": "FINISHING", "ts": 2.0})
    view, _ = replay_path(path)
    assert "FINISHING" not in view.queries["q1"]["state_times"]
    assert view.epoch == 2


def test_sealed_ledger_refuses_appends(tmp_path):
    lg = QueryLedger(str(tmp_path / "q.ledger"), node_id="c1")
    assert lg.admit("q1", "SELECT 1", "u", "root", "fp", {})
    lg.seal()
    assert not lg.admit("q2", "SELECT 2", "u", "root", "fp", {})
    view, _ = lg.replay()
    assert list(view.queries) == ["q1"]


# ---------------------------------------------------------------------------
# statemachine: CANCELED parity with FAILED (satellite 3)
# ---------------------------------------------------------------------------

def test_cancel_records_timeline_and_taxonomy():
    sm = QueryStateMachine("q1")
    sm.transition("PLANNING")
    sm.transition("RUNNING")
    assert sm.cancel()
    assert sm.state == "CANCELED"
    assert "CANCELED" in sm.state_times          # timeline attribution
    assert sm.error_name == "USER_CANCELED" and sm.error_code == 2


def test_restored_statemachine_matches_original():
    """Ledger replay reconstructs a terminal state machine with the
    recorded stamps and error taxonomy — the timeline phases sum the
    same before and after, for CANCELED exactly like FAILED."""
    for final in ("CANCELED", "FAILED", "FINISHED"):
        sm = QueryStateMachine("q1")
        sm.transition("PLANNING")
        sm.transition("RUNNING")
        if final == "CANCELED":
            sm.cancel()
        elif final == "FAILED":
            sm.fail("boom", error_name="E", error_code=9)
        else:
            sm.transition("FINISHING")
            sm.transition("FINISHED")
        back = QueryStateMachine.restored(
            "q1", sm.state, dict(sm.state_times), error=sm.error,
            error_name=sm.error_name, error_code=sm.error_code)
        assert back.state == sm.state
        assert back.state_times == sm.state_times
        assert back.error_name == sm.error_name
        assert back.error_code == sm.error_code
        assert back.is_done()
        # restored terminal machines are settled from birth: there is
        # no completion pipeline left to wait for
        assert back.settled.is_set()


def test_terminal_page_waits_for_completion_pipeline():
    """A fast poller must never observe a terminal state before the
    terminal listeners (completion event, ledger record, metrics) have
    run: `settled` flips only after the listener sweep finishes."""
    sm = QueryStateMachine("q_settle")
    hits = []

    def slow_listener(state):
        if state == "FINISHED":
            time.sleep(0.2)
            hits.append(state)

    sm.add_listener(slow_listener)
    t = threading.Thread(target=lambda: [
        sm.transition(s)
        for s in ("PLANNING", "RUNNING", "FINISHING", "FINISHED")])
    t.start()
    deadline = time.time() + 5.0
    while sm.state != "FINISHED" and time.time() < deadline:
        time.sleep(0.002)
    # state is visible but the pipeline is still draining
    assert sm.state == "FINISHED"
    assert sm.settled.wait(2.0)
    assert hits == ["FINISHED"]
    t.join()
    # failed/canceled queries settle too — error pages are gated the
    # same way as result pages
    for ender in (lambda m: m.fail("boom"), lambda m: m.cancel()):
        m = QueryStateMachine("q_e")
        ender(m)
        assert m.settled.is_set()


# ---------------------------------------------------------------------------
# kill-at-each-state: a fresh coordinator resumes a forged ledger
# ---------------------------------------------------------------------------

def _forge_ledger(path, qid, sql, upto):
    """Write the ledger a primary killed at lifecycle state `upto`
    would leave behind."""
    old = QueryLedger(path, node_id="old")
    old.admit(qid, sql, "alice", "root", "fp", {})
    ts = 1.0
    for st in ("PLANNING", "RUNNING", "FINISHING"):
        if led._rank(st) <= led._rank(upto) and upto != "QUEUED":
            old.state(qid, st, ts)
            ts += 1.0
        if st == upto:
            break
    old.seal()


@pytest.mark.parametrize("upto,mode", [
    ("QUEUED", "replayed"), ("PLANNING", "replayed"),
    ("RUNNING", "reexecuted"), ("FINISHING", "reexecuted")])
def test_boot_replay_resumes_killed_query(tmp_path, upto, mode):
    """A coordinator booting over the dead primary's ledger resumes the
    in-flight query under its ORIGINAL id, classifies the resumption
    mode, and finishes it with the right answer."""
    from trino_tpu_torch.metrics import QUERIES_RESUMED
    path = str(tmp_path / "q.ledger")
    qid = "20260101_000000_00007_tpu"
    _forge_ledger(path, qid, SQL, upto)
    before = QUERIES_RESUMED.value(mode=mode)
    coord = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                              ledger_path=path, node_id="new")
    try:
        tq = coord.state.tracker.get(qid)
        assert tq is not None, "replay did not resume the query"
        assert tq.resumed == mode
        assert QUERIES_RESUMED.value(mode=mode) == before + 1
        deadline = time.time() + 30
        while not tq.state_machine.is_done() and time.time() < deadline:
            time.sleep(0.02)
        assert tq.state == "FINISHED"
        assert [list(r) for r in tq.result.rows] == EXPECT
        # the resumed run's ledger records landed under the new epoch
        view, _ = coord.state.ledger.replay()
        assert view.queries[qid]["terminal"] == "FINISHED"
        # double replay on the live coordinator is a no-op
        assert coord.state._replay_ledger() == 0
    finally:
        coord.state.dispatcher.pool.shutdown(wait=False)
        coord.stop()


def test_boot_replay_restores_terminal_queries(tmp_path):
    """Terminal queries replay byte-for-byte into the registry — state,
    stamps, error taxonomy, row counts — without re-executing."""
    path = str(tmp_path / "q.ledger")
    old = QueryLedger(path, node_id="old")
    old.admit("q_ok", SQL, "alice", "root", "fp", {})
    old.state("q_ok", "RUNNING", 2.0)
    old.terminal("q_ok", "FINISHED", 3.0, rows=5, elapsed_s=0.5)
    old.admit("q_bad", "SELECT nope", "bob", "root", "fp", {})
    old.terminal("q_bad", "FAILED", 2.5, error="column nope",
                 error_name="COLUMN_NOT_FOUND", error_code=47)
    old.admit("q_cxl", SQL, "eve", "root", "fp", {})
    old.state("q_cxl", "RUNNING", 2.0)
    old.terminal("q_cxl", "CANCELED", 2.7, error="Query was canceled",
                 error_name="USER_CANCELED", error_code=2)
    old.seal()
    coord = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                              ledger_path=path, node_id="new")
    try:
        ok = coord.state.tracker.get("q_ok")
        assert ok.state == "FINISHED" and ok.rows_returned == 5
        assert ok.resumed == "restored" and ok.result is None
        bad = coord.state.tracker.get("q_bad")
        assert bad.state == "FAILED"
        assert bad.state_machine.error_name == "COLUMN_NOT_FOUND"
        assert bad.state_machine.error_code == 47
        cxl = coord.state.tracker.get("q_cxl")
        assert cxl.state == "CANCELED"
        assert cxl.state_machine.error_name == "USER_CANCELED"
        # CANCELED lands in state_times exactly like FAILED: the
        # replayed timeline still sums (satellite 3)
        assert cxl.state_machine.state_times["CANCELED"] == 2.7
        assert cxl.state_machine.state_times["RUNNING"] == 2.0
    finally:
        coord.state.dispatcher.pool.shutdown(wait=False)
        coord.stop()


def test_restored_finished_query_reexecutes_on_data_poll(tmp_path):
    """A ledger-restored FINISHED query holds no result pages; the
    first data poll lazily re-executes it under the original id (reads
    are pure, so the client sees the exact rows it would have)."""
    path = str(tmp_path / "q.ledger")
    old = QueryLedger(path, node_id="old")
    old.admit("q_ok", SQL, "alice", "root", "fp", {})
    old.terminal("q_ok", "FINISHED", 3.0, rows=5, elapsed_s=0.5)
    old.seal()
    coord = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                              ledger_path=path, node_id="new").start()
    try:
        client = Client(coord.uri, user="alice")
        info = client.query_info("q_ok")
        assert info["state"] == "FINISHED"
        # polling the executing route re-runs the restored query
        r = client._request(
            "GET", f"{coord.uri}/v1/statement/executing/q_ok/0")
        deadline = time.time() + 30
        rows = r.get("data") or []
        while r.get("nextUri") and time.time() < deadline:
            r = client._poll(r["nextUri"])
            rows.extend(r.get("data") or [])
        assert [list(x) for x in rows] == EXPECT
    finally:
        coord.state.dispatcher.pool.shutdown(wait=False)
        coord.stop()


def test_resumed_committed_write_is_exactly_once(tmp_path):
    """A CTAS whose pre-crash attempt already published parts must NOT
    write again when its query resumes on the promoted coordinator: the
    resumed attempt short-circuits to the committed row count (the
    coordinator-death twin of round-18's duplicate-attempt dedup)."""
    root = str(tmp_path / "orc")
    os.makedirs(os.path.join(root, "out"))
    path = str(tmp_path / "q.ledger")
    src = ("SELECT o_orderkey, o_custkey, o_orderstatus, o_totalprice "
           "FROM tpch.tiny.orders")
    ctas = f"CREATE TABLE orc.out.t1 AS {src}"
    table_dir = os.path.join(root, "out", "t1")

    session1 = Session(default_schema="tiny", device="cpu")
    session1.catalog.register("orc", OrcConnector(root))
    first = CoordinatorServer(session1, ledger_path=path,
                              node_id="c1").start()
    first.state.scheduler.split_rows = 4096
    workers = [WorkerServer(f"wx{i}", first.uri, announce_interval_s=0.1,
                            catalog=session1.catalog, device="cpu").start()
               for i in range(2)]
    try:
        deadline = time.time() + 10
        while len(first.state.active_nodes()) < 2 and \
                time.time() < deadline:
            time.sleep(0.02)
        tq = first.state.dispatcher.submit(ctas, "alice")
        deadline = time.time() + 60
        while not tq.state_machine.is_done() and time.time() < deadline:
            time.sleep(0.02)
        assert tq.state == "FINISHED"
        assert tq.distributed, tq.fallback_reason
        committed = wp.published_rows_for(table_dir, tq.query_id)
        assert committed == 15000
        parts_before = wp.list_parts(table_dir)
        qid = tq.query_id
    finally:
        for w in workers:
            w.kill()
        first.kill()
        first.state.dispatcher.pool.shutdown(wait=False)

    # forge the crash: rewrite the ledger WITHOUT the terminal record,
    # as if the primary died between commit-publish and the ledger
    # terminal append — the worst double-write window
    records, _ = wp.replay_journal(path)
    with open(path, "wb") as f:
        for rec in records:
            if rec.get("rec") == "terminal":
                continue
            f.write(wp._frame(rec))
    os.unlink(path + ".epoch")

    session2 = Session(default_schema="tiny", device="cpu")
    session2.catalog.register("orc", OrcConnector(root))
    second = CoordinatorServer(session2, ledger_path=path, node_id="c2")
    try:
        tq2 = second.state.tracker.get(qid)
        assert tq2 is not None and tq2.resumed == "reexecuted"
        deadline = time.time() + 60
        while not tq2.state_machine.is_done() and time.time() < deadline:
            time.sleep(0.02)
        assert tq2.state == "FINISHED"
        # the resumed attempt deduped: same parts, same rows, no second
        # write — and the table reads back exactly once
        assert wp.list_parts(table_dir) == parts_before
        assert wp.published_rows_for(table_dir, qid) == 15000
        got = session2.execute(
            "SELECT count(*) FROM orc.out.t1").rows[0][0]
        assert got == 15000
    finally:
        second.kill()
        second.state.dispatcher.pool.shutdown(wait=False)


# ---------------------------------------------------------------------------
# spool sweep
# ---------------------------------------------------------------------------

def test_spool_sweep_keeps_live_keys(tmp_path):
    spool = ExchangeSpool(root=str(tmp_path / "spool"))
    spool.put("live1", [b"page"])
    spool.put("dead1", [b"page"])
    spool.put("dead2", [b"page"])
    with open(os.path.join(spool.root, "torn.spool.tmp"), "wb") as f:
        f.write(b"partial")
    removed = spool.sweep(keep={"live1"})
    assert removed == 2
    names = set(os.listdir(spool.root))
    assert "live1.spool" in names
    assert "dead1.spool" not in names and "dead2.spool" not in names
    assert not any(f.endswith(".tmp") for f in names)


# ---------------------------------------------------------------------------
# two-coordinator + two-worker cluster: the e2e failover surface
# ---------------------------------------------------------------------------

@pytest.fixture()
def ha_cluster(tmp_path):
    ledger = str(tmp_path / "query.ledger")
    spool = str(tmp_path / "spool")
    primary = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                                ledger_path=ledger, node_id="c1",
                                spool_root=spool).start()
    standby = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                                ledger_path=ledger, node_id="c2",
                                role="standby", peer_uri=primary.uri,
                                spool_root=spool,
                                standby_interval_s=0.1).start()
    workers = [WorkerServer(f"w{i}", primary.uri,
                            announce_interval_s=0.15, device="cpu").start()
               for i in (1, 2)]
    deadline = time.time() + 10
    while len(primary.state.active_nodes()) < 2 and \
            time.time() < deadline:
        time.sleep(0.02)
    # one announce round so workers learn the standby address
    for w in workers:
        w.announce_once()
    yield primary, standby, workers, ledger
    for w in workers:
        w.kill()
    for c in (primary, standby):
        try:
            c.state.dispatcher.pool.shutdown(wait=False)
            c.stop()
        except Exception:  # noqa: BLE001 — killed servers die twice
            pass


def test_standby_boots_passive_and_rejects_statements(ha_cluster):
    primary, standby, workers, _ = ha_cluster
    assert primary.state.role == "PRIMARY"
    assert standby.state.role == "PASSIVE"
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen
    req = Request(f"{standby.uri}/v1/statement", data=b"SELECT 1",
                  headers={"X-Trino-User": "t"})
    with pytest.raises(HTTPError) as ei:
        urlopen(req, timeout=5)
    assert ei.value.code == 503
    body = json.loads(ei.value.read().decode())
    assert body["error"]["errorName"] == "COORDINATOR_UNAVAILABLE"
    assert body["error"]["retryable"] is True


def test_announce_response_carries_address_list(ha_cluster):
    primary, standby, workers, _ = ha_cluster
    assert workers[0].coordinators == [primary.uri, standby.uri]
    # a single-address client keeps working (shape unchanged for old
    # deployments: ok/role/coordinators/epoch)
    info = json.loads(__import__("urllib.request", fromlist=["urlopen"])
                      .urlopen(f"{primary.uri}/v1/info/state",
                               timeout=5).read().decode())
    assert info["state"] == "PRIMARY" and info["epoch"] >= 1
    assert info["coordinators"][0] == primary.uri


def test_client_failover_midquery_bit_exact(ha_cluster):
    """Kill the primary while the query executes; the polling client
    finishes through the promoted standby: same rows, same query id,
    failovers surfaced, no client-visible error."""
    primary, standby, workers, _ = ha_cluster
    inj = FailureInjector()
    primary.state.dispatcher.failure_injector = inj
    inj.inject("EXECUTION", times=1, fault="DELAY", delay_s=3.0,
               match_sql="n_regionkey")
    client = Client([primary.uri, standby.uri], user="ha", timeout_s=60)
    res = {}

    def run():
        res["r"] = client.execute(SQL)

    t = threading.Thread(target=run)
    t.start()
    time.sleep(1.0)                 # admitted + RUNNING inside the delay
    primary.kill()
    t.join(timeout=60)
    assert not t.is_alive(), "client never finished after failover"
    r = res["r"]
    assert [list(x) for x in r.rows] == EXPECT
    assert r.failovers >= 1
    assert standby.state.role == "PRIMARY"
    tq = standby.state.tracker.get(r.query_id)
    assert tq is not None and tq.state == "FINISHED"
    from trino_tpu_torch.metrics import COORDINATOR_FAILOVERS
    assert COORDINATOR_FAILOVERS.value() >= 1


def test_admin_promotion_and_double_promotion_fencing(ha_cluster, tmp_path):
    """PUT /v1/info/state promotes the standby; the old primary is
    fenced — its ledger appends no-op, its statement route 503s, and a
    resurrected instance under its node id boots PASSIVE."""
    primary, standby, workers, ledger = ha_cluster
    from trino_tpu_torch.server.security import internal_headers
    from urllib.request import Request, urlopen
    req = Request(f"{standby.uri}/v1/info/state",
                  data=json.dumps({"state": "PRIMARY"}).encode(),
                  headers={"Content-Type": "application/json",
                           **internal_headers()}, method="PUT")
    with urlopen(req, timeout=10) as r:
        doc = json.loads(r.read().decode())
    assert doc["promoted"] and doc["role"] == "PRIMARY"
    # the deposed primary self-demotes on its serving path
    time.sleep(QueryLedger.EPOCH_TTL_S + 0.1)
    assert not primary.state.accepting()
    assert primary.state.role == "PASSIVE"
    assert not primary.state.ledger.append(
        {"rec": "state", "query": "qx", "state": "RUNNING", "ts": 1.0})
    # a resurrected old primary must boot fenced, not split-brain
    ghost = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                              ledger_path=ledger, node_id="c1")
    try:
        assert ghost.state.role == "PASSIVE"
    finally:
        ghost.state.dispatcher.pool.shutdown(wait=False)
        ghost.stop()
    # the promoted standby serves queries
    r = Client(standby.uri, user="ha").execute(SQL)
    assert [list(x) for x in r.rows] == EXPECT


# ---------------------------------------------------------------------------
# worker terminal-status buffering
# ---------------------------------------------------------------------------

def test_worker_buffers_terminal_reports_until_announce(tmp_path):
    """A worker whose coordinator is unreachable buffers terminal task
    reports instead of dropping them, and re-delivers after the next
    successful announce (satellite 2)."""
    from trino_tpu_torch.server.tasks import encode_fragment
    w = WorkerServer("wbuf", "http://127.0.0.1:9",       # nothing there
                     announce_interval_s=3600, device="cpu")
    try:
        session = Session(default_schema="tiny", device="cpu")
        _stmt, pr = session.plan(SQL)
        frag = encode_fragment({"root": pr.node, "driver": None})
        # run a task directly; terminal push fails -> buffered
        task = w.task_manager.create_or_update("t-buf", frag, [])
        deadline = time.time() + 30
        while task.state in ("PENDING", "RUNNING") and \
                time.time() < deadline:
            time.sleep(0.02)
        deadline = time.time() + 5
        while not w._pending_reports and time.time() < deadline:
            time.sleep(0.02)
        assert len(w._pending_reports) == 1
        report = w._pending_reports[0]
        assert report["taskId"] == "t-buf"
        # now a coordinator appears: announce succeeds and flushes
        coord = CoordinatorServer(
            Session(default_schema="tiny", device="cpu")).start()
        try:
            w.coordinator_uri = coord.uri
            w.coordinators = [coord.uri]
            w.announce_once(attempts=2)
            assert not w._pending_reports
            assert "t-buf" in coord.state.task_reports
            assert coord.state.task_reports["t-buf"]["state"] == \
                report["state"]
        finally:
            coord.state.dispatcher.pool.shutdown(wait=False)
            coord.stop()
    finally:
        w.kill()


def test_orphan_reaper_fenced_during_failover_reattachment():
    """Round-22 x round-20 composition: the worker announce loop must
    NEVER reap tasks while its coordinator answers as a non-PRIMARY (a
    promotee still reconciling our inventory against its replayed
    ledger) — and after the coordinator is PRIMARY again, the fence
    lapses and the reaper resumes, so a genuinely orphaned task is
    still eventually abandoned."""
    from trino_tpu_torch.server.tasks import encode_fragment
    session = Session(default_schema="tiny", device="cpu")
    coord = CoordinatorServer(session).start()
    w = WorkerServer("fence-w", coord.uri, announce_interval_s=0.1,
                     catalog=session.catalog, device="cpu").start()
    try:
        deadline = time.time() + 5
        while not coord.state.active_nodes() and time.time() < deadline:
            time.sleep(0.05)
        _stmt, pr = session.plan(SQL)
        frag = encode_fragment({"root": pr.node, "driver": None})
        task = w.task_manager.create_or_update("t-fence", frag, [])
        deadline = time.time() + 30
        while task.state in ("PENDING", "RUNNING") and \
                time.time() < deadline:
            time.sleep(0.02)
        assert task.state == "FINISHED"
        # make the task reapable: stale far past a tiny abandonment
        # timeout, with a short post-failover fence so the test can see
        # the reaper resume
        w.task_manager.task_abandonment_timeout_s = 0.2
        w.reap_fence_s = 0.3
        task.last_referenced = time.monotonic() - 100
        # mid-failover: the coordinator answers announces as a
        # still-reconciling promotee — several announce/reap rounds
        # pass and the stale task must survive every one of them
        coord.state.role = "RECONCILING"
        time.sleep(0.8)
        assert task.state == "FINISHED", \
            "reaper fired during failover reattachment"
        # promotion settles: announces say PRIMARY again, the fence
        # lapses, and the orphan is finally reaped
        coord.state.role = "PRIMARY"
        deadline = time.time() + 10
        while task.state != "ABANDONED" and time.time() < deadline:
            time.sleep(0.05)
        assert task.state == "ABANDONED"
    finally:
        w.kill()
        coord.state.dispatcher.pool.shutdown(wait=False)
        coord.stop()


# ---------------------------------------------------------------------------
# parity with the reference on the same inputs
# ---------------------------------------------------------------------------

def _append_script(lg):
    lg.claim_epoch()
    lg.admit("q1", SQL, "alice", "root", "fp", {"p": 1, "obj": {"x": 1}})
    lg.state("q1", "PLANNING", 2.0)
    lg.state("q1", "RUNNING", 3.0)
    lg.assign("q1", "q1.0.0", "w1", "partial")
    lg.spool("q1", "abc")
    lg.terminal("q1", "FINISHED", 4.0, rows=5, elapsed_s=0.5,
                catalog_version=1)
    lg.admit("q2", "SELECT nope", "bob", "root", "fp2", {})
    lg.terminal("q2", "FAILED", 2.5, error="column nope",
                error_name="COLUMN_NOT_FOUND", error_code=47)
    lg.seal()


def test_ledger_bytes_equal_reference(tmp_path, monkeypatch):
    """The same appends under the same clock write the same bytes (the
    ledger and its epoch file), and each package replays the other's
    ledger to the same view."""
    from trino_tpu.server.ledger import QueryLedger as JaxLedger
    from trino_tpu.server.ledger import replay_path as jax_replay
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(time, "monotonic", lambda: 100.0)
    port, ref = str(tmp_path / "port.ledger"), str(tmp_path / "ref.ledger")
    _append_script(QueryLedger(port, node_id="c1"))
    _append_script(JaxLedger(ref, node_id="c1"))
    for suffix in ("", ".epoch"):
        with open(port + suffix, "rb") as a, open(ref + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    (pv, ptorn), (rv, rtorn) = replay_path(ref), jax_replay(port)
    assert not ptorn and not rtorn
    assert pv.fingerprint() == rv.fingerprint()
    assert pv.queries["q2"]["terminal"] == "FAILED"


@pytest.mark.parametrize("final", ["CANCELED", "FAILED", "FINISHED"])
def test_statemachine_equals_reference(final, monkeypatch):
    from trino_tpu.server.statemachine import \
        QueryStateMachine as JaxStateMachine
    clock = iter(range(100))
    monkeypatch.setattr(time, "time", lambda: float(next(clock)))
    out = []
    for cls in (QueryStateMachine, JaxStateMachine):
        sm = cls("q1")
        seen = []
        sm.add_listener(seen.append)
        sm.transition("PLANNING")
        sm.transition("RUNNING")
        if final == "CANCELED":
            sm.cancel()
        elif final == "FAILED":
            sm.fail("boom", error_name="E", error_code=9)
        else:
            sm.transition("FINISHING")
            sm.transition("FINISHED")
        assert not sm.transition("RUNNING")        # terminal is final
        out.append((sm.state, sm.is_done(), sm.error, sm.error_name,
                    sm.error_code, seen,
                    sorted(sm.state_times)))
    assert out[0] == out[1]


def test_port_standby_resumes_jax_primary_ledger(tmp_path):
    """A JAX primary and a port standby share one ledger and spool
    root; the primary is killed while the query runs, the port standby
    is promoted by its own detector, replays the reference's ledger and
    answers under the original query id with the reference's rows."""
    from trino_tpu.exec.session import Session as JaxSession
    from trino_tpu.server.coordinator import \
        CoordinatorServer as JaxCoordinator
    from trino_tpu.server.failureinjector import \
        FailureInjector as JaxInjector
    ledger, spool = str(tmp_path / "query.ledger"), str(tmp_path / "spool")
    primary = JaxCoordinator(JaxSession(default_schema="tiny"),
                             ledger_path=ledger, node_id="c1",
                             spool_root=spool).start()
    standby = CoordinatorServer(Session(default_schema="tiny",
                                        device="cpu"),
                                ledger_path=ledger, node_id="c2",
                                role="standby", peer_uri=primary.uri,
                                spool_root=spool,
                                standby_interval_s=0.1).start()
    try:
        inj = JaxInjector()
        primary.state.dispatcher.failure_injector = inj
        inj.inject("EXECUTION", times=1, fault="DELAY", delay_s=3.0,
                   match_sql="n_regionkey")
        client = Client([primary.uri, standby.uri], user="ha",
                        timeout_s=60)
        res = {}
        t = threading.Thread(target=lambda: res.update(
            r=client.execute(SQL)))
        t.start()
        # kill once the primary holds the query RUNNING inside the delay
        deadline = time.time() + 30
        while time.time() < deadline and not any(
                q.state == "RUNNING" for q in primary.state.tracker.all()):
            time.sleep(0.01)
        primary.kill()
        t.join(timeout=60)
        assert not t.is_alive(), "client never finished after failover"
        r = res["r"]
        want = [list(x) for x in
                JaxSession(default_schema="tiny").execute(SQL).rows]
        assert [list(x) for x in r.rows] == want == EXPECT
        assert r.failovers >= 1
        assert standby.state.role == "PRIMARY"
        tq = standby.state.tracker.get(r.query_id)
        assert tq is not None and tq.state == "FINISHED"
        assert tq.resumed in ("replayed", "reattached", "reexecuted")
        view, torn = standby.state.ledger.replay()
        assert not torn and view.epoch >= 2
        assert view.queries[r.query_id]["terminal"] == "FINISHED"
    finally:
        for c in (primary, standby):
            try:
                c.state.dispatcher.pool.shutdown(wait=False)
                c.stop()
            except Exception:  # noqa: BLE001 — killed servers die twice
                pass


def test_killed_coordinator_releases_device_caches():
    """The port's crash model frees the dead coordinator's card memory:
    kill() drops its executor's cross-statement caches (scans, builds,
    fact columns), which a CUDA Session keeps on the card."""
    coord = CoordinatorServer(
        Session(default_schema="tiny", device="cpu")).start()
    try:
        r = Client(coord.uri, user="k").execute(
            "SELECT l_returnflag, sum(l_quantity) FROM lineitem "
            "GROUP BY l_returnflag ORDER BY l_returnflag")
        assert r.state == "FINISHED"
        ex = coord.state.session.executor
        held = ex.device_cache_bytes()
        assert held > 0
        coord.kill()
        assert ex.device_cache_bytes() == 0
        assert ex._scan_cache == {} and ex._build_cache == {}
    finally:
        coord.state.dispatcher.pool.shutdown(wait=False)


def test_ledger_replay_fences_task_ids(tmp_path):
    """Workers create tasks idempotently by id, so a coordinator that
    replays a ledger never re-mints a task id the dead primary issued."""
    path = str(tmp_path / "q.ledger")
    old = QueryLedger(path, node_id="old")
    old.admit("q1", SQL, "alice", "root", "fp", {})
    old.assign("q1", "t7", "w1", "source")
    old.terminal("q1", "FINISHED", 3.0, rows=5, elapsed_s=0.5)
    old.admit("q2", SQL, "alice", "root", "fp", {})
    old.state("q2", "RUNNING", 4.0)
    old.assign("q2", "t12", "w2", "source")
    old.seal()
    coord = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                              ledger_path=path, node_id="new")
    try:
        assert coord.state.scheduler._seq >= 12
    finally:
        coord.state.dispatcher.pool.shutdown(wait=False)
        coord.stop()


DIST_SQL = ("SELECT l_returnflag, count(*) AS c, sum(l_quantity) AS q "
            "FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag")


def test_standby_resumes_distributed_query_after_primary_tasks(tmp_path):
    """The primary runs a distributed query, then dies holding a second
    one RUNNING: the promoted standby re-runs it on the same workers
    under fresh task ids (a reused id would hand it the first query's
    drained tasks, and the client would wait forever)."""
    from trino_tpu_torch.server.failureinjector import HANG
    ledger = str(tmp_path / "query.ledger")
    spool = str(tmp_path / "spool")
    primary = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                                ledger_path=ledger, node_id="c1",
                                spool_root=spool).start()
    standby = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                                ledger_path=ledger, node_id="c2",
                                role="standby", peer_uri=primary.uri,
                                spool_root=spool,
                                standby_interval_s=0.1).start()
    for c in (primary, standby):
        c.state.scheduler.split_rows = 8192
    workers = [WorkerServer(f"dw{i}", primary.uri, announce_interval_s=0.1,
                            device="cpu").start() for i in (1, 2)]
    inj = FailureInjector()
    try:
        deadline = time.time() + 10
        while len(primary.state.active_nodes()) < 2 and \
                time.time() < deadline:
            time.sleep(0.02)
        for w in workers:
            w.announce_once()
        client = Client([primary.uri, standby.uri], user="ha",
                        timeout_s=60)
        want = [list(x) for x in client.execute(DIST_SQL).rows]
        assert primary.state.scheduler.stats["tasks"] > 0
        primary.state.scheduler.spool.clear()
        primary.state.dispatcher.failure_injector = inj
        inj.inject("EXECUTION", times=1, fault=HANG, delay_s=120.0,
                   match_sql="l_returnflag")
        res = {}
        t = threading.Thread(target=lambda: res.update(
            r=client.execute(DIST_SQL)))
        t.start()
        deadline = time.time() + 30
        while time.time() < deadline and not any(
                q.state == "RUNNING" for q in primary.state.tracker.all()
                if q.query_id != "" and "l_returnflag" in q.sql and
                not q.state_machine.is_done()):
            time.sleep(0.01)
        minted = primary.state.scheduler._seq
        primary.kill()
        t.join(timeout=60)
        assert not t.is_alive(), "the resumed query never finished"
        r = res["r"]
        assert [list(x) for x in r.rows] == want
        assert r.failovers >= 1 and standby.state.role == "PRIMARY"
        assert standby.state.scheduler.stats["tasks"] > 0
        assert standby.state.scheduler._seq > minted
    finally:
        for w in workers:
            w.kill()
        inj.clear()
        for c in (primary, standby):
            try:
                c.state.dispatcher.pool.shutdown(wait=False)
                c.stop()
            except Exception:  # noqa: BLE001 — killed servers die twice
                pass


def test_announce_rotates_past_a_refused_coordinator():
    """A refused connection moves the announce to the next address of
    the failover list within the same attempt: one attempt against
    [dead primary, live standby] lands on the standby."""
    live = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                             node_id="live").start()
    w = WorkerServer("rot-w", "http://127.0.0.1:9",       # nothing there
                     announce_interval_s=3600, device="cpu")
    try:
        w.coordinators = ["http://127.0.0.1:9", live.uri]
        w.coordinator_uri = "http://127.0.0.1:9"
        w.announce_once(attempts=1)
        assert w.coordinator_uri == live.uri
        assert [n.node_id for n in live.state.active_nodes()] == ["rot-w"]
        # the rotation fences the orphan reaper like a failed round
        assert w._reap_fence_until > time.monotonic()
        # with one address there is nowhere to rotate: the refusal
        # propagates once the attempts are spent
        w.coordinators = ["http://127.0.0.1:9"]
        w.coordinator_uri = "http://127.0.0.1:9"
        with pytest.raises(OSError):
            w.announce_once(attempts=1)
    finally:
        w.kill()
        live.state.dispatcher.pool.shutdown(wait=False)
        live.stop()


def test_promotion_waits_for_ledger_workers_past_any_worker_wait(tmp_path):
    """The race of the test above, made deterministic: the standby
    holds every worker's re-announce until 2 s after its promotion
    began (past the 1.5 s wait for any worker). The workers the ledger
    names are waited for, so the resumed query still runs its tasks on
    them rather than on the coordinator alone."""
    from trino_tpu_torch.server.failureinjector import HANG
    ledger = str(tmp_path / "query.ledger")
    spool = str(tmp_path / "spool")
    primary = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                                ledger_path=ledger, node_id="c1",
                                spool_root=spool).start()
    standby = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                                ledger_path=ledger, node_id="c2",
                                role="standby", peer_uri=primary.uri,
                                spool_root=spool, standby_interval_s=0.1,
                                auto_promote=False).start()
    for c in (primary, standby):
        c.state.scheduler.split_rows = 8192
    workers = [WorkerServer(f"hw{i}", primary.uri, announce_interval_s=0.1,
                            device="cpu").start() for i in (1, 2)]
    held = {"until": None, "held": 0}
    real_announce = standby.state.announce

    def held_announce(node_id, uri, state="ACTIVE", *a, **k):
        until = held["until"]
        if state != "STANDBY" and (until is None or
                                   time.monotonic() < until):
            held["held"] += 1
            time.sleep(max(0.0, (until or time.monotonic() + 0.05) -
                           time.monotonic()))
        return real_announce(node_id, uri, state, *a, **k)

    standby.state.announce = held_announce
    inj = FailureInjector()
    try:
        deadline = time.time() + 10
        while len(primary.state.active_nodes()) < 2 and \
                time.time() < deadline:
            time.sleep(0.02)
        for w in workers:
            w.announce_once()
        client = Client([primary.uri, standby.uri], user="ha",
                        timeout_s=60)
        want = [list(x) for x in client.execute(DIST_SQL).rows]
        assert primary.state.scheduler.stats["tasks"] > 0
        primary.state.scheduler.spool.clear()
        primary.state.dispatcher.failure_injector = inj
        inj.inject("EXECUTION", times=1, fault=HANG, delay_s=120.0,
                   match_sql="l_returnflag")
        doc = client._submit(DIST_SQL)
        deadline = time.time() + 30
        while time.time() < deadline and not any(
                q.query_id == doc["id"] and q.state == "RUNNING"
                for q in primary.state.tracker.all()):
            time.sleep(0.01)
        primary.kill()
        t0 = time.monotonic()
        held["until"] = t0 + 2.0
        out = standby.state.promote(reason="admin")
        assert out["promoted"] and time.monotonic() - t0 >= 2.0
        assert held["held"] > 0
        assert {n.node_id for n in standby.state.active_nodes()} == \
            {"hw1", "hw2"}
        r = client._drain(doc, [], [], time.time() + 60, client.failovers)
        assert [list(x) for x in r.rows] == want
        assert r.query_id == doc["id"]
        assert standby.state.scheduler.stats["tasks"] > 0
    finally:
        for w in workers:
            w.kill()
        inj.clear()
        for c in (primary, standby):
            try:
                c.state.dispatcher.pool.shutdown(wait=False)
                c.stop()
            except Exception:  # noqa: BLE001 — killed servers die twice
                pass


# ---------------------------------------------------------------------------
# exactly-once writes across failover: a coordinator's local write commits
# under its query id, and a fenced coordinator leaves shared storage alone
# ---------------------------------------------------------------------------

WRITE_SRC = ("SELECT o_orderkey, o_custkey, o_orderstatus, o_totalprice "
             "FROM tpch.tiny.orders")
SETUP_KEYS = "o_orderkey < 1000"


def _orc_session(root):
    s = Session(default_schema="tiny", device="cpu")
    s.catalog.register("orc", OrcConnector(root))
    return s


def _forget_terminal(path):
    """The crash between a write's commit and its ledger terminal
    record: the ledger without its terminal records, its epoch file gone
    so the next coordinator boots as the primary and resumes."""
    records, _ = wp.replay_journal(path)
    with open(path, "wb") as f:
        for rec in records:
            if rec.get("rec") != "terminal":
                f.write(wp._frame(rec))
    os.unlink(path + ".epoch")


def _wait_done(tq, timeout_s=60):
    deadline = time.time() + timeout_s
    while not tq.state_machine.is_done() and time.time() < deadline:
        time.sleep(0.02)


def _canonical(rows):
    return sorted(tuple(str(v) for v in r) for r in rows)


@pytest.mark.parametrize("kind", ["ctas", "insert"])
def test_local_write_resumed_twice_is_exactly_once(tmp_path, kind):
    """The local-path twin of test_resumed_committed_write_is_exactly_once:
    a coordinator with no workers runs a CTAS (or an INSERT into a table
    a plain Session made) on its own path, which commits under the
    tracked query's id. The query is then resumed twice from a ledger
    without its terminal record: each resumption finds the commit,
    returns its row count, writes nothing and raises nothing. The table
    holds the JAX Session's rows of its sources, as a multiset."""
    from trino_tpu.exec.session import Session as JaxSession
    root = str(tmp_path / "orc")
    os.makedirs(os.path.join(root, "out"))
    path = str(tmp_path / "q.ledger")
    table_dir = os.path.join(root, "out", "t1")
    sources = [WRITE_SRC]
    if kind == "ctas":
        sql = f"CREATE TABLE orc.out.t1 AS {WRITE_SRC}"
    else:
        setup_src = f"{WRITE_SRC} WHERE {SETUP_KEYS}"
        # a plain Session (no coordinator) still writes as local_<uuid>
        _orc_session(root).execute(f"CREATE TABLE orc.out.t1 AS {setup_src}")
        sql = f"INSERT INTO orc.out.t1 {WRITE_SRC}"
        sources.append(setup_src)
    want = _canonical(r for src in sources
                      for r in JaxSession(default_schema="tiny")
                      .execute(src).rows)

    first = CoordinatorServer(_orc_session(root), ledger_path=path,
                              node_id="c1").start()
    try:
        tq = first.state.dispatcher.submit(sql, "alice")
        _wait_done(tq)
        assert tq.state == "FINISHED", tq.state_machine.error
        assert tq.fallback_reason == "no active workers"
        qid = tq.query_id
        assert wp.published_rows_for(table_dir, qid) == 15000
        parts_before = wp.list_parts(table_dir)
    finally:
        first.kill()
        first.state.dispatcher.pool.shutdown(wait=False)

    for node in ("c2", "c3"):
        _forget_terminal(path)
        coord = CoordinatorServer(_orc_session(root), ledger_path=path,
                                  node_id=node)
        try:
            tq2 = coord.state.tracker.get(qid)
            assert tq2 is not None and tq2.resumed == "reexecuted"
            _wait_done(tq2)
            assert tq2.state == "FINISHED", tq2.state_machine.error
            assert [tuple(r) for r in tq2.result.rows] == [(15000,)]
            assert wp.list_parts(table_dir) == parts_before
            assert wp.published_rows_for(table_dir, qid) == 15000
            got = coord.state.session.execute(
                "SELECT o_orderkey, o_custkey, o_orderstatus, o_totalprice "
                "FROM orc.out.t1").rows
            assert _canonical(got) == want
        finally:
            coord.kill()
            coord.state.dispatcher.pool.shutdown(wait=False)


def test_plain_session_write_keeps_a_local_id(tmp_path, monkeypatch):
    """Outside a coordinator's run the connector still mints
    `local_<uuid>`, one id per statement."""
    root = str(tmp_path / "orc")
    os.makedirs(os.path.join(root, "out"))
    s = _orc_session(root)
    seen = []
    real = wp.commit

    def spy(table_dir, query_id, *a, **k):
        seen.append(query_id)
        return real(table_dir, query_id, *a, **k)

    monkeypatch.setattr(wp, "commit", spy)
    s.execute(f"CREATE TABLE orc.out.t1 AS {WRITE_SRC}")
    s.execute(f"INSERT INTO orc.out.t1 {WRITE_SRC}")
    assert len(seen) == 2 and all(q.startswith("local_") for q in seen)
    assert len(set(seen)) == 2


def test_one_query_id_stages_one_write(tmp_path):
    """commit is idempotent per query id, so a second staged write in
    one coordinator run raises rather than being deduplicated away."""
    root = str(tmp_path / "orc")
    os.makedirs(os.path.join(root, "out"))
    conn = OrcConnector(root)
    data = _nation()
    with wp.coordinator_write("q_one"):
        conn.create_table("out", "a", data)
        with pytest.raises(RuntimeError, match="already staged a write"):
            conn.create_table("out", "b", data)
    assert wp.published_rows_for(conn._table_dir("out", "a"), "q_one") == 25
    assert not conn.table_exists("out", "b")


QID = "20260101_000000_00007_tpu"


def _nation():
    return Session(default_schema="tiny", device="cpu").catalog \
        .connector("tpch").get_table("tiny", "nation")


def _tree(d):
    """Every file under `d` with its bytes."""
    out = {}
    for dirpath, _, files in os.walk(d):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


@pytest.mark.parametrize("op", ["abort", "recover", "commit"])
@pytest.mark.parametrize("how", ["sealed", "deposed"])
def test_fenced_coordinator_leaves_standby_staging(tmp_path, how, op):
    """The old primary's ledger is sealed (its process died), or another
    node claimed the epoch: its abort, recovery and commit of a query id
    raise WriteFencedError and leave the directory byte for byte as it
    was, the promoted standby's staged attempt of the same id included.
    The standby then commits that attempt."""
    path = str(tmp_path / "q.ledger")
    table_dir = str(tmp_path / "orc" / "out" / "t1")
    os.makedirs(table_dir)
    old = QueryLedger(path, node_id="p")
    old.claim_epoch()
    new = QueryLedger(path, node_id="s")
    data = _nation()
    mine = wp.stage_table_data(table_dir, data, QID, stage=1, partition=0,
                               attempt="t1", fmt="orc")
    theirs = wp.stage_table_data(table_dir, data, QID, stage=1,
                                 partition=0, attempt="t7", fmt="orc")
    if how == "sealed":
        old.seal()
    else:
        new.claim_epoch()
    before = _tree(table_dir)
    with pytest.raises(wp.WriteFencedError, match=how):
        if op == "abort":
            wp.abort(table_dir, QID, fence=old)
        elif op == "recover":
            wp.recover_table_dir(table_dir, fence=old, query_id=QID)
        else:
            wp.commit(table_dir, QID, [mine], fence=old)
    assert _tree(table_dir) == before
    assert [r["op"] for r in old.fence_refusals] == [op]
    if how == "sealed":
        new.claim_epoch()
    stats = wp.commit(table_dir, QID, [theirs], fence=new)
    assert stats["published"] == 1 and stats["rows"] == 25
    assert wp.published_rows_for(table_dir, QID) == 25
    assert len(wp.list_parts(table_dir)) == 1
    assert not os.path.exists(wp.staging_dir(table_dir))
    assert new.fence_refusals == []


@pytest.mark.parametrize("fenced", [False, True])
def test_stale_and_live_committer_publish_one_part_set(tmp_path, fenced,
                                                      monkeypatch):
    """Two committers of one query id on threads. The stale one passes
    its checks and stops before its INTENT append; meanwhile the live
    one (with fences: after claiming the epoch, which deposes the stale
    one) commits its own attempt. The table lock makes the live commit
    wait, find the stale one's parts and dedup: exactly one part set is
    published, and neither committer fails."""
    path = str(tmp_path / "q.ledger")
    table_dir = str(tmp_path / "orc" / "out" / "t1")
    os.makedirs(table_dir)
    old = new = None
    if fenced:
        old = QueryLedger(path, node_id="p")
        old.claim_epoch()
        new = QueryLedger(path, node_id="s")
    data = _nation()
    mine = wp.stage_table_data(table_dir, data, QID, stage=1, partition=0,
                               attempt="t1", fmt="orc")
    theirs = wp.stage_table_data(table_dir, data, QID, stage=1,
                                 partition=0, attempt="t7", fmt="orc")
    at_intent, go = threading.Event(), threading.Event()
    real_append = wp.append_journal

    def gated(jpath, rec, injector=None, key=""):
        if rec.get("rec") == "intent" and \
                threading.current_thread().name == "stale-committer":
            at_intent.set()
            go.wait(10)
        return real_append(jpath, rec, injector=injector, key=key)

    out = {}

    def run(name, m, fence):
        kw = {"fence": fence} if fenced else {}
        try:
            out[name] = wp.commit(table_dir, QID, [m], **kw)
        except Exception as e:  # noqa: BLE001 — asserted below
            out[name] = e

    monkeypatch.setattr(wp, "append_journal", gated)
    stale = threading.Thread(target=run, args=("stale", mine, old),
                             name="stale-committer")
    stale.start()
    assert at_intent.wait(10)
    if fenced:
        new.claim_epoch()
    live = threading.Thread(target=run, args=("live", theirs, new))
    live.start()
    live.join(1.0)               # unlocked, the live commit ends here
    go.set()
    stale.join(10)
    live.join(10)
    assert isinstance(out["stale"], dict), out["stale"]
    assert isinstance(out["live"], dict), out["live"]
    assert out["stale"]["published"] == 1
    assert out["live"]["published"] == 0 and out["live"]["rows"] == 25
    assert wp.published_rows_for(table_dir, QID) == 25
    assert len(wp.list_parts(table_dir)) == 1
    assert sorted(os.listdir(table_dir)) == wp.list_parts(table_dir)
    conn = OrcConnector(str(tmp_path / "orc"))
    assert conn.get_table("out", "t1").num_rows == 25


@pytest.mark.parametrize("stmt", ["ctas", "insert", "drop"])
def test_fenced_local_path_changes_nothing(tmp_path, stmt):
    """A killed coordinator's local path is fenced too: its CTAS,
    INSERT or DROP TABLE inside its run raises WriteFencedError and the
    schema directory stays as it was."""
    root = str(tmp_path / "orc")
    os.makedirs(os.path.join(root, "out"))
    conn = OrcConnector(root)
    data = _nation()
    if stmt != "ctas":
        conn.create_table("out", "t1", data)
    ledger = QueryLedger(str(tmp_path / "q.ledger"), node_id="p")
    ledger.claim_epoch()
    ledger.seal()
    before = _tree(root)
    with wp.coordinator_write(QID, fence=ledger):
        with pytest.raises(wp.WriteFencedError, match="sealed"):
            if stmt == "ctas":
                conn.create_table("out", "t1", data)
            elif stmt == "insert":
                conn.insert("out", "t1", data.columns, data.valids,
                            data.schema.fields)
            else:
                conn.drop_table("out", "t1")
    assert _tree(root) == before
    assert os.listdir(os.path.join(root, "out")) == \
        ([] if stmt == "ctas" else ["t1"])
    assert [r["op"] for r in ledger.fence_refusals] == \
        [{"ctas": "stage", "insert": "stage", "drop": "drop"}[stmt]]


def test_concurrent_commits_take_turns(tmp_path):
    """Many committers of distinct query ids into one table directory,
    on more threads than cores with a short switch interval: under the
    table lock each takes the next part number, so every part is
    published once under a sequence number of its own."""
    import sys
    table_dir = str(tmp_path / "orc" / "out" / "t1")
    os.makedirs(table_dir)
    data = _nation()
    n = 2 * (os.cpu_count() or 4)
    manifests = [wp.stage_table_data(table_dir, data, f"q{i}", stage=1,
                                     partition=0, attempt="t1", fmt="orc")
                 for i in range(n)]
    errors = []

    def run(i):
        try:
            wp.commit(table_dir, f"q{i}", [manifests[i]])
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    parts = wp.list_parts(table_dir)
    assert sorted(int(p.split("-")[1]) for p in parts) == list(range(n))
    assert all(wp.published_rows_for(table_dir, f"q{i}") == 25
               for i in range(n))
    assert sorted(os.listdir(table_dir)) == sorted(parts)


def test_fenced_coordinator_starts_no_task(tmp_path):
    """A coordinator whose ledger is sealed starts no task on a worker
    (a task id it started unrecorded could be minted again by the
    promoted standby): its distributed query raises FencedError, every
    worker's task list stays empty, and the refusals are recorded."""
    from trino_tpu_torch.server.writeprotocol import FencedError
    coord = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                              ledger_path=str(tmp_path / "q.ledger"),
                              node_id="c1").start()
    coord.state.scheduler.split_rows = 8192
    workers = [WorkerServer(f"fw{i}", coord.uri, announce_interval_s=0.1,
                            device="cpu").start() for i in (1, 2)]
    try:
        deadline = time.time() + 10
        while len(coord.state.active_nodes()) < 2 and \
                time.time() < deadline:
            time.sleep(0.02)
        coord.state.ledger.seal()
        with pytest.raises(FencedError, match="sealed"):
            coord.state.scheduler.execute(DIST_SQL, query_id="q_fenced")
        assert all(not w.task_manager.tasks for w in workers)
        assert coord.state.ledger.fence_refusals and all(
            r["op"] == "dispatch" for r in coord.state.ledger.fence_refusals)
    finally:
        for w in workers:
            w.kill()
        coord.state.dispatcher.pool.shutdown(wait=False)
        coord.stop()


def test_poll_outlasts_a_slow_promotion_until_the_deadline():
    """A standby that answers 503 past the client's retry budget (its
    promotion slowed by the host's load) does not fail the query: the
    poll goes on until the query's deadline, then takes the promoted
    coordinator's page. Without a deadline the budget still ends it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.error import HTTPError
    ready_at = time.monotonic() + 1.5

    class Promoting(BaseHTTPRequestHandler):
        def do_GET(self):
            body, code = b'{"error": "standby"}', 503
            if time.monotonic() >= ready_at:
                body, code = json.dumps(
                    {"id": "q1", "columns": [{"name": "c"}],
                     "data": [[1]], "stats": {"state": "FINISHED"}}
                ).encode(), 200
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Promoting)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    uri = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        import dataclasses
        client = Client([uri], user="ha", timeout_s=30)
        client.retry_policy = dataclasses.replace(
            client.retry_policy, max_attempts=2, max_delay_s=0.1)
        with pytest.raises(HTTPError):
            client._poll(f"{uri}/v1/statement/q1/1")
        doc = client._poll(f"{uri}/v1/statement/q1/1",
                           deadline=time.time() + 30)
        assert doc["data"] == [[1]] and time.monotonic() >= ready_at
    finally:
        httpd.shutdown()
        httpd.server_close()
