"""The port's cluster on the CPU (tpch.tiny): a port coordinator schedules
stages onto two port `WorkerServer`s over real sockets, with a heartbeat
failure detector, as the reference's server tests boot theirs. Every
TPC-H query answers the JAX Session's rows, doubles to the last bit; a
sample also equals the reference's cluster (rows and fallback verdicts);
announce, the failure detector, drain to LEFT, a seeded task crash, a
mixed cluster (a JAX coordinator driving port workers) and the
distributed CTAS into ORC (files byte-equal to the reference's) are held
to the reference's behaviour."""

import json
import os
import time
from collections import Counter
from urllib.request import Request, urlopen

import pytest
import torch

from tpch_full import QUERIES as TPCH
from trino_tpu.client.client import Client as JaxClient
from trino_tpu.connectors.orcdir import OrcConnector as JaxOrcConnector
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu.server.coordinator import CoordinatorServer as JaxCoordinator
from trino_tpu.server.coordinator import _rows_json
from trino_tpu.server.worker import WorkerServer as JaxWorker
from trino_tpu_torch.client.client import Client
from trino_tpu_torch.connectors.orcdir import OrcConnector
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.server.coordinator import CoordinatorServer
from trino_tpu_torch.server.failuredetector import HeartbeatFailureDetector
from trino_tpu_torch.server.failureinjector import CRASH, FailureInjector
from trino_tpu_torch.server.security import internal_headers
from trino_tpu_torch.server.worker import WorkerServer

torch.set_num_threads(1)

SPLIT_ROWS = 8192                 # lineitem in 8 splits, orders in 2
# the reference cluster's verdicts at this split size (the reference's
# own fallback reasons; every other TPC-H query runs distributed)
LOCAL = {2: "no scan larger than split_rows=8192",
         11: "no scan larger than split_rows=8192",
         13: "probe spine below split threshold",
         15: "probe spine below split threshold",
         16: "no scan larger than split_rows=8192",
         20: "no scan larger than split_rows=8192",
         22: "probe spine below split threshold"}
SAMPLE = [1, 3, 6, 13]
ORDERS_SRC = ("SELECT o_orderkey, o_custkey, o_orderstatus, o_totalprice "
              "FROM tpch.tiny.orders")


def _wait(cond, timeout=10.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _boot(coordinator, worker, session, n_workers, orc_root, **worker_kw):
    os.makedirs(os.path.join(orc_root, "out"), exist_ok=True)
    orc = OrcConnector if coordinator is CoordinatorServer \
        else JaxOrcConnector
    session.catalog.register("orc", orc(orc_root))
    coord = coordinator(session).start()
    coord.state.scheduler.split_rows = SPLIT_ROWS
    workers = [worker(f"w{i}", coord.uri, announce_interval_s=0.1,
                      **worker_kw).start() for i in range(n_workers)]
    _wait(lambda: len(coord.state.active_nodes()) == n_workers,
          what="workers to announce")
    return coord, workers


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    coord, workers = _boot(CoordinatorServer, WorkerServer,
                           Session(default_schema="tiny", device="cpu"), 2,
                           str(tmp_path_factory.mktemp("port_orc")),
                           device="cpu")
    detector = HeartbeatFailureDetector(coord.state, interval_s=0.1).start()
    yield coord, workers, detector
    detector.stop()
    for w in workers:
        w.stop(graceful=False)
    coord.stop()


@pytest.fixture(scope="module")
def reference_cluster(tmp_path_factory):
    coord, workers = _boot(JaxCoordinator, JaxWorker,
                           JaxSession(default_schema="tiny"), 2,
                           str(tmp_path_factory.mktemp("jax_orc")))
    yield coord, workers
    for w in workers:
        w.stop(graceful=False)
    coord.stop()


@pytest.fixture(scope="module")
def jax_session():
    return JaxSession(default_schema="tiny")


@pytest.fixture(autouse=True)
def _clean_cluster(request):
    """Spooled fragments replay without dispatch: clear the spool before
    each test, and take every injector off after it."""
    if "cluster" not in request.fixturenames:
        yield
        return
    coord, workers, _ = request.getfixturevalue("cluster")
    coord.state.scheduler.spool.clear()
    yield
    for w in workers:
        w.task_manager.injector = None
    _wait(lambda: len(coord.state.active_nodes()) == len(workers),
          what="workers to be active again")


def _client(coord, cls=Client):
    return cls(coord.uri, user="test", poll_interval_s=0.005)


def _ends_in_order_by(sql: str) -> bool:
    up, depth = sql.upper(), 0
    for i, ch in enumerate(up):
        depth += (ch == "(") - (ch == ")")
        if depth == 0 and up.startswith("ORDER BY", i):
            return True
    return False


def _same_rows(got, want, sql):
    if _ends_in_order_by(sql):
        assert got == want
    else:
        assert Counter(map(repr, got)) == Counter(map(repr, want))


def _tasks_run(workers):
    return [w.task_manager.tasks_run for w in workers]


@pytest.mark.parametrize("qnum", sorted(TPCH))
def test_tpch_rows_equal_reference(cluster, jax_session, qnum):
    coord, workers, _ = cluster
    sql = TPCH[qnum]
    before = _tasks_run(workers)
    client = _client(coord)
    r = client.execute(sql)
    info = client.query_info(r.query_id)
    _same_rows(r.rows, _rows_json(jax_session.execute(sql).rows), sql)
    assert info.get("fallbackReason") == LOCAL.get(qnum)
    if qnum not in LOCAL:
        after = _tasks_run(workers)
        assert all(a > b for a, b in zip(after, before)), (before, after)


@pytest.mark.parametrize("qnum", SAMPLE)
def test_cluster_equals_reference_cluster(cluster, reference_cluster,
                                          qnum):
    sql = TPCH[qnum]
    reference_cluster[0].state.scheduler.spool.clear()
    pc, jc = _client(cluster[0]), _client(reference_cluster[0], JaxClient)
    r, rj = pc.execute(sql), jc.execute(sql)
    assert r.rows == rj.rows
    assert pc.query_info(r.query_id).get("fallbackReason") == \
        jc.query_info(rj.query_id).get("fallbackReason")


def test_announce_is_accepted_and_registers(cluster, reference_cluster):
    """`POST /v1/announce` answers as the reference's does (202) where the
    port answered 501 before it had workers; a DRAINED node is known but
    takes no splits, and a LEFT announce deregisters it."""
    for coord in (cluster[0], reference_cluster[0]):
        for state in ("DRAINED", "LEFT"):
            body = json.dumps({"nodeId": "probe",
                               "uri": "http://127.0.0.1:9",
                               "state": state}).encode()
            req = Request(coord.uri + "/v1/announce", data=body,
                          method="POST",
                          headers={"Content-Type": "application/json",
                                   **internal_headers()})
            with urlopen(req, timeout=10) as resp:
                assert resp.status == 202
            if state == "DRAINED":
                assert coord.state.nodes["probe"].state == "DRAINED"
                assert "probe" not in {n.node_id for n in
                                       coord.state.active_nodes()}
        assert "probe" not in coord.state.nodes


def test_failure_detector_marks_and_recovers(cluster):
    coord, workers, _ = cluster
    client = _client(coord)
    w = workers[0]
    w.fail_status = True
    try:
        _wait(lambda: {n["nodeId"]: n["state"] for n in client.nodes()}
              .get(w.node_id) == "FAILED", what="failure detection")
    finally:
        w.fail_status = False
    _wait(lambda: {n["nodeId"]: n["state"] for n in client.nodes()}
          .get(w.node_id) == "ACTIVE", what="recovery")


def test_drain_walks_to_left(cluster, jax_session):
    coord, workers, _ = cluster
    extra = WorkerServer("drainer", coord.uri, announce_interval_s=0.1,
                         device="cpu").start()
    try:
        _wait(lambda: "drainer" in {n.node_id for n in
                                    coord.state.active_nodes()},
              what="the third worker")
        req = Request(extra.uri + "/v1/info/state",
                      data=json.dumps({"state": "DRAINING"}).encode(),
                      method="PUT",
                      headers={"Content-Type": "application/json",
                               **internal_headers()})
        with urlopen(req, timeout=10) as resp:
            assert resp.status == 200
        _wait(extra.drained, what="DRAINING -> DRAINED -> LEFT")
        _wait(lambda: "drainer" not in coord.state.nodes,
              what="deregistration")
        assert extra.task_manager.inflight() == []
        sql = TPCH[6]
        r = _client(coord).execute(sql)
        _same_rows(r.rows, _rows_json(jax_session.execute(sql).rows), sql)
    finally:
        extra.stop(graceful=False)


def test_injected_task_crash_is_retried(cluster, jax_session):
    coord, workers, _ = cluster
    sched = coord.state.scheduler
    inj = FailureInjector(seed=11)
    inj.inject("WORKER_TASK_RUN", fault=CRASH, times=1)
    workers[1].task_manager.injector = inj
    retries = sched.stats["task_retries"]
    sql = TPCH[1]
    client = _client(coord)
    r = client.execute(sql)
    _same_rows(r.rows, _rows_json(jax_session.execute(sql).rows), sql)
    assert client.query_info(r.query_id).get("fallbackReason") is None
    assert inj.injected_count == 1, "the crash never fired"
    assert sched.stats["task_retries"] > retries


@pytest.fixture(scope="module")
def mixed_cluster():
    """A JAX coordinator with two port workers: the fragment wire form
    and the page frames are the reference's, byte for byte."""
    coord = JaxCoordinator(JaxSession(default_schema="tiny")).start()
    coord.state.scheduler.split_rows = SPLIT_ROWS
    workers = [WorkerServer(f"pw{i}", coord.uri, announce_interval_s=0.1,
                            device="cpu").start() for i in range(2)]
    _wait(lambda: len(coord.state.active_nodes()) == 2,
          what="port workers to announce")
    yield coord, workers
    for w in workers:
        w.stop(graceful=False)
    coord.stop()


@pytest.mark.parametrize("qnum", [1, 3, 6])
def test_mixed_cluster_equals_reference(mixed_cluster, jax_session, qnum):
    coord, workers = mixed_cluster
    coord.state.scheduler.spool.clear()
    before = _tasks_run(workers)
    client = _client(coord, JaxClient)
    sql = TPCH[qnum]
    r = client.execute(sql)
    assert client.query_info(r.query_id).get("fallbackReason") is None
    assert all(a > b for a, b in zip(_tasks_run(workers), before))
    _same_rows(r.rows, _rows_json(jax_session.execute(sql).rows), sql)


def _table_files(root):
    out = []
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out.append((os.path.relpath(p, root), fh.read()))
    return sorted(out)


def test_distributed_ctas_into_orc_equals_reference(cluster,
                                                    reference_cluster):
    """The same CTAS (same query id) through both clusters: 15,000 rows
    committed by the workers' staged writes, the table equal to its
    source, and the published ORC files byte-equal."""
    results = []
    for coord, table in ((cluster[0], "orc.out.port_t"),
                         (reference_cluster[0], "orc.out.port_t")):
        sched = coord.state.scheduler
        res = sched.execute(f"CREATE TABLE {table} AS {ORDERS_SRC}",
                            query_id="q_ctas")
        assert res is not None, sched.fallback_reason
        assert [tuple(r) for r in res.rows] == [(15000,)]
        assert sched.last_query["write"]["phase"] == "committed"
        back = coord.state.session.execute(
            f"SELECT * FROM {table} ORDER BY o_orderkey").rows
        src = coord.state.session.execute(
            f"{ORDERS_SRC} ORDER BY o_orderkey").rows
        assert back == src
        conn = coord.state.session.catalog.connector("orc")
        results.append((back, _table_files(conn._table_dir("out",
                                                           "port_t"))))
    (port_rows, port_files), (ref_rows, ref_files) = results
    assert port_rows == ref_rows
    assert port_files and port_files == ref_files


def test_ctas_into_memory_runs_as_the_reference_decides(cluster,
                                                       reference_cluster):
    """The memory connector stages no writes: both coordinators run the
    CTAS themselves and name the same reason."""
    verdicts = []
    for coord, cls in ((cluster[0], Client),
                       (reference_cluster[0], JaxClient)):
        client = _client(coord, cls)
        r = client.execute(f"CREATE TABLE memory.s.o AS {ORDERS_SRC}")
        assert r.rows == [[15000]]
        back = client.execute("SELECT count(*), sum(o_totalprice) "
                              "FROM memory.s.o")
        verdicts.append((back.rows, client.query_info(
            r.query_id).get("fallbackReason")))
    assert verdicts[0] == verdicts[1]
    assert verdicts[0][1] == "connector memory has no staged write support"


def test_standby_watches_and_promotes(tmp_path):
    """A standby coordinator over the primary's ledger and spool: passive
    (a statement answers 503 COORDINATOR_UNAVAILABLE, retryable), named
    to the workers in announce responses, and promoted by its watcher
    once the primary dies, as the reference's failover tests drive it."""
    from urllib.error import HTTPError
    ledger, spool = str(tmp_path / "query.ledger"), str(tmp_path / "spool")
    primary = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                                ledger_path=ledger, node_id="c1",
                                spool_root=spool).start()
    standby = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                                ledger_path=ledger, node_id="c2",
                                role="standby", peer_uri=primary.uri,
                                spool_root=spool,
                                standby_interval_s=0.1).start()
    worker = WorkerServer("hw", primary.uri, announce_interval_s=0.1,
                          device="cpu").start()
    try:
        _wait(lambda: len(primary.state.active_nodes()) == 1,
              what="the worker to announce")
        assert primary.state.role == "PRIMARY"
        assert standby.state.role == "PASSIVE"
        req = Request(f"{standby.uri}/v1/statement", data=b"SELECT 1",
                      headers={"X-Trino-User": "t"})
        with pytest.raises(HTTPError) as ei:
            urlopen(req, timeout=10)
        assert ei.value.code == 503
        err = json.loads(ei.value.read().decode())["error"]
        assert err["errorName"] == "COORDINATOR_UNAVAILABLE"
        assert err["retryable"] is True
        _wait(lambda: worker.coordinators == [primary.uri, standby.uri],
              what="the worker to learn the standby")
        primary.kill()
        _wait(lambda: standby.state.role == "PRIMARY", timeout=20,
              what="the standby's promotion")
        r = _client(standby).execute("SELECT count(*) FROM nation")
        assert r.rows == [[25]]
    finally:
        worker.stop(graceful=False)
        for c in (primary, standby):
            try:
                c.state.dispatcher.pool.shutdown(wait=False)
                c.stop()
            except Exception:  # noqa: BLE001 — a killed server dies twice
                pass
