"""The port's elastic cluster membership on the CPU (tpch.tiny).

The reference's elastic file (tests/test_elastic.py) carried over to
`trino_tpu_torch`: the worker lifecycle state machine (ACTIVE ->
DRAINING -> DRAINED -> LEFT), drain handoff as split MIGRATION (not
failure), join-mid-stream, a crash mid-drain, and per-tenant isolation
with fair-share routing. The drain contract under test: an admin
`PUT /v1/info/state` stops task intake immediately (409
NODE_DRAINING), in-flight splits finish or hand off to survivors
through the retry machinery WITHOUT burning retry budget, buffered
exchange pages stay pullable through the flush grace, and the final
LEFT announce deregisters the node — all while results stay bit-exact
against a single-process oracle. The parity cases at the end feed the
same seeded transition walks and tenant admissions through both
packages, and hold the drained cluster's rows to the JAX Session's.

Left out: the reference's three tests of the BENCH_soak harness
(`test_elastic_soak_smoke`, `test_check_regressions_gates_soak_series`,
`test_load_bench_round_parses_soak_record`), which drive `bench.py`,
the JAX package's harness."""

import json
import os
import sys
import threading
import time
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

from trino_tpu_torch.client.client import Client                   # noqa: E402
from trino_tpu_torch.exec.session import Session                   # noqa: E402
from trino_tpu_torch.server.coordinator import CoordinatorServer   # noqa: E402
from trino_tpu_torch.server.security import (INTERNAL_HEADER,      # noqa: E402
                                             internal_headers)
from trino_tpu_torch.server.worker import WorkerServer             # noqa: E402

Q_AGG = ("SELECT l_returnflag, l_linestatus, sum(l_quantity), "
         "count(*) FROM lineitem GROUP BY l_returnflag, l_linestatus "
         "ORDER BY l_returnflag, l_linestatus")


def _vals(rows):
    return [tuple(v if v is None or isinstance(v, (int, float, str, bool))
                  else str(v) for v in r) for r in rows]


def _put_state(uri, state, headers=None, timeout=10):
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(internal_headers() if headers is None else headers)
    req = Request(f"{uri}/v1/info/state",
                  data=json.dumps({"state": state}).encode(),
                  method="PUT", headers=hdrs)
    with urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


@pytest.fixture(scope="module")
def cluster():
    session = Session(default_schema="tiny", device="cpu")
    coord = CoordinatorServer(session, retry_policy="QUERY").start()
    sched = coord.state.scheduler
    sched.split_rows = 8192
    workers = [WorkerServer(f"elastic-w{i}", coord.uri,
                            announce_interval_s=0.1,
                            catalog=session.catalog, device="cpu").start()
               for i in range(3)]
    deadline = time.time() + 5
    while len(coord.state.active_nodes()) < 3 and time.time() < deadline:
        time.sleep(0.05)
    yield coord, workers, session
    for w in workers:
        w.kill()
    coord.stop()


@pytest.fixture(autouse=True)
def _settle(request):
    # every cluster test leaves the 3 module workers ACTIVE and
    # re-registered before the next one runs
    if "cluster" not in request.fixturenames:
        yield
        return
    coord, workers, _ = request.getfixturevalue("cluster")
    yield
    deadline = time.time() + 5
    while len(coord.state.active_nodes()) < 3 and time.time() < deadline:
        time.sleep(0.05)
    assert len(coord.state.active_nodes()) >= 3


# ---------------------------------------------------------------------------
# lifecycle state machine
# ---------------------------------------------------------------------------

def test_lifecycle_ratchet_edges():
    """The transition table is a one-way ratchet: no skipping DRAINING,
    no resurrecting a LEFT node, but a DRAINING node may be reverted to
    ACTIVE by an admin cancel."""
    w = WorkerServer("ratchet", "http://127.0.0.1:9", device="cpu")
    try:
        assert w.state == "ACTIVE"
        assert not w._transition("DRAINED")      # cannot skip DRAINING
        assert not w._transition("LEFT")
        assert w._transition("DRAINING")
        assert w._transition("ACTIVE")           # admin cancel
        assert w._transition("DRAINING")
        assert not w._transition("LEFT")         # must pass DRAINED
        assert w._transition("DRAINED")
        assert not w._transition("ACTIVE")       # past the point of return
        assert w._transition("LEFT")
        assert not w._transition("ACTIVE")       # LEFT is terminal
        assert w.drained()
    finally:
        w.httpd.server_close()


def test_admin_drain_under_load_bit_exact(cluster):
    """Join a 4th worker mid-stream, then admin-drain it while queries
    are in flight: every query stays bit-exact, the drain reaches LEFT,
    the node deregisters, and nothing is orphaned on it."""
    coord, workers, session = cluster
    sched = coord.state.scheduler
    want = _vals(session.execute(Q_AGG).rows)

    w3 = WorkerServer("elastic-w3", coord.uri, announce_interval_s=0.1,
                      catalog=session.catalog, device="cpu").start()
    deadline = time.time() + 5
    while len(coord.state.active_nodes()) < 4 and time.time() < deadline:
        time.sleep(0.05)
    assert len(coord.state.active_nodes()) == 4

    results, stop = [], threading.Event()

    def stream():
        client = Client(coord.uri, user="elastic")
        while not stop.is_set():
            results.append(_vals(client.execute(Q_AGG).rows))

    # drop any spooled stage outputs so the stream dispatches real
    # tasks (the durable spool would otherwise replay earlier runs of
    # the same fragment and the joiner would never see a split)
    sched.spool.clear()
    t = threading.Thread(target=stream, daemon=True)
    t.start()
    # drain only once the joiner has demonstrably taken work — a fixed
    # sleep races the first query's dispatch against the drain
    deadline = time.time() + 15
    while time.time() < deadline and not any(
            rec.get("node") == "elastic-w3" for rec in sched.task_history):
        time.sleep(0.05)
    assert any(rec.get("node") == "elastic-w3"
               for rec in sched.task_history)
    status, body = _put_state(w3.uri, "DRAINING")
    assert status == 200
    assert body["state"] in ("DRAINING", "DRAINED", "LEFT")
    deadline = time.time() + 30
    while not w3.drained() and time.time() < deadline:
        time.sleep(0.05)
    stop.set()
    t.join(timeout=60)
    assert w3.drained(), w3.state
    # deregistered: the LEFT announce removed it from the node map
    with coord.state.nodes_lock:
        assert "elastic-w3" not in coord.state.nodes
    # nothing orphaned: no in-flight tasks, no unpulled buffers
    assert w3.task_manager.inflight() == []
    # the joiner actually participated before leaving
    assert any(rec.get("node") == "elastic-w3"
               for rec in sched.task_history)
    assert len(results) > 0
    assert all(r == want for r in results)
    w3.kill()


def test_draining_node_migrates_splits_without_retry_penalty(cluster):
    """A node that starts refusing work (409 NODE_DRAINING) before the
    coordinator learns it is draining: the scheduler re-places its
    splits on survivors as MIGRATIONS — splits_migrated grows, the
    retry counter does not, and the result is still bit-exact."""
    coord, workers, session = cluster
    sched = coord.state.scheduler
    want = _vals(session.execute(Q_AGG).rows)
    w2 = workers[2]
    orig_announce = w2.announce_once
    # keep announcing ACTIVE so the scheduler keeps placing splits on
    # the refusing node (the race window a real drain always has)
    w2.announce_once = lambda attempts=5, state=None: \
        orig_announce(attempts, "ACTIVE")
    w2.state = "DRAINING"
    # a spool-served repeat of Q_AGG dispatches no task, so nothing
    # would reach the refusing node
    sched.spool.clear()
    retries0 = sched.stats["task_retries"]
    migrated0 = sched.stats["splits_migrated"]
    try:
        r = Client(coord.uri, user="elastic").execute(Q_AGG)
        assert r.state == "FINISHED"
        assert _vals(r.rows) == want
        assert sched.stats["splits_migrated"] > migrated0
        assert sched.stats["task_retries"] == retries0, \
            "drain handoff must not burn retry budget"
    finally:
        w2.state = "ACTIVE"
        w2.announce_once = orig_announce


def test_mid_drain_crash_detected_as_failed(cluster):
    """A worker that dies mid-drain must not stay DRAINING forever: the
    failure detector's unreachability signal overrides the last
    reported lifecycle state, and the cluster keeps serving."""
    from trino_tpu_torch.server.failuredetector import HeartbeatFailureDetector
    coord, workers, session = cluster
    want = _vals(session.execute(Q_AGG).rows)
    wx = WorkerServer("elastic-crash", coord.uri, announce_interval_s=0.1,
                      catalog=session.catalog, device="cpu").start()
    deadline = time.time() + 5
    while len(coord.state.active_nodes()) < 4 and time.time() < deadline:
        time.sleep(0.05)
    detector = HeartbeatFailureDetector(coord.state,
                                        interval_s=0.05).start()
    try:
        wx.state = "DRAINING"             # mid-drain: never reaches LEFT
        deadline = time.time() + 5
        while time.time() < deadline:
            with coord.state.nodes_lock:
                node = coord.state.nodes.get("elastic-crash")
                if node is not None and node.state == "DRAINING":
                    break
            time.sleep(0.05)
        with coord.state.nodes_lock:
            assert coord.state.nodes["elastic-crash"].state == "DRAINING"
        wx.kill()                         # crash before DRAINED
        deadline = time.time() + 10
        while time.time() < deadline:
            with coord.state.nodes_lock:
                if coord.state.nodes["elastic-crash"].state == "FAILED":
                    break
            time.sleep(0.05)
        with coord.state.nodes_lock:
            assert coord.state.nodes["elastic-crash"].state == "FAILED"
        r = Client(coord.uri, user="elastic").execute(Q_AGG)
        assert _vals(r.rows) == want
    finally:
        detector.stop()
        with coord.state.nodes_lock:
            coord.state.nodes.pop("elastic-crash", None)


def test_lifecycle_state_visible_in_info_and_nodes_table(cluster):
    """The reported state flows worker /v1/info -> announce ->
    system.runtime.nodes, and a DRAINING node drops out of
    active_nodes() (so placement and hedging skip it)."""
    coord, workers, session = cluster
    w2 = workers[2]
    with urlopen(f"{w2.uri}/v1/info", timeout=5) as resp:
        assert json.loads(resp.read().decode())["state"] == "ACTIVE"
    w2.state = "DRAINING"
    try:
        deadline = time.time() + 5
        while time.time() < deadline:
            with coord.state.nodes_lock:
                if coord.state.nodes["elastic-w2"].state == "DRAINING":
                    break
            time.sleep(0.05)
        assert "elastic-w2" not in \
            {n.node_id for n in coord.state.active_nodes()}
        rows = Client(coord.uri, user="elastic").execute(
            "SELECT node_id, state FROM system.runtime.nodes").rows
        states = {r[0]: r[1] for r in rows}
        assert states["elastic-w2"] == "DRAINING"
        assert states["elastic-w0"] == "ACTIVE"
    finally:
        w2.state = "ACTIVE"


def test_rogue_drain_rejected_without_internal_secret(cluster,
                                                      monkeypatch):
    """On a secured cluster the drain route is cluster-internal: a PUT
    without the shared secret is a 401 AUTHENTICATION_FAILED and the
    worker stays ACTIVE; the same request with the secret succeeds."""
    coord, workers, _ = cluster
    w0 = workers[0]
    monkeypatch.setenv("TRINO_TPU_INTERNAL_SECRET", "s3cr3t")
    with pytest.raises(HTTPError) as ei:
        _put_state(w0.uri, "DRAINING", headers={})
    assert ei.value.code == 401
    body = json.loads(ei.value.read().decode())
    assert body["error"]["errorName"] == "AUTHENTICATION_FAILED"
    assert w0.state == "ACTIVE"
    # wrong secret is just as dead
    with pytest.raises(HTTPError) as ei:
        _put_state(w0.uri, "DRAINING",
                   headers={INTERNAL_HEADER: "wrong"})
    assert ei.value.code == 401
    assert w0.state == "ACTIVE"
    # the real secret passes (ACTIVE request: a no-op cancel)
    status, body = _put_state(w0.uri, "ACTIVE",
                              headers={INTERNAL_HEADER: "s3cr3t"})
    assert status == 200 and body["state"] == "ACTIVE"


# ---------------------------------------------------------------------------
# per-tenant isolation
# ---------------------------------------------------------------------------

def test_tenant_tree_soft_limit_queues_then_admits():
    """Per-tenant resource groups gate admission on the soft memory
    limit: under pressure a tenant's queries queue; when the cluster
    memory tick reports pressure cleared, they admit — and other
    tenants without a limit are never blocked."""
    from trino_tpu_torch.server.resourcegroups import tenant_tree
    rgm = tenant_tree({"alpha": {},
                       "beta": {"hard_concurrency_limit": 2,
                                "soft_memory_limit_bytes": 1000}})
    assert rgm.tenant_of("beta-7") == "beta"
    assert rgm.tenant_of("alpha-0") == "alpha"
    assert rgm.tenant_of("nobody") == "default"
    ran = []
    for r in rgm.set_cluster_memory(5000):   # pressure above beta's soft
        r()
    rgm.submit("beta-1", lambda: ran.append("beta"))
    assert ran == [], "beta must stay queued under memory pressure"
    rgm.submit("alpha-1", lambda: ran.append("alpha"))
    assert ran == ["alpha"], "alpha has no soft limit and runs"
    for r in rgm.set_cluster_memory(0):      # pressure cleared
        r()
    assert ran == ["alpha", "beta"], "beta admits once memory drops"


def test_tenant_fair_share_contention_signal():
    """TenantFairShare sees contention only from OTHER tenants' device
    occupancy — a tenant is never contended by itself."""
    from trino_tpu_torch.exec.router import TenantFairShare
    fs = TenantFairShare()
    assert not fs.contended_by_others("alpha")
    fs.device_begin("beta")
    assert fs.contended_by_others("alpha")
    assert not fs.contended_by_others("beta")
    fs.device_begin("alpha")
    assert fs.contended_by_others("beta")
    fs.device_end("beta")
    assert not fs.contended_by_others("alpha")
    fs.device_end("alpha")
    assert fs.inflight() == {}


def test_tenant_label_flows_to_metrics_and_tracker(cluster):
    """A query from tenant user beta-1 is counted under its tenant in
    trino_tpu_tenant_queries_total and stamped on the tracked query."""
    from trino_tpu_torch.metrics import REGISTRY
    from trino_tpu_torch.server.resourcegroups import tenant_tree
    coord, workers, _ = cluster
    dispatcher = coord.state.dispatcher
    saved = dispatcher.resource_groups
    dispatcher.resource_groups = tenant_tree(
        {"alpha": {}, "beta": {}, "gamma": {}})
    key = ("trino_tpu_tenant_queries_total", "beta")
    before = REGISTRY.snapshot().get(key, 0)
    try:
        r = Client(coord.uri, user="beta-1").execute(
            "SELECT count(*) FROM nation")
        assert r.rows[0][0] == 25
        assert REGISTRY.snapshot().get(key, 0) == before + 1
        tq = next(q for q in coord.state.tracker.all()
                  if q.session_user == "beta-1")
        assert tq.tenant == "beta"
    finally:
        dispatcher.resource_groups = saved


# ---------------------------------------------------------------------------
# parity with the reference on the same inputs
# ---------------------------------------------------------------------------

_LIFECYCLE = ("ACTIVE", "DRAINING", "DRAINED", "LEFT", "FAILED")


@pytest.mark.parametrize("seed", range(3))
def test_lifecycle_walk_equals_reference(seed):
    """A seeded walk of transition attempts: the port's ratchet accepts
    and refuses exactly what the reference's does."""
    import random

    from trino_tpu.server.worker import WorkerServer as JaxWorker
    rng = random.Random(seed)
    walk = [rng.choice(_LIFECYCLE) for _ in range(40)]
    trails = []
    for w in (WorkerServer(f"walk{seed}", "http://127.0.0.1:9",
                           device="cpu"),
              JaxWorker(f"walk{seed}", "http://127.0.0.1:9")):
        try:
            trails.append([(w._transition(st), w.state) for st in walk])
        finally:
            w.httpd.server_close()
    assert trails[0] == trails[1]


@pytest.mark.parametrize("seed", range(3))
def test_tenant_admission_equals_reference(seed):
    """Seeded submissions, completions and memory ticks through the
    tenant trees of both packages: the same queries run in the same
    order and the groups report the same counters."""
    import random

    from trino_tpu.server.resourcegroups import tenant_tree as jax_tree
    from trino_tpu_torch.server.resourcegroups import tenant_tree
    spec = {"alpha": {},
            "beta": {"hard_concurrency_limit": 2,
                     "soft_memory_limit_bytes": 1000},
            "gamma": {"hard_concurrency_limit": 1, "max_queued": 3}}
    rng = random.Random(seed)
    ops = []
    for i in range(60):
        r = rng.random()
        user = rng.choice(["alpha-1", "beta-2", "gamma-3", "nobody"])
        if r < 0.55:
            ops.append(("submit", user, i))
        elif r < 0.85:
            ops.append(("finish", user, i))
        else:
            ops.append(("memory", rng.choice([0, 500, 5000]), i))
    trails = []
    for tree in (tenant_tree, jax_tree):
        rgm, ran, trail = tree(spec), [], []
        for op, arg, i in ops:
            try:
                if op == "submit":
                    rgm.submit(arg, lambda i=i: ran.append(i))
                elif op == "finish":
                    nxt = rgm.finished(rgm.select(arg).path)
                    if nxt is not None:
                        nxt()
                else:
                    for run in rgm.set_cluster_memory(arg):
                        run()
                trail.append("ok")
            except Exception as e:  # noqa: BLE001 — compared, not hidden
                trail.append(type(e).__name__)
        trails.append((list(ran), trail,
                       sorted((g["group"], g["running"], g["queued"])
                              for g in rgm.info())))
    assert trails[0] == trails[1]


def test_drained_cluster_rows_equal_reference(cluster):
    from trino_tpu.exec.session import Session as JaxSession
    coord, workers, _ = cluster
    coord.state.scheduler.spool.clear()
    r = Client(coord.uri, user="elastic").execute(Q_AGG)
    assert r.state == "FINISHED"
    assert _vals(r.rows) == \
        _vals(JaxSession(default_schema="tiny").execute(Q_AGG).rows)
