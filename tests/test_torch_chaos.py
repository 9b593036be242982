"""The port's fault tolerance under seeded chaos (tpch.tiny, on the CPU).

The reference's chaos file (tests/test_chaos.py) carried over to
`trino_tpu_torch`: the RetryPolicy backoff, CRC32C page checksums, the
exchange spool's self-healing, the chaos injector's fault types and
seeded schedules, failure-detector hysteresis, and in-cluster
corruption recovery, straggler hedging (first-success-wins dedup), a
crash mid-split, a dropped task create and a seeded mini-soak, each
held to the reference's assertions. The parity cases at the end feed
the same seeds through both packages: backoff schedules, fault
schedules and corrupted bytes are equal, and the port cluster's rows
under chaos equal the JAX Session's.

Left out: the reference's 50-schedule soak (slow tier), which drives
`bench.py`, the JAX package's harness.
"""

import threading
import time

import numpy as np
import pytest

from trino_tpu_torch.client.client import Client
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.server.coordinator import CoordinatorServer
from trino_tpu_torch.server.exchange_spool import ExchangeSpool
from trino_tpu_torch.server.failureinjector import (
    CORRUPT, CRASH, DELAY, DROP, RAISE, FailureInjector, InjectedDrop,
    InjectedFailure)
from trino_tpu_torch.server.pageserde import (MAGIC, PageChecksumError,
                                              decode_page, encode_page,
                                              verify_page)
from trino_tpu_torch.server.retrypolicy import RetryPolicy
from trino_tpu_torch.server.worker import WorkerServer


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

def test_backoff_schedule_bounded_and_seeded():
    p = RetryPolicy(base_delay_s=0.01, max_delay_s=0.5, max_attempts=6,
                    seed=42)
    d1, d2 = list(p.delays()), list(p.delays())
    assert d1 == d2                       # deterministic per seed
    assert len(d1) == 5                   # attempts - 1 sleeps
    assert all(0.01 <= d <= 0.5 for d in d1)
    # different seeds decorrelate
    assert list(RetryPolicy(0.01, 0.5, 6, seed=7).delays()) != d1


def test_backoff_growth_is_exponential_in_expectation():
    # decorrelated jitter: each delay drawn from [base, prev*3] — the
    # CAP must engage for long schedules (no unbounded growth)
    p = RetryPolicy(base_delay_s=0.1, max_delay_s=1.0, max_attempts=50,
                    seed=3)
    ds = list(p.delays())
    assert max(ds) <= 1.0
    assert ds[-1] >= 0.1


def test_retry_call_retries_then_succeeds():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    slept = []
    p = RetryPolicy(0.01, 0.1, max_attempts=5, seed=0)
    assert p.call(flaky, sleep=slept.append) == "ok"
    assert len(calls) == 3 and len(slept) == 2


def test_retry_call_exhausts_attempts():
    p = RetryPolicy(0.001, 0.01, max_attempts=3, seed=0)
    calls = []

    def always():
        calls.append(1)
        raise OSError("down")

    with pytest.raises(OSError):
        p.call(always, sleep=lambda d: None)
    assert len(calls) == 3


def test_retry_call_respects_deadline_budget():
    p = RetryPolicy(base_delay_s=10.0, max_delay_s=10.0, max_attempts=5,
                    deadline_s=0.5, seed=0)
    calls = []

    def always():
        calls.append(1)
        raise OSError("down")

    with pytest.raises(OSError):
        p.call(always, sleep=lambda d: None)
    # first sleep (>=10s) would blow the 0.5s budget: exactly one try
    assert len(calls) == 1


def test_retry_call_does_not_catch_unlisted_errors():
    p = RetryPolicy(0.001, 0.01, max_attempts=5)
    with pytest.raises(ValueError):
        p.call(lambda: (_ for _ in ()).throw(ValueError("user error")),
               retry_on=(OSError,))


# ---------------------------------------------------------------------------
# CRC32C page checksums
# ---------------------------------------------------------------------------

def _frame():
    rng = np.random.default_rng(5)
    arrays = [rng.integers(-(1 << 40), 1 << 40, 64),
              rng.random(64)]
    valids = [np.ones(64, np.bool_), rng.random(64) < 0.9]
    return encode_page(arrays, valids)


def test_checksum_roundtrip():
    f = _frame()
    assert f[:4] == MAGIC
    verify_page(f)
    decode_page(f)


def test_every_single_bit_flip_is_detected():
    """CRC32C guarantees all 1-bit errors are caught; sweep EVERY bit of
    a whole frame (header, checksum field and body included) and require
    a detection — the zero-wrong-answer-escape property."""
    f = _frame()
    for bit in range(len(f) * 8):
        buf = bytearray(f)
        buf[bit >> 3] ^= 1 << (bit & 7)
        with pytest.raises((PageChecksumError, ValueError)):
            decode_page(bytes(buf))
            verify_page(bytes(buf))


def test_truncated_frame_rejected():
    f = _frame()
    with pytest.raises(PageChecksumError):
        verify_page(f[: len(f) // 2])
    with pytest.raises(PageChecksumError):
        verify_page(b"TPG2\x00\x01")


def test_legacy_v1_frame_still_decodes():
    """Rolling upgrade: checksum-free TPG1 frames decode unverified."""
    f = _frame()
    legacy = b"TPG1" + f[8:]           # strip the crc field
    verify_page(legacy)
    arrs, _ = decode_page(legacy)
    want, _ = decode_page(f)
    np.testing.assert_array_equal(arrs[0], want[0])


def test_spool_rejects_corrupt_pages_and_self_heals():
    """A corrupt spool container must read as a MISS (work re-dispatches)
    and be deleted so the next attempt rewrites it — never served."""
    spool = ExchangeSpool()
    f = _frame()
    spool.put("k", [f, f])
    assert spool.get("k") == [f, f]
    # flip one bit inside the second page's body, on disk
    import os
    path = spool._path("k")
    blob = bytearray(open(path, "rb").read())
    blob[-3] ^= 0x10
    open(path, "wb").write(bytes(blob))
    assert spool.get("k") is None
    assert spool.checksum_rejects == 1
    assert not os.path.exists(path)       # self-healed: container dropped


def test_spool_write_corruption_injected_is_caught_on_read():
    inj = FailureInjector(seed=9)
    inj.inject("SPOOL_WRITE", times=1, fault=CORRUPT)
    spool = ExchangeSpool(injector=inj)
    spool.put("k", [_frame()])
    assert inj.injected_by_fault[CORRUPT] == 1
    assert spool.get("k") is None         # CRC32C catches the bit-flip


def test_spool_read_write_faults_degrade_to_miss():
    inj = FailureInjector()
    inj.inject("SPOOL_WRITE", times=1, fault=RAISE)
    inj.inject("SPOOL_READ", times=1, fault=DROP)
    spool = ExchangeSpool(injector=inj)
    f = _frame()
    spool.put("k", [f])                   # injected write failure: skipped
    assert spool.write_skips == 1
    spool.put("k", [f])                   # second write succeeds
    assert spool.get("k") is None         # injected read failure: miss
    assert spool.get("k") == [f]          # then recovers


# ---------------------------------------------------------------------------
# FailureInjector
# ---------------------------------------------------------------------------

def test_injector_fault_types():
    inj = FailureInjector(seed=1)
    inj.inject("P", times=1, fault=RAISE)
    with pytest.raises(InjectedFailure):
        inj.maybe_fail("P", "x")
    inj.maybe_fail("P", "x")              # consumed: passes through

    inj.inject("P", times=1, fault=DROP)
    with pytest.raises(ConnectionResetError):   # OSError retry path
        inj.maybe_fail("P", "x")

    inj.inject("P", times=1, fault=DELAY, delay_s=0.15)
    t0 = time.monotonic()
    inj.maybe_fail("P", "x")              # sleeps, does not raise
    assert time.monotonic() - t0 >= 0.14

    assert inj.injected_count == 3
    assert len(inj.events) == 3


def test_injector_match_filters_site_key():
    inj = FailureInjector()
    inj.inject("P", times=5, match_sql="lineitem", fault=RAISE)
    inj.maybe_fail("P", "SELECT 1 FROM nation")      # no match: no fire
    with pytest.raises(InjectedFailure):
        inj.maybe_fail("P", "SELECT count(*) FROM lineitem")


def test_injector_corrupt_only_fires_on_payload_sites():
    inj = FailureInjector(seed=2)
    inj.inject("P", times=1, fault=CORRUPT)
    inj.maybe_fail("P", "x")              # CORRUPT rules skip maybe_fail
    page = _frame()
    out = inj.corrupt_page("P", "x", page)
    assert out != page and len(out) == len(page)
    with pytest.raises(PageChecksumError):
        verify_page(out)
    assert inj.corrupt_page("P", "x", page) == page   # consumed


def test_seeded_schedule_is_deterministic():
    for seed in range(20):
        a = FailureInjector.from_seed(seed).schedule()
        b = FailureInjector.from_seed(seed).schedule()
        assert [(r.point, r.fault, r.remaining, r.delay_s) for r in a] == \
            [(r.point, r.fault, r.remaining, r.delay_s) for r in b]
        for r in a:
            if r.fault == CORRUPT:
                assert r.point in ("SPOOL_WRITE", "EXCHANGE_DRAIN")


# ---------------------------------------------------------------------------
# failure-detector hysteresis (scheduler-reported failures)
# ---------------------------------------------------------------------------

def test_task_failure_engages_detector_hysteresis():
    """_mark_failed must fold into the detector's decayed NodeStats so
    neither a re-announce nor one clean ping resurrects a node whose
    task executor is wedged; sustained clean pings do."""
    from trino_tpu_torch.server.coordinator import CoordinatorState
    from trino_tpu_torch.server.failuredetector import HeartbeatFailureDetector
    state = CoordinatorState(Session(default_schema="tiny", device="cpu"))
    det = HeartbeatFailureDetector(state)          # not started: no pings
    assert state.failure_detector is det
    state.announce("w1", "http://127.0.0.1:1")
    state.scheduler._mark_failed("w1", RuntimeError("boom"))
    assert state.nodes["w1"].state == "FAILED"
    assert det.stats["w1"].failure_ratio > det.threshold
    # the wedged node's announcer keeps running: must NOT flip back
    state.announce("w1", "http://127.0.0.1:1")
    assert state.nodes["w1"].state == "FAILED"
    # several clean heartbeat samples decay the ratio below threshold
    while det.stats["w1"].failure_ratio > det.threshold:
        det.stats["w1"].record(True)
    state.announce("w1", "http://127.0.0.1:1")
    assert state.nodes["w1"].state == "ACTIVE"


# ---------------------------------------------------------------------------
# cluster-level chaos (real HTTP, 3 workers)
# ---------------------------------------------------------------------------

Q_AGG = ("SELECT l_returnflag, l_linestatus, sum(l_quantity) AS q, "
         "count(*) AS c FROM lineitem WHERE l_shipdate <= DATE "
         "'1998-09-02' GROUP BY l_returnflag, l_linestatus "
         "ORDER BY l_returnflag, l_linestatus")
Q_CONCAT = ("SELECT l_orderkey, l_quantity FROM lineitem "
            "WHERE l_shipdate > DATE '1998-11-01'")
Q_SORT = ("SELECT l_orderkey, l_linenumber FROM lineitem "
          "WHERE l_shipdate > DATE '1998-09-01' "
          "ORDER BY l_orderkey, l_linenumber")


def _json_vals(rows):
    return [tuple(v if v is None or isinstance(v, (int, float, str, bool))
                  else str(v) for v in r) for r in rows]


@pytest.fixture(scope="module")
def cluster():
    session = Session(default_schema="tiny", device="cpu")
    coord = CoordinatorServer(session, retry_policy="QUERY").start()
    sched = coord.state.scheduler
    sched.split_rows = 8192
    workers = [WorkerServer(f"worker-{i}", coord.uri,
                            announce_interval_s=0.1,
                            catalog=session.catalog, device="cpu").start()
               for i in range(3)]
    deadline = time.time() + 5
    while len(coord.state.active_nodes()) < 3 and time.time() < deadline:
        time.sleep(0.05)
    yield coord, workers, session
    for w in workers:
        w.stop()
    coord.stop()


@pytest.fixture(autouse=True)
def _clean(request):
    # only cluster tests pay for (and reset) the cluster
    if "cluster" not in request.fixturenames:
        yield
        return
    coord, workers, _ = request.getfixturevalue("cluster")
    sched = coord.state.scheduler
    sched.spool.clear()
    yield
    sched.failure_injector = None
    sched.spool.injector = None
    for w in workers:
        w.task_manager.injector = None
    # let failed nodes re-announce before the next test
    deadline = time.time() + 5
    while len(coord.state.active_nodes()) < 3 and time.time() < deadline:
        time.sleep(0.05)


def test_corrupt_page_detected_and_recovered(cluster):
    """A bit-flipped result page must be caught by CRC32C at drain and
    converted into a task retry — identical results, zero escapes."""
    coord, workers, session = cluster
    sched = coord.state.scheduler
    want = _json_vals(session.execute(Q_AGG).rows)
    inj = FailureInjector(seed=101)
    inj.inject("EXCHANGE_DRAIN", times=1, fault=CORRUPT)
    sched.failure_injector = inj
    r = Client(coord.uri, user="chaos").execute(Q_AGG)
    assert r.state == "FINISHED"
    assert _json_vals(r.rows) == want
    assert inj.injected_by_fault[CORRUPT] == 1
    assert sched.stats["checksum_failures"] >= 1
    assert sched.stats["task_retries"] >= 1


def test_straggler_hedged_and_deduped(cluster):
    """A delayed worker's unit is speculatively re-dispatched once it
    exceeds the hedge threshold; the fast attempt wins, the straggler's
    late output is dropped (first-success-wins) — row counts must match
    exactly (no duplicated splits)."""
    coord, workers, session = cluster
    sched = coord.state.scheduler
    want = sorted(_json_vals(session.execute(Q_CONCAT).rows))
    # warm the worker-side fragment (first execution pays XLA compile,
    # which would dominate the drain-time median the hedge keys off)
    Client(coord.uri, user="chaos").execute(Q_CONCAT)
    sched.spool.clear()
    inj = FailureInjector(seed=102)
    inj.inject("WORKER_TASK_RUN", times=1, fault=DELAY, delay_s=3.0)
    workers[0].task_manager.injector = inj
    sched.hedge_min_s, sched.hedge_multiplier = 0.1, 2.0
    hedged_before = sched.stats["hedged_tasks"]
    try:
        t0 = time.monotonic()
        r = Client(coord.uri, user="chaos").execute(Q_CONCAT)
        wall = time.monotonic() - t0
    finally:
        sched.hedge_min_s, sched.hedge_multiplier = 2.0, 4.0
    assert r.state == "FINISHED"
    assert sorted(_json_vals(r.rows)) == want       # exact multiset: dedup
    assert sched.stats["hedged_tasks"] > hedged_before
    assert wall < 2.5, f"hedge did not mitigate the 3s straggler: {wall}"


def test_worker_crash_mid_split_recovers(cluster):
    coord, workers, session = cluster
    sched = coord.state.scheduler
    want = _json_vals(session.execute(Q_AGG).rows)
    inj = FailureInjector(seed=103)
    inj.inject("WORKER_TASK_RUN", times=1, fault=CRASH)
    workers[1].task_manager.injector = inj
    r = Client(coord.uri, user="chaos").execute(Q_AGG)
    assert r.state == "FINISHED"
    assert _json_vals(r.rows) == want
    assert inj.injected_by_fault[CRASH] == 1


def test_task_create_drop_reassigns(cluster):
    coord, workers, session = cluster
    want = _json_vals(session.execute(Q_AGG).rows)
    inj = FailureInjector(seed=104)
    inj.inject("WORKER_TASK_CREATE", times=2, fault=DROP)
    for w in workers:
        w.task_manager.injector = inj
    r = Client(coord.uri, user="chaos").execute(Q_AGG)
    assert r.state == "FINISHED"
    assert _json_vals(r.rows) == want


def test_worker_announce_retries_until_coordinator_up():
    """A worker that boots before its coordinator must not permanently
    fail its announcement — the backoff policy carries it through."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    w = WorkerServer("early-bird", f"http://127.0.0.1:{port}",
                     announce_interval_s=0.1, device="cpu").start()
    try:
        time.sleep(0.2)                 # worker is already failing polls
        coord = CoordinatorServer(Session(default_schema="tiny", device="cpu"),
                                  port=port).start()
        try:
            deadline = time.time() + 5
            while time.time() < deadline:
                if any(n.node_id == "early-bird"
                       for n in coord.state.active_nodes()):
                    break
                time.sleep(0.05)
            assert any(n.node_id == "early-bird"
                       for n in coord.state.active_nodes())
        finally:
            coord.stop()
    finally:
        w.stop()


def test_client_timeout_cancels_server_side_query(cluster):
    """CLIENT_TIMEOUT must DELETE the executing URI before raising so
    the server-side query is canceled, not leaked."""
    from trino_tpu_torch.client.client import QueryError
    coord, workers, session = cluster
    inj = FailureInjector(seed=105)
    # hold the source stage long enough for a 0.3s client budget to lapse
    inj.inject("WORKER_TASK_RUN", times=3, fault=DELAY, delay_s=1.0)
    for w in workers:
        w.task_manager.injector = inj
    client = Client(coord.uri, user="chaos", timeout_s=0.3,
                    poll_interval_s=0.02)
    with pytest.raises(QueryError, match="client timeout"):
        client.execute(Q_AGG)
    # the leaked-query check: the coordinator's tracked query must reach
    # a terminal state promptly (canceled), not keep running
    deadline = time.time() + 10
    tq = coord.state.tracker.all()[-1]
    while not tq.state_machine.is_done() and time.time() < deadline:
        time.sleep(0.05)
    assert tq.state_machine.is_done()
    assert tq.state in ("CANCELED", "FINISHED", "FAILED")


def test_chaos_mini_soak_bit_identical(cluster):
    """Seeded mini-soak (fast tier): randomized schedules over the query
    matrix; every run must return bit-identical rows to the fault-free
    run. The 50-schedule soak runs as -m chaos / bench.py --chaos."""
    coord, workers, session = cluster
    sched = coord.state.scheduler
    client = Client(coord.uri, user="chaos")
    # Q_CONCAT carries no ORDER BY: page arrival order legitimately
    # varies under retry/hedging, so it compares as a multiset (exact
    # rows, any order); ordered queries compare exactly.
    matrix = {
        Q_AGG: (_json_vals(session.execute(Q_AGG).rows), False),
        Q_CONCAT: (sorted(_json_vals(session.execute(Q_CONCAT).rows)),
                   True),
    }
    for seed in range(4):
        inj = FailureInjector.from_seed(seed, max_delay_s=0.2)
        sched.failure_injector = inj
        det = coord.state.failure_detector
        if det is not None:
            det.injector = inj
        for w in workers:
            w.task_manager.injector = inj
        for q, (want, unordered) in matrix.items():
            sched.spool.clear()
            r = client.execute(q)
            assert r.state == "FINISHED", (seed, q)
            got = _json_vals(r.rows)
            if unordered:
                got = sorted(got)
            assert got == want, \
                f"seed {seed} changed results for {q!r}"
        sched.failure_injector = None
        for w in workers:
            w.task_manager.injector = None
        inj.clear()
        # let any FAILED nodes re-announce
        deadline = time.time() + 5
        while len(coord.state.active_nodes()) < 3 and \
                time.time() < deadline:
            time.sleep(0.05)


# ---------------------------------------------------------------------------
# cluster-internal shared secret (round-5 medium finding): with
# TRINO_TPU_INTERNAL_SECRET set, the worker data plane and the
# coordinator announce route reject callers without the header — a
# rogue process with network reach can neither join the cluster nor
# pull result pages.
# ---------------------------------------------------------------------------

def test_rogue_announce_and_secretless_page_pull_rejected(monkeypatch):
    import json
    import urllib.error
    from urllib.request import Request, urlopen

    from trino_tpu_torch.server.security import INTERNAL_HEADER

    monkeypatch.setenv("TRINO_TPU_INTERNAL_SECRET", "cluster-secret")
    session = Session(default_schema="tiny", device="cpu")
    coord = CoordinatorServer(session).start()
    worker = WorkerServer("sec-w0", coord.uri, announce_interval_s=0.1,
                          catalog=session.catalog, device="cpu").start()
    try:
        # the legitimate worker announces WITH the header and registers
        deadline = time.time() + 5
        while not coord.state.active_nodes() and time.time() < deadline:
            time.sleep(0.05)
        assert [n.node_id for n in coord.state.active_nodes()] == \
            ["sec-w0"]

        # a rogue worker's announce (no header) is rejected with 401
        # and never enters the node inventory
        body = json.dumps({"nodeId": "rogue", "uri": "http://evil:1"}
                          ).encode()
        req = Request(f"{coord.uri}/v1/announce", data=body,
                      headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urlopen(req, timeout=5)
        assert e.value.code == 401
        assert "rogue" not in coord.state.nodes

        # a secretless page pull off the worker data plane is rejected
        # before any task lookup happens
        with pytest.raises(urllib.error.HTTPError) as e:
            urlopen(f"{worker.uri}/v1/task/any/results/0/0", timeout=5)
        assert e.value.code == 401
        # task status and task creation are equally closed
        with pytest.raises(urllib.error.HTTPError) as e:
            urlopen(f"{worker.uri}/v1/task/any", timeout=5)
        assert e.value.code == 401

        # with the right header the route works (404: unknown task —
        # authentication passed, resource genuinely absent)
        req = Request(f"{worker.uri}/v1/task/any",
                      headers={INTERNAL_HEADER: "cluster-secret"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urlopen(req, timeout=5)
        assert e.value.code == 404

        # a wrong secret is as good as none
        req = Request(f"{worker.uri}/v1/task/any",
                      headers={INTERNAL_HEADER: "wrong"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urlopen(req, timeout=5)
        assert e.value.code == 401

        # liveness + metrics stay open for probes and scrapers
        for route in ("/v1/status", "/v1/metrics"):
            with urlopen(f"{worker.uri}{route}", timeout=5) as resp:
                assert resp.status == 200
    finally:
        worker.stop()
        coord.stop()


def test_secured_cluster_still_executes_distributed(monkeypatch):
    """End-to-end under the shared secret: scheduler task POSTs, status
    polls, and exchange pulls all carry the header, so a secured
    cluster behaves exactly like an open one for its members."""
    monkeypatch.setenv("TRINO_TPU_INTERNAL_SECRET", "s3cret")
    session = Session(default_schema="tiny", device="cpu")
    coord = CoordinatorServer(session).start()
    coord.state.scheduler.split_rows = 8192
    workers = [WorkerServer(f"sec-w{i}", coord.uri,
                            announce_interval_s=0.1,
                            catalog=session.catalog, device="cpu").start()
               for i in range(2)]
    try:
        deadline = time.time() + 5
        while len(coord.state.active_nodes()) < 2 and \
                time.time() < deadline:
            time.sleep(0.05)
        client = Client(coord.uri, user="sec")
        r = client.execute(
            "SELECT count(*), sum(l_quantity) FROM lineitem")
        assert r.rows[0][0] > 0
        info = client.query_info(r.query_id)
        assert info["distributed"], info
    finally:
        for w in workers:
            w.stop()
        coord.stop()


# ---------------------------------------------------------------------------
# parity with the reference: the same seeds give the same schedules,
# the same corrupted bytes and the same rows
# ---------------------------------------------------------------------------

def _rules(inj):
    return [(r.point, r.fault, r.remaining, r.delay_s, r.match)
            for r in inj.schedule()]


@pytest.mark.parametrize("seed", [0, 3, 7, 42])
def test_backoff_schedule_equals_reference(seed):
    from trino_tpu.server.retrypolicy import RetryPolicy as JaxRetryPolicy
    kw = dict(base_delay_s=0.05, max_delay_s=2.0, max_attempts=12,
              seed=seed)
    assert list(RetryPolicy(**kw).delays()) == \
        list(JaxRetryPolicy(**kw).delays())


@pytest.mark.parametrize("seed", range(8))
def test_seeded_fault_schedule_equals_reference(seed):
    from trino_tpu.server.failureinjector import \
        FailureInjector as JaxInjector
    port = FailureInjector.from_seed(seed, max_delay_s=0.2)
    ref = JaxInjector.from_seed(seed, max_delay_s=0.2)
    assert _rules(port) == _rules(ref)
    # the same bit flips in the same page
    page = _frame()
    for inj in (port, ref):
        inj.clear()
        inj.inject("EXCHANGE_DRAIN", times=1, fault=CORRUPT)
    assert port.corrupt_page("EXCHANGE_DRAIN", "k", page) == \
        ref.corrupt_page("EXCHANGE_DRAIN", "k", page)


def test_chaos_rows_equal_reference_session(cluster):
    """Under seed 5's schedule the port cluster answers the JAX
    Session's rows (the multiset query as a multiset)."""
    from trino_tpu.exec.session import Session as JaxSession
    coord, workers, _ = cluster
    sched = coord.state.scheduler
    ref = JaxSession(default_schema="tiny")
    inj = FailureInjector.from_seed(5, max_delay_s=0.2)
    sched.failure_injector = inj
    for w in workers:
        w.task_manager.injector = inj
    client = Client(coord.uri, user="chaos")
    for q, unordered in ((Q_AGG, False), (Q_CONCAT, True)):
        sched.spool.clear()
        r = client.execute(q)
        assert r.state == "FINISHED"
        got, want = _json_vals(r.rows), _json_vals(ref.execute(q).rows)
        if unordered:
            got, want = sorted(got), sorted(want)
        assert got == want, q
