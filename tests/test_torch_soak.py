"""The port's soaks (trino_tpu_torch/soak.py) on the CPU (tpch.tiny).

Each of the seven soaks runs at a smoke length with `device="cpu"` and
is held to the gates of the reference's own soak tests
(tests/test_serving.py, tests/test_elastic.py, tests/test_chaos.py,
tests/test_deadlines.py). The elastic smoke asserts every gate but the
three that read the per-tenant p99 SLOs (`tenants[*].slo_ok`,
`fair_share_held`, `passed`): those are timing gates, asserted on the
card by chip_smoke.py and here in the slow tier.

The parity cases run the reference's harness (bench.py) beside the port
at the same small arguments: the same record keys, the same gate
booleans, the same injected-fault schedule for each seed, and oracle
rows from the port's CPU Session equal to the JAX Session's.
"""

import json
import os
import sys
import time

import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

from trino_tpu_torch import soak                                 # noqa: E402
from trino_tpu_torch.metrics import SOAK_SLO_VIOLATIONS          # noqa: E402

torch.set_num_threads(1)


def _keys(rec, prefix=""):
    """Every key path of a record, nested dicts included (the values of
    per-seed / per-point / per-fault maps are data, not keys)."""
    out = set()
    for k, v in rec.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k in ("mixes", "tenants"):
            for name, sub in v.items():
                out |= {f"{prefix}{k}.{name}.{s}" for s in sub}
    return out


# ---------------------------------------------------------------------------
# tier 1: each soak at a smoke length, held to the reference's gates
# ---------------------------------------------------------------------------

def test_concurrency_soak_smoke(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rec = soak.concurrency_soak(n_clients=12, queries_per_client=3,
                                device="cpu")
    assert rec["wrong_answers"] == 0
    assert rec["failed_queries"] == 0
    assert rec["result_cache_hits"] > 0
    assert rec["plan_cache_hits"] > 0
    assert rec["router_host"] > 0 and rec["router_device"] > 0
    assert rec["invalidation_proven"]
    assert rec["passed"], rec
    assert rec["queries"] == 36
    assert os.listdir(tmp_path) == [], "a soak wrote a file unasked"


def test_chaos_soak_smoke():
    rec = soak.chaos_soak(n_seeds=4, device="cpu")
    assert rec["schedules"] == 4
    assert rec["wrong_answers"] == 0
    assert rec["failed_queries"] == 0
    assert rec["injected_total"] > 0
    assert soak.gates_held(rec)


def test_overload_soak_smoke():
    rec = soak.overload_soak(device="cpu")
    assert rec["wrong_answers"] == 0
    assert rec["rejected_total"] > 0
    assert rec["deadline_kills"] == 3 and rec["canceled"] == 4, rec
    assert rec["tasks_terminal"] and rec["pools_drained"]
    assert rec["passed"], rec


def test_deadline_kill_leaves_workers_schedulable():
    """The overload soak's second wave submits its next wedged query
    right after the last one's deadline kill. The kill cuts the task
    drains short; that must not mark the (healthy) workers FAILED, or
    the next query finds no active worker, runs on the coordinator
    alone and FINISHES under a deadline that should have fired. The
    workers here never re-announce, so only the kill path decides. The
    kill's cancel request must not outlive the query either: the next
    distributed query's final stage runs on the same executor."""
    from trino_tpu_torch.client.client import Client, QueryError
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.failureinjector import HANG, FailureInjector
    from trino_tpu_torch.server.worker import WorkerServer
    session = Session(default_schema="tiny", device="cpu")
    coord = CoordinatorServer(session, retry_policy="QUERY").start()
    sched = coord.state.scheduler
    sched.split_rows = 8192
    workers = [WorkerServer(f"dk{i}", coord.uri, announce_interval_s=3600,
                            catalog=session.catalog, device="cpu").start()
               for i in range(3)]
    inj = FailureInjector(seed=722)
    q, _ = soak.CHAOS_QUERIES["agg"]
    try:
        deadline = time.time() + 10
        while len(coord.state.active_nodes()) < 3 and \
                time.time() < deadline:
            time.sleep(0.02)
        want = Client(coord.uri, user="dk").execute(q).rows
        session.properties["query_max_run_time_s"] = 1.0
        inj.inject("WORKER_TASK_RUN", times=3, fault=HANG, delay_s=8.0)
        for w in workers:
            w.task_manager.injector = inj
        sched.spool.clear()
        with pytest.raises(QueryError) as ei:
            Client(coord.uri, user="dk", timeout_s=30).execute(q)
        assert ei.value.error_name == "QUERY_EXCEEDED_RUN_TIME"
        assert sorted(n.node_id for n in coord.state.active_nodes()) == \
            ["dk0", "dk1", "dk2"]
        inj.clear()
        session.properties.pop("query_max_run_time_s", None)
        sched.spool.clear()
        tasks0 = sched.stats["tasks"]
        r = Client(coord.uri, user="dk").execute(q)
        assert r.rows == want
        assert sched.stats["tasks"] > tasks0
    finally:
        inj.clear()
        for w in workers:
            w.task_manager.injector = None
            w.stop()
        coord.stop()


def test_write_chaos_soak_smoke():
    rec = soak.write_chaos_soak(n_seeds=6, device="cpu")
    assert rec["seeds"] == 6
    assert rec["injected_by_point"] == {"WRITE_STAGE": 2,
                                        "WRITE_COMMIT": 2,
                                        "WRITE_PUBLISH": 2}
    assert rec["lost_rows"] == 0 and rec["dup_rows"] == 0
    assert rec["orphans"] == 0
    assert rec["failed_writes"] == 0
    assert rec["passed"], rec


def test_coordinator_chaos_soak_smoke():
    rec = soak.coordinator_chaos_soak(n_seeds=5, device="cpu")
    assert rec["kills_by_phase"] == {p: 1 for p in soak.COORD_CHAOS_PHASES}
    assert rec["wrong_results"] == 0
    assert rec["lost_rows"] == 0 and rec["dup_rows"] == 0
    assert rec["client_errors"] == 0
    assert rec["failovers"] >= rec["seeds"] == 5
    assert rec["passed"], rec


@pytest.mark.parametrize("seed", [4, 9])
def test_coordinator_chaos_write_seed_with_distributed_standby(seed,
                                                               monkeypatch):
    """The coordinator-chaos soak's WRITE_COMMIT seeds (4: detector
    promotion, 9: admin promotion) with both coordinators' sessions at
    split_rows = 4096, so the standby's resumed CTAS goes distributed
    while the killed primary's dispatch thread takes its injected CRASH
    at WRITE_COMMIT and aborts. The fence keeps that abort off the
    standby's staged files: no client error, no lost or duplicate row,
    the table published under the client's query id, and no staged
    write under a `local_<uuid>` id on a coordinator's dispatch
    thread."""
    import threading
    from trino_tpu_torch.exec.session import SESSION_PROPERTY_DEFAULTS
    from trino_tpu_torch.server import writeprotocol as wp
    monkeypatch.setitem(SESSION_PROPERTY_DEFAULTS, "split_rows",
                        (4096, int))
    local = []
    real = wp.commit

    def commit(table_dir, query_id, *a, **k):
        if query_id.startswith("local_") and \
                threading.current_thread().name.startswith("dispatch"):
            local.append(query_id)
        return real(table_dir, query_id, *a, **k)

    monkeypatch.setattr(wp, "commit", commit)
    one = soak.coordinator_chaos_seed(seed, device="cpu")
    assert one["phase"] == "WRITE_COMMIT"
    assert not one["client_error"], one
    assert one["lost_rows"] == 0 and one["dup_rows"] == 0, one
    assert one["committed_rows"] == 15000, one
    assert one["failovers"] >= 1
    assert local == []


def test_memory_pressure_soak_smoke():
    rec = soak.memory_pressure_soak(n_queries=6, device="cpu")
    assert rec["queries"] + rec["oom_user_errors"] == 6
    assert rec["wrong_answers"] == 0
    assert rec["worker_crashes"] == 0
    assert rec["failed_queries"] == 0
    assert rec["pool_limit_bytes"] < rec["working_set_bytes"]
    assert rec["passed"], rec


def test_elastic_soak_smoke(tmp_path):
    """The gates of the reference's smoke but the three that read the
    per-tenant p99 SLOs; the SLO counter is fed as the reference feeds
    it."""
    v0 = SOAK_SLO_VIOLATIONS.value()
    out = tmp_path / "soak.json"
    rec = soak.elastic_soak(duration_s=7.0, out_path=str(out), device="cpu")
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert rec["wrong_answers"] == 0
    assert rec["failed_queries"] == 0
    assert rec["orphaned_splits"] == 0
    assert rec["drain_completed"] and rec["drained_node_deregistered"]
    assert rec["join_received_splits"]
    assert rec["writes_visible"]
    assert rec["lifecycle_transitions"]["LEFT"] >= 1
    tel = rec["telemetry"]
    fed = sum(tel["interval_slo_violations"].values()) + sum(
        not t["slo_ok"] for t in rec["tenants"].values())
    assert SOAK_SLO_VIOLATIONS.value() - v0 == fed


def test_cli_runs_one_soak_and_exits_on_its_gates(tmp_path, capsys):
    out = tmp_path / "rec.json"
    rc = soak.main(["--concurrency", "--clients", "4",
                    "--queries-per-client", "1", "--device", "cpu",
                    "--out", str(out)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(out.read_text())
    assert printed["metric"] == "concurrency_soak"
    assert printed["clients"] == 4 and printed["queries_per_client"] == 1
    assert rc == (0 if printed["passed"] else 1)
    with pytest.raises(SystemExit):
        soak.build_parser().parse_args(["--chaos", "--soak"])
    assert not soak.gates_held({"metric": "chaos_soak", "wrong_answers": 0,
                                "failed_queries": 0, "injected_total": 0})


# ---------------------------------------------------------------------------
# parity with the reference's harness
# ---------------------------------------------------------------------------

def _jax_session():
    from trino_tpu.exec.session import Session
    return Session(default_schema="tiny")


def _port_session():
    from trino_tpu_torch.exec.session import Session
    return Session(default_schema="tiny", device="cpu")


def test_concurrency_soak_parity_with_reference():
    import bench
    ref = bench.concurrency_soak(n_clients=12, queries_per_client=3,
                                 out_path=None)
    got = soak.concurrency_soak(n_clients=12, queries_per_client=3,
                                device="cpu")
    assert _keys(got) == _keys(ref)
    for gate in ("wrong_answers", "failed_queries"):
        assert (got[gate] == 0) == (ref[gate] == 0), gate
    for gate in ("result_cache_hits", "plan_cache_hits", "router_host",
                 "router_device"):
        assert (got[gate] > 0) == (ref[gate] > 0), gate
    assert got["invalidation_proven"] == ref["invalidation_proven"]
    assert got["passed"] == ref["passed"]
    assert got["queries"] == ref["queries"] == 36
    # the oracle: every statement of the mixes, each package's Session
    # executing it directly
    jx, pt = _jax_session(), _port_session()
    for s in (jx, pt):
        s.execute("CREATE TABLE memory.s.counters (k bigint, v bigint)")
        s.execute("INSERT INTO memory.s.counters VALUES (1, 10), (2, 20)")
    for qs in soak.CONCURRENCY_MIXES.values():
        for q in qs:
            assert soak._chaos_rows(pt.execute(q).rows) == \
                bench._chaos_rows(jx.execute(q).rows), q


def _schedules(monkeypatch, injector_cls, into):
    """Record the fault schedule of every seeded injector a soak draws."""
    real = injector_cls.from_seed.__func__

    def from_seed(cls, seed, *a, **k):
        inj = real(cls, seed, *a, **k)
        into.append((seed, [(r.point, r.fault, r.remaining, r.match,
                             r.delay_s) for r in inj.schedule()]))
        return inj

    monkeypatch.setattr(injector_cls, "from_seed", classmethod(from_seed))


def test_chaos_soak_parity_with_reference(monkeypatch):
    import bench
    from trino_tpu.server.failureinjector import \
        FailureInjector as JaxInjector
    from trino_tpu_torch.server.failureinjector import FailureInjector
    assert soak.CHAOS_QUERIES == bench.CHAOS_QUERIES
    ref_sched, got_sched = [], []
    _schedules(monkeypatch, JaxInjector, ref_sched)
    _schedules(monkeypatch, FailureInjector, got_sched)
    ref = bench.chaos_soak(n_seeds=2, out_path=None)
    got = soak.chaos_soak(n_seeds=2, device="cpu")
    assert _keys(got) == _keys(ref)
    assert [s for s, _ in got_sched] == [0, 1]
    assert got_sched == ref_sched
    for gate in ("wrong_answers", "failed_queries"):
        assert (got[gate] == 0) == (ref[gate] == 0), gate
    assert (got["injected_total"] > 0) == (ref["injected_total"] > 0)
    assert got["schedules"] == ref["schedules"] == 2
    jx, pt = _jax_session(), _port_session()
    for q, unordered in soak.CHAOS_QUERIES.values():
        a = soak._chaos_rows(pt.execute(q).rows)
        b = bench._chaos_rows(jx.execute(q).rows)
        if unordered:
            a, b = sorted(a), sorted(b)
        assert a == b, q


# ---------------------------------------------------------------------------
# slow tier: the full-length soaks and the elastic SLO gate
# ---------------------------------------------------------------------------

@pytest.fixture
def cluster():
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.worker import WorkerServer
    session = Session(default_schema="tiny", device="cpu")
    coord = CoordinatorServer(session, retry_policy="QUERY").start()
    coord.state.scheduler.split_rows = 8192
    workers = [WorkerServer(f"sw{i}", coord.uri, announce_interval_s=0.1,
                            catalog=session.catalog, device="cpu").start()
               for i in range(3)]
    deadline = time.time() + 10
    while len(coord.state.active_nodes()) < 3 and time.time() < deadline:
        time.sleep(0.05)
    yield coord, workers, session
    for w in workers:
        w.stop()
    coord.stop()


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_soak_50_schedules(cluster):
    coord, workers, session = cluster
    rec = soak.chaos_soak(n_seeds=50, cluster=(coord, workers, session))
    assert rec["schedules"] == 50
    assert rec["wrong_answers"] == 0
    assert rec["failed_queries"] == 0
    assert rec["injected_total"] > 0


@pytest.mark.slow
def test_overload_soak(cluster):
    coord, workers, session = cluster
    rec = soak.overload_soak(cluster=(coord, workers, session))
    assert rec["passed"], rec
    assert rec["wrong_answers"] == 0
    assert rec["rejected_total"] > 0
    assert rec["deadline_kills"] == 3 and rec["canceled"] == 4
    assert rec["tasks_terminal"] and rec["pools_drained"]


@pytest.mark.slow
def test_elastic_soak_slo_gates():
    rec = soak.elastic_soak(duration_s=30.0, device="cpu")
    assert rec["passed"], rec
    assert rec["fair_share_held"]
    for tname in ("alpha", "beta", "gamma"):
        assert rec["tenants"][tname]["slo_ok"], rec["tenants"]
