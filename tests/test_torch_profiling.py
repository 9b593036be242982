"""The port's fenced device/host/compile attribution
(trino_tpu_torch/exec/executor.py `_dispatch_timed`) against the
reference's surface (tests/test_profiling.py): under `enable_profiling`
every operator's node_stats is (wall, rows, device, host, compile) with
the three components summing to the wall; with it off nothing fences;
EXPLAIN ANALYZE renders the split on the same plan lines as the JAX
Session, with the same row counts; the `execute` span carries the four
attributes; a kernel library build lands on the node whose dispatch
built it; a two-worker port cluster carries the split into TaskStats,
system.runtime.operator_stats and the distributed EXPLAIN ANALYZE.

On the CPU torch is synchronous, so the time components are held to
their invariants (non-negative, summing to the wall within 1e-9 s), not
to the reference's values; row counts are exact."""

import ctypes
import re
import threading
import time
import types

import pytest
import torch

from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.client.client import Client
from trino_tpu_torch.exec import executor as executor_mod
from trino_tpu_torch.exec.profiler import RECORDER
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.ops import cuda_build
from trino_tpu_torch.planner import logical as L
from trino_tpu_torch.server.coordinator import CoordinatorServer
from trino_tpu_torch.server.worker import WorkerServer

torch.set_num_threads(1)

GROUP_SQL = ("SELECT l_returnflag, sum(l_quantity) FROM lineitem "
             "GROUP BY l_returnflag ORDER BY l_returnflag")
JOIN_SQL = ("SELECT o_orderpriority, count(*) FROM orders o JOIN customer c "
            "ON o.o_custkey = c.c_custkey WHERE c.c_mktsegment = 'BUILDING' "
            "GROUP BY o_orderpriority ORDER BY o_orderpriority")
NATION_SQL = ("SELECT n_regionkey, count(*) FROM nation "
              "GROUP BY n_regionkey")
SPLIT = re.compile(r"\[[\d.]+ms \(device [\d.]+ \+ host [\d.]+ \+ "
                   r"compile [\d.]+\), (\d+) rows\]")


def _session():
    return Session(default_schema="tiny", device="cpu")


def _profiled(sql):
    s = _session()
    s.execute("SET SESSION enable_profiling = true")
    return s, s.execute(sql)


def _assert_split(st):
    wall, _rows, device_s, host_s, compile_s = st
    assert wall >= 0 and device_s >= 0 and host_s >= 0 and compile_s >= 0
    assert abs(wall - (device_s + host_s + compile_s)) < 1e-9


@pytest.mark.parametrize("sql", [GROUP_SQL, JOIN_SQL],
                         ids=["group", "join"])
def test_profile_split_sums_to_wall(sql):
    s, res = _profiled(sql)
    ns = s.executor.node_stats
    assert ns, "profiled run produced no node stats"
    for st in ns.values():
        assert len(st) == 5
        _assert_split(st)
    # profiling changes no result
    assert res.rows == _session().execute(sql).rows


def test_profiling_off_adds_zero_fences(monkeypatch):
    calls = []
    real = executor_mod.Executor._fence
    monkeypatch.setattr(executor_mod.Executor, "_fence",
                        lambda self: (calls.append(1), real(self))[1])
    s = _session()
    s.execute(NATION_SQL)
    assert calls == []
    assert s.executor.node_stats == {}
    s.execute("SET SESSION enable_profiling = true")
    s.execute(NATION_SQL)
    # one fence before and one after each dispatched operator
    assert len(calls) == 2 * len(s.executor.node_stats) > 0


@pytest.mark.parametrize("sql", [NATION_SQL, GROUP_SQL, JOIN_SQL],
                         ids=["nation", "group", "join"])
def test_explain_analyze_renders_the_reference_split(sql):
    ours = [r[0] for r in _session().execute("EXPLAIN ANALYZE " + sql).rows]
    ref = [r[0] for r in JaxSession(default_schema="tiny").execute(
        "EXPLAIN ANALYZE " + sql).rows]
    annotated = [line for line in ours if SPLIT.search(line)]
    assert annotated, ours
    # the same plan lines carry the split, with the same row counts
    assert [SPLIT.sub(r"[\1 rows]", line) for line in annotated] == \
        [SPLIT.sub(r"[\1 rows]", line) for line in ref if SPLIT.search(line)]


def test_execute_span_carries_the_split():
    s = _session()
    s.execute("SET SESSION enable_tracing = true")
    s.execute("SET SESSION enable_profiling = true")
    s.execute(GROUP_SQL)
    (sp,) = [x for x in s.tracer.spans if x.name == "execute"]
    assert sp.attributes["profiled"] is True
    ns = list(s.executor.node_stats.values())
    for key, i in (("deviceMs", 2), ("hostMs", 3), ("compileMs", 4)):
        assert sp.attributes[key] == round(sum(v[i] for v in ns) * 1000, 3)
    assert sp.attributes["hostMs"] > 0
    # profiling off: no split on the span
    s.execute("SET SESSION enable_profiling = false")
    s.execute(GROUP_SQL)
    last = [x for x in s.tracer.spans if x.name == "execute"][-1]
    assert "profiled" not in last.attributes


BUILD_S = 0.05


def _fake_builds(monkeypatch):
    """cuda_build with nvcc and the loader faked: a library's first load
    'builds' for BUILD_S seconds on the calling thread."""
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "_start_build",
                        lambda name: ("nvcc", name))

    def finish(name, started):
        time.sleep(BUILD_S)
        cuda_build._built_s[name] = BUILD_S

    monkeypatch.setattr(cuda_build, "_finish_build", finish)
    # the loader alone is faked (cuda_build's own view of ctypes)
    monkeypatch.setattr(cuda_build, "ctypes", types.SimpleNamespace(
        c_int=ctypes.c_int,
        CDLL=lambda path: types.SimpleNamespace(
            **{e: types.SimpleNamespace()
               for sig in cuda_build.SIGNATURES.values() for e in sig})))


def test_kernel_build_is_charged_to_the_launching_node(monkeypatch):
    _fake_builds(monkeypatch)
    launched = []
    real = executor_mod.Executor.run_aggregate

    def run_aggregate(self, node):
        launched.append(node)
        cuda_build.library("gather")      # the first launch builds
        return real(self, node)

    monkeypatch.setattr(executor_mod.Executor, "run_aggregate",
                        run_aggregate)
    # a build on another thread is that thread's compile, not the query's
    other = threading.Thread(target=cuda_build.library,
                             args=("multiprobe",))
    other.start()
    other.join()
    s = _session()
    s.execute("SET SESSION enable_profiling = true")
    compiles0 = s.executor.stats.jit_compiles
    thread0 = RECORDER.thread_compile_seconds()
    s.execute(GROUP_SQL)
    assert RECORDER.thread_compile_seconds() - thread0 == \
        pytest.approx(BUILD_S, abs=1e-12)
    assert s.executor.stats.jit_compiles == compiles0 + 1
    (agg,) = launched
    ns = s.executor.node_stats
    assert ns[id(agg)][4] == pytest.approx(BUILD_S, abs=1e-12)
    below = []
    stack = list(L.children(agg))
    while stack:
        n = stack.pop()
        below.append(id(n))
        stack.extend(L.children(n))
    assert below and all(ns[i][4] == 0.0 for i in below if i in ns)
    # the node and every ancestor carry it (times are inclusive)
    charged = [i for i, st in ns.items() if st[4] > 0]
    assert id(agg) in charged and len(charged) == len(ns) - len(
        [i for i in below if i in ns])
    for st in ns.values():
        _assert_split(st)
    entry = [e for e in RECORDER.snapshot()
             if e["site"] == "cuda_build.gather"][-1]
    assert entry["compiles"] >= 1
    # the library is loaded now: a second run compiles nothing
    launched.clear()
    s.execute(GROUP_SQL)
    assert all(st[4] == 0.0 for st in s.executor.node_stats.values())
    assert s.executor.stats.jit_compiles == compiles0 + 1


# ---------------------------------------------------------------------------
# a two-worker port cluster
# ---------------------------------------------------------------------------

DIST_SQL = ("SELECT l_returnflag, count(*) AS c FROM lineitem "
            "GROUP BY l_returnflag ORDER BY l_returnflag")


@pytest.fixture(scope="module")
def cluster():
    coord = CoordinatorServer(_session()).start()
    coord.state.scheduler.split_rows = 8192
    workers = [WorkerServer(f"prof-w{i}", coord.uri,
                            announce_interval_s=0.1, device="cpu").start()
               for i in range(2)]
    deadline = time.time() + 10
    while len(coord.state.active_nodes()) < 2 and time.time() < deadline:
        time.sleep(0.02)
    assert len(coord.state.active_nodes()) == 2
    yield coord, workers
    for w in workers:
        w.stop(graceful=False)
    coord.stop()


def test_distributed_explain_analyze_and_task_stats_split(cluster):
    coord, workers = cluster
    sched = coord.state.scheduler
    sched.spool.clear()
    client = Client(coord.uri, user="prof")
    r = client.execute("EXPLAIN ANALYZE " + DIST_SQL)
    assert client.query_info(r.query_id)["distributed"]
    text = "\n".join(row[0] for row in r.rows)
    assert "Distributed execution" in text
    ops = re.findall(r"operator (\w+): rows=\d+, wall=([\d.]+)ms "
                     r"\(device ([\d.]+) \+ host ([\d.]+) \+ "
                     r"compile ([\d.]+)\), calls=\d+", text)
    assert ops, text
    assert sum(float(o[3]) for o in ops) > 0
    # every worker task of the profiled run carries the split
    tasks = [t for t in sched.task_history if t["query_id"]
             and t["query_id"] == sched.last_query.get("query_id")]
    assert {t["node"] for t in tasks} == {"prof-w0", "prof-w1"}
    for t in tasks:
        assert t["host_ms"] > 0 and t["device_ms"] >= 0 \
            and t["compile_ms"] >= 0
    rows = client.execute(
        "SELECT operator, wall_ms, device_ms, host_ms, compile_ms FROM "
        "system.runtime.operator_stats").rows
    assert rows
    assert any(float(row[3]) > 0 for row in rows)
    for _op, wall, dev, host, comp in rows:
        # rounded to 3 decimals per task operator before the rollup
        assert abs(float(wall) - (float(dev) + float(host) + float(comp))) \
            < 0.01 + 1e-3 * float(wall)


def test_worker_task_stats_split_on_a_traced_run(cluster):
    """A traced run profiles its worker tasks: each task's TaskStats and
    its worker-task span carry the split."""
    coord, workers = cluster
    sched = coord.state.scheduler
    sched.spool.clear()
    client = Client(coord.uri, user="prof")
    client.execute("SET SESSION enable_tracing = true")
    try:
        r = client.execute(DIST_SQL)
        assert r.rows and client.query_info(r.query_id)["distributed"]
        trace = client._request(
            "GET", f"{coord.uri}/v1/query/{r.query_id}/trace")
    finally:
        client.execute("SET SESSION enable_tracing = false")
    tasks = [t for t in sched.task_history if t["query_id"] == r.query_id]
    assert {t["node"] for t in tasks} == {"prof-w0", "prof-w1"}
    for t in tasks:
        assert t["host_ms"] > 0 and t["device_ms"] >= 0
    wspans = [sp for sp in trace["spans"] if sp["name"] == "worker-task"]
    assert len(wspans) == len(tasks)
    for sp in wspans:
        attrs = sp["attributes"]
        assert attrs["hostMs"] > 0 and attrs["deviceMs"] >= 0 \
            and attrs["compileMs"] >= 0
