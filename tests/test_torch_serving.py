"""The serving layer over HTTP: the port's coordinator against the
reference's, statement by statement (tpch.tiny, on the CPU).

Each side runs its own CoordinatorServer, the reference over a JAX
Session and the port over ``Session(device="cpu")``, and gets the same
statements through its own Client. History is off on both, as in the
reference's own serving tests, because history medians are timings:
routes must agree before rows can. Rows are compared exactly (floats
travel as JSON reprs, so bit for bit), and so are ``route``,
``routeReason`` and ``fallbackReason`` from /v1/query/{id}.

The two DOUBLE queries differ between the routes in the reference: the
host route divides a decimal by 10^s and sums with ``np.sum``, the device
route multiplies by the reciprocal (XLA's rewrite) and sums in XLA's
order. The port equals the reference on each route, and so keeps that
difference.
"""

import os
import threading
import time
import types

import pytest
import torch

from trino_tpu import metrics as jax_metrics
from trino_tpu.client.client import Client as JaxClient
from trino_tpu.exec import router as jax_router
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu.planner.optimizer import prune_plan as jax_prune
from trino_tpu.server.coordinator import CoordinatorServer as JaxServer
from trino_tpu.server.history import QueryHistoryStore as JaxHistory
from trino_tpu_torch import metrics as port_metrics
from trino_tpu_torch.client.client import Client
from trino_tpu_torch.exec import router
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.planner.optimizer import prune_plan
from trino_tpu_torch.server.coordinator import CoordinatorServer
from trino_tpu_torch.server.history import QueryHistoryStore

torch.set_num_threads(1)

DOUBLE_SUM = "SELECT sum(CAST(l_extendedprice AS double) / 7) FROM lineitem"
DOUBLE_ROWS = ("SELECT l_orderkey, CAST(l_extendedprice AS double) / 0.07 "
               "FROM lineitem WHERE l_orderkey < 40 "
               "ORDER BY l_orderkey, l_linenumber")

# the reference's test_host_path_bit_exact_vs_device queries
HOST_QUERIES = [
    "SELECT count(*), sum(l_quantity), min(l_shipdate), "
    "max(l_discount) FROM lineitem",
    "SELECT n_nationkey, n_name FROM nation "
    "WHERE n_regionkey = 2 ORDER BY n_nationkey",
    "SELECT r_name FROM region WHERE r_regionkey >= 1 "
    "ORDER BY r_name DESC LIMIT 3",
    "SELECT s_suppkey + 1, s_acctbal * 2 FROM supplier "
    "WHERE s_nationkey IN (1, 3) ORDER BY s_suppkey LIMIT 5",
    "SELECT count(*) FROM orders "
    "WHERE o_orderdate >= DATE '1996-01-01'",
]

DEFAULTS = {"routing_mode": "auto", "router_host_max_rows": 200000,
            "enable_result_cache": "false", "enable_microbatch": "false"}


class Pair:
    """The two coordinators with a client each."""

    def __init__(self, tmp):
        saved = os.environ.get("TRINO_TPU_HISTORY_PATH")
        try:
            os.environ["TRINO_TPU_HISTORY_PATH"] = str(tmp / "ref.jsonl")
            self.ref = JaxServer(JaxSession(default_schema="tiny"),
                                 max_concurrency=16).start()
            os.environ["TRINO_TPU_HISTORY_PATH"] = str(tmp / "port.jsonl")
            self.port = CoordinatorServer(
                Session(default_schema="tiny", device="cpu"),
                max_concurrency=16).start()
        finally:
            if saved is None:
                os.environ.pop("TRINO_TPU_HISTORY_PATH", None)
            else:
                os.environ["TRINO_TPU_HISTORY_PATH"] = saved
        for c in (self.ref, self.port):
            # history medians are timings: off, as in the reference's
            # serving tests
            c.state.dispatcher.serving.history = None
            c.state.session.history_store = None
        self.ref_client = JaxClient(self.ref.uri, user="t",
                                    poll_interval_s=0.005)
        self.port_client = Client(self.port.uri, user="t",
                                  poll_interval_s=0.005)

    def stop(self):
        self.ref.stop()
        self.port.stop()

    def set(self, **props):
        """Every property of DEFAULTS back to its default, then `props`,
        on both sides."""
        for name, value in {**DEFAULTS, **props}.items():
            for cl in (self.ref_client, self.port_client):
                cl.execute(f"SET SESSION {name} = '{value}'")

    def run(self, sql):
        """(reference result, port result, reference info, port info)."""
        r = self.ref_client.execute(sql)
        p = self.port_client.execute(sql)
        return (r, p, self.ref_client.query_info(r.query_id),
                self.port_client.query_info(p.query_id))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("serving"))
    yield p
    p.stop()


def _assert_same(r, p, ri, pi, sql):
    assert (pi["route"], pi["routeReason"]) == \
        (ri["route"], ri["routeReason"]), sql
    assert pi["fallbackReason"] == ri["fallbackReason"], sql
    assert p.columns == r.columns, sql
    assert p.rows == r.rows, sql


# (sql, properties, the route both must take)
ROUTED = [
    ("SELECT count(*) FROM nation", {}, "host"),
    ("SELECT count(*) FROM nation", {"routing_mode": "host"}, "host"),
    ("SELECT count(*) FROM nation", {"routing_mode": "device"}, "device"),
    ("SELECT n_name FROM nation WHERE n_nationkey = 7",
     {"router_host_max_rows": 1000}, "host"),
    ("SELECT count(*) FROM lineitem WHERE l_quantity > 49",
     {"router_host_max_rows": 1000}, "device"),
    ("SELECT r_regionkey, count(*) FROM region GROUP BY r_regionkey",
     {"routing_mode": "host"}, "device"),
    (DOUBLE_SUM, {}, "host"),
    (DOUBLE_SUM, {"routing_mode": "host"}, "host"),
    (DOUBLE_SUM, {"routing_mode": "device"}, "device"),
    (DOUBLE_ROWS, {"routing_mode": "host"}, "host"),
    (DOUBLE_ROWS, {"routing_mode": "device"}, "device"),
] + [(sql, {}, "host") for sql in HOST_QUERIES]


@pytest.mark.parametrize("sql,props,route", ROUTED,
                         ids=[f"{i}-{r}" for i, (_s, _p, r)
                              in enumerate(ROUTED)])
def test_routes_and_rows_equal_reference(pair, sql, props, route):
    pair.set(**props)
    r, p, ri, pi = pair.run(sql)
    assert ri["route"] == route
    _assert_same(r, p, ri, pi, sql)


@pytest.mark.parametrize("sql", [DOUBLE_SUM, DOUBLE_ROWS])
def test_double_result_depends_on_route(pair, sql):
    """A kept quirk of the reference: a DOUBLE result depends on the
    route. Each route equals the reference's own, and the two differ."""
    rows = {}
    for mode in ("host", "device"):
        pair.set(routing_mode=mode)
        r, p, ri, pi = pair.run(sql)
        _assert_same(r, p, ri, pi, sql)
        rows[mode] = p.rows
    assert rows["host"] != rows["device"]


def _planned(session, prune, sql):
    _stmt, rel = session.plan(sql)
    return rel, prune(rel.node)


@pytest.fixture(scope="module")
def sessions():
    return (JaxSession(default_schema="tiny"),
            Session(default_schema="tiny", device="cpu"))


@pytest.mark.parametrize("sql", HOST_QUERIES + [DOUBLE_SUM, DOUBLE_ROWS])
def test_run_host_equals_reference(sessions, sql):
    """The numpy interpreter, called directly: the port's rows equal the
    reference's `run_host` bit for bit, and (off the DOUBLE queries) the
    port's own device path."""
    js, ts = sessions
    rel, root = _planned(js, jax_prune, sql)
    ref = jax_router.run_host(js, rel, root, time.monotonic())
    rel, root = _planned(ts, prune_plan, sql)
    assert router.host_supported(root) is None
    got = router.run_host(ts, rel, root, time.monotonic())
    assert got.column_names == ref.column_names
    assert got.rows == ref.rows
    if sql not in (DOUBLE_SUM, DOUBLE_ROWS):
        assert got.rows == ts.execute(sql).rows


@pytest.mark.parametrize("sql", [
    "SELECT c_name FROM customer JOIN nation ON c_nationkey = n_nationkey",
    "SELECT r_regionkey, count(*) FROM region GROUP BY r_regionkey",
    "SELECT count(DISTINCT n_regionkey) FROM nation",
    "SELECT sum(n_nationkey + 1) FROM nation",
    "SELECT avg(n_nationkey) FROM nation",
    "SELECT upper(n_name) FROM nation",
    "SELECT n_name FROM nation WHERE n_regionkey = "
    "(SELECT max(r_regionkey) FROM region)",
    "SELECT n_name, rank() OVER (ORDER BY n_nationkey) FROM nation",
    "SELECT n_name FROM nation ORDER BY n_name LIMIT 3",
])
def test_host_supported_reasons_equal_reference(sessions, sql):
    js, ts = sessions
    _rel, jroot = _planned(js, jax_prune, sql)
    _rel, troot = _planned(ts, prune_plan, sql)
    assert router.host_supported(troot) == \
        jax_router.host_supported(jroot)


@pytest.mark.parametrize("sql,props", [
    ("EXPLAIN SELECT count(*) FROM region", {}),
    ("EXPLAIN SELECT count(*) FROM lineitem WHERE l_quantity > 49",
     {"router_host_max_rows": 1000}),
    ("EXPLAIN SELECT r_regionkey, count(*) FROM region "
     "GROUP BY r_regionkey", {"routing_mode": "host"}),
    ("EXPLAIN " + DOUBLE_SUM, {"routing_mode": "device"}),
])
def test_explain_equals_reference(pair, sql, props):
    pair.set(**props)
    r, p, _ri, _pi = pair.run(sql)
    assert p.rows == r.rows
    assert p.rows[-1][0].startswith("routing: ")


def _delta(metric_pairs, fn):
    before = [m.value() for m in metric_pairs]
    fn()
    return [m.value() - b for m, b in zip(metric_pairs, before)]


def test_plan_cache_deltas_equal_reference(pair):
    pair.set()
    sqls = ["SELECT count(*) FROM supplier WHERE s_suppkey > 11",
            "SELECT count(*) FROM supplier WHERE s_suppkey > 11",
            "select   COUNT(*)  from SUPPLIER  where S_SUPPKEY > 11;"]

    def side(client, m):
        return _delta([m.PLAN_CACHE_MISSES, m.PLAN_CACHE_HITS],
                      lambda: [client.execute(s) for s in sqls])
    ref = side(pair.ref_client, jax_metrics)
    got = side(pair.port_client, port_metrics)
    assert got == ref and got[1] >= 2


def test_result_cache_hit_and_invalidation_equal_reference(pair):
    pair.set()
    for cl in (pair.ref_client, pair.port_client):
        cl.execute("CREATE TABLE memory.s.rc (k bigint, v bigint)")
        cl.execute("INSERT INTO memory.s.rc VALUES (1, 10), (2, 20)")
    pair.set(enable_result_cache="true")
    sql = "SELECT sum(v) FROM memory.s.rc"

    def script(client, m):
        out = []
        counters = [m.RESULT_CACHE_HITS, m.RESULT_CACHE_MISSES,
                    m.RESULT_CACHE_INVALIDATIONS]
        for step in (None, None, "INSERT INTO memory.s.rc VALUES (3, 30)",
                     "UPDATE memory.s.rc SET v = 0 WHERE k = 1"):
            if step is not None:
                client.execute(step)

            def one():
                r = client.execute(sql)
                out.append((r.rows, client.query_info(r.query_id)["route"]))
            out.append(_delta(counters, one))
        return out
    ref = script(pair.ref_client, jax_metrics)
    got = script(pair.port_client, port_metrics)
    assert got == ref
    assert got[2][1] == "cache" and got[5] == [0, 1, 1]
    pair.set()


def test_system_tables_never_cached(pair):
    pair.set(enable_result_cache="true")
    sql = "SELECT query_id FROM system.runtime.queries ORDER BY query_id"
    for cl in (pair.ref_client, pair.port_client):
        # every execution adds a tracked query: a cached page would
        # return the same ids twice
        a = cl.execute(sql)
        b = cl.execute(sql)
        assert [a.query_id] in b.rows and b.rows != a.rows
    pair.set()


def test_microbatch_coalesces_and_demuxes_per_client(pair):
    pair.set(enable_microbatch="true")
    pair.port_client.execute("SET SESSION microbatch_window_ms = 40")
    session = pair.port.state.session
    oracle = {k: [list(r) for r in session.execute(
        f"SELECT n_name, n_regionkey FROM nation WHERE n_nationkey = {k}"
    ).rows] for k in range(8)}
    q0 = port_metrics.MICROBATCH_QUERIES.value()
    b0 = port_metrics.MICROBATCH_BATCHES.value()
    results = {}

    def one(k):
        c = Client(pair.port.uri, user=f"mb{k}", poll_interval_s=0.005)
        results[k] = c.execute(f"SELECT n_name, n_regionkey FROM nation "
                               f"WHERE n_nationkey = {k}").rows

    threads = [threading.Thread(target=one, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert results == oracle
    dq = port_metrics.MICROBATCH_QUERIES.value() - q0
    db = port_metrics.MICROBATCH_BATCHES.value() - b0
    assert db >= 1 and dq > db
    pair.port_client.execute("SET SESSION microbatch_window_ms = 4")
    pair.set()


def _history(cls, path, sql, n, elapsed_s):
    from trino_tpu_torch.server.history import plan_fingerprint
    store = cls(path=str(path))
    for i in range(n):
        store.record({"query_id": f"h{i}", "sql": sql,
                      "fingerprint": plan_fingerprint(sql),
                      "state": "FINISHED", "elapsed_s": elapsed_s})
    return cls(path=str(path))        # read back from the file


def test_history_baseline_routes_host_with_reference_reason(pair,
                                                            tmp_path):
    """Five FINISHED runs of 4 ms in a history file: the statement that
    the row estimate sends to the device routes to the host, with the
    reference's reason text."""
    sql = "SELECT count(*) FROM lineitem WHERE l_quantity > 48"
    pair.set(router_host_max_rows=1000)
    stores = (_history(JaxHistory, tmp_path / "ref.jsonl", sql, 5, 0.004),
              _history(QueryHistoryStore, tmp_path / "port.jsonl", sql, 5,
                       0.004))
    try:
        for c, store in zip((pair.ref, pair.port), stores):
            c.state.dispatcher.serving.history = store
            c.state.session.history_store = store
        r, p, ri, pi = pair.run(sql)
        assert ri["route"] == "host"
        assert ri["routeReason"] == \
            "history median 4.0ms <= 30ms over 5 runs"
        _assert_same(r, p, ri, pi, sql)
    finally:
        for c in (pair.ref, pair.port):
            c.state.dispatcher.serving.history = None
            c.state.session.history_store = None
        pair.set()


def test_prewarm_cold_route_equals_reference(sessions):
    """An enabled prewarm engine with the fingerprint cold routes a
    host-eligible plan to the host with the reference's reason; the
    port's engine on a CPU session loads no kernel library."""
    from trino_tpu.exec.prewarm import PrewarmEngine as JaxPrewarm
    from trino_tpu_torch.exec.prewarm import PrewarmEngine
    js, ts = sessions
    sql = "SELECT count(*) FROM lineitem WHERE l_quantity > 49"
    props = {"routing_mode": "auto", "router_host_max_rows": 1000}
    _rel, jroot = _planned(js, jax_prune, sql)
    _rel, troot = _planned(ts, prune_plan, sql)
    ref = jax_router.decide_route(js.planner(), jroot, props,
                                  fingerprint="fp",
                                  prewarm=JaxPrewarm(enabled=True))
    engine = PrewarmEngine(enabled=True)
    got = router.decide_route(ts.planner(), troot, props,
                              fingerprint="fp", prewarm=engine)
    assert (got.target, got.reason) == (ref.target, ref.reason) == \
        ("host", "device program cold")
    engine.mark_warm("fp")
    got = router.decide_route(ts.planner(), troot, props,
                              fingerprint="fp", prewarm=engine)
    assert got.target == "device"
    cpu_session = types.SimpleNamespace(device=torch.device("cpu"),
                                        properties={})
    assert PrewarmEngine(session=cpu_session,
                         enabled=True).warm_shapes() == 0


def test_status_and_jit_surfaces(pair):
    """/v1/status reports the port's device and kernel-library cache;
    /v1/jit has the reference's totals keys."""
    import json
    import urllib.request
    from trino_tpu_torch.ops.cuda_build import BUILD_DIR

    def get(srv, path):
        with urllib.request.urlopen(srv.uri + path, timeout=30) as r:
            return json.loads(r.read())
    status = get(pair.port, "/v1/status")
    assert status["device"]["platform"] == "cpu"
    assert status["compileCache"]["dir"] == str(BUILD_DIR)
    assert status["prewarm"]["enabled"] is False
    assert get(pair.port, "/v1/jit")["totals"].keys() == \
        get(pair.ref, "/v1/jit")["totals"].keys()
