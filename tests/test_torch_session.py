"""The slice end to end: TPC-H q1, q6 and q3 through the port's Session
(on the CPU) against the reference's Session and the sqlite oracle, on
the very same generated tables (tpch.tiny, SF 0.01).

Tolerances: port vs reference rows are equal exactly (decimals are
exact scaled integers; q1/q3 ORDER BY is total); vs the sqlite oracle,
which sums REALs, abs 0.01 as in tests/test_tpch_queries.py. EXPLAIN
strategy lines must be equal with both kernels enabled."""

import pytest
import torch

from oracle import assert_rows_match, load_oracle, oracle_query
from test_tpch_queries import Q1, Q3, Q6, TPCH_TABLES
from tpch_full import QUERIES as H_QUERIES
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpch import datagen as jax_datagen
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.connectors.tpch import datagen as torch_datagen
from trino_tpu_torch.exec.session import Session

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

QUERIES = {"q1": Q1, "q6": Q6, "q3": Q3}
KERNELS_ON = (("enable_pallas_gather", "true"),
              ("enable_pallas_hash", "true"))


@pytest.fixture(scope="module")
def tables():
    conn = TpchConnector()
    return {t: conn.get_table("tiny", t) for t in TPCH_TABLES}


@pytest.fixture(scope="module")
def oracle(tables):
    return load_oracle([tables[t] for t in TPCH_TABLES])


def _jax_session(tables):
    conn = TpchConnector()
    conn._cache[0.01] = dict(tables)
    cat = JaxCatalog()
    cat.register("tpch", conn)
    return JaxSession(cat, default_schema="tiny")


def _sessions(tables, props=()):
    js = _jax_session(tables)
    ts = Session(catalog_from_tables(tables), default_schema="tiny",
                 device="cpu")
    for name, value in props:
        js.execute(f"SET SESSION {name} = '{value}'")
        ts.execute(f"SET SESSION {name} = '{value}'")
    return js, ts


def _strategy_lines(session, sql):
    return [r[0] for r in session.execute("EXPLAIN " + sql).rows
            if r[0].startswith(("agg strategy", "join strategy",
                                "join distribution", "multiway star"))]


@pytest.mark.parametrize("name", ["q1", "q6", "q3"])
def test_query_three_ways(tables, oracle, name):
    js, ts = _sessions(tables)
    sql = QUERIES[name]
    got = ts.execute(sql).rows
    assert got == js.execute(sql).rows
    assert_rows_match(got, oracle_query(oracle, sql), rel_tol=1e-9,
                      abs_tol=0.01, ordered=True)


@pytest.mark.parametrize("name", ["q1", "q6", "q3"])
def test_explain_strategy_lines_equal_kernels_on(tables, name):
    js, ts = _sessions(tables, KERNELS_ON)
    assert _strategy_lines(ts, QUERIES[name]) == \
        _strategy_lines(js, QUERIES[name])


def test_q3_hash_aggregate_through_k3_on_both_sides(tables, oracle):
    """hash_agg_mode=force with both kernels on: q3's aggregate runs the
    hash table (K3's plain version here, the interpreted Pallas kernel in
    the reference) and the joins ride K1."""
    js, ts = _sessions(tables, (("hash_agg_mode", "force"),) + KERNELS_ON)
    want = js.execute(Q3).rows
    got = ts.execute(Q3).rows
    assert got == want
    assert_rows_match(got, oracle_query(oracle, Q3), rel_tol=1e-9,
                      abs_tol=0.01, ordered=True)
    assert ts.executor.strategy_decisions == js.executor.strategy_decisions
    assert ts.executor.strategy_decisions["AggregateNode"] == "hash"
    assert ts.executor.stats.hash_agg_calls == \
        js.executor.stats.hash_agg_calls == 1
    assert ts.executor.stats.pallas_gather_calls == \
        js.executor.stats.pallas_gather_calls > 0
    assert _strategy_lines(ts, Q3) == _strategy_lines(js, Q3)
    # a rerun is served the same way (decision cache on both sides)
    assert ts.execute(Q3).rows == want


def test_pinned_small_table_escapes_and_partitions(tables):
    """A pinned 1024-slot table overflows (about 1500 groups > its 640
    cap): both executors escape, radix-partition and still agree."""
    js, ts = _sessions(tables, (("hash_agg_mode", "force"),
                                ("hash_table_slots", "1024")) + KERNELS_ON)
    sql = ("SELECT o_custkey, count(*), sum(o_totalprice) FROM orders "
           "WHERE o_orderkey < 8000 GROUP BY o_custkey ORDER BY o_custkey")
    got = ts.execute(sql).rows
    assert got == js.execute(sql).rows and len(got) > 640
    assert ts.executor.stats.hash_agg_escapes == \
        js.executor.stats.hash_agg_escapes == 1


def test_datagen_byte_identical():
    want = jax_datagen.generate(0.01)
    got = torch_datagen.generate(0.01)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert [f.name for f in g.schema.fields] == \
            [f.name for f in w.schema.fields]
        assert [f.dictionary for f in g.schema.fields] == \
            [f.dictionary for f in w.schema.fields]
        assert [repr(f.dtype) for f in g.schema.fields] == \
            [repr(f.dtype) for f in w.schema.fields]
        assert tuple(g.primary_key) == tuple(w.primary_key)
        for a, b in zip(g.columns, w.columns):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_session_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        assert Session().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Session()
    assert Session(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("sql", [
    "SELECT n_name, rank() OVER (ORDER BY n_nationkey) FROM nation",
    "SELECT n_nationkey FROM nation UNION SELECT r_regionkey FROM region",
    "SELECT n_name FROM nation WHERE EXISTS "
    "(SELECT 1 FROM region WHERE r_regionkey = n_regionkey)",
])
def test_outside_the_slice_raises(tables, sql):
    """A window function, a set operation and a semi join raised until
    their modules were ported; they now run to the reference's rows. So
    does a CTAS into the memory catalog, which raised until DDL and DML
    were ported, and `distributed = true`, which raised until the mesh
    tier was ported: it swaps in a MeshExecutor (one shard on the CPU)
    and back."""
    from trino_tpu.connectors.memory import MemoryConnector
    js, ts = _sessions(tables)
    js.catalog.register("memory", MemoryConnector())
    assert ts.execute(sql).rows == js.execute(sql).rows
    ctas = "CREATE TABLE memory.default.t AS SELECT 1 AS x"
    assert ts.execute(ctas).rows == js.execute(ctas).rows == [(1,)]
    back = "SELECT * FROM memory.default.t"
    assert ts.execute(back).rows == js.execute(back).rows == [(1,)]
    from trino_tpu_torch.parallel.dist_executor import MeshExecutor
    count = "SELECT count(*) FROM lineitem"
    ts.execute("SET SESSION distributed = 'true'")
    assert isinstance(ts.executor, MeshExecutor)
    assert ts.executor.n_shards == 1
    assert ts.execute(count).rows == js.execute(count).rows
    ts.execute("SET SESSION distributed = 'false'")
    assert not isinstance(ts.executor, MeshExecutor)
    assert ts.execute(count).rows == js.execute(count).rows


@pytest.mark.parametrize("prop,value", [("distributed", "true"),
                                        ("spill_chunk_rows", "4096")])
def test_unported_options_raise(tables, oracle, prop, value):
    """Both options raised until their slices were ported; each now runs
    q6 to the reference's rows: `distributed` on the mesh executor (the
    reference's Session runs it single-device, with the same rows),
    `spill_chunk_rows` through the chunked driver (lineitem in 15
    chunks)."""
    js, ts = _sessions(tables)
    if prop == "distributed":
        from trino_tpu_torch.parallel.dist_executor import MeshExecutor
        ts.execute(f"SET SESSION {prop} = '{value}'")
        assert isinstance(ts.executor, MeshExecutor)
        got = ts.execute(Q6).rows
        assert got == js.execute(Q6).rows
        assert_rows_match(got, oracle_query(oracle, Q6), rel_tol=1e-9,
                          abs_tol=0.01, ordered=True)
        return
    for s in (js, ts):
        s.execute(f"SET SESSION {prop} = '{value}'")
    got = ts.execute(Q6).rows
    assert got == js.execute(Q6).rows
    assert ts.executor.stats.agg_spill_chunks == 15
    assert_rows_match(got, oracle_query(oracle, Q6), rel_tol=1e-9,
                      abs_tol=0.01, ordered=True)


@pytest.mark.parametrize("qnum,k", [(3, None), (5, 2)])
def test_multiway_join_plans_as_reference(tables, qnum, k):
    """`enable_multiway_join = 'true'` plans what the reference plans —
    q3's spine is a chain, so neither side fuses it; q5 fuses a k=2
    star — with plan texts equal, the routing line included,
    and the query runs to the reference's rows (q5 through K4's plain
    version here, the interpreted TPU kernel there)."""
    js, ts = _sessions(tables, (("enable_multiway_join", "true"),))
    sql = H_QUERIES[qnum]

    def plan(s):
        return [r[0] for r in s.execute("EXPLAIN " + sql).rows]
    got = plan(ts)
    assert got == plan(js)
    assert any("MultiJoin[" in ln for ln in got) == (k is not None)
    rows = ts.execute(sql).rows
    assert rows == js.execute(sql).rows and rows
    if k is not None:
        assert ts.executor.strategy_decisions["MultiJoinNode"] == \
            js.executor.strategy_decisions["MultiJoinNode"] == \
            f"multiway[k={k}]"
