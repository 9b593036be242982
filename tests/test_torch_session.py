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
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpch import datagen as jax_datagen
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.connectors.tpch import datagen as torch_datagen
from trino_tpu_torch.exec.session import Session

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
    _, ts = _sessions(tables)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.execute(sql)


@pytest.mark.parametrize("prop,value", [("distributed", "true"),
                                        ("spill_chunk_rows", "4096")])
def test_unported_options_raise(tables, prop, value):
    _, ts = _sessions(tables)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.execute(f"SET SESSION {prop} = '{value}'")
        ts.execute(Q6)


def test_multiway_join_resolves_off(tables):
    """K4 is not ported: even `enable_multiway_join = true` plans the
    pairwise ladder (and the query still runs)."""
    _, ts = _sessions(tables, (("enable_multiway_join", "true"),))
    plan = "\n".join(r[0] for r in ts.execute("EXPLAIN " + Q3).rows)
    assert "MultiJoin" not in plan
    assert len(ts.execute(Q3).rows) == 10
