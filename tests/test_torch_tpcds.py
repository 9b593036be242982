"""TPC-DS on the port: the tpcds connector copy, and the star queries of
the repo's TPC-DS corpus end to end through the port Session (CPU) three
ways — fused (K4's plain version), the pairwise ladder, and the sqlite
oracle — plus q7 against the reference Session with every kernel on.

Tolerances: fused and ladder rows are equal exactly and in order; vs the
sqlite oracle, which sums REALs, rel 1e-9 and abs 0.02 with ORDER BY kept
(as tests/test_multiway_join.py); port vs reference rows and EXPLAIN
strategy lines are equal exactly. The generated tables are byte-identical
to the reference generator's at tpcds.tiny."""

import pytest
import torch

from oracle import assert_rows_match, load_oracle, oracle_query
from tpcds_queries import ORACLE, QUERIES
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpcds import datagen as jax_datagen
from trino_tpu.connectors.tpcds.connector import (TABLE_NAMES,
                                                  TpcdsConnector)
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.connectors.tpcds import datagen as torch_datagen
from trino_tpu_torch.exec.session import Session

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

# the star queries and the k of the MultiJoin the planner fuses for them
STARS = {3: 2, 7: 4, 19: 4, 26: 4, 42: 2, 52: 2, 55: 2, 96: 3}
KERNELS_ON = (("enable_pallas_gather", "true"),
              ("enable_pallas_hash", "true"),
              ("enable_multiway_join", "true"))


@pytest.fixture(scope="module")
def tables():
    conn = TpcdsConnector()
    return {t: conn.get_table("tiny", t) for t in TABLE_NAMES}


@pytest.fixture(scope="module")
def oracle(tables):
    return load_oracle(tables.values())


@pytest.fixture(scope="module")
def session(tables):
    return Session(catalog_from_tables(tables, "tiny", "tpcds"),
                   default_cat="tpcds", default_schema="tiny", device="cpu")


def test_tpcds_datagen_byte_identical():
    want = jax_datagen.generate(0.01)
    got = torch_datagen.generate(0.01)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert [(f.name, f.dictionary, repr(f.dtype))
                for f in g.schema.fields] == \
            [(f.name, f.dictionary, repr(f.dtype)) for f in w.schema.fields]
        assert tuple(g.primary_key) == tuple(w.primary_key)
        for a, b in zip(g.columns, w.columns):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert (g.valids is None) == (w.valids is None)
        for a, b in zip(g.valids or (), w.valids or ()):
            assert (a is None) == (b is None)
            assert a is None or a.tobytes() == b.tobytes()


def test_default_catalog_has_tpcds():
    s = Session(device="cpu")
    assert sorted(s.catalog._connectors) == ["memory", "tpcds", "tpch"]
    assert "store_sales" in [r[0] for r in s.execute(
        "SHOW TABLES FROM tpcds.tiny").rows]


@pytest.mark.parametrize("qid", sorted(STARS))
def test_star_query_three_ways(session, oracle, qid):
    sql = QUERIES[qid]
    plan = "\n".join(r[0] for r in session.execute("EXPLAIN " + sql).rows)
    assert f"MultiJoin[star, k={STARS[qid]}" in plan
    before = session.executor.stats.multijoin_fused_probes
    fused = session.execute(sql).rows
    assert session.executor.strategy_decisions["MultiJoinNode"].startswith(
        "multiway[k=")
    assert session.executor.stats.multijoin_fused_probes == before + 1
    session.execute("SET SESSION enable_multiway_join = 'false'")
    try:
        ladder = session.execute(sql).rows
    finally:
        session.execute("SET SESSION enable_multiway_join = 'auto'")
    assert fused == ladder
    assert_rows_match(fused, oracle_query(oracle, ORACLE.get(qid, sql)),
                      rel_tol=1e-9, abs_tol=0.02, ordered=True)


def _strategy_lines(s, sql):
    return [r[0] for r in s.execute("EXPLAIN " + sql).rows
            if r[0].startswith(("agg strategy", "join strategy",
                                "join distribution", "multiway star"))]


def test_q7_equals_reference(tables):
    """q7 (k=4, every dim fused): rows, executed strategies, degrade
    counts and EXPLAIN lines equal the reference's with every kernel
    on."""
    conn = TpcdsConnector()
    conn._cache[0.01] = dict(tables)
    cat = JaxCatalog()
    cat.register("tpcds", conn)
    js = JaxSession(cat, default_cat="tpcds", default_schema="tiny")
    ts = Session(catalog_from_tables(tables, "tiny", "tpcds"),
                 default_cat="tpcds", default_schema="tiny", device="cpu")
    for name, value in KERNELS_ON:
        js.execute(f"SET SESSION {name} = '{value}'")
        ts.execute(f"SET SESSION {name} = '{value}'")
    sql = QUERIES[7]
    want = js.execute(sql).rows
    got = ts.execute(sql).rows
    assert got == want
    assert ts.executor.strategy_decisions == js.executor.strategy_decisions
    assert ts.executor.stats.multijoin_fused_probes == \
        js.executor.stats.multijoin_fused_probes == 1
    assert ts.executor.stats.multijoin_degrades == \
        js.executor.stats.multijoin_degrades
    assert _strategy_lines(ts, sql) == _strategy_lines(js, sql)
