"""Writes on the port (trino_tpu_torch/exec/session.py DDL and DML, the
memory connector) against the reference's Session and a sqlite oracle.

Three groups:

- the ten cases of tests/test_dml.py (UPDATE, DELETE, MERGE on a small
  memory table), each statement run through the JAX Session, the port's
  `Session(device="cpu")` and sqlite; after every statement the stored
  tables of the two sessions are equal to the byte (columns, validity,
  VARCHAR pools) and their rows equal sqlite's;
- CREATE TABLE (AS SELECT), INSERT VALUES / SELECT, DROP TABLE,
  IF [NOT] EXISTS, the reference's error cases and EXPLAIN of a write,
  with the texts equal to the reference's, the routing line included;
- stale state on `tpch.tiny` copied into memory tables: a query, a
  mutation, the query again with the scan cache warm and under
  `spill_chunk_rows` (the fact-column cache), each time equal to the JAX
  session's rows.

Tolerances: none. Port and reference are equal exactly; the sqlite
tables hold integers and strings only."""

import sqlite3

import numpy as np
import pytest
import torch

from test_tpch_queries import Q1, Q3, Q6, TPCH_TABLES
from tpch_full import QUERIES as H_QUERIES
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.catalog import Catalog, catalog_from_tables
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.exec.session import Session

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

SETUP = [
    "CREATE TABLE m.s.accounts (id bigint, name varchar, bal bigint)",
    "INSERT INTO m.s.accounts VALUES (1, 'alice', 100), (2, 'bob', 50),"
    " (3, 'carol', 0), (4, 'dan', 75)",
    "CREATE TABLE m.s.feed (id bigint, name varchar, amount bigint)",
    "INSERT INTO m.s.feed VALUES (2, 'bob', 25), (5, 'eve', 10),"
    " (3, 'carol', -5)",
]
ORACLE_SETUP = """
    CREATE TABLE accounts (id INTEGER, name TEXT, bal INTEGER);
    INSERT INTO accounts VALUES (1, 'alice', 100), (2, 'bob', 50),
        (3, 'carol', 0), (4, 'dan', 75);
    CREATE TABLE feed (id INTEGER, name TEXT, amount INTEGER);
    INSERT INTO feed VALUES (2, 'bob', 25), (5, 'eve', 10),
        (3, 'carol', -5);
"""
MERGE_UPSERT = """
    MERGE INTO accounts a USING feed f ON a.id = f.id
    WHEN MATCHED THEN UPDATE SET bal = a.bal + f.amount
    WHEN NOT MATCHED THEN INSERT (id, name, bal)
         VALUES (f.id, f.name, f.amount)
"""

# the ten cases of tests/test_dml.py: the statements, sqlite's version of
# them (None: the case checks its own outcome), the row count the last
# statement reports (None: not checked there either)
CASES = {
    "delete_where": (["DELETE FROM accounts WHERE bal < 60"],
                     "DELETE FROM accounts WHERE bal < 60", 2),
    "delete_all": (["DELETE FROM accounts"], "DELETE FROM accounts", None),
    "update_expression": (
        ["UPDATE accounts SET bal = bal * 2 + 1 WHERE bal >= 50"],
        "UPDATE accounts SET bal = bal * 2 + 1 WHERE bal >= 50", 3),
    "update_varchar_new_pool_value": (
        ["UPDATE accounts SET name = 'zed' WHERE id = 3"],
        "UPDATE accounts SET name = 'zed' WHERE id = 3", None),
    "update_multi_assignments": (
        ["UPDATE accounts SET bal = bal - 10, name = upper(name)"
         " WHERE id IN (1, 2)"],
        "UPDATE accounts SET bal = bal - 10, name = upper(name)"
        " WHERE id IN (1, 2)", None),
    "merge_upsert": ([MERGE_UPSERT], """
        UPDATE accounts SET bal = bal +
          (SELECT amount FROM feed WHERE feed.id = accounts.id)
        WHERE id IN (SELECT id FROM feed);
        INSERT INTO accounts
          SELECT id, name, amount FROM feed
          WHERE id NOT IN (SELECT id FROM accounts);""", 3),
    "merge_conditional_delete": (["""
        MERGE INTO accounts a USING feed f ON a.id = f.id
        WHEN MATCHED AND f.amount < 0 THEN DELETE"""], """
        DELETE FROM accounts WHERE id IN
          (SELECT id FROM feed WHERE amount < 0)""", 1),
    "merge_insert_only_with_null_padding": (["""
        MERGE INTO accounts a USING feed f ON a.id = f.id
        WHEN NOT MATCHED THEN INSERT (id, name) VALUES (f.id, f.name)"""],
        """INSERT INTO accounts (id, name)
          SELECT id, name FROM feed
          WHERE id NOT IN (SELECT id FROM accounts)""", 1),
    "merge_duplicate_source_rows_error": (
        ["INSERT INTO feed VALUES (2, 'bob2', 7)"], None, 1),
    "update_unseen_varchar_keeps_pool_sorted": (
        ["UPDATE m.s.accounts SET name = 'zed' WHERE id = 1",
         "UPDATE m.s.accounts SET name = 'amy' WHERE id = 3",
         "INSERT INTO m.s.accounts VALUES (9, 'cat', 1)"], None, 1),
}


def _small_sessions():
    jcat = JaxCatalog()
    jcat.register("m", JaxMemory())
    js = JaxSession(catalog=jcat, default_cat="m", default_schema="s")
    tcat = Catalog()
    tcat.register("m", MemoryConnector())
    ts = Session(catalog=tcat, default_cat="m", default_schema="s",
                 device="cpu")
    for sql in SETUP:
        assert ts.execute(sql).rows == js.execute(sql).rows
    return js, ts


def assert_tables_equal(jcat, tcat, cat, schema):
    """Every stored table of `cat.schema` equal between the two catalogs:
    names, field names, type names, VARCHAR pools, column dtypes and
    bytes, validity (None and all-valid kept apart)."""
    jconn, tconn = jcat.connector(cat), tcat.connector(cat)
    names = jconn.table_names(schema)
    assert tconn.table_names(schema) == names
    for name in names:
        j, t = jconn.get_table(schema, name), tconn.get_table(schema, name)
        assert [(f.name, repr(f.dtype), f.dictionary)
                for f in t.schema.fields] == \
            [(f.name, repr(f.dtype), f.dictionary)
             for f in j.schema.fields], name
        for a, b in zip(t.columns, j.columns):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        assert (t.valids is None) == (j.valids is None), name
        for a, b in zip(t.valids or (), j.valids or ()):
            assert (a is None) == (b is None), name
            assert a is None or np.asarray(a).tobytes() == \
                np.asarray(b).tobytes(), name


def _accounts(session):
    return session.execute(
        "SELECT id, name, bal FROM accounts ORDER BY id").rows


@pytest.mark.parametrize("case", list(CASES))
def test_dml_case_three_ways(case):
    """One case of tests/test_dml.py: each statement through both
    sessions (equal reported counts, equal stored tables after each) and
    sqlite (equal rows at the end); the two cases that check their own
    outcome there check it here on both sessions."""
    js, ts = _small_sessions()
    statements, oracle_sql, count = CASES[case]
    for sql in statements:
        got = ts.execute(sql).rows
        assert got == js.execute(sql).rows
        assert_tables_equal(js.catalog, ts.catalog, "m", "s")
    if count is not None:
        assert got[0][0] == count
    if oracle_sql is not None:
        db = sqlite3.connect(":memory:")
        db.executescript(ORACLE_SETUP)
        db.executescript(oracle_sql)
        want = db.execute(
            "SELECT id, name, bal FROM accounts ORDER BY id").fetchall()
        assert [tuple(r) for r in _accounts(ts)] == want
    assert _accounts(ts) == _accounts(js)
    if case == "merge_duplicate_source_rows_error":
        sql = ("MERGE INTO accounts a USING feed f ON a.id = f.id "
               "WHEN MATCHED THEN UPDATE SET bal = f.amount")
        for s in (js, ts):
            with pytest.raises(RuntimeError,
                               match="more than one source row"):
                s.execute(sql)
        assert_tables_equal(js.catalog, ts.catalog, "m", "s")
    if case == "update_unseen_varchar_keeps_pool_sorted":
        for s in (js, ts):
            assert s.execute("SELECT id FROM m.s.accounts ORDER BY name "
                             "DESC").rows == [(1,), (4,), (9,), (2,), (3,)]
            assert s.execute("SELECT count(*) FROM m.s.accounts WHERE "
                             "name < 'dan'").rows == [(3,)]


# ---- CREATE / INSERT / DROP, errors, EXPLAIN of a write ---------------


@pytest.fixture(scope="module")
def tables():
    conn = TpchConnector()
    return {t: conn.get_table("tiny", t) for t in TPCH_TABLES}


def _tpch_sessions(tables, props=()):
    """JAX and port sessions over the same tpch.tiny tables, each with an
    empty `memory` catalog (as the reference's default catalog has)."""
    conn = TpchConnector()
    conn._cache[0.01] = dict(tables)
    jcat = JaxCatalog()
    jcat.register("tpch", conn)
    jcat.register("memory", JaxMemory())
    js = JaxSession(jcat, default_schema="tiny")
    ts = Session(catalog_from_tables(tables), default_schema="tiny",
                 device="cpu")
    for name, value in props:
        js.execute(f"SET SESSION {name} = '{value}'")
        ts.execute(f"SET SESSION {name} = '{value}'")
    return js, ts


DDL_STEPS = [
    "CREATE TABLE memory.w.o AS SELECT * FROM tpch.tiny.orders "
    "WHERE o_orderkey < 3000",
    "CREATE TABLE IF NOT EXISTS memory.w.o AS SELECT 1 AS x",
    "CREATE TABLE memory.w.t (k bigint, v varchar, d decimal(10,2), "
    "day date, f double, b boolean)",
    "INSERT INTO memory.w.t VALUES (1, 'b', 1.5, DATE '1995-01-01', 0.25, "
    "true), (2, NULL, NULL, NULL, NULL, false)",
    "INSERT INTO memory.w.t SELECT o_orderkey, o_orderstatus, o_totalprice, "
    "o_orderdate, CAST(o_totalprice AS double) / 3, o_orderkey > 100 "
    "FROM tpch.tiny.orders WHERE o_orderkey < 40",
    "INSERT INTO memory.w.o SELECT * FROM tpch.tiny.orders "
    "WHERE o_orderkey BETWEEN 3000 AND 3100",
    "CREATE TABLE IF NOT EXISTS memory.w.t (x bigint)",
    "CREATE TABLE memory.w.agg AS SELECT o_orderstatus, count(*) AS n, "
    "sum(o_totalprice) AS total, avg(o_totalprice) AS mean "
    "FROM memory.w.o GROUP BY o_orderstatus",
    "DROP TABLE memory.w.agg",
    "DROP TABLE IF EXISTS memory.w.agg",
]


def test_ddl_steps_equal_reference(tables):
    """CTAS, CREATE, INSERT VALUES (NULLs of every type), INSERT SELECT,
    IF [NOT] EXISTS and DROP: equal results and equal stored tables after
    every statement; then every table's rows equal."""
    js, ts = _tpch_sessions(tables)
    for sql in DDL_STEPS:
        assert ts.execute(sql).rows == js.execute(sql).rows, sql
        assert_tables_equal(js.catalog, ts.catalog, "memory", "w")
    for name in ("o", "t"):
        sql = f"SELECT * FROM memory.w.{name}"
        assert sorted(ts.execute(sql).rows, key=repr) == \
            sorted(js.execute(sql).rows, key=repr)
    assert ts.execute("SHOW TABLES FROM memory.w").rows == [("o",), ("t",)]


ERRORS = {
    "create existing": ("CREATE TABLE memory.w.o (x bigint)", KeyError),
    "drop missing": ("DROP TABLE memory.w.nope", KeyError),
    "insert missing": ("INSERT INTO memory.w.nope VALUES (1)", KeyError),
    "insert width": ("INSERT INTO memory.w.o VALUES (1)", ValueError),
    "update unknown column": ("UPDATE memory.w.o SET nope = 1", Exception),
    "dml on a generator": ("DELETE FROM tpch.tiny.nation", Exception),
    "merge two matched": ("MERGE INTO memory.w.o t USING tpch.tiny.nation n"
                          " ON t.o_orderkey = n.n_nationkey WHEN MATCHED "
                          "THEN DELETE WHEN MATCHED THEN DELETE",
                          Exception),
    "merge not matched delete": (
        "MERGE INTO memory.w.o t USING tpch.tiny.nation n ON t.o_orderkey"
        " = n.n_nationkey WHEN NOT MATCHED THEN DELETE", Exception),
    "explain create without select": (
        "EXPLAIN CREATE TABLE memory.w.z (x bigint)", ValueError),
}


@pytest.mark.parametrize("what", list(ERRORS))
def test_write_errors_as_reference(tables, what):
    """The reference's error for each malformed write, with the same
    message, and no stored table changed."""
    js, ts = _tpch_sessions(tables)
    setup = "CREATE TABLE memory.w.o AS SELECT * FROM tpch.tiny.region"
    assert ts.execute(setup).rows == js.execute(setup).rows
    sql, exc = ERRORS[what]
    with pytest.raises(exc) as jerr:
        js.execute(sql)
    with pytest.raises(exc) as terr:
        ts.execute(sql)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)
    assert_tables_equal(js.catalog, ts.catalog, "memory", "w")


@pytest.mark.parametrize("sql", [
    "EXPLAIN CREATE TABLE memory.w.x AS SELECT o_orderstatus, count(*) "
    "FROM tpch.tiny.orders GROUP BY o_orderstatus",
    "EXPLAIN INSERT INTO memory.w.o SELECT * FROM tpch.tiny.region "
    "WHERE r_regionkey > 2",
    "EXPLAIN ANALYZE INSERT INTO memory.w.o SELECT * FROM tpch.tiny.region",
])
def test_explain_write_equals_reference(tables, sql):
    """EXPLAIN of CTAS and INSERT: the TableCommit/TableWriter rows over
    the source plan, text equal to the reference's; ANALYZE writes."""
    js, ts = _tpch_sessions(tables)
    setup = "CREATE TABLE memory.w.o AS SELECT * FROM tpch.tiny.region"
    ts.execute(setup)
    js.execute(setup)
    got = ts.execute(sql).rows
    assert got[0][0].startswith("TableCommit[memory.w.")
    assert got == js.execute(sql).rows
    assert_tables_equal(js.catalog, ts.catalog, "memory", "w")


def test_drop_keeps_device_and_chunking(tables):
    """DROP TABLE rebuilds the executor on the session's device, with the
    session's chunk size; the next query runs there to the reference's
    rows."""
    js, ts = _tpch_sessions(tables, (("spill_chunk_rows", "8192"),))
    for s in (js, ts):
        s.execute("CREATE TABLE memory.w.l AS SELECT * FROM "
                  "tpch.tiny.lineitem")
        s.execute("DROP TABLE memory.w.l")
    assert ts.executor.device == ts.device
    assert ts.executor.spill_chunk_rows == 8192
    assert ts.execute(Q6).rows == js.execute(Q6).rows
    assert ts.executor.stats.agg_spill_chunks > 0


# ---- stale state after a write ----------------------------------------

MEMORY_QUERIES = {
    "q1": Q1.replace("FROM lineitem", "FROM memory.w.lineitem"),
    "q6": Q6.replace("FROM lineitem", "FROM memory.w.lineitem"),
    "q3": Q3.replace("FROM customer, orders, lineitem",
                     "FROM memory.w.customer, memory.w.orders, "
                     "memory.w.lineitem"),
    "q12": H_QUERIES[12].replace("orders,", "memory.w.orders,").replace(
        "lineitem\n", "memory.w.lineitem\n"),
}
MUTATIONS = [
    "DELETE FROM memory.w.lineitem WHERE l_shipdate < DATE '1993-01-01'",
    "UPDATE memory.w.lineitem SET l_discount = l_discount + 0.01, "
    "l_shipmode = 'AIRBUS' WHERE l_orderkey % 4 = 1",
    "INSERT INTO memory.w.lineitem SELECT * FROM tpch.tiny.lineitem "
    "WHERE l_shipdate < DATE '1992-06-01'",
    "MERGE INTO memory.w.orders t USING (SELECT o_orderkey + 60000 AS k, "
    "o_orderkey AS src, o_totalprice AS p, o_orderpriority AS pr, "
    "o_orderdate AS d FROM tpch.tiny.orders WHERE o_orderkey % 10 = 3) s "
    "ON t.o_orderkey = s.src WHEN MATCHED THEN UPDATE SET o_orderpriority "
    "= '1-URGENT', o_totalprice = s.p * 2 WHEN NOT MATCHED THEN INSERT "
    "(o_orderkey, o_custkey, o_totalprice, o_orderdate, o_orderpriority, "
    "o_shippriority) VALUES (s.k, 1, s.p, s.d, s.pr, 0)",
]


@pytest.mark.parametrize("chunked", [False, True])
def test_queries_after_each_mutation(tables, chunked):
    """TPC-H q1, q6, q3 and q12 over memory copies of tpch.tiny's tables
    (q12 and q1 under `spill_chunk_rows = 8192` in the chunked case,
    twice a state): run, mutate (DELETE, UPDATE with a VARCHAR value the
    pool lacks, INSERT, MERGE), run again with the caches warm; every run
    equal to the JAX session's rows and the reported counts equal."""
    js, ts = _tpch_sessions(tables)
    for t in ("lineitem", "orders", "customer"):
        sql = f"CREATE TABLE memory.w.{t} AS SELECT * FROM tpch.tiny.{t}"
        assert ts.execute(sql).rows == js.execute(sql).rows
    names = ("q12", "q1") if chunked else ("q1", "q6", "q3", "q12")
    if chunked:
        for s in (js, ts):
            s.execute("SET SESSION spill_chunk_rows = '8192'")
    for step in [None] + MUTATIONS:
        if step is not None:
            assert ts.execute(step).rows == js.execute(step).rows, step
        for name in names:
            want = js.execute(MEMORY_QUERIES[name]).rows
            for _ in range(2 if chunked else 1):
                assert ts.execute(MEMORY_QUERIES[name]).rows == want, \
                    (name, step)
    if chunked:
        assert ts.executor.stats.fact_cache_chunks > 0
    assert_tables_equal(js.catalog, ts.catalog, "memory", "w")
