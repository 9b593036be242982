"""The TPC-H queries the port's slice covers, end to end on the port
Session (CPU) against the sqlite oracle over tpch.tiny (the reference's
generated tables, byte-identical to the port's) — the check
tests/test_tpch_all.py makes of the reference, with its tolerance
(abs 0.02: the oracle sums REALs). q4, q21 and q22 need semi/anti joins,
which are not ported yet, and must say so."""

import pytest

from oracle import assert_rows_match, load_oracle, oracle_query
from tpch_full import QUERIES
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.exec.session import Session

NEEDS_SEMI_ANTI = (4, 21, 22)
TPCH_TABLES = ["region", "nation", "supplier", "customer", "part",
               "partsupp", "orders", "lineitem"]


@pytest.fixture(scope="module")
def tables():
    conn = TpchConnector()
    return {t: conn.get_table("tiny", t) for t in TPCH_TABLES}


@pytest.fixture(scope="module")
def session(tables):
    return Session(catalog_from_tables(tables), default_schema="tiny",
                   device="cpu")


@pytest.fixture(scope="module")
def oracle(tables):
    return load_oracle([tables[t] for t in TPCH_TABLES])


@pytest.mark.parametrize("qnum", [q for q in sorted(QUERIES)
                                  if q not in NEEDS_SEMI_ANTI])
def test_tpch_query_on_port(session, oracle, qnum):
    sql = QUERIES[qnum]
    got = session.execute(sql).rows
    assert_rows_match(got, oracle_query(oracle, sql), rel_tol=1e-9,
                      abs_tol=0.02, ordered=True)


@pytest.mark.parametrize("qnum", NEEDS_SEMI_ANTI)
def test_semi_anti_queries_say_not_ported(session, qnum):
    with pytest.raises(NotImplementedError, match="semi/anti/mark joins"):
        session.execute(QUERIES[qnum])
