"""The TPC-H queries the port's slice covers, end to end on the port
Session (CPU) against the sqlite oracle over tpch.tiny (the reference's
generated tables, byte-identical to the port's) — the check
tests/test_tpch_all.py makes of the reference, with its tolerance
(abs 0.02: the oracle sums REALs). All 22 queries, q4, q21 and q22
through the port's semi and anti joins."""

import pytest
import torch

from oracle import assert_rows_match, load_oracle, oracle_query
from tpch_full import QUERIES
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.exec.session import Session

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

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


@pytest.mark.parametrize("qnum", sorted(QUERIES))
def test_tpch_query_on_port(session, oracle, qnum):
    sql = QUERIES[qnum]
    got = session.execute(sql).rows
    assert_rows_match(got, oracle_query(oracle, sql), rel_tol=1e-9,
                      abs_tol=0.02, ordered=True)
