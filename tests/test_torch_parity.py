"""The port's rows against the reference's over the whole query corpus:
the 22 TPC-H queries at tpch.tiny and the 99 TPC-DS queries of
tests/tpcds_queries.py at tpcds.tiny, each through the JAX Session and
the port's Session(device="cpu"), both at their defaults.

Tolerance: none. The rows are equal exactly, doubles to the last bit: in
order where the query ends in ORDER BY, as multisets otherwise. The
doubles the reference computes from decimals and from `round` carry
XLA's rewrite of a division by a constant (a multiply by the
reciprocal), which the port mirrors; TPC-DS q31, q59 and q78 show it.
Its float sums and cumsums carry XLA's summation orders, which the port
mirrors too (tests/test_torch_cumsum.py).

A corpus query the port cannot run would be listed with the ROADMAP item
that ports what it needs and must raise NotImplementedError naming it;
no query is listed now, and every corpus query plans on the port."""

from collections import Counter

import pytest
import torch

from tpcds_queries import QUERIES as TPCDS
from tpch_full import QUERIES as TPCH
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpcds.connector import (TABLE_NAMES,
                                                  TpcdsConnector)
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.exec.session import Session

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

TPCH_TABLES = ["region", "nation", "supplier", "customer", "part",
               "partsupp", "orders", "lineitem"]
# the ROADMAP item each corpus query the port does not run yet raises
TPCH_NOT_PORTED: dict = {}
TPCDS_NOT_PORTED: dict = {}
TPCH_RUN = [q for q in sorted(TPCH) if q not in TPCH_NOT_PORTED]
TPCDS_RUN = [q for q in sorted(TPCDS) if q not in TPCDS_NOT_PORTED]


@pytest.fixture(scope="module")
def tpch_sessions():
    conn = TpchConnector()
    tables = {t: conn.get_table("tiny", t) for t in TPCH_TABLES}
    cat = JaxCatalog()
    cat.register("tpch", conn)
    return (JaxSession(cat, default_schema="tiny"),
            Session(catalog_from_tables(tables), default_schema="tiny",
                    device="cpu"))


@pytest.fixture(scope="module")
def tpcds_sessions():
    conn = TpcdsConnector()
    tables = {t: conn.get_table("tiny", t) for t in TABLE_NAMES}
    cat = JaxCatalog()
    cat.register("tpcds", conn)
    return (JaxSession(cat, default_cat="tpcds", default_schema="tiny"),
            Session(catalog_from_tables(tables, "tiny", "tpcds"),
                    default_cat="tpcds", default_schema="tiny",
                    device="cpu"))


def _ends_in_order_by(sql: str) -> bool:
    """Whether `sql` has an ORDER BY outside every parenthesis."""
    up, depth = sql.upper(), 0
    for i, ch in enumerate(up):
        depth += (ch == "(") - (ch == ")")
        if depth == 0 and up.startswith("ORDER BY", i):
            return True
    return False


def _assert_same_rows(sessions, sql):
    reference, port = sessions
    want = reference.execute(sql).rows
    got = port.execute(sql).rows
    if _ends_in_order_by(sql):
        assert got == want
    else:
        assert Counter(map(repr, got)) == Counter(map(repr, want))


def test_corpus_lists_every_query():
    assert len(TPCH_RUN) == 22 and len(TPCDS_RUN) == 99
    assert set(TPCDS_NOT_PORTED) <= set(TPCDS)


@pytest.mark.parametrize("qnum", TPCH_RUN)
def test_tpch_rows_equal_reference(tpch_sessions, qnum):
    _assert_same_rows(tpch_sessions, TPCH[qnum])


@pytest.mark.parametrize("qid", TPCDS_RUN)
def test_tpcds_rows_equal_reference(tpcds_sessions, qid):
    _assert_same_rows(tpcds_sessions, TPCDS[qid])


def test_other_queries_name_their_roadmap_item(tpch_sessions,
                                               tpcds_sessions):
    for queries, not_ported, (_, port) in (
            (TPCH, TPCH_NOT_PORTED, tpch_sessions),
            (TPCDS, TPCDS_NOT_PORTED, tpcds_sessions)):
        for q, item in sorted(not_ported.items()):
            with pytest.raises(NotImplementedError,
                               match=f"ROADMAP: {item}"):
                port.execute(queries[q])
        # nothing else in the corpus raises: every query plans on the port
        for q in sorted(set(queries) - set(not_ported)):
            assert port.execute("EXPLAIN " + queries[q]).rows
