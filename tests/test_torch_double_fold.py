"""DOUBLE products and quotients by literals on the port
(trino_tpu_torch/ops/project.py `_fold_factor`) against the reference's
compiled projection, bit for bit.

The reference evaluates a projection inside one jit: XLA turns a division
by a constant into a multiplication by its reciprocal and folds chained
constant factors into one, in an order set by its simplifier's passes.
The port folds the same factor on the host. Expressions run over
`tpch.tiny` through both Sessions; rows are compared as the bytes of
their doubles (no tolerance), and the window sum over a folded product
as the reference's rows."""

import numpy as np
import pytest
import torch

from test_tpch_queries import TPCH_TABLES
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.exec.session import Session

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sessions():
    conn = TpchConnector()
    tables = {t: conn.get_table("tiny", t) for t in TPCH_TABLES}
    jconn = TpchConnector()
    jconn._cache[0.01] = dict(tables)
    jcat = JaxCatalog()
    jcat.register("tpch", jconn)
    return (JaxSession(jcat, default_schema="tiny"),
            Session(catalog_from_tables(tables), default_schema="tiny",
                    device="cpu"))


def _bits(rows):
    return np.array([r[-1] for r in rows], dtype=np.float64).tobytes()


@pytest.mark.parametrize("expr", [
    # ROADMAP Queue C 1's expressions
    "CAST(l_extendedprice AS double) / 7",
    "CAST(l_extendedprice AS double) * 0.7",
    "(CAST(l_extendedprice AS double) / 3) / 7",
    # the same rules in other orders: a literal on the left, a factor
    # after a quotient, a quotient after a factor, a plain double, a
    # decimal operand of a double division, a cast literal
    "1.1 * CAST(l_extendedprice AS double)",
    "(CAST(l_extendedprice AS double) / 13) * 1.1",
    "(CAST(l_extendedprice AS double) * 1.1) / 13",
    "((CAST(l_extendedprice AS double) / 3) * 7) / 11",
    "(CAST(l_quantity AS double) * 0.7) * 3",
    "CAST(l_orderkey AS double) / 3",
    "l_extendedprice / 7",
    "CAST(l_extendedprice AS double) * CAST(0.7 AS double)",
])
def test_folded_doubles_equal_reference_bits(sessions, expr):
    js, ts = sessions
    sql = f"SELECT l_orderkey, l_linenumber, {expr} FROM lineitem"
    got, want = ts.execute(sql).rows, js.execute(sql).rows
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert _bits(got) == _bits(want)


def test_window_sum_over_folded_product(sessions):
    """The window probe of ROADMAP Queue C 1: the projection under the
    running sum now has the reference's bits, and so does the sum."""
    js, ts = sessions
    sql = ("SELECT o_orderkey, sum(CAST(o_totalprice AS double) * 1.1) "
           "OVER (PARTITION BY o_orderstatus ORDER BY o_orderkey) "
           "FROM orders")
    got = sorted(ts.execute(sql).rows)
    want = sorted(js.execute(sql).rows)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert _bits(got) == _bits(want)


def test_comparison_with_a_decimal_literal(sessions):
    """A decimal literal compared with a double is the literal's correctly
    rounded double (the reference folds it before XLA sees it), not its
    value times the reciprocal of 10^s."""
    js, ts = sessions
    sql = ("SELECT count(*) FROM lineitem WHERE "
           "CAST(l_quantity AS double) * 0.1 > 1.1")
    assert ts.execute(sql).rows == js.execute(sql).rows
