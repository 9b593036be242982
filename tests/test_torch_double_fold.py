"""DOUBLE products and quotients by literals on the port
(trino_tpu_torch/ops/project.py `_fold_factor`) against the reference's
compiled projection, bit for bit.

The reference evaluates a projection inside one jit: XLA turns a division
by a constant into a multiplication by its reciprocal and folds chained
constant factors into one, in an order set by its simplifier's passes.
The port folds the same factor on the host. Expressions run over
`tpch.tiny` through both Sessions; rows are compared as the bytes of
their doubles (no tolerance), and the window sum over a folded product
as the reference's rows. Long chains (up to six factors), chains through
`round()`, a chain across two projections of one fused chunk program, and
a seeded battery of random chains over a DECIMAL(12,2), a DOUBLE and a
BIGINT column hold the port's replay of the simplifier
(`ops/project._fold_factor`) to the reference's compiled bits."""

import random

import numpy as np
import pytest
import torch

from test_tpch_queries import TPCH_TABLES
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.memory import MemoryConnector as JaxMemory
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.connectors.memory import MemoryConnector
from trino_tpu_torch.exec.session import Session

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)


def _make_sessions(tables):
    jconn = TpchConnector()
    jconn._cache[0.01] = dict(tables)
    jcat = JaxCatalog()
    jcat.register("tpch", jconn)
    jcat.register("memory", JaxMemory())
    tcat = catalog_from_tables(tables)
    tcat.register("memory", MemoryConnector())
    return (JaxSession(jcat, default_schema="tiny"),
            Session(tcat, default_schema="tiny", device="cpu"))


@pytest.fixture(scope="module")
def tables():
    conn = TpchConnector()
    return {t: conn.get_table("tiny", t) for t in TPCH_TABLES}


@pytest.fixture(scope="module")
def sessions(tables):
    js, ts = _make_sessions(tables)
    # a table with a DECIMAL(12,2), a DOUBLE and a BIGINT column for the
    # random chains (the DOUBLE is stored, so a chain over it starts at a
    # plain double, not at a cast)
    for s in (js, ts):
        s.execute("CREATE TABLE memory.s.fold AS SELECT l_orderkey AS k, "
                  "l_linenumber AS n, l_extendedprice AS p, "
                  "CAST(l_extendedprice AS double) + 0.25 AS d "
                  "FROM lineitem WHERE l_orderkey <= 1200")
    return js, ts


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


# ROADMAP Queue C 1's long chains: four and more literal factors (a
# decimal's scale counted as one), and chains through round()
LONG_CHAINS = [
    "((((CAST(l_orderkey AS double)) * 13) * 1.1) * 0.07) / 9.75",
    "(0.07 * (1.3 * (CAST(l_extendedprice AS double) / 0.3))) / 17",
    "((CAST(l_extendedprice AS double) / 0.07) * 6) * 0.01",
    "round(CAST(l_extendedprice AS double) * 1.1 / 7, 2) * 3",
    "((l_extendedprice / 0.07) * 6) * 0.01",
    "(((CAST(l_extendedprice AS double) * 0.01) / 1.7) * 7) * 0.7",
    "((((CAST(l_quantity AS double) / 9.75) * 0.7) * 0.05) / 3) * 11",
    "round(CAST(l_extendedprice AS double) / 7, 1)",
    "round(CAST(l_extendedprice AS double) * 1.1, 0) / 3",
    "CAST(CAST(l_extendedprice AS double) * 1.1 / 7 AS decimal(12,2))",
]


@pytest.mark.parametrize("expr", LONG_CHAINS)
def test_long_chains_equal_reference_bits(sessions, expr):
    js, ts = sessions
    sql = f"SELECT l_orderkey, l_linenumber, {expr} FROM lineitem"
    got, want = ts.execute(sql).rows, js.execute(sql).rows
    assert [r[:2] for r in got] == [r[:2] for r in want]
    if isinstance(want[0][-1], float):
        assert _bits(got) == _bits(want)
    else:
        assert got == want


def test_chain_across_two_projections_in_a_fused_chunk(tables):
    """The reference compiles the whole per-chunk path as one program, so
    a subquery's quotient and the product outside it fold as one chain;
    the port's fused chunk program inlines the inner projection."""
    js, ts = _make_sessions(tables)
    for s in (js, ts):
        s.execute("SET SESSION spill_chunk_rows = 8192")
    sql = ("SELECT l_returnflag, max(y * 0.07 / 3), min(y * 13) FROM ("
           "SELECT l_returnflag, CAST(l_extendedprice AS double) / 9.75 "
           "AS y FROM lineitem WHERE l_quantity > 5) t "
           "GROUP BY l_returnflag ORDER BY l_returnflag")
    got, want = ts.execute(sql).rows, js.execute(sql).rows
    assert ts.executor.stats.fused_chunk_pipelines >= 1
    assert got == want
    assert np.array([r[1:] for r in got]).tobytes() == \
        np.array([r[1:] for r in want]).tobytes()


def _random_chains(seed: int, n: int):
    rng = random.Random(seed)
    bases = ["CAST(p AS double)", "d", "CAST(k AS double)"]
    lits = ["13", "1.1", "0.07", "9.75", "0.3", "1.3", "17", "6", "0.01",
            "7", "3", "0.7", "2.5", "11", "0.05", "1.7", "100", "0.125"]
    out = []
    for _ in range(n):
        e = rng.choice(bases)
        for _ in range(rng.randint(2, 6)):
            op, c = rng.choice(["*", "/", "l*"]), rng.choice(lits)
            e = f"({c} * {e})" if op == "l*" else f"({e} {op} {c})"
        out.append(e)
    return out


@pytest.mark.parametrize("expr", _random_chains(9, 64))
def test_random_chain_equals_reference_bits(sessions, expr):
    js, ts = sessions
    sql = f"SELECT k, n, {expr} FROM memory.s.fold"
    got, want = ts.execute(sql).rows, js.execute(sql).rows
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert _bits(got) == _bits(want)


@pytest.mark.parametrize("expr", [
    # ROADMAP Queue C 3's four shapes
    "CAST(l_extendedprice AS double) + l_tax",
    "CAST(l_extendedprice AS double) / 3 + CAST(l_tax AS double)",
    "CAST(l_extendedprice AS double) * 1.1 + CAST(l_tax AS double)",
    "CAST(l_extendedprice AS double) * 3 - CAST(l_quantity AS double) * 7",
    # the contraction from the right, against a literal, of a product of
    # two doubles, and under a later product
    "l_tax + CAST(l_extendedprice AS double) * 2.0",
    "1.5 - CAST(l_extendedprice AS double) / 7",
    "CAST(l_extendedprice AS double) * 2.0 + 1.5",
    "CAST(l_extendedprice AS double) * CAST(l_discount AS double) + l_tax",
    "(CAST(l_extendedprice AS double) + l_tax) * 1.1 - l_discount",
])
def test_sums_of_scaled_operands_equal_reference_bits(sessions, expr):
    """The reference's compiled code contracts an add or subtract whose
    operand is a product into one fused multiply-add (left product
    first); the port replays it (`ops/project._eval_contracted`)."""
    js, ts = sessions
    sql = f"SELECT l_orderkey, l_linenumber, {expr} FROM lineitem"
    got, want = ts.execute(sql).rows, js.execute(sql).rows
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert _bits(got) == _bits(want)


def _random_sums(seed: int, n: int):
    rng = random.Random(seed)
    terms = ["CAST(p AS double)", "d", "CAST(k AS double)", "p", "2.5",
             "CAST(n AS double)"]
    lits = ["13", "1.1", "0.07", "3", "0.7", "17", "0.05", "100"]

    def chain():
        e = rng.choice(terms)
        for _ in range(rng.randint(0, 2)):
            op, c = rng.choice(["*", "/"]), rng.choice(lits)
            e = f"({e} {op} {c})"
        return e

    out = []
    while len(out) < n:
        e = f"({chain()} {rng.choice('+-')} {chain()})"
        if rng.random() < 0.5:
            e = f"({e} {rng.choice('+-')} {chain()})"
        if "double" in e or " d" in e or "(d" in e:
            out.append(e)
    return out


# An add of two products fuses the operand LLVM's Reassociate ranks
# lower, and loads rank in the order XLA's emitter extracts them: deepest
# in the optimised HLO first (ops/project._load_order). In
# ((((n / 0.7) / 0.05) + ((p * 100) / 3)) + n * 0.07) the loop reads `p`
# before `n`, although the expression names `n` first.
@pytest.mark.parametrize("expr", _random_sums(5, 32))
def test_random_sum_equals_reference_bits(sessions, expr):
    js, ts = sessions
    sql = f"SELECT k, n, {expr} FROM memory.s.fold"
    got, want = ts.execute(sql).rows, js.execute(sql).rows
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert _bits(got) == _bits(want)
