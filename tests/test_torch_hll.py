"""The port's HyperLogLog approx_distinct on the CPU (tpch.tiny): the
reference's file (tests/test_hll.py) carried over to `trino_tpu_torch`,
then the same statements through the JAX Session, integer for integer.

Reference behavior: ApproximateCountDistinctAggregation.java — default
max standard error 2.3%, NULLs ignored, mergeable partial state. Here
the sketch is a relational rewrite (planner.plan_hll_aggregation): an
inner max-aggregate over (keys, bucket) rows whose partials merge with
the ordinary machinery, so the same bound must hold in single-shot,
chunked, and distributed execution.
"""

import pytest
import torch

from torch_time_cases import HLL_QUERIES, hll_close, hll_sql
from trino_tpu_torch.exec.session import Session

torch.set_num_threads(1)

TOL = 0.023


def _close(got, want):
    # 2.3% is the sketch's ASYMPTOTIC standard error; for small true
    # counts the absolute error floor of a few registers dominates
    return abs(got - want) <= max(TOL * want, 5)


@pytest.fixture(scope="module")
def session():
    return Session(default_schema="tiny", device="cpu")


def _exact(session, sql):
    return session.execute(sql).rows


def test_hll_global_accuracy(session):
    got = session.execute(
        "SELECT approx_distinct(o_custkey) FROM orders").rows[0][0]
    want = session.execute(
        "SELECT count(DISTINCT o_custkey) FROM orders").rows[0][0]
    assert _close(got, want)


def test_hll_grouped_accuracy(session):
    got = session.execute("""
        SELECT l_returnflag, approx_distinct(l_orderkey)
        FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag""").rows
    want = session.execute("""
        SELECT l_returnflag, count(DISTINCT l_orderkey)
        FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag""").rows
    for (f1, a), (f2, e) in zip(got, want):
        assert f1 == f2
        assert _close(a, e)


def test_hll_mixed_with_plain_aggs(session):
    rows = session.execute("""
        SELECT l_returnflag, approx_distinct(l_suppkey), count(*),
               sum(l_quantity), min(l_orderkey), max(l_orderkey)
        FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag""").rows
    want = session.execute("""
        SELECT l_returnflag, count(DISTINCT l_suppkey), count(*),
               sum(l_quantity), min(l_orderkey), max(l_orderkey)
        FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag""").rows
    for g, w in zip(rows, want):
        assert g[0] == w[0]
        assert _close(g[1], w[1])
        assert tuple(g[2:]) == tuple(w[2:])       # plain aggs stay exact


def test_hll_nulls_and_empty(session):
    # all rows filtered out: approx_distinct over empty input is 0
    got = session.execute(
        "SELECT approx_distinct(o_custkey) FROM orders "
        "WHERE o_custkey < 0").rows[0][0]
    assert got == 0
    # NULLs are ignored (nation has no nulls; synthesize via nullif)
    got = session.execute(
        "SELECT approx_distinct(nullif(n_nationkey, n_nationkey)) "
        "FROM nation").rows[0][0]
    assert got == 0
    got = session.execute(
        "SELECT approx_distinct(nullif(n_nationkey, 3)) "
        "FROM nation").rows[0][0]
    assert got == 24


def test_hll_chunked_bounded_state(session):
    """The chunked driver merges the inner aggregate's partial rows —
    bounded 2^p rows per group — instead of refusing distinct the way
    the exact path must."""
    s = Session(default_schema="tiny", device="cpu")
    want = s.execute(
        "SELECT count(DISTINCT l_orderkey) FROM lineitem").rows[0][0]
    s.properties["spill_chunk_rows"] = 8192
    s.executor.spill_chunk_rows = 8192
    got = s.execute(
        "SELECT approx_distinct(l_orderkey) FROM lineitem").rows[0][0]
    assert s.executor.stats.agg_spill_chunks > 1, "did not chunk"
    assert _close(got, want)


def test_hll_matches_exact_fallbacks(session):
    """Mixed with an exact DISTINCT aggregate the rewrite steps aside
    (shared sort-dedup column), so approx == exact there."""
    rows = session.execute("""
        SELECT approx_distinct(o_custkey), count(DISTINCT o_custkey)
        FROM orders""").rows[0]
    assert rows[0] == rows[1]


# ---------------------------------------------------------------------------
# parity with the reference: the same integers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_session():
    from trino_tpu.exec.session import Session as JaxSession
    return JaxSession(default_schema="tiny")


@pytest.mark.parametrize("i", range(len(HLL_QUERIES)))
def test_approx_distinct_equals_reference(session, jax_session, i):
    sql = hll_sql(HLL_QUERIES[i])
    got = session.execute(sql).rows
    assert got == jax_session.execute(sql).rows
    exact = session.execute(hll_sql(HLL_QUERIES[i], exact=True)).rows
    assert [r[:-1] for r in got] == [r[:-1] for r in exact]
    assert all(hll_close(a[-1], e[-1]) for a, e in zip(got, exact))


def test_small_cardinalities_equal_reference(jax_session):
    """Forty groups of 1 to 400 seeded values each: small counts take
    the linear-counting branch of `$hll_est` (a `log` of the share of
    empty registers), where a last-bit difference in the float64
    estimate would show as a different integer at a .5."""
    import numpy as np
    rng = np.random.default_rng(3)
    s = Session(default_cat="memory", default_schema="default",
                device="cpu")
    rows = ", ".join(f"({g}, {b}, {int(r)})" for g in range(40)
                     for b, r in enumerate(rng.integers(
                         0, 12, rng.integers(1, 400))))
    sql = ("SELECT g, approx_distinct(x) FROM (SELECT g, b * 1000 + r "
           "AS x FROM memory.default.regs) t GROUP BY g ORDER BY g")
    j = jax_session
    for sess in (s, j):
        sess.execute("CREATE TABLE memory.default.regs "
                     "(g bigint, b bigint, r bigint)")
        sess.execute(f"INSERT INTO memory.default.regs VALUES {rows}")
    assert s.execute(sql).rows == j.execute(sql).rows
