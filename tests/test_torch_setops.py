"""Set operations and grouping sets on the port against the reference.

UNION ALL, UNION, INTERSECT [ALL] and EXCEPT [ALL] through the port's
``ops/setops.py`` against the reference's concat and host loop
(``Executor.run_setop_host``): on seeded batches (NULLs, duplicates,
``-0.0`` beside ``0.0``, NaN, dead rows, several lane types), and through
both Sessions in SQL over VALUES and tpch.tiny (varchar columns from two
dictionaries), with GROUPING SETS, ROLLUP and CUBE, which plan into
``union_all`` set operations.

Tolerance: none. Rows equal the reference's exactly and in the
reference's order (a set operation's output order is its first
occurrences, left rows before right rows); doubles compare by their
bits."""

import numpy as np
import pytest
import torch

from trino_tpu.batch import batch_from_numpy as jax_batch
from trino_tpu.batch import batch_to_numpy as jax_to_numpy
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.exec.executor import Executor as JaxExecutor
from trino_tpu.exec.executor import concat_batches as jax_concat
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.batch import batch_from_numpy as torch_batch
from trino_tpu_torch.batch import batch_to_numpy as torch_to_numpy
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.ops.setops import concat_batches, setop_rows

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

OPS = ("union", "intersect", "intersect_all", "except", "except_all")


def _side(rng, n):
    """Columns drawn from small domains so rows repeat within and across
    sides: int64, int32 dictionary codes, doubles with -0.0/0.0/NaN, bool;
    each with NULLs."""
    f = rng.choice(np.array([0.0, -0.0, 1.5, np.nan, -2.25]), n)
    arrays = [rng.integers(0, 3, n), rng.integers(0, 3, n).astype(np.int32),
              f, rng.integers(0, 2, n).astype(bool)]
    valids = [rng.random(n) > 0.2 for _ in arrays]
    return arrays, valids


def _pair(op, seed):
    rng = np.random.default_rng(seed)
    (la, lv), (ra, rv) = _side(rng, 300), _side(rng, 200)
    # dead rows: a mask over the left side's capacity
    dead = np.zeros(1024, dtype=bool)
    dead[rng.integers(0, 300, 40)] = True
    jl = jax_batch(la, valids=lv)
    jl = jl.with_live(jl.live & ~dead)
    tl = torch_batch(la, valids=lv, device="cpu")
    tl = tl.with_live(tl.live & ~torch.from_numpy(dead))
    return (jl, jax_batch(ra, valids=rv)), \
        (tl, torch_batch(ra, valids=rv, device="cpu"))


def _same(got, want):
    (ga, gv), (wa, wv) = got, want
    assert len(ga) == len(wa)
    for g, w, g_ok, w_ok in zip(ga, wa, gv, wv):
        assert g.dtype == w.dtype
        assert np.array_equal(g_ok, w_ok)
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("op", OPS)
def test_setop_rows_equal_reference(op, seed):
    (jl, jr), (tl, tr) = _pair(op, seed)
    want = jax_to_numpy(JaxExecutor.run_setop_host(None, op, jl, jr))
    got = torch_to_numpy(setop_rows(op, tl, tr))
    _same(got, want)


def test_union_all_equals_reference():
    (jl, jr), (tl, tr) = _pair("union_all", 2)
    _same(torch_to_numpy(concat_batches(tl, tr)),
          jax_to_numpy(jax_concat(jl, jr)))


@pytest.mark.parametrize("op", OPS)
def test_setop_of_empty_sides(op):
    arrays = [np.zeros(0, np.int64), np.zeros(0, np.float64)]
    (la, lv) = _side(np.random.default_rng(5), 10)
    for left, right in (((arrays, None), (arrays, None)),
                        ((la[:2], lv[:2]), (arrays, None)),
                        ((arrays, None), (la[:2], lv[:2]))):
        want = jax_to_numpy(JaxExecutor.run_setop_host(
            None, op, jax_batch(left[0], valids=left[1]),
            jax_batch(right[0], valids=right[1])))
        got = torch_to_numpy(setop_rows(
            op, torch_batch(left[0], valids=left[1], device="cpu"),
            torch_batch(right[0], valids=right[1], device="cpu")))
        _same(got, want)


TPCH_TABLES = ["region", "nation", "supplier", "customer", "part",
               "partsupp", "orders", "lineitem"]


@pytest.fixture(scope="module")
def sessions():
    conn = TpchConnector()
    tables = {t: conn.get_table("tiny", t) for t in TPCH_TABLES}
    cat = JaxCatalog()
    cat.register("tpch", conn)
    return (JaxSession(cat, default_schema="tiny"),
            Session(catalog_from_tables(tables), default_schema="tiny",
                    device="cpu"))


_L = ("SELECT * FROM (VALUES (1, 'a', CAST(0 AS double)), "
      "(NULL, 'b', -CAST(0 AS double)), (1, 'a', CAST(0 AS double)), "
      "(2, NULL, CAST('NaN' AS double)), (NULL, 'b', CAST(0 AS double)), "
      "(3, 'c', CAST(1.5 AS double)), (2, NULL, CAST('NaN' AS double))) "
      "t(x, s, d)")
_R = ("SELECT * FROM (VALUES (NULL, 'b', CAST(0 AS double)), "
      "(1, 'a', -CAST(0 AS double)), (4, 'z', CAST(2 AS double)), "
      "(2, NULL, CAST('NaN' AS double)), (1, 'a', CAST(0 AS double))) "
      "u(x, s, d)")

SQL = {
    "values_union_all": f"{_L} UNION ALL {_R}",
    "values_union": f"{_L} UNION {_R}",
    "values_intersect": f"{_L} INTERSECT {_R}",
    "values_intersect_all": f"{_L} INTERSECT ALL {_R}",
    "values_except": f"{_L} EXCEPT {_R}",
    "values_except_all": f"{_L} EXCEPT ALL {_R}",
    "values_chain": f"{_R} UNION {_L} EXCEPT {_R}",
    # varchar columns from two dictionaries (nation and region names,
    # l_returnflag and l_linestatus)
    "names_union": "SELECT n_name FROM nation UNION SELECT r_name FROM "
                   "region",
    "names_intersect": "SELECT r_name FROM region INTERSECT "
                       "SELECT n_name FROM nation",
    "flags_union": "SELECT l_returnflag AS f FROM lineitem UNION "
                   "SELECT l_linestatus FROM lineitem",
    "flags_except_all": "SELECT l_returnflag AS f FROM lineitem "
                        "WHERE l_orderkey < 100 EXCEPT ALL "
                        "SELECT l_linestatus FROM lineitem "
                        "WHERE l_orderkey < 50",
    "keys_intersect_all": "SELECT o_custkey FROM orders WHERE "
                          "o_orderkey < 3000 INTERSECT ALL SELECT "
                          "c_custkey FROM customer WHERE c_nationkey < 5",
    "keys_except": "SELECT c_nationkey, c_mktsegment FROM customer EXCEPT "
                   "SELECT s_nationkey, 'BUILDING' FROM supplier",
    "union_order_limit": "SELECT n_regionkey AS k FROM nation UNION "
                         "SELECT r_regionkey FROM region "
                         "ORDER BY k DESC LIMIT 3",
    "rollup": "SELECT l_returnflag, l_linestatus, sum(l_quantity), "
              "count(*) FROM lineitem "
              "GROUP BY ROLLUP (l_returnflag, l_linestatus)",
    "cube": "SELECT l_returnflag, l_linestatus, sum(l_extendedprice) "
            "FROM lineitem GROUP BY CUBE (l_returnflag, l_linestatus)",
    "grouping_sets": "SELECT n_regionkey, n_nationkey % 3 AS m, count(*) "
                     "FROM nation GROUP BY GROUPING SETS "
                     "((n_regionkey), (n_nationkey % 3), ())",
    # NULL grouping keys beside the rollup's own NULLs
    "rollup_null_keys": "SELECT x, s, count(*), sum(d) FROM "
                        f"({_L}) v GROUP BY ROLLUP (x, s)",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_sql_rows_equal_reference(sessions, name):
    reference, port = sessions
    want = reference.execute(SQL[name]).rows
    got = port.execute(SQL[name]).rows
    assert repr(got) == repr(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float):
                assert np.float64(a).tobytes() == np.float64(b).tobytes()
