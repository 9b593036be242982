"""Window functions on the port against the reference.

``trino_tpu_torch.ops.window.window_compute`` against
``trino_tpu.ops.window.window_compute`` on seeded batches: every function
(row_number, rank, dense_rank, ntile, lead, lag, first_value, last_value,
count, count(*), sum, min, max) over every frame (partition,
range_running, rows_running, rows_bounded, range_bounded), with NULL
partition and order keys, ties, dead rows and DOUBLE sums long enough
for the reference's blocked cumsum order to matter. Then window SQL
through both Sessions at tpch.tiny.

Tolerance: none. Every output column equals the reference's bit for bit
(data and validity, live rows); rows equal in order."""

import numpy as np
import pytest
import torch

from trino_tpu.batch import batch_from_numpy as jax_batch
from trino_tpu.batch import batch_to_numpy as jax_to_numpy
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu.ops import window as jwin
from trino_tpu_torch.batch import batch_from_numpy as torch_batch
from trino_tpu_torch.batch import batch_to_numpy as torch_to_numpy
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.ops import window as twin

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

N = 5000          # rows (capacity 5120: the last cumsum block is padded)

# columns of the seeded batch
P_INT, P_CODE, O_INT, O_DBL, V_INT, V_DBL, V_I32 = range(7)


def _arrays(seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.integers(0, 7, N),                       # partition key
              rng.integers(0, 4, N).astype(np.int32),      # dict codes
              rng.integers(-20, 60, N),                    # order key, ties
              rng.standard_normal(N).round(1),             # double order
              rng.integers(-10 ** 6, 10 ** 6, N),          # int values
              rng.standard_normal(N) * rng.integers(1, 10 ** 6, N),
              rng.integers(-100, 100, N).astype(np.int32)]
    valids = [rng.random(N) > 0.1 for _ in arrays]
    dead = rng.random(N) < 0.05
    return arrays, valids, dead


def _run(seed, partition, order, specs):
    arrays, valids, dead = _arrays(seed)
    jb = jax_batch(arrays, valids=valids)
    pad = np.zeros(jb.capacity, dtype=bool)
    pad[:N] = dead
    jb = jb.with_live(jb.live & ~pad)
    tb = torch_batch(arrays, valids=valids, device="cpu")
    tb = tb.with_live(tb.live & ~torch.from_numpy(pad))
    want = jax_to_numpy(jwin.window_compute(
        jb, partition, order, tuple(jwin.WinSpec(*s) for s in specs)))
    got = torch_to_numpy(twin.window_compute(
        tb, partition, order, tuple(twin.WinSpec(*s) for s in specs)))
    for j in range(len(arrays), len(arrays) + len(specs)):
        g, w = got[0][j], want[0][j]
        assert g.dtype == w.dtype, specs[j - len(arrays)]
        assert np.array_equal(got[1][j], want[1][j]), specs[j - len(arrays)]
        assert g.tobytes() == w.tobytes(), specs[j - len(arrays)]


RANKING = [("row_number",), ("rank",), ("dense_rank",),
           ("ntile", None, "partition", 3), ("ntile", None, "partition", 7)]
VALUES = [("lead", V_INT), ("lag", V_DBL, "partition", 2),
          ("lead", V_I32, "partition", 3, -1), ("lag", V_INT, "partition",
                                                 1, 42),
          ("first_value", V_DBL), ("last_value", V_INT, "partition"),
          ("last_value", V_DBL, "range_running"),
          ("last_value", V_I32, "rows_running")]


def _aggs(frame):
    return [("sum", V_INT, frame), ("sum", V_DBL, frame),
            ("sum", V_I32, frame), ("count", V_DBL, frame),
            ("count_star", None, frame), ("min", V_INT, frame),
            ("max", V_DBL, frame), ("min", V_I32, frame)]


ORDER = ((O_INT, True, False), (O_DBL, False, True))
CASES = {
    "ranking": ((P_INT, P_CODE), ORDER, RANKING),
    "ranking_desc_nulls_first": ((P_CODE,), ((O_INT, False, True),),
                                 RANKING),
    "ranking_no_partition": ((), ((O_INT, True, True),), RANKING),
    "values": ((P_INT,), ORDER, VALUES),
    "values_no_order": ((P_CODE,), (), VALUES),
    "aggs_partition": ((P_INT,), ORDER, _aggs("partition")),
    "aggs_no_keys": ((), (), _aggs("partition")),
    "aggs_range_running": ((P_INT, P_CODE), ((O_INT, True, False),),
                           _aggs("range_running")),
    "aggs_rows_running": ((P_CODE,), ORDER, _aggs("rows_running")),
    "aggs_rows_bounded": ((P_INT,), ORDER, _aggs("rows_bounded:3:1")),
    "aggs_rows_unbounded_preceding": (
        (P_INT,), ORDER, _aggs(f"rows_bounded:{(1 << 31) - 1}:2")),
    "aggs_range_bounded": ((P_INT,), ((O_INT, True, False),),
                           _aggs("range_bounded:5:2")),
    "aggs_range_bounded_desc_nulls_first": (
        (P_CODE,), ((O_INT, False, True),), _aggs("range_bounded:0:4")),
    "aggs_range_unbounded_preceding": (
        (P_INT,), ((O_INT, True, True),),
        _aggs(f"range_bounded:{1 << 62}:3")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_compute_equals_reference(name):
    partition, order, specs = CASES[name]
    _run(sum(map(ord, name)), partition, order, specs)


def test_window_spec_rejects_unknown_frame():
    with pytest.raises(ValueError):
        twin.WinSpec("sum", 0, "groups_running")


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


SQL = {
    "row_number": "SELECT n_name, n_regionkey, row_number() OVER "
                  "(PARTITION BY n_regionkey ORDER BY n_name) AS rn "
                  "FROM nation ORDER BY n_regionkey, rn",
    "rank_dense_rank": "SELECT o_custkey, o_orderpriority, rank() OVER "
                       "(PARTITION BY o_orderpriority ORDER BY o_custkey) "
                       "AS r, dense_rank() OVER (PARTITION BY "
                       "o_orderpriority ORDER BY o_custkey) AS dr "
                       "FROM orders ORDER BY o_orderpriority, o_custkey, r",
    "running_sum": "SELECT o_orderkey, o_custkey, sum(o_totalprice) OVER "
                   "(PARTITION BY o_custkey ORDER BY o_orderkey) AS rt "
                   "FROM orders ORDER BY o_custkey, o_orderkey",
    "double_running_sum": "SELECT o_orderkey, sum(CAST(o_totalprice AS "
                          "double)) OVER (ORDER BY o_orderkey ROWS "
                          "BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) "
                          "FROM orders ORDER BY o_orderkey",
    "double_partition_sum": "SELECT l_orderkey, l_linenumber, "
                            "sum(CAST(l_extendedprice AS double) * "
                            "l_discount) OVER (PARTITION BY l_suppkey) "
                            "FROM lineitem ORDER BY l_orderkey, "
                            "l_linenumber",
    "partition_total": "SELECT l_orderkey, l_linenumber, sum(l_quantity) "
                       "OVER (PARTITION BY l_orderkey) AS t, count(*) OVER "
                       "(PARTITION BY l_orderkey) AS c FROM lineitem "
                       "ORDER BY l_orderkey, l_linenumber",
    "rows_frame": "SELECT o_orderkey, sum(o_totalprice) OVER (ORDER BY "
                  "o_orderkey ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING), "
                  "count(o_comment) OVER (PARTITION BY o_custkey ORDER BY "
                  "o_orderdate RANGE BETWEEN 30 PRECEDING AND CURRENT "
                  "ROW), min(o_totalprice) OVER (ORDER BY o_orderkey ROWS "
                  "BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW), "
                  "max(CAST(o_totalprice AS double)) OVER (PARTITION BY "
                  "o_orderstatus) FROM orders ORDER BY o_orderkey",
    "lead_lag": "SELECT n_nationkey, lead(n_name) OVER (ORDER BY "
                "n_nationkey), lag(n_nationkey, 2, -1) OVER (ORDER BY "
                "n_nationkey) FROM nation ORDER BY n_nationkey",
    "first_last_ntile": "SELECT n_name, first_value(n_name) OVER "
                        "(PARTITION BY n_regionkey ORDER BY n_name), "
                        "last_value(n_nationkey) OVER (PARTITION BY "
                        "n_regionkey ORDER BY n_name), ntile(3) OVER "
                        "(ORDER BY n_name) FROM nation ORDER BY n_name",
    "window_avg_of_sum": "SELECT o_orderpriority, o_orderstatus, "
                         "sum(o_totalprice) AS s, avg(sum(o_totalprice)) "
                         "OVER (PARTITION BY o_orderpriority) AS a "
                         "FROM orders GROUP BY o_orderpriority, "
                         "o_orderstatus ORDER BY o_orderpriority, "
                         "o_orderstatus",
    "rank_over_nullable_keys": "SELECT c_nationkey, rank() OVER (PARTITION "
                               "BY CASE WHEN c_nationkey < 5 THEN NULL "
                               "ELSE c_nationkey % 4 END ORDER BY CASE WHEN "
                               "c_acctbal < 0 THEN NULL ELSE c_acctbal END "
                               "NULLS FIRST) AS r, c_custkey FROM customer "
                               "ORDER BY c_custkey",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_sql_rows_equal_reference(sessions, name):
    reference, port = sessions
    want = reference.execute(SQL[name]).rows
    got = port.execute(SQL[name]).rows
    assert repr(got) == repr(want)
