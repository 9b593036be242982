"""UNNEST on the port against the reference.

The shapes of tests/test_unnest.py (literal arrays, ordinality, a lateral
cross product, aggregation and filters over elements, varchar elements,
the empty array) and NULL elements through both Sessions at tpch.tiny;
NULL arrays (which SQL here cannot spell) through both executors'
UnnestNode over a VALUES child.

Tolerance: none. Rows equal the reference's exactly, in order."""

import numpy as np
import pytest
import torch

from trino_tpu.batch import batch_to_numpy as jax_to_numpy
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch.batch import batch_to_numpy as torch_to_numpy
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.exec.session import Session

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sessions():
    conn = TpchConnector()
    tables = {t: conn.get_table("tiny", t) for t in ("nation", "region")}
    cat = JaxCatalog()
    cat.register("tpch", conn)
    return (JaxSession(cat, default_schema="tiny"),
            Session(catalog_from_tables(tables), default_schema="tiny",
                    device="cpu"))


SQL = {
    "literal": "SELECT x FROM UNNEST(ARRAY[3, 1, 2]) AS t(x)",
    "literal_ordered": "SELECT x FROM UNNEST(ARRAY[3, 1, 2]) AS t(x) "
                       "ORDER BY x",
    "ordinality": "SELECT x, o FROM UNNEST(ARRAY[30, 10, 20]) "
                  "WITH ORDINALITY AS t(x, o)",
    "lateral": "SELECT n_name, x FROM nation, UNNEST(ARRAY['a', 'b']) "
               "AS u(x) WHERE n_nationkey < 2 ORDER BY n_name, x",
    "lateral_ordinality_null_elements": "SELECT n_nationkey, x, o FROM "
                                        "nation, UNNEST(ARRAY['a', NULL, "
                                        "'c']) WITH ORDINALITY AS u(x, o) "
                                        "WHERE n_nationkey < 3",
    "aggregation": "SELECT count(*), sum(x), min(x) FROM "
                   "UNNEST(ARRAY[5, 10, 15, 20]) AS t(x)",
    "varchar": "SELECT upper(x) FROM UNNEST(ARRAY['pear', 'fig']) AS t(x) "
               "ORDER BY x",
    "filter": "SELECT x FROM UNNEST(ARRAY[1, 2, 3, 4, 5]) AS t(x) "
              "WHERE x > 3 ORDER BY x",
    "null_elements": "SELECT x FROM UNNEST(ARRAY[1, NULL, 3]) AS t(x)",
    "decimal_elements": "SELECT x FROM UNNEST(ARRAY[2.5, 1.25]) AS t(x)",
    "empty": "SELECT count(*) FROM UNNEST(ARRAY[]) AS t(x)",
    "join_after_unnest": "SELECT r_name, x FROM region, UNNEST(ARRAY[0, "
                         "2, 4]) AS u(x) WHERE r_regionkey = x "
                         "ORDER BY r_name",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_sql_rows_equal_reference(sessions, name):
    reference, port = sessions
    want = reference.execute(SQL[name]).rows
    assert repr(port.execute(SQL[name]).rows) == repr(want)


@pytest.mark.parametrize("ordinality", [False, True])
def test_null_arrays_give_no_rows(ordinality):
    """Rows whose array is NULL expand to nothing; the others keep their
    own elements (a NULL element included), in row order."""
    from trino_tpu.exec.executor import Executor as JaxExecutor
    from trino_tpu.planner import logical as jlogical
    from trino_tpu.types import BIGINT as JBIGINT
    from trino_tpu_torch.catalog import Catalog
    from trino_tpu_torch.exec.executor import Executor
    from trino_tpu_torch.planner import logical as tlogical
    from trino_tpu_torch.types import BIGINT
    ids = np.array([0, 1, 2, 0, 1], dtype=np.int32)
    ok = np.array([True, False, True, True, True])
    tag = np.arange(5, dtype=np.int64)
    pool = ((7, None, 9), (4,), ())
    got = []
    for ex, logical, bigint, to_numpy in (
            (JaxExecutor(JaxCatalog()), jlogical, JBIGINT, jax_to_numpy),
            (Executor(Catalog(), "cpu"), tlogical, BIGINT,
             torch_to_numpy)):
        child = logical.ValuesNode((ids, tag), (ok, np.ones(5, bool)), 5,
                                   (), ())
        node = logical.UnnestNode(child, 0, pool, "x", bigint, None,
                                  ordinality, ())
        got.append(to_numpy(ex.run(node)))
    (wa, wv), (ga, gv) = got
    assert len(ga) == len(wa) == 3 + ordinality
    for g, w, g_ok, w_ok in zip(ga, wa, gv, wv):
        assert np.array_equal(g_ok, w_ok)
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert list(ga[1]) == [0, 0, 0, 3, 3, 3, 4]
