"""Semi, anti and mark joins on the port against the reference.

``ops/join.join_mark`` (the residual expansion) against the reference's
on seeded batches, with and without a dense key domain, and with a pair
capacity too small (the overflow the executor grows from). Then SQL
through both Sessions at tpch.tiny: EXISTS and NOT EXISTS (semi and anti
joins), IN and null-aware NOT IN with and without a NULL in the
subquery, a correlated residual whose expansion must grow, a disjunctive
EXISTS (a mark join), and dense-domain against sparse-key (hash, K3's
plain version) builds. The strategies each join ran and the executor
counters both packages keep (`join_domain_fallbacks`,
`join_expansion_retries`, `join_fallbacks`) are equal too.

Tolerance: none. Marks, totals and rows equal the reference's exactly."""

import numpy as np
import pytest
import torch

import trino_tpu.ir as jir
import trino_tpu.types as jtypes
import trino_tpu_torch.ir as tir
import trino_tpu_torch.types as ttypes
from trino_tpu.batch import batch_from_numpy as jax_batch
from trino_tpu.catalog import Catalog as JaxCatalog
from trino_tpu.connectors.tpch.connector import TpchConnector
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu.ops import join as jjoin
from trino_tpu_torch.batch import batch_from_numpy as torch_batch
from trino_tpu_torch.catalog import catalog_from_tables
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.ops import join as tjoin

# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

COUNTERS = ("join_domain_fallbacks", "join_expansion_retries",
            "join_fallbacks")


def _residual(ir, types):
    """probe column 1 <> build column 1 (the pair batch: probe ++ build,
    two columns each): TPC-H q21's shape."""
    return ir.Compare("<>", ir.ColumnRef(1, types.BIGINT),
                      ir.ColumnRef(3, types.BIGINT), types.BOOLEAN)


@pytest.mark.parametrize("domain", [None, 64])
@pytest.mark.parametrize("cap", [1024, 65536])
def test_join_mark_equals_reference(domain, cap):
    rng = np.random.default_rng(cap + (domain or 0))
    probe = [rng.integers(0, 60, 900), rng.integers(0, 4, 900)]
    build = [rng.integers(0, 60, 700), rng.integers(0, 4, 700)]
    pv = [rng.random(900) > 0.1, rng.random(900) > 0.1]
    bv = [rng.random(700) > 0.1, rng.random(700) > 0.1]
    want = jjoin.join_mark(jax_batch(probe, valids=pv),
                           jax_batch(build, valids=bv), (0,), (0,),
                           _residual(jir, jtypes), cap, domain)
    got = tjoin.join_mark(torch_batch(probe, valids=pv, device="cpu"),
                          torch_batch(build, valids=bv, device="cpu"),
                          (0,), (0,), _residual(tir, ttypes), cap, domain)
    mark, total, oob = (np.asarray(x) for x in want)
    assert int(got[1]) == int(total) and int(got[2]) == int(oob)
    # at 1024 pairs the expansion overflowed: the executor grows and
    # retries, and the marks it discards agree all the same
    assert (int(total) > cap) == (cap == 1024)
    assert np.array_equal(got[0].numpy(), mark)


def test_join_mark_without_residual_is_membership():
    rng = np.random.default_rng(4)
    probe = torch_batch([rng.integers(0, 50, 300)], device="cpu")
    build = torch_batch([rng.integers(0, 50, 200)], device="cpu")
    mark, total, _ = tjoin.join_mark(probe, build, (0,), (0,), None, 65536)
    semi, _ = tjoin.join_unique_build(probe, build, (0,), (0,), "semi")
    assert int(total) <= 65536
    assert torch.equal(mark & probe.live, semi.live)


def _executors(hash_setting):
    from trino_tpu.catalog import Catalog as JaxCatalog_
    from trino_tpu.exec.executor import Executor as JaxExecutor
    from trino_tpu_torch.catalog import Catalog
    from trino_tpu_torch.exec.executor import Executor
    out = (JaxExecutor(JaxCatalog_()), Executor(Catalog(), "cpu"))
    for ex in out:
        ex.enable_pallas_hash = hash_setting
    return out


def _join_node(logical, kind, domain, null_aware, residual):
    return logical.JoinNode(kind, None, None, (0,), (0,), residual, False,
                            (), null_aware=null_aware,
                            build_key_domain=domain)


# (kind, domain, null_aware, NULL in the build keys, residual, K3 on)
MEMBERSHIP = {
    "semi_dense": ("semi", 64, False, False, False, "false"),
    "anti_dense": ("anti", 64, False, False, False, "false"),
    "semi_dense_stale_domain": ("semi", 16, False, False, False, "false"),
    "semi_sorted": ("semi", None, False, False, False, "false"),
    "anti_hash": ("anti", None, False, False, False, "true"),
    "semi_hash": ("semi", None, False, False, False, "true"),
    "not_in_without_null": ("anti", None, True, False, False, "false"),
    "not_in_with_null": ("anti", None, True, True, False, "false"),
    "not_in_dense_without_null": ("anti", 64, True, False, False, "false"),
    "semi_residual": ("semi", 64, False, False, True, "false"),
    "anti_residual": ("anti", None, False, False, True, "false"),
    "mark_dense": ("mark", 64, False, False, False, "false"),
    "mark_sorted": ("mark", None, False, False, False, "false"),
    "mark_residual": ("mark", 64, False, False, True, "false"),
}


@pytest.mark.parametrize("name", sorted(MEMBERSHIP))
def test_membership_join_equals_reference(name):
    """The executor's semi/anti/mark routing (dynamic filter, null-aware
    NOT IN short-circuit, dense LUT with its domain check, hash table,
    sorted build, residual expansion) on seeded batches: the same rows,
    mark column, strategy and counters as the reference's."""
    from trino_tpu.planner import logical as jlogical
    from trino_tpu_torch.planner import logical as tlogical
    kind, domain, null_aware, build_null, residual, hash_on = \
        MEMBERSHIP[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    probe = [rng.integers(0, 60, 900), rng.integers(0, 4, 900)]
    build = [rng.integers(0, 60, 300), rng.integers(0, 4, 300)]
    pv = [rng.random(900) > 0.05, np.ones(900, bool)]
    bv = [np.ones(300, bool), np.ones(300, bool)]
    if build_null:
        bv[0][17] = False
    outs = []
    for ex, logical, ir, types, make in (
            (*_executors(hash_on)[:1], jlogical, jir, jtypes,
             lambda a, v: jax_batch(a, valids=v)),
            (*_executors(hash_on)[1:], tlogical, tir, ttypes,
             lambda a, v: torch_batch(a, valids=v, device="cpu"))):
        node = _join_node(logical, kind, domain, null_aware,
                          _residual(ir, types) if residual else None)
        with ex.no_decisions():
            out = ex._run_join_inner(node, make(probe, pv), make(build, bv))
        stats = {c: getattr(ex.stats, c) for c in COUNTERS}
        outs.append((np.asarray(out.live),
                     [np.asarray(c.data) for c in out.columns],
                     [np.asarray(c.valid) for c in out.columns],
                     stats, ex.strategy_decisions.get("JoinNode")))
    (wl, wd, wv, ws, wst), (gl, gd, gv, gs, gst) = outs
    assert np.array_equal(gl, wl)
    assert len(gd) == len(wd)
    for g, w, g_ok, w_ok, live in zip(gd, wd, gv, wv, [wl] * len(wd)):
        assert np.array_equal(g_ok & live, w_ok & live)
        assert np.array_equal(np.where(live, g, 0), np.where(live, w, 0))
    assert gs == ws and gst == wst
    if build_null:
        assert not gl.any()


TPCH_TABLES = ["region", "nation", "supplier", "customer", "part",
               "partsupp", "orders", "lineitem"]


@pytest.fixture(scope="module")
def sessions():
    conn = TpchConnector()
    tables = {t: conn.get_table("tiny", t) for t in TPCH_TABLES}
    cat = JaxCatalog()
    cat.register("tpch", conn)
    out = (JaxSession(cat, default_schema="tiny"),
           Session(catalog_from_tables(tables), default_schema="tiny",
                   device="cpu"))
    # K3 on in both packages (the reference interprets it on the CPU), so
    # sparse-key builds take the hash table on both sides
    for s in out:
        s.execute("SET SESSION enable_pallas_hash = 'true'")
    return out


SQL = {
    "exists_dense": "SELECT o_orderpriority, count(*) FROM orders WHERE "
                    "EXISTS (SELECT * FROM lineitem WHERE l_orderkey = "
                    "o_orderkey AND l_commitdate < l_receiptdate) "
                    "GROUP BY o_orderpriority ORDER BY o_orderpriority",
    "not_exists_dense": "SELECT count(*) FROM customer WHERE NOT EXISTS "
                        "(SELECT * FROM orders WHERE o_custkey = "
                        "c_custkey)",
    "exists_sparse_keys": "SELECT count(*), sum(o_totalprice) FROM orders "
                          "WHERE EXISTS (SELECT * FROM customer WHERE "
                          "c_acctbal = o_totalprice)",
    "not_exists_sparse_keys": "SELECT count(*) FROM part WHERE NOT EXISTS "
                              "(SELECT * FROM supplier WHERE s_acctbal = "
                              "p_retailprice)",
    # IN and NOT IN fold to value lists (the subquery is uncorrelated);
    # NOT IN with a NULL in the subquery passes no row
    "in_subquery": "SELECT count(*), sum(c_acctbal) FROM customer WHERE "
                   "c_custkey IN (SELECT o_custkey FROM orders WHERE "
                   "o_totalprice > 300000)",
    "not_in": "SELECT count(*) FROM customer WHERE c_custkey NOT IN "
              "(SELECT o_custkey FROM orders WHERE o_totalprice > 200000)",
    "not_in_with_null": "SELECT count(*) FROM customer WHERE c_custkey "
                        "NOT IN (SELECT CASE WHEN o_orderkey % 7 = 0 THEN "
                        "NULL ELSE o_custkey END FROM orders)",
    "residual": "SELECT count(*) FROM lineitem l1 WHERE EXISTS (SELECT * "
                "FROM lineitem l2 WHERE l2.l_orderkey = l1.l_orderkey AND "
                "l2.l_suppkey <> l1.l_suppkey) AND NOT EXISTS (SELECT * "
                "FROM lineitem l3 WHERE l3.l_orderkey = l1.l_orderkey AND "
                "l3.l_suppkey <> l1.l_suppkey AND l3.l_receiptdate > "
                "l3.l_commitdate)",
    # ~30 pairs per probe row: the expansion grows past probe capacity
    "residual_grows": "SELECT count(*) FROM lineitem l1 WHERE EXISTS "
                      "(SELECT * FROM lineitem l2 WHERE l2.l_partkey = "
                      "l1.l_partkey AND l2.l_orderkey <> l1.l_orderkey AND "
                      "l2.l_quantity > l1.l_quantity)",
    "mark_or_exists": "SELECT count(*) FROM customer WHERE c_acctbal > "
                      "9000 OR EXISTS (SELECT * FROM orders WHERE "
                      "o_custkey = c_custkey AND o_totalprice > 400000)",
    "mark_residual": "SELECT count(*) FROM customer WHERE c_acctbal < 0 OR "
                     "NOT EXISTS (SELECT * FROM orders WHERE o_custkey = "
                     "c_custkey AND o_totalprice > c_acctbal * 40)",
    "semi_multi_key": "SELECT count(*) FROM partsupp WHERE EXISTS (SELECT "
                      "* FROM lineitem WHERE l_partkey = ps_partkey AND "
                      "l_suppkey = ps_suppkey AND l_quantity > 45)",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_sql_rows_equal_reference(sessions, name):
    reference, port = sessions
    before = [{c: getattr(s.executor.stats, c) for c in COUNTERS}
              for s in sessions]
    want = reference.execute(SQL[name]).rows
    got = port.execute(SQL[name]).rows
    assert repr(got) == repr(want)
    moved = [{c: getattr(s.executor.stats, c) - b[c] for c in COUNTERS}
             for s, b in zip(sessions, before)]
    assert moved[1] == moved[0]
    assert port.executor.strategy_decisions.get("JoinNode") == \
        reference.executor.strategy_decisions.get("JoinNode")
    if name == "residual_grows":
        assert moved[1]["join_expansion_retries"] > 0
    if name.endswith("sparse_keys"):
        assert port.executor.strategy_decisions["JoinNode"] == \
            "hybrid-hash"
