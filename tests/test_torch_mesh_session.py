"""SQL on the port's mesh (trino_tpu_torch/parallel/dist_executor.py)
against the reference, on the CPU.

Against the reference's MeshExecutor on eight virtual devices, bit for
bit and row for row: the shapes of tests/test_mesh_dynamic_filter.py
(the partitioned join with the batched dynamic filter on and off, the
pruned-row counters, the EXPLAIN line, a six-shard mesh that pads an odd
capacity) and DOUBLE sums whose last bit depends on the mesh (GSPMD sums
a row-sharded batch shard by shard, then across shards in order: the
port's mesh gives the reference mesh's bits, not the single-device
Session's). Against the reference's single-device Session, as rows: the
22 TPC-H queries on the port's mesh under the partitioned distribution,
a TPC-DS star (the mesh degrades it to the ladder) and TPC-DS q77 (as
multisets, the dynamic filter pruning rows). q77 and the long lists are
not run on the reference's mesh: its virtual-device rendezvous can fail
under load (tests/conftest.py)."""

from collections import Counter

import pytest
import torch

from test_mesh_dynamic_filter import JOIN_AGG, PROBE_ROWS, SELECTIVE
from tpcds_queries import QUERIES as TPCDS
from tpch_full import QUERIES as TPCH
from trino_tpu.exec.session import Session as JaxSession
from trino_tpu.parallel.dist_executor import MeshExecutor as JaxMesh
from trino_tpu.parallel.mesh import make_mesh as jax_make_mesh
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.parallel.dist_executor import MeshExecutor
from trino_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

# fact 2 of the mesh slice: the reference's mesh sums these apart from
# its single-device Session, in the last bit
FACT2 = {
    "SELECT sum(CAST(l_extendedprice AS double) / 7) FROM lineitem":
        ([(307026904.03571427,)], [(307026904.0357143,)]),
}
GROUPED = ("SELECT l_returnflag, sum(CAST(l_extendedprice AS double) * 1.1)"
           " FROM lineitem GROUP BY l_returnflag ORDER BY l_returnflag")
D = "CAST(l_extendedprice AS double) / 7"
DOUBLE_SQL = [
    GROUPED,
    f"SELECT stddev({D}), variance({D}), avg({D}) FROM lineitem",
    f"SELECT sum({D}) FROM lineitem WHERE l_quantity > 10",
    f"SELECT l_returnflag, l_linestatus, sum({D}), avg({D}) FROM lineitem "
    "WHERE l_shipdate <= DATE '1998-09-01' "
    "GROUP BY l_returnflag, l_linestatus ORDER BY 1, 2",
    f"SELECT l_suppkey, sum({D}) FROM lineitem GROUP BY l_suppkey "
    "ORDER BY l_suppkey",
    f"SELECT o_orderpriority, sum({D}) FROM lineitem, orders "
    "WHERE l_orderkey = o_orderkey GROUP BY o_orderpriority "
    "ORDER BY o_orderpriority",
    f"SELECT sum({D}) FROM lineitem, orders WHERE l_orderkey = o_orderkey "
    "AND o_totalprice > 100000",
    "SELECT c_mktsegment, sum(CAST(c_acctbal AS double) * 1.1) "
    "FROM customer GROUP BY c_mktsegment ORDER BY 1",
]


def _jax_mesh(n=8, partitioned=True, **props):
    s = JaxSession(default_schema="tiny")
    s.executor = JaxMesh(s.catalog, jax_make_mesh(n))
    return _setup(s, partitioned, props)


def _port_mesh(n=8, partitioned=True, **props):
    s = Session(default_schema="tiny", device="cpu")
    s.executor = MeshExecutor(s.catalog, make_mesh(n, "cpu"))
    return _setup(s, partitioned, props)


def _setup(s, partitioned, props):
    if partitioned:
        s.execute("SET SESSION join_distribution_type = 'partitioned'")
        s.execute("SET SESSION enable_pallas_hash = true")
    for k, v in props.items():
        s.properties[k] = v
    return s


@pytest.fixture(scope="module")
def single():
    return JaxSession(default_schema="tiny")


# one mesh session a configuration and side for the module: each new
# reference MeshExecutor compiles its stage programs anew, and that load
# is what the reference's virtual-device runtime is fragile under
@pytest.fixture(scope="module")
def meshes():
    return {(side, part): make(partitioned=part)
            for side, make in (("jax", _jax_mesh), ("port", _port_mesh))
            for part in (False, True)}


def _deltas(s, run):
    """`run()`'s result and the mesh counters it moved on session `s`."""
    st = s.executor.stats
    before = (st.mesh_partitioned_joins, st.dynamic_filter_rows_pruned)
    out = run()
    return out, (st.mesh_partitioned_joins - before[0],
                 st.dynamic_filter_rows_pruned - before[1])


def _bits(rows):
    return [tuple(float(v).hex() if isinstance(v, float) else v for v in r)
            for r in rows]


def test_partitioned_join_equals_reference_mesh(single, meshes):
    js, ts = meshes["jax", True], meshes["port", True]
    for sql in (JOIN_AGG, PROBE_ROWS):
        want, jd = _deltas(js, lambda: js.execute(sql).rows)
        got, td = _deltas(ts, lambda: ts.execute(sql).rows)
        assert got == want == single.execute(sql).rows
        assert td[0] == jd[0] >= 1
        assert ts.executor.strategy_decisions["JoinDistribution"] == \
            "partitioned"


@pytest.mark.parametrize("filtering", [True, False])
def test_probe_rows_and_pruned_counts_equal_reference(single, meshes,
                                                      filtering):
    js, ts = meshes["jax", True], meshes["port", True]
    want = single.execute(PROBE_ROWS).rows
    out = {}
    for side, s in (("jax", js), ("port", ts)):
        s.properties["mesh_dynamic_filtering"] = filtering
        try:
            out[side] = _deltas(s, lambda: s.execute(PROBE_ROWS).rows)
        finally:
            s.properties["mesh_dynamic_filtering"] = True
    assert out["port"][0] == out["jax"][0] == want
    pruned = out["port"][1][1]
    assert pruned == out["jax"][1][1]
    assert (pruned > 0) == filtering


def test_selective_join_moves_the_pruned_counters(single, meshes):
    from trino_tpu_torch.metrics import DYNAMIC_FILTER_ROWS_PRUNED
    before = DYNAMIC_FILTER_ROWS_PRUNED.value()
    js, ts = meshes["jax", True], meshes["port", True]
    want, jd = _deltas(js, lambda: js.execute(SELECTIVE).rows)
    got, td = _deltas(ts, lambda: ts.execute(SELECTIVE).rows)
    assert got == want == single.execute(SELECTIVE).rows
    assert td[1] == jd[1] > 0
    assert DYNAMIC_FILTER_ROWS_PRUNED.value() - before >= td[1]


def test_explain_equals_reference_mesh(meshes):
    js, ts = meshes["jax", True], meshes["port", True]
    for s in (js, ts):
        s.execute(JOIN_AGG)
    want = [r[0] for r in js.execute("EXPLAIN " + JOIN_AGG).rows]
    got = [r[0] for r in ts.execute("EXPLAIN " + JOIN_AGG).rows]
    assert "join distribution: partitioned" in "\n".join(got)
    assert got == want


def test_six_shard_mesh_pads_odd_capacity():
    js, ts = _jax_mesh(6, False), _port_mesh(6, False)
    sql = "SELECT count(*) FROM lineitem"
    assert ts.execute(sql).rows == js.execute(sql).rows
    (tb,) = ts.executor._scan_cache.values()
    (jb,) = js.executor._scan_cache.values()
    assert tb.capacity % 6 == 0 and tb.capacity == jb.capacity
    assert [s.capacity for s in tb.shards] == [tb.capacity // 6] * 6
    assert sum(int(s.live.sum()) for s in tb.shards) == int(jb.live.sum())
    js, ts = _jax_mesh(6), _port_mesh(6)
    assert ts.execute(PROBE_ROWS).rows == js.execute(PROBE_ROWS).rows
    assert ts.executor.stats.mesh_partitioned_joins == 1


def test_fact2_doubles_take_the_reference_mesh_bits(single, meshes):
    ts = meshes["port", False]
    for sql, (single_rows, mesh_rows) in FACT2.items():
        assert single.execute(sql).rows == single_rows
        assert ts.execute(sql).rows == mesh_rows
    got = ts.execute(GROUPED).rows
    assert [r[1] for r in got if r[0] == "A"] == [596823852.669]
    assert [r[1] for r in single.execute(GROUPED).rows
            if r[0] == "A"] == [596823852.6690001]


@pytest.mark.parametrize("sql", DOUBLE_SQL)
@pytest.mark.parametrize("partitioned", [False, True])
def test_double_sums_equal_reference_mesh_bits(meshes, sql, partitioned):
    js, ts = meshes["jax", partitioned], meshes["port", partitioned]
    assert _bits(ts.execute(sql).rows) == _bits(js.execute(sql).rows)


@pytest.mark.parametrize("qnum", sorted(TPCH))
def test_tpch_on_port_mesh_equals_reference(single, meshes, qnum):
    sql = TPCH[qnum]
    assert meshes["port", True].execute(sql).rows == \
        single.execute(sql).rows


@pytest.fixture(scope="module")
def tpcds_single():
    return JaxSession(default_cat="tpcds", default_schema="tiny")


def _tpcds_port_mesh():
    s = Session(default_cat="tpcds", default_schema="tiny", device="cpu")
    s.executor = MeshExecutor(s.catalog, make_mesh(8, "cpu"))
    return s


def test_star_degrades_to_the_ladder_on_the_mesh(tpcds_single):
    ts = _tpcds_port_mesh()
    ts.execute("SET SESSION enable_multiway_join = true")
    sql = TPCDS[3]
    assert ts.execute(sql).rows == tpcds_single.execute(sql).rows
    assert ts.executor.stats.multijoin_degrades > 0
    assert ts.executor.stats.multijoin_fused_probes == 0


def test_q77_on_port_mesh_with_filtering_on(tpcds_single):
    ts = _tpcds_port_mesh()
    assert ts.executor.mesh_dynamic_filtering
    sql = TPCDS[77]
    got = ts.execute(sql).rows
    assert 0 < len(got) <= 100
    assert Counter(map(repr, got)) == \
        Counter(map(repr, tpcds_single.execute(sql).rows))
    assert ts.executor.stats.dynamic_filter_rows_pruned > 0


# the per-shard data plane: what runs on the shards' devices and what
# the all-gather brings to the first one
D_WIDE = ("SELECT {sel}, sum(l_quantity), min(l_discount), max(l_tax), "
          "count(*) FROM lineitem, orders WHERE l_orderkey = o_orderkey")
BROADCAST_SQL = [
    # the dense-LUT probe per shard keeps the scan's layout: the reference
    # sums the float over it shard by shard
    D_WIDE.format(sel=f"o_orderpriority, sum({D})") +
    " GROUP BY o_orderpriority ORDER BY 1",
    D_WIDE.format(sel=f"sum({D})") + " AND o_totalprice > 100000",
    f"SELECT sum({D}), sum(CAST(o_totalprice AS double) * 1.1), max(l_tax),"
    " count(*) FROM lineitem, orders WHERE l_orderkey = o_orderkey "
    "AND l_quantity > 5",
    # a selective join compacts: the reference sums over it as one array
    D_WIDE.format(sel=f"sum({D})") + " AND o_totalprice > 300000",
    D_WIDE.format(sel=f"o_orderpriority, sum({D})") +
    " AND o_totalprice > 250000 GROUP BY o_orderpriority ORDER BY 1",
]
# q3's one all-gather: its hash aggregate reads every row of the joins
Q3_GATHERS = 1


def _gathers(s, sql):
    g = s.executor.stats.mesh_gathers
    rows = s.execute(sql).rows
    return rows, s.executor.stats.mesh_gathers - g


@pytest.mark.parametrize("qnum", [1, 6])
def test_q1_q6_aggregate_on_the_shards_without_a_gather(single, meshes,
                                                        qnum):
    ts = meshes["port", True]
    rows, gathers = _gathers(ts, TPCH[qnum])
    assert rows == single.execute(TPCH[qnum]).rows
    assert gathers == 0
    scans = [b for b in ts.executor._scan_cache.values()
             if b.first.num_columns and b.capacity >= 60_000]
    assert scans, "lineitem's scan is not cached"
    for b in scans:
        assert b.sum_by_shard and b.n_shards == 8
        assert [s.capacity for s in b.shards] == [b.capacity // 8] * 8


def test_q3_gathers_once_for_its_hash_aggregate(single, meshes):
    ts = meshes["port", True]
    rows, gathers = _gathers(ts, TPCH[3])
    assert rows == single.execute(TPCH[3]).rows
    assert gathers == Q3_GATHERS
    assert ts.executor.stats.mesh_partitioned_joins >= 2


@pytest.mark.parametrize("sql", BROADCAST_SQL)
def test_broadcast_join_per_shard_equals_reference_mesh_bits(meshes, sql):
    js, ts = meshes["jax", False], meshes["port", False]
    want = _bits(js.execute(sql).rows)
    rows, gathers = _gathers(ts, sql)
    assert _bits(rows) == want
    assert ts.executor.strategy_decisions["JoinNode"] == "dense-lut"
    # the build is replicated (one gather); a compacted join's output is
    # gathered for the float sum
    assert 1 <= gathers <= 2


@pytest.mark.parametrize("n", [2, 6, 8])
def test_mesh_sizes_give_reference_mesh_rows_and_bits(n):
    """Meshes of 2, 6 (lineitem's capacity padded to a multiple of 48)
    and 8 shards: the reference mesh's rows and DOUBLE bits, the scans
    split into n equal blocks."""
    sqls = [next(iter(FACT2)), GROUPED, DOUBLE_SQL[6], BROADCAST_SQL[0],
            "SELECT l_returnflag, count(*), sum(l_quantity) FROM lineitem "
            "WHERE l_shipdate > DATE '1995-01-01' GROUP BY l_returnflag "
            "ORDER BY 1"]
    for partitioned in (False, True):
        js, ts = _jax_mesh(n, partitioned), _port_mesh(n, partitioned)
        for sql in sqls:
            assert _bits(ts.execute(sql).rows) == \
                _bits(js.execute(sql).rows), (n, partitioned, sql)
        for b in ts.executor._scan_cache.values():
            assert b.capacity % n == 0
            assert [s.capacity for s in b.shards] == [b.capacity // n] * n


def test_two_phase_dense_join_per_shard_equals_single_device(monkeypatch,
                                                             single):
    """The large-probe paths of the per-shard broadcast join (the dynamic
    filter's and the probe's compaction per shard, the two-phase dense
    probe with its compacted payload gathers), reached at tpch.tiny by
    lowering the port's size gates: the 8-shard mesh gives the
    reference's single-device rows (integer and decimal results, which
    the gates do not change), the slots restoring the global layout."""
    from trino_tpu_torch.exec import executor as ex_mod
    monkeypatch.setattr(ex_mod.Executor, "COMPACT_MIN_ROWS", 4096)
    monkeypatch.setattr(ex_mod, "SORT_SMALL_ROWS", 4096)
    sqls = [
        "SELECT l_orderkey, l_linenumber, o_totalprice, l_quantity "
        "FROM lineitem, orders WHERE l_orderkey = o_orderkey "
        "AND o_totalprice > 400000 ORDER BY l_orderkey, l_linenumber",
        "SELECT o_orderpriority, count(*), sum(l_quantity), "
        "sum(l_extendedprice) FROM lineitem, orders "
        "WHERE l_orderkey = o_orderkey AND o_orderkey < 3000 "
        "GROUP BY o_orderpriority ORDER BY 1",
        TPCH[3], TPCH[10]]
    ts = _port_mesh(8, False)
    for sql in sqls:
        c0 = ts.executor.stats.dynamic_filter_compactions
        assert ts.execute(sql).rows == single.execute(sql).rows, sql
        assert ts.executor.stats.dynamic_filter_compactions > c0, sql


@pytest.mark.parametrize("sql", [
    "SELECT l_orderkey, l_linenumber FROM lineitem WHERE l_quantity > 45 "
    "ORDER BY 1, 2 LIMIT 7",
    TPCH[3]])
def test_a_gathered_output_is_reserved_beside_its_shards(single, sql):
    """Every all-gather (a sort's input, q3's hash aggregate input and
    replicated builds) reserves its whole copy in the query's pool beside
    the shards, freed when the operator that gathered it returns: after
    each run the pool holds the nodes' outputs and nothing else."""
    from trino_tpu_torch.exec.memory import batch_bytes
    ts = _port_mesh(8, False)
    ex = ts.executor
    copies = []
    real_gather = ex.gather

    def gather(batch):
        before = ex.pool.reserved
        out = real_gather(batch)
        if out is not batch:
            copies.append((ex.pool.reserved - before, batch_bytes(out)))
        return out
    ex.gather = gather
    for _ in range(2):
        assert ts.execute(sql).rows == single.execute(sql).rows
        assert ex.pool.reserved == sum(ex._node_bytes.values()) + \
            ex._gathered_bytes
    assert copies and all(got == want for got, want in copies)
