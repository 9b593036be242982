"""K3's escape counters are read every run, never replayed from the
decision cache (ROADMAP Queue C 8).

On the card K3 inserts in parallel, so which rows escape a table differs
from run to run: a star's 4,096-key dimension at 8,192 slots escaped one
key in some runs and none in others (`micro.star_micro` at k = 5 on the
H100). The executor used to replay a statement's first escape verdict
from the decision cache; a later run whose table lost a key then fused
(or probed, or kept) it and answered wrong rows; the mesh's shard
join replayed its escapes the same way. Here the CPU's plain K3
is deterministic, so each test stands in a build whose escapes differ
between two runs of one statement: the first run's build is whole and
reports its verdict, the second loses a key and reports the escape, as
the kernel does. Every run must answer the rows of the JAX Session (or,
for the star, of the pairwise ladder and a numpy oracle), exactly."""

import numpy as np
import pytest
import torch

from trino_tpu.exec.session import Session as JaxSession
from trino_tpu_torch import e2e, micro
from trino_tpu_torch.catalog import Catalog
from trino_tpu_torch.exec.session import Session
from trino_tpu_torch.ops import hashtable as ht

torch.set_num_threads(1)


def _drop_key(tkey, d=None):
    """Empty the first occupied slot of table `d` (all of `tkey` when
    None): the key a parallel insert failed to place."""
    t = tkey if d is None else tkey[d]
    slot = int(torch.nonzero(t != ht.EMPTY_KEY)[0])
    t[slot] = ht.EMPTY_KEY


class _TwoRuns:
    """A build that counts its calls (one a run of the statement)."""

    def __init__(self, real):
        self.real, self.calls = real, 0

    def __call__(self, *args):
        self.calls += 1
        return self.real(*args)


def _star_oracle(t, k, dim_rows):
    f = t["fact"].columns
    m = np.ones(len(f[0]), bool)
    tot = f[k].copy()
    for i in range(k):
        key = f[i]
        ok = key < dim_rows
        m &= ok
        tot = tot + np.where(ok, t[f"dim{i}"].columns[1][
            np.minimum(key, dim_rows - 1)], 0)
    return int(tot[m].sum())


def test_star_fuses_no_dimension_whose_table_escaped_this_run(monkeypatch):
    k, fact_rows, dim_rows = 3, 1 << 12, 256
    t = micro._star_tables(k, fact_rows, dim_rows, 0.9)
    cat = Catalog()
    cat.register("bench", e2e.BenchConnector(t, "star"))
    s = Session(catalog=cat, default_cat="bench", default_schema="star",
                device="cpu")
    sql = micro.star_sql(k)
    s.execute("SET SESSION enable_multiway_join = 'false'")
    want = s.execute(sql).rows
    assert want == [(_star_oracle(t, k, dim_rows),)]
    wrap = _TwoRuns(ht.build_join_tables)

    def build(builds, keys_per_build, slots):
        tkey, src, dup, esc = wrap(builds, keys_per_build, slots)
        esc = esc.clone()
        if wrap.calls == 1:
            esc[0] = 1                  # whole tables; dimension 0 escaped
        elif wrap.calls == 2:
            for d in (1, 2):            # this run, 1 and 2 lost a key
                _drop_key(tkey, d)
                esc[d] = 1
        return tkey, src, dup, esc
    monkeypatch.setattr(ht, "build_join_tables", build)
    s.execute("SET SESSION enable_multiway_join = 'true'")
    first = s.execute(sql).rows
    assert s.executor.strategy_decisions["MultiJoinNode"] == \
        "multiway[k=2]"
    second = s.execute(sql).rows
    assert wrap.calls == 2
    assert s.executor.strategy_decisions["MultiJoinNode"] == "ladder"
    assert first == second == want


def test_hash_join_probes_no_table_that_escaped_this_run(monkeypatch):
    rng = np.random.default_rng(8)
    from trino_tpu_torch.batch import Field, Schema
    from trino_tpu_torch.connectors.tpch.datagen import TableData
    from trino_tpu_torch.types import BIGINT
    keys = rng.choice(1 << 40, 300, replace=False).astype(np.int64)
    fact_key = keys[rng.integers(0, 300, 5000)]
    tables = {
        "fact": TableData("fact", Schema.of(Field("f_key", BIGINT),
                                            Field("f_value", BIGINT)),
                          [fact_key, rng.integers(0, 1000, 5000)]),
        "dim": TableData("dim", Schema.of(Field("d_key", BIGINT),
                                          Field("d_attr", BIGINT)),
                         [keys, rng.integers(0, 1000, 300)],
                         primary_key=("d_key",))}
    cat = Catalog()
    cat.register("bench", e2e.BenchConnector(tables, "j"))
    s = Session(catalog=cat, default_cat="bench", default_schema="j",
                device="cpu")
    s.execute("SET SESSION enable_pallas_hash = 'true'")
    s.execute("SET SESSION merge_join = false")     # past the small shapes
    sql = ("SELECT sum(f_value + d_attr), count(*) FROM fact "
           "JOIN dim ON f_key = d_key")
    wrap = _TwoRuns(ht.build_join_table)

    def build(b, bk, slots):
        tkey, src, dup, esc = wrap(b, bk, slots)
        if wrap.calls == 2:
            _drop_key(tkey)
            esc = torch.ones_like(esc)
        return tkey, src, dup, esc
    monkeypatch.setattr(ht, "build_join_table", build)
    first = s.execute(sql).rows
    assert s.executor.strategy_decisions["JoinNode"] == "hybrid-hash"
    second = s.execute(sql).rows
    assert wrap.calls >= 2
    fv, fk = tables["fact"].columns[1], fact_key
    attr = dict(zip(keys.tolist(), tables["dim"].columns[1].tolist()))
    want = [(int(fv.sum()) + sum(attr[x] for x in fk.tolist()), 5000)]
    assert first == second == want


@pytest.fixture(scope="module")
def group_sql():
    return ("SELECT l_orderkey, count(*) AS c, sum(l_linenumber) AS s "
            "FROM lineitem GROUP BY l_orderkey ORDER BY l_orderkey")


def test_hash_aggregate_keeps_no_group_table_that_escaped_this_run(
        monkeypatch, group_sql):
    s = Session(device="cpu")
    s.execute("SET SESSION enable_pallas_hash = 'true'")
    # a pinned table of 131,072 slots: the plain K3 places all 15,000
    # groups, and every run asks for the same table
    s.execute("SET SESSION hash_table_slots = 131072")
    wrap = _TwoRuns(ht.hash_group_aggregate)

    def agg(*args):
        out, esc, occ = wrap(*args)
        if wrap.calls == 2:
            # a group lost from this run's table, and its escape counted
            live = out.live.clone()
            live[int(torch.nonzero(live)[0])] = False
            out = type(out)(columns=out.columns, live=live)
            esc = torch.ones_like(esc)
        return out, esc, occ
    monkeypatch.setattr(ht, "hash_group_aggregate", agg)
    runs = []
    for _ in range(2):
        runs.append(s.execute(group_sql).rows)
        assert s.executor.strategy_decisions["AggregateNode"] == "hash"
    assert wrap.calls == 2
    want = [tuple(r) for r in JaxSession().execute(group_sql).rows]
    assert runs == [want] * 2


def test_mesh_join_keeps_no_shard_table_that_escaped_this_run(monkeypatch):
    from trino_tpu_torch.parallel import stages as DX
    from trino_tpu_torch.parallel.dist_executor import MeshExecutor
    from trino_tpu_torch.parallel.mesh import make_mesh
    s = Session(device="cpu")
    s.executor = MeshExecutor(s.catalog, make_mesh(8, "cpu"))
    s.execute("SET SESSION join_distribution_type = 'partitioned'")
    s.execute("SET SESSION enable_pallas_hash = true")
    sql = ("SELECT count(*), sum(o_totalprice) FROM lineitem, orders "
           "WHERE l_orderkey = o_orderkey")
    real = DX.partitioned_hash_join_step
    calls = []

    def step_factory(*args, **kwargs):
        step = real(*args, **kwargs)

        def step_run(probe, build):
            out, dup, esc, pruned = step(probe, build)
            calls.append(1)
            if len(calls) == 2:
                # a shard's table lost a key this run: its probe rows drop
                live = out.live.clone()
                live[int(torch.nonzero(live)[0])] = False
                out = type(out)(columns=out.columns, live=live)
                esc = torch.ones_like(torch.as_tensor(esc))
            return out, dup, esc, pruned
        return step_run
    monkeypatch.setattr(DX, "partitioned_hash_join_step", step_factory)
    first = s.execute(sql).rows
    assert s.executor.stats.mesh_partitioned_joins == 1
    second = s.execute(sql).rows
    assert len(calls) == 2
    want = [tuple(r) for r in JaxSession().execute(sql).rows]
    assert first == second == want
