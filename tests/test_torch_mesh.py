"""The port's mesh tier (trino_tpu_torch/parallel/) against the reference's
on eight shards, bit for bit, on the CPU.

The reference runs its collectives inside `shard_map` over eight virtual
CPU devices (tests/conftest.py); the port loops over eight CPU shards with
the collectives as functions over the list. The same seeded numpy inputs
go through both: the exchange's layout (`repartition_by_key`, row for
row, dead rows and NULL keys on their own shard), the dynamic-filter
bounds and prune, `merge_partial_states` for each function (float sums
added shard 0 first), the four stage programs and the shard-local join
(`shard_join`: K3's build and the probe; the reference's kernel runs in
interpret mode, the port's plain version). Hashes with the top bit set
check the unsigned modulo of `partition_of`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from trino_tpu import ir as jir
from trino_tpu.batch import batch_from_numpy as j_batch
from trino_tpu.ops import pallas_hash as jph
from trino_tpu.ops.aggregate import AggSpec as JAgg
from trino_tpu.ops.aggregate import direct_group_aggregate as j_direct
from trino_tpu.parallel import exchange as jex
from trino_tpu.parallel import stages as jst
from trino_tpu.parallel.mesh import AXIS, shard_map
from trino_tpu.parallel.mesh import make_mesh as j_make_mesh
from trino_tpu.parallel.mesh import replicate as j_replicate
from trino_tpu.parallel.mesh import shard_rows as j_shard_rows
from trino_tpu.types import BIGINT as J_BIGINT
from trino_tpu_torch import ir as tir
from trino_tpu_torch.batch import batch_from_numpy as t_batch
from trino_tpu_torch.ops import hashtable as tht
from trino_tpu_torch.ops.aggregate import AggSpec as TAgg
from trino_tpu_torch.ops.aggregate import direct_group_aggregate as t_direct
from trino_tpu_torch.parallel import exchange as tex
from trino_tpu_torch.parallel import mesh as tmesh
from trino_tpu_torch.parallel import stages as tst
from trino_tpu_torch.types import BIGINT as T_BIGINT

torch.set_num_threads(1)

N = 8


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= N, "conftest must force 8 CPU devices"
    return j_make_mesh(N), tmesh.make_mesh(N, "cpu")


def _inputs(seed=5, n=3000, cap=4096, nulls=True):
    """Probe columns (group int32, key int64, val int64, fval float64)
    with dead padding and NULL keys, and a unique-key build (bkey, bval)
    that covers part of the probe's keys."""
    rng = np.random.default_rng(seed)
    group = rng.integers(0, 6, n).astype(np.int32)
    key = rng.integers(1, 700, n).astype(np.int64)
    val = rng.integers(-10_000, 10_000, n).astype(np.int64)
    fval = rng.normal(0, 1, n) * 10.0 ** rng.uniform(-8, 8, n)
    kvalid = rng.random(n) > 0.05 if nulls else np.ones(n, bool)
    probe = ([group, key, val, fval],
             [np.ones(n, bool), kvalid, np.ones(n, bool), np.ones(n, bool)])
    bkey = rng.permutation(np.arange(100, 600, dtype=np.int64))[:400]
    bval = (bkey % 7 + 1).astype(np.int64)
    build = ([bkey, bval], [np.ones(400, bool), np.ones(400, bool)])
    return probe, build, cap


def _both(cols, valids, cap):
    return (j_batch(cols, valids=valids, capacity=cap),
            t_batch(cols, valids=valids, capacity=cap, device="cpu"))


def _planes(batch):
    out = [np.asarray(batch.live)]
    for c in batch.columns:
        out += [np.asarray(c.data), np.asarray(c.valid)]
    return out


def _same(jb, tb):
    jp = _planes(jb)
    tp = _planes(tb)
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        assert a.shape == b.shape
        assert a.tobytes() == b.astype(a.dtype).tobytes()


def _jmap(mesh, fn, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs))


def test_make_mesh_and_shard_rows_lay_out_blocks(meshes):
    jm, tm = meshes
    assert tm.size == N and tm.axis_names == (AXIS,)
    assert all(d.type == "cpu" for d in tm.devices)
    assert tmesh.make_mesh(device="cpu").size == 1
    assert tmesh.make_mesh_2d(2, 4, "cpu").shape == (2, 4)
    (cols, valids), _, cap = _inputs()
    jb, tb = _both(cols, valids, cap)
    js = j_shard_rows(jb, jm)
    shards = tmesh.shard_rows(tb, tm)
    assert [s.capacity for s in shards] == [cap // N] * N
    # P('workers'): device i holds rows [i * cap/N, (i+1) * cap/N)
    for i, s in enumerate(shards):
        block = js.columns[1].data.addressable_shards[i]
        assert block.index[0].start == i * cap // N
        assert np.array_equal(np.asarray(block.data),
                              s.columns[1].data.numpy())
    _same(jb, tmesh.concat_rows(shards))
    padded = tmesh.pad_to_multiple(t_batch([np.arange(5)], device="cpu"),
                                   48)
    assert padded.capacity == 1056 and int(padded.live.sum()) == 5


@pytest.mark.parametrize("n_parts", [3, 6, 8, 1000003])
def test_partition_of_is_the_unsigned_modulo(n_parts):
    rng = np.random.default_rng(n_parts)
    keys = np.concatenate([rng.integers(-2 ** 62, 2 ** 62, 20_000),
                           np.arange(-50, 50),
                           [np.iinfo(np.int64).min, np.iinfo(np.int64).max]])
    keys = keys.astype(np.int64)
    h = np.asarray(jex._hash64(jnp.asarray(keys)))
    assert (h >> np.uint64(63)).sum() > 1000        # top bit set: signed
    want = np.asarray(jex.partition_of(jnp.asarray(keys), n_parts))
    got = tex.partition_of(torch.from_numpy(keys), n_parts).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, (h % np.uint64(n_parts)).astype(np.int32))


@pytest.mark.parametrize("key_index", [1, 0])
def test_repartition_layout_equals_reference(meshes, key_index):
    jm, tm = meshes
    (cols, valids), _, cap = _inputs()
    jb, tb = _both(cols, valids, cap)
    step = _jmap(jm, lambda b: jex.repartition_by_key(b, key_index, N),
                 (JP(AXIS),), JP(AXIS))
    want = step(j_shard_rows(jb, jm))
    got = tex.repartition_by_key(tmesh.shard_rows(tb, tm), key_index, N)
    assert [g.capacity for g in got] == [N * cap // N] * N
    _same(want, tmesh.concat_rows(got))


def test_join_filter_bounds_and_prune_equal_reference(meshes):
    jm, tm = meshes
    (pcols, pvalids), (bcols, bvalids), cap = _inputs()
    jp, tp = _both(pcols, pvalids, cap)
    jb, tb = _both(bcols, bvalids, 1024)

    def body(probe, build):
        kmins, kmaxs = jex.join_filter_bounds(build, (0,))
        out, pruned = jex.apply_filter_bounds(probe, (1,), kmins, kmaxs)
        return out, kmins, kmaxs, jax.lax.psum(pruned, AXIS)

    step = _jmap(jm, body, (JP(AXIS), JP(AXIS)),
                 (JP(AXIS), JP(), JP(), JP()))
    wout, wmin, wmax, wpruned = step(j_shard_rows(jp, jm),
                                     j_shard_rows(jb, jm))
    bounds = tex.join_filter_bounds(tmesh.shard_rows(tb, tm), (0,))
    outs, pruned = [], []
    for s, (kmins, kmaxs) in zip(tmesh.shard_rows(tp, tm), bounds):
        assert np.array_equal(kmins.numpy(), np.asarray(wmin))
        assert np.array_equal(kmaxs.numpy(), np.asarray(wmax))
        o, p = tex.apply_filter_bounds(s, (1,), kmins, kmaxs)
        outs.append(o)
        pruned.append(p)
    _same(wout, tmesh.concat_rows(outs))
    assert int(tex.psum_scalar(pruned)) == int(wpruned) > 0
    # a NULL probe key stays live: the join drops it, not the filter
    live = tmesh.concat_rows(outs).live.numpy()
    null_keys = ~np.asarray(jp.columns[1].valid) & np.asarray(jp.live)
    assert live[null_keys].all()


@pytest.mark.parametrize("func", ["sum", "count", "count_star", "min",
                                  "max"])
@pytest.mark.parametrize("arg", [2, 3])
def test_merge_partial_states_equals_reference(meshes, func, arg):
    jm, tm = meshes
    (cols, valids), _, cap = _inputs()
    valids[3] = np.random.default_rng(9).random(len(cols[3])) > 0.1
    jb, tb = _both(cols, valids, cap)
    idx = None if func == "count_star" else arg
    jaggs, taggs = (JAgg(func, idx),), (TAgg(func, idx),)

    def body(b):
        return jex.merge_partial_states(j_direct(b, (0,), (6,), jaggs),
                                        (func,), 1)

    want = _jmap(jm, body, (JP(AXIS),), JP())(j_shard_rows(jb, jm))
    parts = [t_direct(s, (0,), (6,), taggs)
             for s in tmesh.shard_rows(tb, tm)]
    got = tex.merge_partial_states(parts, (func,), 1)
    for g in got:
        _same(want, g)


def _filters():
    return (jir.Compare(">", jir.ColumnRef(2, J_BIGINT),
                        jir.Literal(0, J_BIGINT)),
            tir.Compare(">", tir.ColumnRef(2, T_BIGINT),
                        tir.Literal(0, T_BIGINT)))


AGGS = (("sum", 2), ("sum", 3), ("count_star", None), ("min", 3),
        ("max", 2), ("count", 1))


def test_sharded_agg_step_equals_reference(meshes):
    jm, tm = meshes
    (cols, valids), _, cap = _inputs()
    jb, tb = _both(cols, valids, cap)
    jf, tf = _filters()
    want = jst.sharded_agg_step(jm, jf, None, (0,), (6,), tuple(
        JAgg(f, a) for f, a in AGGS))(j_shard_rows(jb, jm))
    got = tst.sharded_agg_step(tm, tf, None, (0,), (6,), tuple(
        TAgg(f, a) for f, a in AGGS))(tb)
    _same(want, got)


def test_sharded_join_agg_step_equals_reference(meshes):
    jm, tm = meshes
    (pcols, pvalids), (bcols, bvalids), cap = _inputs()
    jp, tp = _both(pcols, pvalids, cap)
    jb, tb = _both(bcols, bvalids, 1024)
    jf, tf = _filters()
    aggs = (("sum", 2), ("sum", 3), ("sum", 5), ("count_star", None),
            ("max", 3))
    jstep = jst.sharded_join_agg_step(
        jm, N, jf, 1, None, 0, None, (0,), (6,),
        tuple(JAgg(f, a) for f, a in aggs))
    want, wdup = jstep(j_shard_rows(jp, jm), j_shard_rows(jb, jm))
    got, dup = tst.sharded_join_agg_step(
        tm, N, tf, 1, None, 0, None, (0,), (6,),
        tuple(TAgg(f, a) for f, a in aggs))(tp, tb)
    _same(want, got)
    assert int(dup) == int(wdup) == 0


def test_broadcast_join_step_equals_reference(meshes):
    jm, tm = meshes
    (pcols, pvalids), (bcols, bvalids), cap = _inputs()
    jp, tp = _both(pcols, pvalids, cap)
    jb, tb = _both(bcols, bvalids, 1024)
    jf, tf = _filters()
    want = jst.broadcast_join_step(jm, jf, (1,), (0,), None)(
        j_shard_rows(jp, jm), j_replicate(jb, jm))
    got = tst.broadcast_join_step(tm, tf, (1,), (0,), None)(tp, tb)
    _same(want, got)


@pytest.mark.parametrize("dynamic_filter", [True, False])
def test_partitioned_hash_join_step_equals_reference(meshes,
                                                     dynamic_filter):
    jm, tm = meshes
    (pcols, pvalids), (bcols, bvalids), cap = _inputs(n=1500, cap=2048)
    jp, tp = _both(pcols, pvalids, cap)
    jb, tb = _both(bcols, bvalids, 512)
    slots = 1024
    jstep = jst.partitioned_hash_join_step(
        jm, N, (1,), (0,), "inner", slots, "interpret", "off",
        dynamic_filter=dynamic_filter)
    want = jstep(j_shard_rows(jp, jm), j_shard_rows(jb, jm))
    before = tht.hash_insert_multi.launches
    got = tst.partitioned_hash_join_step(
        tm, N, (1,), (0,), "inner", slots, "off",
        dynamic_filter=dynamic_filter)(tp, tb)
    assert len(got[0]) == N
    _same(want[0], tmesh.concat_rows(got[0]))
    assert [int(x) for x in got[1:]] == [int(x) for x in want[1:]]
    assert (int(got[3]) > 0) == dynamic_filter
    # the CPU runs K3's plain version: no launch is counted here
    assert tht.hash_insert_multi.launches == before


@pytest.mark.parametrize("dynamic_filter", [True, False])
def test_partitioned_hash_join_step_takes_sharded_sides(meshes,
                                                        dynamic_filter):
    """Sides that arrive as shards (a ShardedBatch's list) give the rows
    and totals of the same sides given whole."""
    jm, tm = meshes
    (pcols, pvalids), (bcols, bvalids), cap = _inputs(n=1500, cap=2048)
    _jp, tp = _both(pcols, pvalids, cap)
    _jb, tb = _both(bcols, bvalids, 512)
    step = tst.partitioned_hash_join_step(
        tm, N, (1,), (0,), "inner", 1024, "off",
        dynamic_filter=dynamic_filter)
    whole = step(tp, tb)
    sharded = step(tmesh.split_rows(tp, tm).shards,
                   tmesh.shard_rows(tb, tm))
    for a, b in zip(whole[0], sharded[0]):
        _same(a, b)
    assert [int(x) for x in sharded[1:]] == [int(x) for x in whole[1:]]


@pytest.mark.parametrize("case", ["unique", "dups", "escapes"])
def test_shard_join_equals_reference(case):
    rng = np.random.default_rng(11)
    n = 2000
    if case == "escapes":
        bkey = rng.choice(np.arange(1, 10 ** 6), 1000, replace=False)
    else:
        bkey = rng.permutation(np.arange(1, 700))[:500]
    if case == "dups":
        bkey = np.concatenate([bkey, bkey[:40]])
    bkey = bkey.astype(np.int64)
    pkey = rng.choice(np.concatenate([bkey, np.arange(10 ** 7, 10 ** 7 +
                                                      300)]), n)
    pcols = [pkey, rng.integers(0, 9, n).astype(np.int64)]
    pvalids = [rng.random(n) > 0.03, np.ones(n, bool)]
    bcols = [bkey, (bkey % 13).astype(np.int64)]
    bvalids = [np.ones(len(bkey), bool)] * 2
    jp, tp = _both(pcols, pvalids, 2048)
    jb, tb = _both(bcols, bvalids, 2048 if len(bkey) > 1024 else 1024)
    wj, wdup, wesc = jph.shard_join(jp, jb, (0,), (0,), "inner", 1024,
                                    "interpret", "off")
    gj, gdup, gesc = tht.shard_join(tp, tb, (0,), (0,), "inner", 1024,
                                    "off")
    assert (int(gdup), int(gesc)) == (int(wdup), int(wesc))
    assert (int(gdup) > 0) == (case == "dups")
    assert (int(gesc) > 0) == (case == "escapes")
    if case == "unique":
        _same(wj, gj)
