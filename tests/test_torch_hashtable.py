"""K3 (trino_tpu_torch/ops/hashtable.py) against the reference's
`pallas_hash` in interpret mode, on the same numpy inputs.

Tolerances: the slot hash is bit-exact; aggregation states are exact
(int64, wrapping) and compared as multisets of live groups, because group
order is slot order and which rows claim which slot is order-dependent;
escape counts agree on zero vs non-zero (the contract), and occupancy is
exact when nothing escaped. Join outputs compare as row multisets.

On the CPU the wrapper runs its vectorised plain version; the CUDA kernel
runs only on a card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu.batch import batch_from_numpy as jax_batch
from trino_tpu.ops import pallas_hash as ph
from trino_tpu.ops.aggregate import AggSpec as JaxAggSpec
from trino_tpu.ops.aggregate import key_pack_plan as jax_pack
from trino_tpu_torch.batch import batch_from_numpy as torch_batch
from trino_tpu_torch.ops import hashtable as ht
from trino_tpu_torch.ops.aggregate import AggSpec, key_pack_plan


# pytest-xdist runs one process per core: one torch thread each keeps
# the CPU tests from oversubscribing the cores
torch.set_num_threads(1)

def rows_of(batch):
    live = np.asarray(batch.live)
    out = []
    for i in np.nonzero(live)[0]:
        out.append(tuple(
            (np.asarray(c.data)[i].item() if np.asarray(c.valid)[i]
             else None) for c in batch.columns))
    return sorted(out, key=repr)


def both_batches(arrays, valids=None):
    return (jax_batch(arrays, valids=valids),
            torch_batch(arrays, valids=valids, device="cpu"))


AGGS5 = (("sum", 1), ("count", 1), ("min", 1), ("max", 1),
         ("count_star", None))


def _specs(aggs):
    return (tuple(JaxAggSpec(f, a) for f, a in aggs),
            tuple(AggSpec(f, a) for f, a in aggs))


def run_both(arrays, valids, keys, aggs, slots=1024):
    jb, tb = both_batches(arrays, valids)
    jaggs, taggs = _specs(aggs)
    jk, jbits = jax_pack(jb, keys)
    tk, tbits = key_pack_plan(tb, keys)
    assert tbits == jbits and list(tk) == list(jk)
    jout = ph.hash_group_aggregate(jb, jnp.asarray(jk), keys, jbits, jaggs,
                                   slots, "interpret")
    tout = ht.hash_group_aggregate(tb, tk, keys, tbits, taggs, slots)
    return jout, tout


def test_hash_slot_bit_exact():
    rng = np.random.default_rng(0)
    keys = np.concatenate([rng.integers(-(1 << 63), (1 << 63) - 1, 5000),
                           [0, 1, -1, -(1 << 63), (1 << 63) - 1]])
    for slots in (1024, 1 << 17):
        want = np.asarray(ph.hash_slot(jnp.asarray(keys), slots))
        got = ht.hash_slot(torch.from_numpy(keys), slots).numpy()
        assert np.array_equal(got, want.astype(np.int64))


def test_hash_agg_matches_reference_with_nulls():
    """Random keys (negative too), NULL keys and NULL values, every
    aggregate kind: same groups, same states."""
    rng = np.random.default_rng(7)
    n = 2000
    arrays = [rng.integers(-40, 160, n),
              rng.integers(-(1 << 52), 1 << 52, n)]
    valids = [rng.random(n) > 0.1, rng.random(n) > 0.1]
    (jout, jesc, jocc), (tout, tesc, tocc) = run_both(arrays, valids, (0,),
                                                      AGGS5)
    assert int(jesc) == 0 and int(tesc) == 0
    assert int(tocc) == int(jocc)
    assert rows_of(tout) == rows_of(jout)


def test_hash_agg_wrapping_sums_and_all_null_values():
    """int64 sums that wrap, and a value column that is NULL throughout
    (count 0, sum/min/max NULL)."""
    rng = np.random.default_rng(3)
    n = 1500
    arrays = [rng.integers(0, 50, n),
              rng.integers((1 << 61), (1 << 62), n),
              rng.integers(-9, 9, n)]
    valids = [None, None, np.zeros(n, bool)]
    aggs = (("sum", 1), ("min", 2), ("max", 2), ("sum", 2), ("count", 2))
    (jout, jesc, _), (tout, tesc, _) = run_both(arrays, valids, (0,), aggs)
    assert int(jesc) == 0 and int(tesc) == 0
    assert rows_of(tout) == rows_of(jout)
    assert all(r[2] is None and r[5] == 0 for r in rows_of(tout))


def test_hash_agg_multikey_packed_null_groups():
    rng = np.random.default_rng(8)
    n = 2000
    arrays = [rng.integers(0, 12, n), rng.integers(-5, 7, n),
              rng.integers(-1000, 1000, n)]
    valids = [rng.random(n) > 0.2, rng.random(n) > 0.2, None]
    aggs = (("sum", 2), ("count_star", None))
    (jout, jesc, _), (tout, tesc, _) = run_both(arrays, valids, (0, 1),
                                                aggs)
    assert int(jesc) == 0 and int(tesc) == 0
    assert rows_of(tout) == rows_of(jout)


def _colliders(slots):
    cands = np.arange(0, 60000, dtype=np.int64)
    home = ht.hash_slot(torch.from_numpy(cands + 1), slots).numpy()
    return cands[home == home[0]]


def test_hash_agg_crafted_collisions_and_deep_chain_escape():
    """Distinct keys sharing one home slot stay distinct groups; a chain
    deeper than MAX_PROBES escapes in both versions."""
    slots = 1024
    coll = _colliders(slots)
    assert len(coll) > ht.MAX_PROBES + 4
    keys = np.concatenate([[0], np.repeat(coll[:ht.MAX_PROBES - 4], 3)])
    vals = np.arange(len(keys), dtype=np.int64) * 7 - 11
    aggs = (("sum", 1), ("count_star", None))
    (jout, jesc, _), (tout, tesc, _) = run_both([keys, vals], None, (0,),
                                                aggs, slots)
    assert int(jesc) == 0 and int(tesc) == 0
    assert rows_of(tout) == rows_of(jout)
    deep = np.concatenate([[0], coll[:ht.MAX_PROBES + 4]])
    (_, jesc, _), (_, tesc, _) = run_both(
        [deep, np.ones(len(deep), np.int64)], None, (0,), aggs, slots)
    assert int(jesc) > 0 and int(tesc) > 0


def test_hash_agg_forced_overflow_escapes():
    n = 900                                  # 900 > 640 = 1024 * 5/8
    arrays = [np.arange(n, dtype=np.int64), np.ones(n, dtype=np.int64)]
    (_, jesc, jocc), (_, tesc, tocc) = run_both(arrays, None, (0,),
                                                (("sum", 1),), 1024)
    cap = 1024 * ht.LOAD_NUM // ht.LOAD_DEN
    assert int(jesc) > 0 and int(tesc) > 0
    assert int(tocc) == int(jocc) == cap


def test_build_join_table_duplicate_keys():
    arrays = [np.array([7, 7, 9, 11, 11, 11], dtype=np.int64),
              np.arange(6, dtype=np.int64)]
    jb, tb = both_batches(arrays)
    _, _, _, jdup, jesc = ph.build_join_table(jb, (0,), 1024, "interpret")
    tkey, src, tdup, tesc = ht.build_join_table(tb, (0,), 1024)
    assert int(tdup) == int(jdup) == 3
    assert int(tesc) == int(jesc) == 0
    # min(row_id) per key is the payload
    occupied = tkey != ht.EMPTY_KEY
    assert sorted(zip(tkey[occupied].tolist(), src[occupied].tolist())) \
        == [(7, 0), (9, 2), (11, 3)]


def _reference_pairs(tk_lo, tk_hi, src):
    """{(key, row id)} of a reference table's occupied slots."""
    key = (np.asarray(tk_hi).astype(np.int64) << 32) | \
        (np.asarray(tk_lo).astype(np.int64) & 0xFFFFFFFF)
    occ = key != ht.EMPTY_KEY
    return sorted(zip(key[occ].tolist(),
                      np.asarray(src)[occ].astype(np.int64).tolist()))


def _port_pairs(tkey, src):
    occ = tkey != ht.EMPTY_KEY
    return sorted(zip(tkey[occ].tolist(), src[occ].tolist()))


def test_build_join_tables_equal_per_dimension_reference():
    """A star's builds in one batched call equal one reference
    build_join_table per dimension: the {key, row id} slots, dup_rows and
    escaped (exact where nothing escaped, non-zero together otherwise) —
    a clean int64 dimension with NULLs and dead rows, a duplicated one, one
    over its load cap that also holds an EMPTY_KEY-valued key (force-
    escaped), and a clean int32 one."""
    rng = np.random.default_rng(41)
    slots = 1024
    cap = slots * ht.LOAD_NUM // ht.LOAD_DEN
    specs = [rng.permutation(1 << 30)[:300].astype(np.int64),
             rng.choice(100, 300).astype(np.int64) + (1 << 33),
             np.concatenate([rng.permutation(1 << 20)[:cap + 20],
                             [ht.EMPTY_KEY]]).astype(np.int64),
             rng.permutation(1 << 20)[:200].astype(np.int32)]
    jbs, tbs = [], []
    for d, keys in enumerate(specs):
        valid = rng.random(len(keys)) > (0.05 if d == 0 else 0.0)
        jb, tb = both_batches([keys, np.arange(len(keys))], [valid, None])
        if d == 0:
            dead = np.pad(rng.random(len(keys)) < 0.05,
                          (0, tb.capacity - len(keys)))
            jb = jb.with_live(jb.live & jnp.asarray(~dead))
            tb = tb.with_live(tb.live & torch.from_numpy(~dead))
        jbs.append(jb)
        tbs.append(tb)
    tkey, src, dup, esc = ht.build_join_tables(tbs, [(0,)] * len(tbs),
                                               slots)
    assert tkey.shape == src.shape == (len(tbs), slots)
    jdups = []
    for d, (jb, tb) in enumerate(zip(jbs, tbs)):
        tk_lo, tk_hi, jsrc, jdup, jesc = ph.build_join_table(
            jb, (0,), slots, "interpret")
        jdups.append(int(jdup))
        one = ht.build_join_table(tb, (0,), slots)
        assert torch.equal(one[0], tkey[d]) and torch.equal(one[1], src[d])
        assert int(one[2]) == int(dup[d]) and int(one[3]) == int(esc[d])
        assert (int(esc[d]) > 0) == (int(jesc) > 0)
        if int(jesc) == 0:
            assert int(dup[d]) == int(jdup)
            assert _port_pairs(tkey[d], src[d]) == \
                _reference_pairs(tk_lo, tk_hi, jsrc)
    assert int(dup[1]) == jdups[1] > 0
    assert int(esc[2]) > 0
    assert [int(e) for e in esc[[0, 1, 3]]] == [0, 0, 0]


def _skewed_groups(rng, count, heavy, light):
    """Groups (k0 int64, k1 int32 or NULL, a function of k0) whose
    splitmix64 partition of `count` over both keys is 0 for `heavy` of
    them and 1..count-1 for `light` each."""
    from trino_tpu_torch.exec.spill import partition_assignment
    k0 = rng.permutation(1 << 22).astype(np.int64)
    k1 = (k0 % 3).astype(np.int32)
    v1 = k0 % 7 != 0
    part = partition_assignment([k0, k1], [np.ones(len(k0), bool), v1],
                                (0, 1), count)
    pick = np.concatenate([np.flatnonzero(part == 0)[:heavy]] + [
        np.flatnonzero(part == p)[:light] for p in range(1, count)])
    return k0[pick], k1[pick], v1[pick]


@pytest.mark.parametrize("case", ["uniform", "skewed", "launch-groups"])
def test_executor_partitioned_agg_matches_reference(case, monkeypatch):
    """The one-launch partitioned aggregate against the reference's
    per-partition path, groups as multisets: two group keys (one nullable)
    and sum/count/min/max. `skewed`: partition 0 holds more groups than a
    table's cap, escapes alone and finishes on the sort path; `launch-
    groups`: a launch budget of three tables, so the four partitions run
    in a group of three and a group of one."""
    from trino_tpu_torch.exec import executor as texec
    jex, tex = _executors()
    rng = np.random.default_rng(43)
    sorts = []
    real_sort = texec.sort_group_aggregate
    monkeypatch.setattr(texec, "sort_group_aggregate",
                        lambda *a, **kw: sorts.append(1) or
                        real_sort(*a, **kw))
    if case == "launch-groups":
        monkeypatch.setattr(ht, "MAX_LAUNCH_TABLE_BYTES",
                            3 * ht.table_bytes(1024, 7))
    heavy = 800 if case == "skewed" else 300
    k0, k1, v1 = _skewed_groups(rng, 4, heavy, 300)
    n = 6000
    rows = rng.integers(0, len(k0), n)
    vals = rng.integers(-(1 << 40), 1 << 40, n)
    arrays = [k0[rows], vals, k1[rows]]
    valids = [None, rng.random(n) > 0.05, v1[rows]]
    jb, tb = both_batches(arrays, valids)
    aggs = (("sum", 1), ("count", 1), ("min", 1), ("max", 1))
    jaggs, taggs = _specs(aggs)
    want = jex.try_hash_group_agg(jb, (0, 2), jaggs, est_groups=1500)
    got = tex.try_hash_group_agg(tb, (0, 2), taggs, est_groups=1500)
    assert tex.stats.hash_agg_escapes == jex.stats.hash_agg_escapes == 1
    assert rows_of(got) == rows_of(want)
    assert len(sorts) == (1 if case == "skewed" else 0)


@pytest.mark.parametrize("keys,count", [
    ((0,), 16), ((1,), 4), ((2,), 2), ((0, 1, 2), 256), ((1, 0), 7),
    ((3,), 32)])
def test_partition_ids_bit_identical(keys, count):
    """The device partitioner equals the host tier's numpy one (and the
    reference's) bit for bit: int64, int32 and bool keys with NULLs, a
    multi-key, a partition count that is no power of two."""
    from trino_tpu.exec.spill import _partition_ids as jax_partition_ids
    from trino_tpu_torch.exec.spill import (partition_assignment,
                                            partition_ids)
    rng = np.random.default_rng(47)
    n = 5000
    arrays = [rng.integers(-(1 << 62), 1 << 62, n),
              rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
              rng.integers(0, 2, n).astype(bool),
              rng.integers(-5, 5, n)]
    valids = [rng.random(n) > 0.1 for _ in arrays]
    tb = torch_batch(arrays, valids=valids, device="cpu")
    got = partition_ids(tb, keys, count)[:n].numpy()
    assert np.array_equal(got, partition_assignment(arrays, valids, keys,
                                                    count))
    assert np.array_equal(got, jax_partition_ids(arrays, valids, keys,
                                                 count))


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
def test_hash_join_probe_matches_reference(kind):
    rng = np.random.default_rng(3)
    nb, npr = 400, 1500
    bkeys = rng.permutation(500000)[:nb].astype(np.int64)
    barr = [bkeys, rng.integers(0, 99, nb)]
    bval = [rng.random(nb) > 0.05, None]
    pkeys = np.concatenate([bkeys[:200],
                            rng.integers(0, 500000, npr - 200)])
    parr = [pkeys.astype(np.int64), rng.integers(0, 9, npr)]
    pval = [rng.random(npr) > 0.05, None]
    jb, tb = both_batches(barr, bval)
    jp, tp = both_batches(parr, pval)
    slots, fits = ht.join_table_slots(tb.capacity)
    assert fits and (slots, fits) == ph.join_table_slots(jb.capacity)
    tkl, tkh, jsrc, _, _ = ph.build_join_table(jb, (0,), slots,
                                               "interpret")
    want = ph.hash_join_probe(jp, jb, tkl, tkh, jsrc, (0,), (0,), kind,
                              "off")
    tkey, src, dup, esc = ht.build_join_table(tb, (0,), slots)
    assert int(dup) == 0 and int(esc) == 0
    got = ht.hash_join_probe(tp, tb, tkey, src, (0,), (0,), kind, "on")
    assert rows_of(got) == rows_of(want)


def _executors():
    from trino_tpu.catalog import default_catalog as jax_catalog
    from trino_tpu.exec.executor import Executor as JaxExecutor
    from trino_tpu_torch.catalog import default_catalog
    from trino_tpu_torch.exec.executor import Executor
    jex = JaxExecutor(jax_catalog())
    tex = Executor(default_catalog(), "cpu")
    for ex in (jex, tex):
        ex.enable_pallas_hash = "true"
        ex.hash_table_slots = 1024
    return jex, tex


def test_executor_escape_partitions_and_reenters():
    """Overflow -> radix partition by splitmix64 -> per-partition
    re-entry, in both executors, same groups."""
    jex, tex = _executors()
    rng = np.random.default_rng(9)
    n = 3000
    arrays = [rng.integers(0, 1500, n),
              rng.integers(-(1 << 40), 1 << 40, n)]
    valids = [rng.random(n) > 0.05, None]
    jb, tb = both_batches(arrays, valids)
    jaggs, taggs = _specs((("sum", 1), ("count_star", None)))
    want = jex.try_hash_group_agg(jb, (0,), jaggs, est_groups=1500)
    got = tex.try_hash_group_agg(tb, (0,), taggs, est_groups=1500)
    assert tex.stats.hash_agg_escapes == jex.stats.hash_agg_escapes == 1
    assert rows_of(got) == rows_of(want)


def test_executor_hash_join_partitioned_degrade():
    from trino_tpu.planner import logical as JL
    from trino_tpu.types import BIGINT as JBIGINT
    from trino_tpu_torch.planner import logical as L
    from trino_tpu_torch.types import BIGINT
    jex, tex = _executors()
    rng = np.random.default_rng(4)
    nb, npr = 1500, 2000                    # 1500 > 640 load cap
    bkeys = rng.permutation(1 << 20)[:nb].astype(np.int64)
    barr = [bkeys, rng.integers(0, 99, nb)]
    pkeys = np.concatenate([bkeys[:500],
                            rng.integers(0, 1 << 20, npr - 500)])
    parr = [pkeys.astype(np.int64), rng.integers(0, 9, npr)]
    jb, tb = both_batches(barr)
    jp, tp = both_batches(parr)
    outs = []
    for mod, bt, ex, probe, build in ((JL, JBIGINT, jex, jp, jb),
                                      (L, BIGINT, tex, tp, tb)):
        out_cols = tuple((f"c{i}", bt) for i in range(4))
        vals = mod.ValuesNode(arrays=(), valids=(), num_rows=0, fields=(),
                              output=out_cols[:2])
        node = mod.JoinNode(kind="inner", left=vals, right=vals,
                            left_keys=(0,), right_keys=(0,), residual=None,
                            build_unique=True, output=out_cols)
        status, got = ex.try_hash_join(node, probe, build, allow_dup=False)
        assert status == "ok" and ex.stats.hash_join_escapes == 1
        outs.append(rows_of(got))
    assert outs[0] == outs[1]


def test_table_sizing_matches_reference():
    for est in (1, 640, 641, 5000, 81920, 1 << 20):
        for aggs in (AGGS5, (("sum", 1),), (("count_star", None),)):
            jaggs, taggs = _specs(aggs)
            assert ht.pick_table_slots(est, taggs) == \
                ph.pick_table_slots(est, jaggs)
            assert ht.max_table_slots(taggs) == ph.max_table_slots(jaggs)
        assert ht.join_table_slots(est) == ph.join_table_slots(est)


def test_wrapper_raises_off_cpu_without_a_kernel():
    meta = torch.empty(8, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError):
        ht.hash_insert(meta, meta, meta.to(torch.int32), meta[None], (), 0,
                       1024)

