"""Card-only tests of the port's hand-written kernels: each kernel against
its plain torch version on CUDA tensors, and a query through the port
Session on the card against the same query on the CPU.

Every test here needs an NVIDIA GPU and skips without one (decided inside
the test). The file imports neither jax nor the reference package, so on
the GPU machine it runs without them:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: bit-exact (K1 bytes, K2 words and escape totals, K3 group
states as multisets, K4 found and miss, K5 sums, query rows equal)."""

import os
import sys

import numpy as np
import pytest
import torch

from trino_tpu_torch.ops import gather as k1
from trino_tpu_torch.ops import hashtable as ht
from trino_tpu_torch.ops.aggregate import AggSpec

pytestmark = pytest.mark.cuda

# the shared query texts and K5's cases live beside this file (no conftest
# on the card)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_k5_cases import (K5_CASES, k5_case, k5_case_id,  # noqa: E402
                                 same_batch)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _tables(rng, w):
    return [rng.integers(-(1 << 62), 1 << 62, w),
            rng.integers(-100, 100, w).astype(np.int8),
            rng.integers(0, 2, w).astype(bool),
            rng.normal(size=w),
            rng.normal(size=w).astype(np.float32),
            rng.integers(-(1 << 30), 1 << 30, w).astype(np.int32)]


def test_k1_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(9)
    w, n = 5000, 70_000
    tables = [torch.from_numpy(t).to(dev) for t in _tables(rng, w)] * 3
    idx = torch.from_numpy(rng.integers(-50, w + 50, n)).to(dev)
    fills = [-5, 3, True, 2.5, -1.5, -7] * 3
    before = k1.gather_columns.launches
    got = k1.gather_columns(tables, idx, fills)
    want = k1.gather_columns_plain(tables, idx, fills)
    torch.cuda.synchronize()
    # 18 tables ride one launch (MAX_TABLES = 64)
    assert k1.gather_columns.launches == before + 1
    for g, wv in zip(got, want):
        assert g.cpu().numpy().tobytes() == wv.cpu().numpy().tobytes()


def _lane_tables(rng, w, count):
    """`count` tables cycling through every lane type K1 takes."""
    makers = [lambda: rng.integers(-(1 << 62), 1 << 62, w),
              lambda: rng.normal(size=w),
              lambda: rng.integers(-(1 << 30), 1 << 30, w).astype(np.int32),
              lambda: rng.normal(size=w).astype(np.float32),
              lambda: rng.integers(-(1 << 15), 1 << 15, w).astype(np.int16),
              lambda: rng.integers(-100, 100, w).astype(np.int8),
              lambda: rng.integers(0, 256, w).astype(np.uint8),
              lambda: rng.integers(0, 2, w).astype(bool)]
    fills = [-5, 2.5, -7, -1.5, 300, 3, 200, True]
    return ([makers[i % 8]() for i in range(count)],
            [fills[i % 8] for i in range(count)])


def _k1_case(dev, rng, w, n, idx_dtype, tables=None, fills=None):
    if tables is None:
        tables, fills = _lane_tables(rng, w, 40)
        tables = [torch.from_numpy(t).to(dev) for t in tables]
    idx = rng.integers(-50, w + 50, n)
    idx[::97] = -(1 << 40)                       # wild
    idx[1::89] = 1 << 40
    idx = torch.from_numpy(idx)
    if idx_dtype == "int32":
        idx = idx.clamp(-(1 << 31), (1 << 31) - 1).to(torch.int32)
    idx = idx.to(dev)
    before = k1.gather_columns.launches
    got = k1.gather_columns(tables, idx, fills)
    want = k1.gather_columns_plain(tables, idx, fills)
    torch.cuda.synchronize()
    assert k1.gather_columns.launches == before + (1 if n else 0)
    for g, wv in zip(got, want):
        assert g.dtype == wv.dtype and g.shape == (n,)
        assert g.cpu().numpy().tobytes() == wv.cpu().numpy().tobytes()


@pytest.mark.parametrize("idx_dtype", ["int64", "int32"])
@pytest.mark.parametrize("w", ["5000", "budget", "budget+1"])
def test_k1_forty_tables_every_lane(w, idx_dtype):
    """40 tables of every lane type in one launch, bit-exact: W of 5,000
    (int8 and bool tables end off a 16-byte boundary), of L1_BYTES
    exactly for the int64 tables, and one row past it (big tiles either
    way, by the narrower lanes); n not a multiple of the tile; wild
    indices."""
    dev = _card()
    width = {"5000": 5000, "budget": k1.L1_BYTES // 8,
             "budget+1": k1.L1_BYTES // 8 + 1}[w]
    rng = np.random.default_rng(width)
    _k1_case(dev, rng, width, 3 * k1.K1_TILE_BIG + 1001, idx_dtype)


@pytest.mark.parametrize("idx_dtype", ["int64", "int32"])
def test_k1_empty_and_all_miss_on_card(idx_dtype):
    dev = _card()
    rng = np.random.default_rng(3)
    _k1_case(dev, rng, 5000, 0, idx_dtype)
    tables, fills = _lane_tables(rng, 5000, 16)
    tables = [torch.from_numpy(t).to(dev) for t in tables]
    idx = torch.full((70_001,), -1, dtype=getattr(torch, idx_dtype),
                     device=dev)
    idx[::3] = 5000                              # past the end: a miss too
    got = k1.gather_columns(tables, idx, fills)
    want = k1.gather_columns_plain(tables, idx, fills)
    torch.cuda.synchronize()
    for g, wv in zip(got, want):
        assert g.cpu().numpy().tobytes() == wv.cpu().numpy().tobytes()


def test_k1_unaligned_and_many_tables_on_card():
    """Tables that are views off a 16-byte boundary and a call of 70
    tables (two launches)."""
    dev = _card()
    rng = np.random.default_rng(5)
    w = 18_432
    base, fills = _lane_tables(rng, w + 3, 70)
    tables = [torch.from_numpy(t).to(dev)[3:] for t in base]
    idx = torch.from_numpy(rng.integers(-5, w + 5, 200_003)).to(dev)
    before = k1.gather_columns.launches
    got = k1.gather_columns(tables, idx, fills)
    want = k1.gather_columns_plain(tables, idx, fills)
    torch.cuda.synchronize()
    assert k1.gather_columns.launches == before + 2
    for g, wv in zip(got, want):
        assert g.cpu().numpy().tobytes() == wv.cpu().numpy().tobytes()


def _groups(tkey, states):
    m = (tkey != ht.EMPTY_KEY).cpu()
    return sorted(map(tuple, torch.cat(
        [tkey.cpu()[m][None], states.cpu()[:, m]]).T.tolist()))


def test_k3_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(11)
    n, groups, slots = 200_000, 3000, 1 << 15
    key = torch.from_numpy(rng.integers(0, groups, n) * 7919).to(dev)
    slot = ht.hash_slot(key, slots)
    vals = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, (3, n)))
    vbits = torch.from_numpy(rng.integers(0, 16, n).astype(np.int32))
    aggs = tuple(AggSpec(f, 0) for f in ("sum", "count", "min", "max"))
    layout, ns, _ = ht.agg_layout(aggs)
    args = (slot, key, vbits.to(dev), vals.to(dev), layout, ns, slots)
    before = ht.hash_insert_multi.launches
    tk, st, esc, occ = ht.hash_insert(*args)
    tk2, st2, esc2, occ2 = ht.hash_insert_plain(*args)
    torch.cuda.synchronize()
    assert ht.hash_insert_multi.launches == before + 1
    assert int(esc) == int(esc2) == 0 and int(occ) == int(occ2) == groups
    assert _groups(tk, st) == _groups(tk2, st2)


def test_k3_overflow_escapes_on_card():
    dev = _card()
    keys = torch.arange(5000, dtype=torch.int64, device=dev)
    _, _, esc, occ = ht.hash_insert(
        ht.hash_slot(keys, 1024), keys,
        torch.zeros(5000, dtype=torch.int32, device=dev),
        torch.zeros((1, 5000), dtype=torch.int64, device=dev), (), 0, 1024)
    assert int(esc) > 0 and int(occ) <= 1024 * ht.LOAD_NUM // ht.LOAD_DEN


@pytest.mark.parametrize("tables", [1, 3, 16])
def test_k3_multi_tables_match_plain_on_card(tables):
    """G tables in one launch against the plain version per table: four
    aggregates over int32 and int64 values with NULLs; table 1 (when
    there is one) is forced over its cap while the others stay clean, so
    the per-table counters are shown to be independent."""
    dev = _card()
    rng = np.random.default_rng(19 + tables)
    slots = 1 << 12
    cap = slots * ht.LOAD_NUM // ht.LOAD_DEN
    n = 60_000
    tid = rng.integers(0, tables, n).astype(np.int32)
    key = rng.integers(0, 600, n).astype(np.int64) * 7919 + tid
    if tables > 1:
        over = tid == 1
        key[over] = rng.integers(0, 1 << 40, int(over.sum()))
    mask = rng.random(n) > 0.03
    v64 = rng.integers(-(1 << 62), 1 << 62, n)
    v32 = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    aggs = tuple(AggSpec(f, 0) for f in ("sum", "count", "min", "max"))
    layout, ns, _ = ht.agg_layout(aggs)
    t = [torch.from_numpy(a).to(dev) for a in
         (key, mask, tid, v64, v32, valid)]
    planes = ((t[3], t[5]), (None, t[5]), (t[4], t[5]), (t[3], None))
    args = (t[0], t[1], planes, layout, ns, slots, tables,
            t[2] if tables > 1 else None)
    before = ht.hash_insert_multi.launches
    tk, st, cnt, _ = ht.hash_insert_multi(*args)
    tk2, st2, cnt2, _ = ht.hash_insert_multi_plain(*args)
    torch.cuda.synchronize()
    assert ht.hash_insert_multi.launches == before + 1
    assert cnt.dtype == torch.int32 and cnt.shape == (tables, 2)
    for g in range(tables):
        if g == 1:
            assert int(cnt[g, 0]) > 0 and int(cnt2[g, 0]) > 0
            assert int(cnt[g, 1]) <= cap
            continue
        assert int(cnt[g, 0]) == int(cnt2[g, 0]) == 0
        assert int(cnt[g, 1]) == int(cnt2[g, 1]) > 0
        assert _groups(tk[g], st[:, g]) == _groups(tk2[g], st2[:, g])


@pytest.mark.parametrize("k", [2, 3, 4, 5])
@pytest.mark.parametrize("width", [torch.int32, torch.int64])
def test_k4_keys_in_matches_plain_on_card(k, width):
    """The keys-in K4 entry on k tables built by one K3 launch (the
    interleaved table) and on the same tables as planes (interleaved by
    the wrapper), against the plain version: found and miss bit-exact,
    NULL and sentinel keys, dead rows; one launch per call."""
    from trino_tpu_torch.batch import Batch, Column
    dev = _card()
    rng = np.random.default_rng(23 + k)
    n, slots = 200_000, 1 << 15        # load <= 0.22: no chain escapes
    builds, cols = [], []
    for d in range(k):
        m = 3000 + 1000 * d
        keys = rng.choice(1 << 30, m, replace=False)
        ones = torch.ones(m, dtype=torch.bool, device=dev)
        builds.append(Batch((Column(torch.from_numpy(keys).to(dev).to(
            width), ones),), ones))
        fk = np.where(rng.random(n) < 0.85, keys[rng.integers(0, m, n)],
                      rng.integers(1 << 30, (1 << 31) - 1, n))
        fk = torch.from_numpy(fk).to(width)
        if width == torch.int64:
            fk[rng.random(n) < 0.01] = ht.EMPTY_KEY
        cols.append(Column(fk.to(dev), torch.from_numpy(
            rng.random(n) > 0.02).to(dev)))
    probe = Batch(tuple(cols), torch.from_numpy(rng.random(n) > 0.03).to(
        dev))
    tkey, src, dup, esc = ht.build_join_tables(
        builds, [(0,)] * k, slots)
    assert tkey.stride(1) == 2 and int(dup.sum()) == int(esc.sum()) == 0
    pk = tuple((d,) for d in range(k))
    for tk, sr in ((tkey, src), (tkey.contiguous(), src.contiguous())):
        before = ht.multiway_probe.launches
        found, miss = ht.multiway_probe(probe, tk, sr, pk)
        torch.cuda.synchronize()
        assert ht.multiway_probe.launches == before + 1
        cpu = Batch(tuple(Column(c.data.cpu(), c.valid.cpu())
                          for c in cols), probe.live.cpu())
        found2, miss2 = ht.multiway_probe(cpu, tk.cpu(), sr.cpu(), pk)
        assert found.dtype == torch.int32
        assert torch.equal(found.cpu(), found2)
        assert torch.equal(miss.cpu(), miss2)
    assert int(miss[0]) > 0 and int((found[-1] >= 0).sum()) > 0


def test_q3_on_card_equals_cpu():
    _card()
    from trino_tpu_torch.exec.session import Session
    q3 = """
SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
       o_orderdate, o_shippriority
FROM customer, orders, lineitem
WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
  AND l_orderkey = o_orderkey AND o_orderdate < DATE '1995-03-15'
  AND l_shipdate > DATE '1995-03-15'
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate, l_orderkey LIMIT 10"""
    rows = []
    for device in ("cuda", "cpu"):
        s = Session(device=device)
        s.execute("SET SESSION hash_agg_mode = 'force'")
        rows.append(s.execute(q3).rows)
        assert s.executor.strategy_decisions["AggregateNode"] == "hash"
    assert rows[0] == rows[1] and len(rows[0]) == 10


def test_partitioned_hash_agg_on_card_equals_cpu():
    """15,000 groups into 1024-slot tables: the aggregate escapes, and on
    the card every partition then aggregates in one K3 launch; rows equal
    the CPU's."""
    _card()
    from trino_tpu_torch.exec.session import Session
    sql = ("SELECT l_orderkey, count(*), sum(l_quantity), min(l_partkey) "
           "FROM lineitem GROUP BY l_orderkey ORDER BY l_orderkey")
    rows = []
    for device in ("cuda", "cpu"):
        s = Session(device=device)
        s.execute("SET SESSION hash_agg_mode = 'force'")
        s.execute("SET SESSION hash_table_slots = 1024")
        before = ht.hash_insert_multi.launches
        rows.append(s.execute(sql).rows)
        assert s.executor.stats.hash_agg_escapes == 1
        if device == "cuda":
            assert ht.hash_insert_multi.launches == before + 2
    assert rows[0] == rows[1] and len(rows[0]) == 15_000


def _tpch_queries():
    from tpch_full import QUERIES
    return dict(QUERIES)


@pytest.fixture(scope="module")
def sessions():
    from trino_tpu_torch.exec.session import Session
    _card()
    return Session(device="cuda"), Session(device="cpu")


# the corpus tests' two kernel modes: the session defaults, and every
# kernel forced on (chip_smoke.py's FORCED)
KERNEL_MODES = {"auto": {}, "forced": {
    "enable_pallas_gather": "true", "enable_pallas_hash": "true",
    "enable_multiway_join": "true", "mxu_agg": "true"}}


def _rows_in_mode(session, sql, mode):
    """`sql`'s rows with KERNEL_MODES[mode] set, the properties restored
    after (the sessions are shared by the module)."""
    props = KERNEL_MODES[mode]
    saved = {k: session.properties[k] for k in props}
    session.properties.update(props)
    try:
        return session.execute(sql).rows
    finally:
        session.properties.update(saved)


@pytest.mark.parametrize("mode", sorted(KERNEL_MODES))
@pytest.mark.parametrize("qnum", sorted(_tpch_queries()))
def test_tpch_on_card_equals_cpu(sessions, qnum, mode):
    """The 22 TPC-H queries at tpch.tiny (q4, q21 and q22 through the
    semi and anti joins), under `auto` and with every kernel forced on:
    the card's rows equal the CPU's under the same settings (the kernels
    against their plain versions, end to end)."""
    gpu, cpu = sessions
    sql = _tpch_queries()[qnum]
    assert _rows_in_mode(gpu, sql, mode) == _rows_in_mode(cpu, sql, mode)


def _star_slots(rng, dev, k=3, n=300_000, slots=1 << 14):
    """k tables built by K3 at one T, fact slots/keys with hits, misses,
    NULL keys (slot -1) and dead rows (slot -2)."""
    from trino_tpu_torch.batch import Batch, Column
    dead = torch.from_numpy(rng.random(n) < 0.03).to(dev)
    tkeys, srcs, slot_rows, key_rows = [], [], [], []
    for d in range(k):
        m = 4000 + 2000 * d
        keys = torch.from_numpy(rng.choice(1 << 24, m, replace=False)).to(dev)
        ones = torch.ones(m, dtype=torch.bool, device=dev)
        tkey, src, _dup, _esc = ht.build_join_table(
            Batch((Column(keys, ones),), ones), (0,), slots)
        fk = torch.where(
            torch.from_numpy(rng.random(n) < 0.8).to(dev),
            keys[torch.from_numpy(rng.integers(0, m, n)).to(dev)],
            torch.from_numpy(rng.integers(1 << 25, 1 << 30, n)).to(dev))
        null = torch.from_numpy(rng.random(n) < 0.02).to(dev)
        slot = torch.where(null, -1, ht.hash_slot(fk, slots))
        slot = torch.where(dead, -2, slot)
        tkeys.append(tkey)
        srcs.append(src)
        slot_rows.append(slot)
        key_rows.append(torch.where(slot >= 0, fk, 0))
    return (torch.stack(slot_rows), torch.stack(key_rows),
            torch.stack(tkeys), torch.stack(srcs))


def test_k4_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(13)
    slot, key, tkey, src = _star_slots(rng, dev)
    before = ht.multiway_probe.launches
    found, miss = ht.multiway_probe_slots(slot, key, tkey, src)
    found2, miss2 = ht.multiway_probe_plain(slot, key, tkey, src)
    torch.cuda.synchronize()
    assert ht.multiway_probe.launches == before + 1
    assert torch.equal(found, found2) and torch.equal(miss, miss2)
    assert int(miss[0]) > 0 and int((found[-1] >= 0).sum()) > 0


def _k5_batch(case, seed, dev):
    from trino_tpu_torch.batch import Batch, Column
    arrays, valids, live, keys, domains, aggs = k5_case(case, seed)
    batch = Batch(tuple(Column(torch.from_numpy(a).to(dev),
                               torch.from_numpy(v).to(dev))
                        for a, v in zip(arrays, valids)),
                  torch.from_numpy(live).to(dev))
    return batch, keys, domains, tuple(AggSpec(f, c) for f, c in aggs)


@pytest.mark.parametrize("case", K5_CASES, ids=k5_case_id)
def test_k5_grid_matches_plain_on_card(case):
    """K5 against its plain version on the grid of cases, all groups bit
    for bit, one launch a call."""
    from trino_tpu_torch.ops import direct_agg as k5
    dev = _card()
    args = _k5_batch(case, 5, dev)
    before = k5.direct_group_aggregate_mxu.launches
    got = k5.direct_group_aggregate_mxu(*args)
    want = k5.direct_group_aggregate_mxu_plain(*args)
    torch.cuda.synchronize()
    assert k5.direct_group_aggregate_mxu.launches == before + 1
    assert same_batch(got, want)


def test_k5_matches_plain_on_card():
    """K5 at G = 16 with eight sums near +-2^58 (carries between the
    32-bit halves, sums that wrap) over 500,000 rows, called twice: the second call finds the scratch the first left
    zero. The summing part equals index_add_ too."""
    from trino_tpu_torch.ops import direct_agg as k5
    dev = _card()
    case = (500_000, ("int16", "int32"), (4, 4), "eight sums")
    args = _k5_batch(case, 17, dev)
    before = k5.direct_group_aggregate_mxu.launches
    first = k5.direct_group_aggregate_mxu(*args)
    second = k5.direct_group_aggregate_mxu(*args)
    want = k5.direct_group_aggregate_mxu_plain(*args)
    torch.cuda.synchronize()
    assert k5.direct_group_aggregate_mxu.launches == before + 2
    assert same_batch(first, want) and same_batch(second, want)
    batch, keys, domains, aggs = args
    gid = torch.zeros(batch.capacity, dtype=torch.int64, device=dev)
    ok = batch.live.clone()
    for ki, d in zip(keys, domains):
        col = batch.columns[ki]
        gid = gid * d + col.data.to(torch.int32).clamp(0, d - 1)
        ok &= col.valid
    lib = torch.zeros((17, 8), dtype=torch.int64, device=dev)
    vals = torch.stack([torch.where(batch.columns[c].valid,
                                    batch.columns[c].data, 0)
                        for c in range(8)], 1)
    lib.index_add_(0, torch.where(ok, gid, 16), vals)
    assert torch.equal(torch.stack([c.data for c in first.columns[2:]], 1),
                       lib[:16])


def test_k5_one_launch_no_memset_on_card():
    """A public call on q12's shape is one kernel on the card: no memset,
    no torch kernel before it (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from trino_tpu_torch.ops import direct_agg as k5
    dev = _card()
    args = _k5_batch((32_768, ("int32",), (7,), "q12"), 12, dev)
    k5.direct_group_aggregate_mxu(*args)
    torch.cuda.synchronize()
    for _attempt in range(3):     # CUPTI now and then drops a whole trace
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                k5.direct_group_aggregate_mxu(*args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    assert len(names) == 3 and all("k5_" in n for n in names), names


@pytest.fixture(scope="module")
def ds_sessions():
    from trino_tpu_torch.exec.session import Session
    _card()
    return tuple(Session(default_cat="tpcds", default_schema="tiny",
                         device=d) for d in ("cuda", "cpu"))


@pytest.mark.parametrize("qid", [3, 7, 19, 26, 42, 52, 55, 96])
def test_tpcds_star_on_card_equals_cpu(ds_sessions, qid):
    """The TPC-DS star queries at tpcds.tiny: the card's rows (K4 fused)
    equal the CPU's (K4's plain version)."""
    from tpcds_queries import QUERIES
    gpu, cpu = ds_sessions
    before = ht.multiway_probe.launches
    got = gpu.execute(QUERIES[qid]).rows
    assert ht.multiway_probe.launches == before + 1
    assert got == cpu.execute(QUERIES[qid]).rows
    assert gpu.executor.strategy_decisions == \
        cpu.executor.strategy_decisions


def test_q12_mxu_on_card_equals_cpu(sessions):
    from tpch_full import QUERIES
    from trino_tpu_torch.ops import direct_agg as k5
    gpu, cpu = sessions
    rows = []
    for s in (gpu, cpu):
        s.execute("SET SESSION mxu_agg = 'true'")
        before = k5.direct_group_aggregate_mxu.launches
        rows.append(s.execute(QUERIES[12]).rows)
        s.execute("SET SESSION mxu_agg = 'auto'")
        assert s.executor.strategy_decisions["AggregateNode"] == "mxu"
    # the CPU run: plain
    assert k5.direct_group_aggregate_mxu.launches == before
    assert rows[0] == rows[1] and len(rows[0]) == 2


@pytest.mark.parametrize("word", ["int8", "int16", "int32", "int64"])
def test_k2_matches_plain_on_card(word):
    """K2 against its plain version, words and escape totals bit-exact:
    near-sorted indices (no escapes), random ones (escapes), misses and
    out-of-range indices, and a LUT shorter than two windows."""
    dev = _card()
    rng = np.random.default_rng(31)
    info = np.iinfo(word)
    for w, n in ((300_000, 200_000), (5000, 3000)):
        lut = torch.from_numpy(rng.integers(info.min, info.max, w,
                                            dtype=np.int64).astype(word))
        planes = k1.prepare_word_planes(lut.to(dev))
        near = np.clip(np.sort(rng.integers(0, w, n)) +
                       rng.integers(-3, 4, n), 0, w - 1)
        wild = rng.integers(0, w, n)
        wild[::7] = -1
        wild[3::11] = -(1 << 40)
        wild[5::13] = planes.shape[0] + 9
        for idx in (near, wild):
            ic = torch.from_numpy(idx).to(dev)
            before = k1.gather_word_windowed.launches
            got_w, got_e = k1.gather_word_windowed(planes, ic, word)
            want_w, want_e = k1.gather_word_windowed_plain(planes, ic, word)
            torch.cuda.synchronize()
            assert k1.gather_word_windowed.launches == before + 1
            assert torch.equal(got_w, want_w)
            assert int(got_e) == int(want_e)
            if idx is near:
                assert int(got_e) == 0


def _escaping_k2_input(dev):
    rng = np.random.default_rng(37)
    w = 300_000
    lut = torch.from_numpy(rng.integers(-128, 128, w).astype(np.int8))
    planes = k1.prepare_word_planes(lut.to(dev))
    idx = torch.from_numpy(rng.integers(-10, w, 250_001)).to(dev)
    return planes, idx


def test_k2_twice_in_a_row_same_escapes():
    """Two launches back to back on escaping input: the same escape total
    both times (each launch zeroes its own counter), equal to the plain
    version's."""
    dev = _card()
    planes, idx = _escaping_k2_input(dev)
    want_w, want_e = k1.gather_word_windowed_plain(planes, idx, "int8")
    w1, e1 = k1.gather_word_windowed(planes, idx, "int8")
    w2, e2 = k1.gather_word_windowed(planes, idx, "int8")
    torch.cuda.synchronize()
    assert int(want_e) > 0
    assert int(e1) == int(e2) == int(want_e)
    assert torch.equal(w1, want_w) and torch.equal(w2, want_w)


def test_k2_on_a_side_stream():
    """K2 launched on a side stream (its counter zeroed on that stream)
    agrees with the plain version and with a launch on the default
    stream."""
    dev = _card()
    planes, idx = _escaping_k2_input(dev)
    main_w, main_e = k1.gather_word_windowed(planes, idx, "int8")
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            side_w, side_e = k1.gather_word_windowed(planes, idx, "int8")
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    want_w, want_e = k1.gather_word_windowed_plain(planes, idx, "int8")
    assert int(side_e) == int(main_e) == int(want_e) > 0
    assert torch.equal(side_w, want_w) and torch.equal(main_w, want_w)


def test_chunked_q12_on_card_equals_cpu():
    """TPC-H q12 through the chunked driver at tpch.tiny: the adapted
    second run probes orders through K2 once per chunk on the card, and
    every run's rows equal the CPU's."""
    from tpch_full import QUERIES
    from trino_tpu_torch.exec.session import Session
    _card()
    rows = {}
    for device in ("cuda", "cpu"):
        s = Session(device=device)
        s.execute("SET SESSION spill_chunk_rows = 8192")
        before = k1.gather_word_windowed.launches
        rows[device] = [s.execute(QUERIES[12]).rows for _ in range(2)]
        launched = k1.gather_word_windowed.launches - before
        assert launched == (8 if device == "cuda" else 0)
        assert s.executor.stats.escaped_window_reruns == 0
        assert s.executor.stats.fused_chunk_pipelines == 2
    assert rows["cuda"] == rows["cpu"]


@pytest.mark.parametrize("qnum", [1, 12])
def test_chunked_prefetch_pipeline_on_card(qnum):
    """The prefetch pipeline on the card (fact cache off, so every chunk
    is decoded on the host and staged on the worker's stream): depth 2
    equals the serial depth 0 and the CPU on every run, every chunk is
    served from staging, and no staged bytes stay reserved. q12's second
    run at each depth probes the staged chunks through K2."""
    from tpch_full import QUERIES
    from trino_tpu_torch.exec.session import Session
    _card()
    sql = QUERIES[qnum]
    cpu = Session(device="cpu")
    cpu.execute("SET SESSION spill_chunk_rows = 8192")
    want = [cpu.execute(sql).rows for _ in range(2)]
    s = Session(device="cuda")
    s.executor.enable_fact_cache = False
    s.execute("SET SESSION spill_chunk_rows = 8192")
    stats = s.executor.stats
    for depth in (0, 2):
        s.execute(f"SET SESSION prefetch_depth = {depth}")
        before = stats.scan_prefetched_chunks
        got = [s.execute(sql).rows for _ in range(2)]
        assert got == want, depth
        spans = s.executor.chunk_spans
        assert spans["chunks"] == 8
        assert spans["prefetched"] == (8 if depth else 0)
        assert stats.scan_prefetched_chunks - before == (16 if depth else 0)
        assert stats.fact_cache_chunks == 0
        assert stats.escaped_window_reruns == 0
        assert s.executor.pool.snapshot()["revocable_holders"].get(
            "scan-prefetch", 0) == 0


def _tpcds_queries():
    from tpcds_queries import QUERIES
    return dict(QUERIES)


@pytest.mark.parametrize("mode", sorted(KERNEL_MODES))
@pytest.mark.parametrize("qid", sorted(_tpcds_queries()))
def test_tpcds_corpus_on_card_equals_cpu(ds_sessions, qid, mode):
    """All 99 TPC-DS queries at tpcds.tiny, under `auto` and with every
    kernel forced on: the card's rows equal the CPU's under the same
    settings."""
    gpu, cpu = ds_sessions
    sql = _tpcds_queries()[qid]
    assert _rows_in_mode(gpu, sql, mode) == _rows_in_mode(cpu, sql, mode)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 257, 100_003, 6_000_000])
def test_reference_order_sums_on_card_equal_cpu_bits(n):
    """cumsum_like_reference and sum_like_reference give the CPU's bits on
    the card (explicit adds, no library scan)."""
    from trino_tpu_torch.ops.aggregate import (cumsum_like_reference,
                                               sum_like_reference)
    dev = _card()
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal(n) *
                         rng.integers(1, 10 ** 6, n))
    for fn in (cumsum_like_reference, sum_like_reference):
        got = fn(x.to(dev)).cpu().numpy()
        assert got.tobytes() == fn(x).numpy().tobytes()


def _window_batch(device):
    from trino_tpu_torch.batch import batch_from_numpy
    rng = np.random.default_rng(11)
    n = 70_000
    arrays = [rng.integers(0, 50, n), rng.integers(-20, 900, n),
              rng.standard_normal(n) * rng.integers(1, 10 ** 6, n),
              rng.integers(-10 ** 6, 10 ** 6, n)]
    valids = [rng.random(n) > 0.1 for _ in arrays]
    return batch_from_numpy(arrays, valids=valids, device=device)


def test_window_compute_on_card_equals_cpu():
    """Every window function and frame over 70,000 rows (NULL keys,
    ties, DOUBLE sums): the card's columns equal the CPU's bit for
    bit."""
    from trino_tpu_torch.ops.window import WinSpec, window_compute
    dev = _card()
    specs = tuple(WinSpec(*s) for s in (
        ("row_number",), ("rank",), ("dense_rank",),
        ("ntile", None, "partition", 4), ("lead", 2), ("lag", 3,
                                                       "partition", 2, 7),
        ("first_value", 2), ("last_value", 3, "range_running"),
        ("sum", 2, "partition"), ("sum", 2, "rows_running"),
        ("sum", 3, "range_running"), ("count", 2, "rows_bounded:3:2"),
        ("sum", 2, "range_bounded:10:5"), ("count_star", None,
                                           "range_bounded:0:0"),
        ("min", 3, "rows_running"), ("max", 2, "partition")))
    order = ((1, True, False),)
    got = window_compute(_window_batch(dev), (0,), order, specs)
    want = window_compute(_window_batch("cpu"), (0,), order, specs)
    for g, w in zip(got.columns, want.columns):
        assert g.data.cpu().numpy().tobytes() == w.data.numpy().tobytes()
        assert torch.equal(g.valid.cpu(), w.valid)


@pytest.mark.parametrize("op", ["union", "intersect", "intersect_all",
                                "except", "except_all"])
def test_setops_on_card_equal_cpu(op):
    """The device set operations (NULLs, -0.0 beside 0.0, NaN, dead
    rows): the card's rows and their order equal the CPU's."""
    from trino_tpu_torch.batch import batch_from_numpy, batch_to_numpy
    from trino_tpu_torch.ops.setops import setop_rows
    dev = _card()
    rng = np.random.default_rng(5)

    def side(n, device):
        arrays = [rng.integers(0, 5, n),
                  rng.choice(np.array([0.0, -0.0, 1.5, np.nan]), n)]
        valids = [rng.random(n) > 0.2, rng.random(n) > 0.2]
        return batch_from_numpy(arrays, valids=valids, device=device)
    sides = []
    for n in (3000, 2000):
        state = rng.bit_generator.state
        a = side(n, "cpu")
        rng.bit_generator.state = state
        sides.append((a, side(n, dev)))
    want = batch_to_numpy(setop_rows(op, sides[0][0], sides[1][0]))
    got = batch_to_numpy(setop_rows(op, sides[0][1], sides[1][1]))
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.tobytes() == w.tobytes()


def test_join_mark_on_card_equals_cpu():
    """The residual expansion (TPC-H q21's <> shape) on the card: marks,
    pair totals and the out-of-domain count equal the CPU's, at a pair
    capacity that overflows and at one that fits."""
    from trino_tpu_torch import ir, types
    from trino_tpu_torch.batch import batch_from_numpy
    from trino_tpu_torch.ops.join import join_mark
    dev = _card()
    rng = np.random.default_rng(21)
    probe = [rng.integers(0, 5000, 200_000), rng.integers(0, 7, 200_000)]
    build = [rng.integers(0, 5000, 100_000), rng.integers(0, 7, 100_000)]
    resid = ir.Compare("<>", ir.ColumnRef(1, types.BIGINT),
                       ir.ColumnRef(3, types.BIGINT), types.BOOLEAN)
    for cap, domain in ((1 << 18, None), (1 << 23, 5000), (1 << 23, None)):
        out = []
        for device in (dev, "cpu"):
            out.append(join_mark(batch_from_numpy(probe, device=device),
                                 batch_from_numpy(build, device=device),
                                 (0,), (0,), resid, cap, domain))
        (gm, gt, go), (wm, wt, wo) = out
        assert int(gt) == int(wt) and int(go) == int(wo)
        assert torch.equal(gm.cpu(), wm)


def test_mutation_cycle_on_card_equals_cpu():
    """One write cycle on the card against the CPU: memory copies of
    tpch.tiny's lineitem and orders, then DELETE, UPDATE (a VARCHAR value
    new to the pool), INSERT ... SELECT and MERGE; after each, q1, q12
    (K5 under mxu_agg = 'true') and chunked q12 twice. Reported counts,
    rows and stored tables equal the CPU's; MERGE's anti join launches K1
    on the card."""
    from tpch_full import QUERIES
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.ops import direct_agg as k5
    _card()
    q12 = QUERIES[12].replace("orders,", "memory.w.orders,").replace(
        "lineitem\n", "memory.w.lineitem\n")
    q1 = QUERIES[1].replace("FROM lineitem", "FROM memory.w.lineitem")
    steps = [
        "CREATE TABLE memory.w.lineitem AS SELECT * FROM tpch.tiny.lineitem",
        "CREATE TABLE memory.w.orders AS SELECT * FROM tpch.tiny.orders",
        "DELETE FROM memory.w.lineitem WHERE l_shipdate < DATE '1993-01-01'",
        "UPDATE memory.w.lineitem SET l_extendedprice = l_extendedprice + "
        "1.00, l_shipmode = 'DRONE' WHERE l_orderkey % 4 = 1",
        "INSERT INTO memory.w.lineitem SELECT * FROM tpch.tiny.lineitem "
        "WHERE l_shipdate < DATE '1992-09-01'",
        "MERGE INTO memory.w.orders t USING (SELECT o_orderkey + 60000 * "
        "(o_orderkey % 2) AS k, o_totalprice AS p FROM tpch.tiny.orders "
        "WHERE o_orderkey % 10 IN (3, 4)) s ON t.o_orderkey = s.k WHEN "
        "MATCHED THEN UPDATE SET o_totalprice = s.p * 2 WHEN NOT MATCHED "
        "THEN INSERT (o_orderkey, o_totalprice) VALUES (s.k, s.p)"]
    out, stored = {}, {}
    for device in ("cuda", "cpu"):
        s = Session(device=device)
        rows = []
        for i, step in enumerate(steps):
            before = k1.gather_columns.launches
            rows.append(s.execute(step).rows)
            if device == "cuda" and step.startswith("MERGE"):
                assert k1.gather_columns.launches > before
            if i == 0:                # orders is the next statement's
                continue
            rows.append(s.execute(q1).rows)
            s.execute("SET SESSION mxu_agg = 'true'")
            before = k5.direct_group_aggregate_mxu.launches
            rows.append(s.execute(q12).rows)
            if device == "cuda":
                assert k5.direct_group_aggregate_mxu.launches == before + 1
            s.execute("SET SESSION mxu_agg = 'auto'")
            s.execute("SET SESSION spill_chunk_rows = 8192")
            rows += [s.execute(q12).rows for _ in range(2)]
            s.execute("SET SESSION spill_chunk_rows = 0")
        out[device] = rows
        conn = s.catalog.connector("memory")
        stored[device] = {t: conn.get_table("w", t)
                          for t in conn.table_names("w")}
    assert out["cuda"] == out["cpu"]
    for t, g in stored["cuda"].items():
        w = stored["cpu"][t]
        assert [f.dictionary for f in g.schema.fields] == \
            [f.dictionary for f in w.schema.fields]
        for a, b in zip(list(g.columns) + list(g.valids or ()),
                        list(w.columns) + list(w.valids or ())):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_pruned_file_scan_on_card_equals_cpu(tmp_path, fmt):
    """A Parquet / ORC table written by a CTAS and INSERTs over key
    ranges (a part file each), scanned on the card through the
    connector's pruned decode (its cache cold): the full scan's rows,
    groups skipped, no fallback."""
    from trino_tpu_torch.connectors.orcdir import OrcConnector
    from trino_tpu_torch.connectors.parquetdir import ParquetConnector
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.planner.optimizer import prune_plan
    from trino_tpu_torch.sql.parser import parse
    _card()
    s = Session(device="cuda")
    conn = ParquetConnector(str(tmp_path)) if fmt == "parquet" else \
        OrcConnector(str(tmp_path))
    s.catalog.register("f", conn)
    # o_shippriority as BIGINT: ORC reads any integer back as BIGINT, and
    # an INSERT's kinds must match the stored table's
    src = ("SELECT o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
           "o_orderdate, o_orderpriority, o_clerk, CAST(o_shippriority AS "
           "BIGINT) AS o_shippriority, o_comment FROM tpch.tiny.orders "
           "WHERE o_orderkey")
    s.execute(f"CREATE TABLE f.s.o AS {src} < 7500")
    for lo in range(7500, 60000, 7500):
        s.execute(f"INSERT INTO f.s.o {src} >= {lo} AND o_orderkey < "
                  f"{lo + 7500}")
    sql = ("SELECT count(*), sum(o_totalprice), max(o_orderdate) FROM "
           "f.s.o WHERE o_orderkey < 4000")
    want = Session(s.catalog, device="cpu").execute(sql).rows
    rel = s.planner().plan_query(parse(sql))
    root = prune_plan(rel.node)
    conn._cache.clear()
    cold = Session(s.catalog, device="cuda")
    batch = cold.executor.execute(root)
    names, arrays, valids = cold.executor.result_to_host(root, batch)
    assert cold.decode_rows(rel, arrays, valids) == want
    st = cold.executor.stats
    assert (st.pruned_decodes, st.pruned_groups_skipped,
            st.pruned_decode_fallbacks) == (1, 7, 0)


def test_spilled_operators_on_card_equal_cpu(tmp_path, monkeypatch):
    """JOIN_Q, GROUP BY l_orderkey (its 20 largest groups, and every
    group), the four-group sums under mxu_agg and a TopN at tpch.tiny,
    each at a quarter of its resident pool peak: the card's spilled rows
    and spill counters equal the CPU's, every query spills, K3 launches in
    the spilled GROUP BYs and K5 in the chunk-and-merge aggregate."""
    from spill_queries import GROUP_ALL_Q, GROUP_Q, JOIN_Q, SORT_Q, SUMAGG_Q
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.ops import direct_agg as k5
    _card()
    monkeypatch.setenv("TRINO_TPU_SPILL_DIR", str(tmp_path))
    # cold decisions in every session, as in tests/conftest.py: a replayed
    # JOIN_Q needs 1,013,760 bytes, and a quarter of that rounds up to the
    # session's 1 MiB
    monkeypatch.setenv("TRINO_TPU_DECISION_CACHE", "0")
    queries = {"join": JOIN_Q, "group": GROUP_Q, "group_all": GROUP_ALL_Q,
               "sumagg": SUMAGG_Q, "sort": SORT_Q}
    for name, sql in queries.items():
        out = {}
        for device in ("cpu", "cuda"):
            s = Session(device=device)
            if name == "sumagg":
                s.execute("SET SESSION mxu_agg = 'true'")
            resident = s.execute(sql).rows
            limit = max(1, s.executor.pool.peak // 4)
            s = Session(device=device)
            if name == "sumagg":
                s.execute("SET SESSION mxu_agg = 'true'")
            s.executor.pool.set_limit(limit)
            s.properties["query_max_memory_mb"] = max(1, limit >> 20)
            k3 = ht.hash_insert_multi.launches
            k5n = k5.direct_group_aggregate_mxu.launches
            rows = s.execute(sql).rows
            torch.cuda.synchronize()
            st = s.executor.stats
            spilled = (st.spilled_joins, st.spilled_aggregations,
                       st.spilled_sorts)
            assert rows == resident, (name, device)
            assert sum(spilled) >= 1, (name, device)
            if device == "cuda" and name in ("group", "group_all"):
                assert ht.hash_insert_multi.launches > k3
            if device == "cuda" and name == "sumagg":
                assert k5.direct_group_aggregate_mxu.launches > k5n
            out[device] = (rows, spilled)
        assert out["cuda"] == out["cpu"], name


def test_http_q3_on_card_equals_cpu_coordinator(tmp_path, monkeypatch):
    """TPC-H q3 over HTTP at tpch.tiny: a coordinator over a CUDA Session
    routes it to the card and answers the CPU coordinator's rows, route
    and reason. Its aggregate takes the hash strategy (K3) under
    hash_agg_min_groups = 1 (at tiny the default picks the sort one)."""
    from tpch_full import QUERIES
    from trino_tpu_torch.client.client import Client
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    _card()
    monkeypatch.setenv("TRINO_TPU_HISTORY_PATH", str(tmp_path / "h.jsonl"))
    out = {}
    for device in ("cpu", "cuda"):
        coord = CoordinatorServer(Session(device=device)).start()
        try:
            client = Client(coord.uri, user="t", poll_interval_s=0.005)
            client.execute("SET SESSION hash_agg_min_groups = 1")
            k3 = ht.hash_insert_multi.launches
            res = client.execute(QUERIES[3])
            info = client.query_info(res.query_id)
            launched = ht.hash_insert_multi.launches - k3
            out[device] = (res.rows, info["route"], info["routeReason"])
        finally:
            coord.stop()
        assert (launched > 0) == (device == "cuda"), (device, launched)
    assert out["cuda"] == out["cpu"] and out["cuda"][1] == "device"
    assert out["cuda"][0]


def test_cluster_q3_on_card_equals_cpu_cluster(tmp_path, monkeypatch):
    """TPC-H q3 at tpch.tiny on a cluster (a coordinator and two workers,
    split_rows 8192): on the card every task runs on a CUDA executor
    (K1 or K3 launch in the workers), and the rows, the fallback verdict
    (none: it ran distributed) and the workers that took tasks equal a
    CPU cluster's."""
    import time
    from tpch_full import QUERIES
    from trino_tpu_torch.client.client import Client
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.worker import WorkerServer
    _card()
    monkeypatch.setenv("TRINO_TPU_HISTORY_PATH", str(tmp_path / "h.jsonl"))
    out = {}
    for device in ("cpu", "cuda"):
        coord = CoordinatorServer(Session(device=device)).start()
        coord.state.scheduler.split_rows = 8192
        workers = [WorkerServer(f"w{i}", coord.uri, announce_interval_s=0.05,
                                device=device).start() for i in range(2)]
        try:
            deadline = time.time() + 30
            while len(coord.state.active_nodes()) < 2 and \
                    time.time() < deadline:
                time.sleep(0.02)
            client = Client(coord.uri, user="t", poll_interval_s=0.005)
            before = (k1.gather_columns.launches,
                      ht.hash_insert_multi.launches)
            res = client.execute(QUERIES[3])
            launched = (k1.gather_columns.launches - before[0] +
                        ht.hash_insert_multi.launches - before[1])
            info = client.query_info(res.query_id)
            out[device] = (res.rows, info.get("fallbackReason"),
                           [w.task_manager.tasks_run > 0 for w in workers])
            assert all(w.task_manager.device.type == device
                       for w in workers)
        finally:
            for w in workers:
                w.stop(graceful=False)
            coord.stop()
        assert (launched > 0) == (device == "cuda"), (device, launched)
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][0] and out["cuda"][1] is None
    assert out["cuda"][2] == [True, True]


def test_glibc_math_kernel_equals_replay_and_glibc_on_card():
    """csrc/glibc_math.cu's log and pow on the card equal their plain
    torch replay there and glibc's on the CPU, bit for bit, over seeded
    arguments through every branch (the wrappers' subnormal flush
    aside: the kernel is called directly)."""
    from trino_tpu_torch.ops import project as P
    dev = _card()
    rng = np.random.default_rng(21)
    n = 50_000
    x = np.concatenate([
        rng.uniform(0, 2, n), np.exp(rng.uniform(-745, 709, n)),
        rng.uniform(0.93, 1.07, n), -np.abs(rng.normal(0, 5, n)),
        np.abs(rng.normal(0, 1, n)) * 2.0 ** -1060,
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 2.0 ** -1074]])
    y = np.concatenate([
        rng.uniform(-3, 3, n), np.round(rng.uniform(-20, 20, n)),
        rng.uniform(-1100, 1100, n), np.round(rng.uniform(-9, 9, n)),
        rng.normal(0, 1, n) * 10.0 ** rng.integers(-25, 25, n),
        [2.0 ** 63, -2.0 ** 63, 2.0 ** -70, 0.0, np.inf, -np.inf, np.nan,
         3.0]])
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    cx, cy = tx.to(dev), ty.to(dev)
    before = P.glibc_math_kernel.launches
    for op, kern, plain, cpu in (
            ("log", P.glibc_math_kernel("log", cx), P.glibc_log_plain(cx),
             P._glibc("log", tx)),
            ("pow", P.glibc_math_kernel("pow", cx, cy),
             P.glibc_pow_plain(cx, cy), P._glibc("pow", tx, ty))):
        k = kern.cpu().numpy()
        for other in (plain.cpu().numpy(), cpu.numpy()):
            nan = np.isnan(k) & np.isnan(other)
            assert (~nan & (k.view(np.int64) != other.view(np.int64))
                    ).sum() == 0, op
    assert P.glibc_math_kernel.launches == before + 2


def test_mesh_partitioned_join_on_card_equals_cpu_mesh():
    """The mesh on eight shards of one card (make_mesh(8, "cuda")) answers
    a partitioned join and TPC-H q3 with the CPU mesh's rows at
    tpch.tiny, building one K3 table per shard."""
    from tpch_full import QUERIES
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.parallel.dist_executor import MeshExecutor
    from trino_tpu_torch.parallel.mesh import make_mesh
    _card()
    probe_rows = ("SELECT l_orderkey, l_linenumber, o_totalprice "
                  "FROM lineitem, orders WHERE l_orderkey = o_orderkey "
                  "AND o_totalprice > 400000 "
                  "ORDER BY l_orderkey, l_linenumber")
    out = {}
    for device in ("cpu", "cuda"):
        s = Session(device=device)
        s.executor = MeshExecutor(s.catalog, make_mesh(8, device))
        s.execute("SET SESSION join_distribution_type = 'partitioned'")
        s.execute("SET SESSION enable_pallas_hash = true")
        before = ht.hash_insert_multi.launches
        out[device] = [s.execute(q).rows for q in (probe_rows, QUERIES[3])]
        joins = s.executor.stats.mesh_partitioned_joins
        launched = ht.hash_insert_multi.launches - before
        assert joins > 0
        assert launched >= (8 * joins if device == "cuda" else 0)
        assert s.executor.stats.dynamic_filter_rows_pruned > 0
    assert out["cuda"] == out["cpu"]


Q3_SQL = """
SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
       o_orderdate, o_shippriority
FROM customer, orders, lineitem
WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
  AND l_orderkey = o_orderkey AND o_orderdate < DATE '1995-03-15'
  AND l_shipdate > DATE '1995-03-15'
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate, l_orderkey LIMIT 10"""


def test_profiled_fence_splits_q3_on_card(monkeypatch):
    """enable_profiling on the card: the fence is torch.cuda.synchronize,
    every node's device + host + compile equals its wall, q3's join
    nodes wait on the card (device > 0), and the rows equal the
    unprofiled run's."""
    _card()
    from trino_tpu_torch.exec import executor as ex_mod
    from trino_tpu_torch.exec.session import Session
    names = {}
    real = ex_mod.Executor._dispatch_timed

    def spy(self, node):
        names[id(node)] = type(node).__name__
        return real(self, node)

    monkeypatch.setattr(ex_mod.Executor, "_dispatch_timed", spy)
    s = Session(device="cuda")
    want = s.execute(Q3_SQL).rows
    s.execute("SET SESSION enable_profiling = true")
    got = s.execute(Q3_SQL).rows
    assert got == want and len(got) == 10
    ns = s.executor.node_stats
    joins = [st for i, st in ns.items() if names[i] == "JoinNode"]
    assert joins and all(st[2] > 0 for st in joins)
    for wall, _rows, dev, host, comp in ns.values():
        assert min(dev, host, comp) >= 0
        assert abs(wall - (dev + host + comp)) < 1e-9
    s.execute("SET SESSION enable_profiling = false")
    assert s.execute(Q3_SQL).rows == want


def test_profiled_star_counts_fused_probes_on_card(ds_sessions):
    """A fused TPC-DS star, profiled: rows bit-equal to the unprofiled
    run, and MULTIJOIN_FUSED_PROBES rises by the delta of
    stats.multijoin_fused_probes; K4 launches at least as often (one
    `ht.multiway_probe` call a fused pass)."""
    from tpcds_queries import QUERIES
    from trino_tpu_torch.metrics import MULTIJOIN_FUSED_PROBES
    gpu, _cpu = ds_sessions
    want = gpu.execute(QUERIES[3]).rows
    gpu.execute("SET SESSION enable_profiling = true")
    try:
        probes0 = gpu.executor.stats.multijoin_fused_probes
        metric0 = MULTIJOIN_FUSED_PROBES.value()
        k4_0 = ht.multiway_probe.launches
        got = gpu.execute(QUERIES[3]).rows
    finally:
        gpu.execute("SET SESSION enable_profiling = false")
    assert got == want
    d_probes = gpu.executor.stats.multijoin_fused_probes - probes0
    assert d_probes >= 1
    assert MULTIJOIN_FUSED_PROBES.value() - metric0 == d_probes
    assert ht.multiway_probe.launches - k4_0 >= d_probes


def test_chaos_schedule_on_card_equals_cpu(tmp_path, monkeypatch):
    """TPC-H q3 at tpch.tiny on a card cluster under seed 5's schedule,
    then a crash mid-split and a corrupted drained page: every run's
    rows equal the CPU Session's, the corrupted page is caught and
    retried, and the workers' dense-LUT joins launch K1 under the
    faults (at tiny a split's aggregate takes no hash table)."""
    import time
    from tpch_full import QUERIES
    from trino_tpu_torch.client.client import Client
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.failureinjector import (CORRUPT, CRASH,
                                                        FailureInjector)
    from trino_tpu_torch.server.worker import WorkerServer
    _card()
    monkeypatch.setenv("TRINO_TPU_HISTORY_PATH", str(tmp_path / "h.jsonl"))
    want = [list(r) for r in Session(device="cpu").execute(QUERIES[3]).rows]
    want = [[v if isinstance(v, (int, float, str)) else str(v) for v in r]
            for r in want]
    coord = CoordinatorServer(Session(), retry_policy="QUERY").start()
    sched = coord.state.scheduler
    sched.split_rows = 8192
    workers = [WorkerServer(f"w{i}", coord.uri, announce_interval_s=0.05,
                            device="cuda").start() for i in range(2)]
    deadline = time.time() + 30
    while len(coord.state.active_nodes()) < 2 and time.time() < deadline:
        time.sleep(0.02)
    try:
        client = Client(coord.uri, user="t", poll_interval_s=0.005)
        seeded = FailureInjector.from_seed(5, max_delay_s=0.2)
        crash = FailureInjector(seed=103)
        crash.inject("WORKER_TASK_RUN", times=1, fault=CRASH)
        corrupt = FailureInjector(seed=101)
        corrupt.inject("EXCHANGE_DRAIN", times=1, fault=CORRUPT)
        k0 = k1.gather_columns.launches
        for inj in (None, seeded, crash, corrupt):
            sched.spool.clear()
            sched.failure_injector = inj
            for w in workers:
                w.task_manager.injector = inj
            cf = sched.stats["checksum_failures"]
            rows = client.execute(QUERIES[3]).rows
            assert rows == want
            if inj is corrupt:
                assert sched.stats["checksum_failures"] == cf + 1
        assert crash.injected_count == 1 and corrupt.injected_count == 1
        assert k1.gather_columns.launches > k0
    finally:
        for w in workers:
            w.stop(graceful=False)
        coord.stop()


def test_failover_on_card_equals_cpu(tmp_path, monkeypatch):
    """A card primary killed while TPC-H q3 runs: the card standby is
    promoted by its detector and answers the CPU Session's rows under
    the original query id; the dead primary's device caches are freed."""
    import threading
    import time
    from tpch_full import QUERIES
    from trino_tpu_torch.client.client import Client
    from trino_tpu_torch.exec.session import Session
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.failureinjector import HANG, FailureInjector
    from trino_tpu_torch.server.worker import WorkerServer
    _card()
    monkeypatch.setenv("TRINO_TPU_HISTORY_PATH", str(tmp_path / "h.jsonl"))
    want = [[v if isinstance(v, (int, float, str)) else str(v) for v in r]
            for r in Session(device="cpu").execute(QUERIES[3]).rows]
    ledger, spool = str(tmp_path / "q.ledger"), str(tmp_path / "spool")
    primary = CoordinatorServer(Session(), ledger_path=ledger,
                                node_id="c1", spool_root=spool).start()
    standby = CoordinatorServer(Session(), ledger_path=ledger,
                                node_id="c2", role="standby",
                                peer_uri=primary.uri, spool_root=spool,
                                standby_interval_s=0.1).start()
    for c in (primary, standby):
        c.state.scheduler.split_rows = 8192
    workers = [WorkerServer(f"fw{i}", primary.uri, announce_interval_s=0.05,
                            device="cuda").start() for i in range(2)]
    inj = FailureInjector()
    try:
        deadline = time.time() + 30
        while len(primary.state.active_nodes()) < 2 and \
                time.time() < deadline:
            time.sleep(0.02)
        for w in workers:
            w.announce_once()
        client = Client([primary.uri, standby.uri], user="t",
                        timeout_s=120, poll_interval_s=0.005)
        assert client.execute(QUERIES[3]).rows == want
        primary.state.dispatcher.failure_injector = inj
        inj.inject("EXECUTION", times=1, fault=HANG, delay_s=120.0,
                   match_sql="c_mktsegment")
        res = {}
        t = threading.Thread(target=lambda: res.update(
            r=client.execute(QUERIES[3])))
        t.start()
        deadline = time.time() + 60
        while time.time() < deadline and not any(
                q.state == "RUNNING" and not q.state_machine.is_done()
                for q in primary.state.tracker.all()
                if "c_mktsegment" in q.sql):
            time.sleep(0.01)
        primary.kill()
        assert primary.state.session.executor.device_cache_bytes() == 0
        t.join(timeout=120)
        assert not t.is_alive()
        r = res["r"]
        assert r.rows == want and r.failovers >= 1
        assert standby.state.role == "PRIMARY"
        assert standby.state.tracker.get(r.query_id).state == "FINISHED"
    finally:
        for w in workers:
            w.stop(graceful=False)
        inj.clear()
        for c in (primary, standby):
            try:
                c.state.dispatcher.pool.shutdown(wait=False)
                c.stop()
            except Exception:  # noqa: BLE001 — killed servers die twice
                pass


def test_approx_distinct_on_card_equals_cpu():
    """approx_distinct at tpch.tiny: the card's integers equal the CPU's
    (the splitmix64 hash's wrapping multiplies and logical shifts, the
    leading-zero count and the finisher's log on CUDA)."""
    from torch_time_cases import HLL_QUERIES, hll_sql
    from trino_tpu_torch.exec.session import Session
    _card()
    gpu, cpu = Session(), Session(device="cpu")
    for q in HLL_QUERIES:
        assert gpu.execute(hll_sql(q)).rows == cpu.execute(hll_sql(q)).rows


def test_timestamp_pre_epoch_on_card_equals_cpu():
    """TIMESTAMP at tpch.tiny with rows before 1970 and at day boundaries:
    EXTRACT, CAST to date, every date_trunc unit, grouped min/max and
    comparisons against a DATE equal the CPU's rows on the card."""
    from torch_time_cases import TS_QUERIES, ts_setup
    from trino_tpu_torch.exec.session import Session
    _card()
    gpu, cpu = Session(), Session(device="cpu")
    for sess in (gpu, cpu):
        for sql in ts_setup("tiny", np.random.default_rng(7)):
            sess.execute(sql)
    for sql in TS_QUERIES:
        assert gpu.execute(sql).rows == cpu.execute(sql).rows, sql


# ---------------------------------------------------------------------------
# the scale path's largest launches (trino_tpu_torch/e2e.py, q5-shaped at
# SF100 in 33,554,432-row chunks): each as large as the run made it
# ---------------------------------------------------------------------------

SCALE_CHUNK = 33_554_432
# the planner rounds q5-shaped SF100's o_orderkey domain (max key
# 599,999,976, plus 2) up to 2^30: the dense LUT has 2^30 + 1 entries
SF100_ORDERKEY_LUT = (1 << 30) + 1


def _chunk_keys(dev, g, width, n):
    """A chunk of sorted keys in [0, width), every 1009th past the top
    and every 997th negative (misses)."""
    idx = torch.randint(0, width, (n,), dtype=torch.int64, device=dev,
                        generator=g).sort().values
    idx[::1009] = width + 7
    idx[1::997] = -3
    return idx


def _k1_equal(tables, idx, fills):
    before = k1.gather_columns.launches
    got = k1.gather_columns(tables, idx, fills)
    want = k1.gather_columns_plain(tables, idx, fills)
    torch.cuda.synchronize()
    assert k1.gather_columns.launches > before
    for gv, wv in zip(got, want):
        assert gv.dtype == wv.dtype and gv.shape == (idx.shape[0],)
        assert torch.equal(gv, wv)


def test_k1_scale_chunk_into_sf100_orderkey_lut_on_card():
    """K1's widest launch on the scale path: a chunk of 33,554,432 int64
    order keys into the dense int32 LUT of 2^30 + 1 entries that
    q5-shaped SF100's orders hop builds (csrc/gather.cu narrows each
    index to int, so a table's width must stay under 2^31), against the
    plain version: equal words."""
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    lut = torch.randint(-(1 << 30), 1 << 30, (SF100_ORDERKEY_LUT,),
                        dtype=torch.int32, device=dev, generator=g)
    idx = _chunk_keys(dev, g, SF100_ORDERKEY_LUT, SCALE_CHUNK)
    _k1_equal([lut], idx, [0])
    # and the last entry, which only a table past 2^30 rows has
    edge = torch.tensor([SF100_ORDERKEY_LUT - 1, 0], device=dev)
    _k1_equal([lut], edge, [0])


def test_k1_scale_chunk_payload_gather_on_card():
    """K1's payload gather on the scale path: a chunk of 33,554,432
    int32 row ids into the five columns (int64, int64, int32, int64,
    int64) of the orders hop's 25,165,824-row build, with fills,
    against the plain version."""
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    w = 25_165_824
    dts = [torch.int64, torch.int64, torch.int32, torch.int64, torch.int64]
    tables = [torch.randint(-(1 << 30), 1 << 30, (w,), dtype=dt,
                            device=dev, generator=g) for dt in dts]
    idx = _chunk_keys(dev, g, w, SCALE_CHUNK).to(torch.int32)
    _k1_equal(tables, idx, [-1, 0, 7, -5, 3])


def test_k4_scale_chunk_widest_tables_on_card():
    """K4 on a whole scale chunk (33,554,432 fact rows) against two
    dimensions at the widest table a star may take (MAX_TABLE_SLOTS
    slots; 28,000 keys each, load 0.21, so no chain escapes): the launch
    q5's star would make at scale if its dimensions fit (its orders
    dimension degrades for `vmem` at SF10 and SF100, so the star runs
    the pairwise ladder and the run itself launches none), against the
    plain version: found and miss bit-exact, one launch."""
    from trino_tpu_torch.batch import Batch, Column
    dev = _card()
    rng = np.random.default_rng(20)
    n, slots, m = SCALE_CHUNK, ht.MAX_TABLE_SLOTS, 28_000
    builds, cols = [], []
    for d in range(2):
        keys = rng.choice(1 << 30, m, replace=False)
        ones = torch.ones(m, dtype=torch.bool, device=dev)
        builds.append(Batch((Column(torch.from_numpy(keys).to(dev),
                                    ones),), ones))
        fk = np.where(rng.random(n) < 0.7, keys[rng.integers(0, m, n)],
                      rng.integers(1 << 30, (1 << 31) - 1, n))
        cols.append(Column(torch.from_numpy(fk).to(dev),
                           torch.from_numpy(rng.random(n) > 0.01).to(dev)))
    probe = Batch(tuple(cols), torch.from_numpy(rng.random(n) > 0.02).to(
        dev))
    tkey, src, dup, esc = ht.build_join_tables(builds, [(0,)] * 2, slots)
    assert int(dup.sum()) == int(esc.sum()) == 0
    pk = ((0,), (1,))
    before = ht.multiway_probe.launches
    found, miss = ht.multiway_probe(probe, tkey, src, pk)
    torch.cuda.synchronize()
    assert ht.multiway_probe.launches == before + 1
    found2, miss2 = ht._multiway_probe_keys_plain(
        probe.live, [(c.data, c.valid) for c in cols], tkey, src)
    assert torch.equal(found, found2) and torch.equal(miss, miss2)
    assert int(miss[0]) > 0 and int((found[1] >= 0).sum()) > 0


def test_star_rows_equal_ladder_whatever_k3_escapes_on_card():
    """Queue C 8 on the card: the star micro's k = 5 shape (4,096-key
    dimensions at 8,192 slots), whose K3 builds escape one key in some
    runs and none in others; six fused runs in one Session, each equal
    to the numpy sum, whichever dimensions each run fused."""
    dev = _card()
    from trino_tpu_torch import e2e, micro
    from trino_tpu_torch.catalog import Catalog
    from trino_tpu_torch.exec.session import Session
    k, fact_rows, dim_rows = 5, 1 << 20, 4096
    t = micro._star_tables(k, fact_rows, dim_rows, 0.9)
    f = t["fact"].columns
    m = np.ones(fact_rows, bool)
    tot = f[k].copy()
    for i in range(k):
        ok = f[i] < dim_rows
        m &= ok
        tot = tot + np.where(ok, t[f"dim{i}"].columns[1][
            np.minimum(f[i], dim_rows - 1)], 0)
    cat = Catalog()
    cat.register("bench", e2e.BenchConnector(t, "star"))
    s = Session(catalog=cat, default_cat="bench", default_schema="star",
                device=dev)
    s.execute("SET SESSION enable_multiway_join = 'true'")
    verdicts = set()
    for _ in range(6):
        assert s.execute(micro.star_sql(k)).rows == [(int(tot[m].sum()),)]
        verdicts.add(s.executor.strategy_decisions["MultiJoinNode"])
    assert verdicts
