"""Card-only tests of the port's hand-written kernels: each kernel against
its plain torch version on CUDA tensors, and a query through the port
Session on the card against the same query on the CPU.

Every test here needs an NVIDIA GPU and skips without one (decided inside
the test). The file imports neither jax nor the reference package, so on
the GPU machine it runs without them:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: bit-exact (K1 bytes, K3 group states as multisets, query rows
equal)."""

import os
import sys

import numpy as np
import pytest
import torch

from trino_tpu_torch.ops import gather as k1
from trino_tpu_torch.ops import hashtable as ht
from trino_tpu_torch.ops.aggregate import AggSpec

pytestmark = pytest.mark.cuda

# the shared query texts live beside this file (no conftest on the card)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


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
    # 18 tables: two launches of at most MAX_TABLES
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
    before = ht.hash_insert.launches
    tk, st, esc, occ = ht.hash_insert(*args)
    tk2, st2, esc2, occ2 = ht.hash_insert_plain(*args)
    torch.cuda.synchronize()
    assert ht.hash_insert.launches == before + 1
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


def _tpch_queries():
    from tpch_full import QUERIES
    return {q: sql for q, sql in QUERIES.items() if q not in (4, 21, 22)}


@pytest.fixture(scope="module")
def sessions():
    from trino_tpu_torch.exec.session import Session
    _card()
    return Session(device="cuda"), Session(device="cpu")


@pytest.mark.parametrize("qnum", sorted(_tpch_queries()))
def test_tpch_on_card_equals_cpu(sessions, qnum):
    """The TPC-H queries of the slice at tpch.tiny: the card's rows equal
    the CPU's (the kernels against their plain versions, end to end)."""
    gpu, cpu = sessions
    sql = _tpch_queries()[qnum]
    assert gpu.execute(sql).rows == cpu.execute(sql).rows
